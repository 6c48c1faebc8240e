"""The routed experts of a MoE decode step (``models/mla_moe.py``): for each
live row's chosen experts, the expert's SwiGLU of the row, weighted by the
router's weight and added over the choices in fp32.

Kernel, hand-written for Hopper (sm_90a): ``csrc/moe_experts.cu`` (K11). It
replaces no TPU kernel (the JAX package has no MoE block). It reads each
expert that at least one live row chose once, and an expert that no live
row chose not at all, with the routing read on the device, so a CUDA graph
captures it. The design is in the source.

Route (:func:`uses_kernel`): a CUDA bf16 step launches the kernel; the CPU
and fp32 run the plain version :func:`plain_moe_experts`, the kernel's
arithmetic: gate and up products rounded to x's dtype, silu(gate) * up in
fp32 rounded once, the down product rounded, times the weight in fp32,
then the choices added in order in fp32. A CUDA bf16 step at shapes past
the kernel's tiles (D or F not a multiple of 32, more than 256 experts or
8,192 (row, choice) pairs) is refused.

``live`` ([N] bool, default every row): a row that is not live gets 0 from
the routed experts and reads none of them (the server's parked lanes, and
every row of a step past its chunk's end). Routing counters: ``counts``
[2, E] int32 gets each expert's live (row, choice) pairs and 1 for each
expert with any: the server's ``expert_tokens`` and the experts touched a
step.

``launches`` counts the kernels' launches (:data:`LAUNCHES_PER_CALL` a
call), those a CUDA graph replays included (``cuda_build.launched``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import check_layout, launched, load

_KERNEL = "moe_experts"
MAX_SLOTS = 8192
MAX_EXPERTS = 256
LAUNCHES_PER_CALL = 3  # gate/up products, silu(gate) * up, down products

# kernel launches since the last reset (a plain integer)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _count(n: int) -> None:
    global launches
    launches += n


def uses_kernel(x: torch.Tensor) -> bool:
    return x.device.type == "cuda" and x.dtype == torch.bfloat16


def _check_shapes(idx: torch.Tensor, down: torch.Tensor) -> None:
    n, k = idx.shape
    E, D, Fe = down.shape
    if D % 32 or Fe % 32 or E > MAX_EXPERTS or n * k > MAX_SLOTS:
        raise ValueError(
            f"moe experts kernel: D {D} and F {Fe} must be multiples of 32, "
            f"E {E} at most {MAX_EXPERTS}, N * k {n * k} at most {MAX_SLOTS}")


def _count_routing(counts, idx, E, live):
    ones = torch.ones(idx.shape, dtype=torch.int32, device=idx.device)
    if live is not None:
        ones = ones * live[:, None].to(torch.int32)
    hits = torch.zeros(E, dtype=torch.int32, device=idx.device).scatter_add_(
        0, idx.reshape(-1), ones.reshape(-1))
    counts.add_(torch.stack([hits, (hits > 0).to(torch.int32)]))


def plain_moe_experts(x, idx, w, experts_gu, experts_down, *, counts=None,
                      live=None) -> torch.Tensor:
    """x [N, D], idx [N, k] int64, w [N, k] fp32, experts_gu [E, 2F, D],
    experts_down [E, D, F], live [N] bool or None -> [N, D] fp32. Every
    expert runs over every row (no data-dependent shape: the plain version
    is capturable too) and the live rows' choices take theirs."""
    n, k = idx.shape
    E, twoF, _ = experts_gu.shape
    y = torch.zeros((n, k, x.shape[1]), dtype=torch.float32, device=x.device)
    for e in range(E):
        g, u = (x @ experts_gu[e].to(x.dtype).t()).float().chunk(2, dim=-1)
        ye = ((F.silu(g) * u).to(x.dtype) @ experts_down[e].to(x.dtype).t()).float()
        chosen = idx == e
        if live is not None:
            chosen = chosen & live[:, None]
        y = torch.where(chosen[..., None], w[..., None] * ye[:, None], y)
    if counts is not None:
        _count_routing(counts, idx, E, live)
    return y.sum(1)


def load_kernel():
    built = load(_KERNEL)
    fn = built.lib.ssr_moe_experts_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return built


def kernel_moe_experts(x, idx, w, experts_gu, experts_down, *, counts=None,
                       live=None) -> torch.Tensor:
    """K11 on checked CUDA tensors, as :func:`plain_moe_experts`."""
    n, k = idx.shape
    E, twoF, D = experts_gu.shape
    Fe = twoF // 2
    if (x.dtype != torch.bfloat16 or x.shape != (n, D)
            or experts_gu.dtype != torch.bfloat16
            or experts_down.dtype != torch.bfloat16
            or experts_down.shape != (E, D, Fe) or idx.dtype != torch.int64
            or w.dtype != torch.float32 or w.shape != (n, k)
            or (live is not None and (live.dtype != torch.bool
                                      or live.shape != (n,)))):
        raise ValueError(f"moe experts kernel: x {tuple(x.shape)} {x.dtype}, "
                         f"idx {idx.dtype}, w {w.dtype} {tuple(w.shape)}, "
                         f"experts {tuple(experts_gu.shape)} / "
                         f"{tuple(experts_down.shape)}, live "
                         f"{None if live is None else (live.dtype, tuple(live.shape))}")
    _check_shapes(idx, experts_down)
    idx, w = idx.contiguous(), w.contiguous()
    check_layout("moe experts", x=x, idx=idx, w=w, experts_gu=experts_gu,
                 experts_down=experts_down)
    if live is not None:  # read a byte at a time: any offset will do
        live = live.contiguous()
        if live.device != x.device:
            raise ValueError(f"moe experts kernel: live is on {live.device}")
    if counts is not None:
        if counts.dtype != torch.int32 or counts.shape != (2, E):
            raise ValueError("moe experts kernel: counts must be int32 [2, E]")
        check_layout("moe experts", counts=counts)
    gu_out = torch.empty((n * k, 2 * Fe), dtype=x.dtype, device=x.device)
    hmid = torch.empty((n * k, Fe), dtype=x.dtype, device=x.device)
    y = torch.empty((n * k, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = load_kernel().lib.ssr_moe_experts_bf16(
            x.data_ptr(), idx.data_ptr(), w.data_ptr(),
            live.data_ptr() if live is not None else None,
            experts_gu.data_ptr(), experts_down.data_ptr(), gu_out.data_ptr(),
            hmid.data_ptr(), y.data_ptr(),
            counts.data_ptr() if counts is not None else None, n, k, E, D, Fe,
            stream)
    if err != 0:
        raise RuntimeError(f"moe experts kernel launch failed: CUDA error "
                           f"{err} at N {n}, k {k}, E {E}, D {D}, F {Fe}")
    for _ in range(LAUNCHES_PER_CALL):
        launched(_count)
    return y.view(n, k, D).sum(1)


def moe_experts(x, idx, w, experts_gu, experts_down, *,
                counts: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts of one layer, by :func:`uses_kernel`'s route;
    arguments and result as :func:`plain_moe_experts`."""
    fn = kernel_moe_experts if uses_kernel(x) else plain_moe_experts
    return fn(x, idx, w, experts_gu, experts_down, counts=counts, live=live)
