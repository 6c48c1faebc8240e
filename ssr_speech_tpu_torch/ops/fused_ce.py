"""Fused CE head: second head matmul + log-softmax + target NLL + top-k rank,
forward and backward, without [N, C] fp32 logits in device memory (port of
``ssr_speech_tpu/ops/fused_ce.py``).

Kernels: ``csrc/fused_ce.cu``, hand-written for Hopper (sm_90a), three entry
points that replace the three Pallas TPU kernels:

- ``ssr_fused_ce_fwd_bf16`` <- ``_fwd_kernel``: nll, logz and the top-k hit
  per row, in two passes over vocab tiles (online max/sum and the target
  logit, then the rank count);
- ``ssr_fused_ce_bwd_dhidden_bf16`` <- ``_bwd_dhidden_kernel``: the logits are
  recomputed tile by tile from the saved logz and
  dhidden = bf16((p - onehot) * g) . w2^T accumulates in registers;
- ``ssr_fused_ce_bwd_dw2_bf16`` <- ``_bwd_dw2_kernel``: a block owns
  (codebook, vocab tile) and loops over every row block, so dw2 and db2 (the
  sum of the bf16-rounded dlogits) accumulate in fp32 with no atomics.

The vocab tail is masked by bounds inside the kernels: the JAX padding rule
(``_pad_inputs``: rows to a multiple of 128, columns with a -1e9 bias) has no
counterpart, and columns past C never enter logz or the rank. At the 830M
shapes each pass is 2*K*N*Hh*C ~ 0.34 TFLOP of tensor-core work (N ~ 2e4);
the forward makes two passes and the backward two, so the kernels are bound
by the mma.sync rate and by re-reading the staged w2/hidden tiles from L2.

:class:`FusedCEHead` binds them as a ``torch.autograd.Function``; ``hits``
gets no gradient. On a CPU tensor :func:`fused_ce_head` takes the plain
version :func:`reference_ce_head` and autograd's backward of it (the CPU
tests); on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_layout, load

_KERNEL = "fused_ce"
TOP = 10

# kernel launches since the last reset (plain integers; read by chip_smoke.py)
fwd_launches = 0
dhidden_launches = 0
dw2_launches = 0


def reset_launches() -> None:
    global fwd_launches, dhidden_launches, dw2_launches
    fwd_launches = dhidden_launches = dw2_launches = 0


def reference_ce_head(hidden, w2, b2, targets, top: int = TOP):
    """Plain version with the kernels' math (fp32 matmul accumulation).

    hidden [K, N, Hh]; w2 [K, Hh, C]; b2 [K, C]; targets [K, N] int.
    Returns (nll [K, N] fp32, hits [K, N] fp32, 1.0 where rank < top)."""
    logits = torch.matmul(hidden.float(), w2.float()) + b2.float()[:, None, :]
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    rank = (logits > tgt[..., None]).float().sum(dim=-1)
    return logz - tgt, (rank < float(top)).float()


def load_kernel():
    """Build (first call only) and bind the three entry points."""
    built = load(_KERNEL)
    lib = built.lib
    if lib.ssr_fused_ce_fwd_bf16.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssr_fused_ce_fwd_bf16.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.ssr_fused_ce_bwd_dhidden_bf16.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.ssr_fused_ce_bwd_dw2_bf16.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        for fn in (lib.ssr_fused_ce_fwd_bf16, lib.ssr_fused_ce_bwd_dhidden_bf16,
                   lib.ssr_fused_ce_bwd_dw2_bf16):
            fn.restype = ctypes.c_int
    return built


def _check_cuda_args(hidden, w2, b2, targets) -> None:
    k, n, hh = hidden.shape
    c = w2.shape[-1]
    for name, t in (("hidden", hidden), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused CE kernel takes bfloat16 {name}, got "
                            f"{t.dtype}")
    if w2.shape != (k, hh, c) or b2.shape != (k, c) or targets.shape != (k, n):
        raise ValueError(f"fused CE shapes: hidden {tuple(hidden.shape)}, w2 "
                         f"{tuple(w2.shape)}, b2 {tuple(b2.shape)}, targets "
                         f"{tuple(targets.shape)}")
    if hh % 128 or not 128 <= hh <= 1024:
        raise ValueError(f"fused CE kernel takes Hh a multiple of 128 up to "
                         f"1024, got {hh}")
    if targets.dtype != torch.int32:
        raise TypeError(f"fused CE kernel takes int32 targets, got "
                        f"{targets.dtype}")
    check_layout("fused CE", hidden=hidden, w2=w2, b2=b2, targets=targets)


def _launch(fn, name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"fused CE {name} kernel launch failed: CUDA error "
                           f"{err}")


def ce_forward(hidden, w2, b2, targets, top: int = TOP):
    """Forward kernel on checked CUDA tensors -> (nll, logz, hits) fp32."""
    global fwd_launches
    k, n, hh = hidden.shape
    c = w2.shape[-1]
    nll, logz, hits = (torch.empty((k, n), dtype=torch.float32,
                                   device=hidden.device) for _ in range(3))
    with torch.cuda.device(hidden.device):
        _launch(load_kernel().lib.ssr_fused_ce_fwd_bf16, "forward",
                hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), nll.data_ptr(), logz.data_ptr(),
                hits.data_ptr(), k, n, hh, c, top)
    fwd_launches += 1
    return nll, logz, hits


def ce_backward_dhidden(hidden, w2, b2, targets, logz, g):
    """dhidden [K, N, Hh] in hidden's dtype; g is the nll cotangent."""
    global dhidden_launches
    k, n, hh = hidden.shape
    check_layout("fused CE", logz=logz, g=g)
    dhid = torch.empty_like(hidden)
    with torch.cuda.device(hidden.device):
        _launch(load_kernel().lib.ssr_fused_ce_bwd_dhidden_bf16, "dhidden",
                hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), logz.data_ptr(), g.data_ptr(),
                dhid.data_ptr(), k, n, hh, w2.shape[-1])
    dhidden_launches += 1
    return dhid


def ce_backward_dw2(hidden, w2, b2, targets, logz, g):
    """(dw2 [K, Hh, C], db2 [K, C]) in fp32."""
    global dw2_launches
    k, n, hh = hidden.shape
    c = w2.shape[-1]
    check_layout("fused CE", logz=logz, g=g)
    dw2 = torch.empty((k, hh, c), dtype=torch.float32, device=hidden.device)
    db2 = torch.empty((k, c), dtype=torch.float32, device=hidden.device)
    with torch.cuda.device(hidden.device):
        _launch(load_kernel().lib.ssr_fused_ce_bwd_dw2_bf16, "dw2",
                hidden.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), logz.data_ptr(), g.data_ptr(),
                dw2.data_ptr(), db2.data_ptr(), k, n, hh, c)
    dw2_launches += 1
    return dw2, db2


class FusedCEHead(torch.autograd.Function):
    """Forward kernel; backward = the dhidden and dw2/db2 kernels. ``hits``
    is locally constant (zero cotangent); dw2/db2 come back in the weights'
    dtype, as the JAX VJP casts them."""

    @staticmethod
    def forward(ctx, hidden, w2, b2, targets, top):
        nll, logz, hits = ce_forward(hidden, w2, b2, targets, top)
        ctx.save_for_backward(hidden, w2, b2, targets, logz)
        ctx.mark_non_differentiable(hits)
        return nll, hits

    @staticmethod
    def backward(ctx, g_nll, _g_hits):
        hidden, w2, b2, targets, logz = ctx.saved_tensors
        g = g_nll.float().contiguous()
        dhid = ce_backward_dhidden(hidden, w2, b2, targets, logz, g)
        dw2, db2 = ce_backward_dw2(hidden, w2, b2, targets, logz, g)
        return dhid, dw2.to(w2.dtype), db2.to(b2.dtype), None, None


def fused_ce_head(hidden, w2, b2, targets, top: int = TOP):
    """hidden [K, N, Hh], w2 [K, Hh, C], b2 [K, C], targets [K, N] int ->
    (nll [K, N] fp32, hits [K, N] fp32)."""
    if hidden.device.type == "cpu":
        return reference_ce_head(hidden, w2, b2, targets, top)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_ce_head: unsupported device {hidden.device}")
    _check_cuda_args(hidden, w2, b2, targets)
    if torch.is_grad_enabled() and (hidden.requires_grad or w2.requires_grad
                                    or b2.requires_grad):
        return FusedCEHead.apply(hidden, w2, b2, targets, top)
    nll, _, hits = ce_forward(hidden, w2, b2, targets, top)
    return nll, hits
