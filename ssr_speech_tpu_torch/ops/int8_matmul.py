"""Int8 weight-streaming matvecs: a few activation rows against an int8 weight
with one fp32 scale per output column (port of the TPU probe kernels under
``tools/``: ``int8_matmul.py``, ``int8_kernel_probe2.py``,
``int8_kernel_probe3.py``).

Kernels: ``csrc/int8_matmul.cu``, hand-written for Hopper (sm_90a), one entry
point per TPU kernel (and per mode of the second):

- :func:`int8_matvec` <- ``int8_matmul``: the weight dequantised to fp32 in
  registers, an fp32 dot, times scale;
- :func:`int8_matvec_chain` <- the probe's chain of 16 ``pallas_call``s, one
  launch per layer, ``h <- y[:, :K]``. Mode ``bf16``: the weight converted to
  bf16 (exact), bf16 x bf16 products on the tensor cores with fp32
  accumulation. Mode ``int8``: the activation quantised inside the kernel,
  ``xq = clip(round(32 x), +-127)`` (half to even), int8 x int8 products
  accumulated in int32, times ``(1/32) * scale``; the int32 sums are exact, so
  this mode equals its plain version bit for bit;
- :func:`int8_megakernel` <- ``mega``: all layers in ONE cooperative launch
  with a grid-wide barrier between layers; h stays fp32 and is rounded to
  bf16 for each product.

All are bound by the weight's bytes (K*N a layer against 2*B*K*N operations
with B <= 8); the source says what the design does about it. None is wired
into ``inference.decode``: the JAX decode has no int8 option either; their
entry point is ``python3 -m ssr_speech_tpu_torch.int8_probe``.

Beside each wrapper stands its plain PyTorch version (``reference_*``). On a
CPU tensor a wrapper takes the plain version (the CPU tests); on a CUDA tensor
it launches the kernel or raises. The probes' random weights multiply |h| by
about 25 a layer in the bf16 modes, so outputs are compared by max error over
max magnitude, never absolutely.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import check_layout, load

_KERNEL = "int8_matmul"
MAX_ROWS = 8  # activation rows a launch carries
TILE_N = 64  # output columns per block: N must be a multiple
K_MULTIPLE = 32  # K must be a multiple (the int8 mode's k-step)
ACT_SCALE = 32.0  # the int8 mode's activation quantisation step is 1/32
MODES = ("bf16", "int8")

# kernel launches since the last reset (plain integers; read by chip_smoke.py)
matvec_launches = 0  # int8_matvec (fp32 dequant)
chain_bf16_launches = 0  # int8_matvec_chain, mode "bf16", one per layer
chain_int8_launches = 0  # int8_matvec_chain, mode "int8", one per layer
mega_launches = 0  # int8_megakernel, one per call


def reset_launches() -> None:
    global matvec_launches, chain_bf16_launches, chain_int8_launches
    global mega_launches
    matvec_launches = chain_bf16_launches = chain_int8_launches = 0
    mega_launches = 0


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], scale fp32 [N]): per-output-channel
    symmetric, scale = max(amax / 127, 1e-12), round half to even, clip to
    +-127. The same int8 matrix and scale as the JAX ``quantize_weight``."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


# ------------------------------------------------------------ plain versions


def reference_int8_matvec(x, w_q, scale):
    """Dequantise to fp32, fp32 matmul, cast to bf16 (the JAX
    ``int8_matmul_reference``)."""
    w = w_q.float() * scale.float()[None, :]
    return torch.matmul(x.float(), w).to(torch.bfloat16)


def reference_int8_layer(x, w_q, scale, mode: str):
    """One layer of the chain in ``mode``: bf16 [B, K] -> bf16 [B, N]."""
    scale = scale.float().reshape(1, -1)
    if mode == "bf16":  # int8 -> bf16 is exact; products exact in fp32
        y = torch.matmul(x.to(torch.bfloat16).float(), w_q.float())
    elif mode == "int8":
        xq = torch.clamp(torch.round(x.float() * ACT_SCALE), -127, 127)
        # integers below 2^53: the fp64 product is the exact int32 sum
        acc = torch.matmul(xq.double(), w_q.double()).to(torch.int32)
        y = acc.float() * (1.0 / ACT_SCALE)
    else:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    return (y * scale).to(torch.bfloat16)


def _layer_weights(w_q, scale, layer: int):
    """Layer ``layer`` of stacked ([L, K, N], [L, 1, N] or [L, N]) weights, or
    the one shared matrix ([K, N], [N] or [1, N])."""
    if w_q.dim() == 3:
        return w_q[layer], scale[layer].reshape(-1)
    return w_q, scale.reshape(-1)


def reference_int8_chain(x, w_q, scale, mode: str, n_layers: int = 16):
    """``n_layers`` chained layers, ``h <- y[:, :K]`` (bf16 between layers)."""
    h, k = x, x.shape[1]
    for layer in range(n_layers):
        w, s = _layer_weights(w_q, scale, layer)
        h = reference_int8_layer(h, w, s, mode)[:, :k]
    return h.contiguous()


def reference_int8_mega(x, w_q, scale):
    """The megakernel's math: h fp32 between layers, rounded to bf16 for each
    product, acc = dot * scale in fp32, h <- acc[:, :K]; bf16 of the last."""
    h, k = x.float(), x.shape[1]
    for layer in range(w_q.shape[0]):
        y = torch.matmul(h.to(torch.bfloat16).float(), w_q[layer].float())
        h = (y * scale[layer].float().reshape(1, -1))[:, :k]
    return h.to(torch.bfloat16).contiguous()


# ------------------------------------------------------------------ kernels


def load_kernel():
    """Build (first call only) and bind the four entry points."""
    built = load(_KERNEL)
    lib = built.lib
    if lib.ssr_int8_matvec_f32.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ssr_int8_matvec_f32, lib.ssr_int8_matvec_bf16,
                   lib.ssr_int8_matvec_int8):
            fn.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32, ptr]
            fn.restype = i32
        lib.ssr_int8_mega_bf16.argtypes = ([ptr] * 5 + [i32] * 5
                                           + [ctypes.POINTER(i32), ptr])
        lib.ssr_int8_mega_bf16.restype = i32
    return built


def _check_layer_args(name: str, x, w_q, scale) -> None:
    """The TPU wrapper's refusals (shape mismatch, wrong dtype, N not a
    multiple of the tile) plus what the kernels' vector loads assume. x may
    be a column slice of a wider row-major tensor (the chain's feedback)."""
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name}: x [B, K], w_q [K, N], scale [N]; got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    (b, k), (kk, n) = x.shape, w_q.shape
    if k != kk or scale.shape[0] != n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
                         f"and scale {tuple(scale.shape)} do not fit")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: bfloat16 x, int8 w_q, float32 scale; got "
                        f"{x.dtype}, {w_q.dtype}, {scale.dtype}")
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"{name}: 1 to {MAX_ROWS} rows, got {b}")
    if n % TILE_N or k % K_MULTIPLE:
        raise ValueError(f"{name}: N a multiple of {TILE_N} and K of "
                         f"{K_MULTIPLE}, got K = {k}, N = {n}")
    if x.stride(1) != 1 or x.stride(0) % 8 or x.stride(0) < k:
        raise ValueError(f"{name} kernel needs x rows contiguous with a pitch "
                         f"that is a multiple of 8, got strides {x.stride()}")
    if x.device.type != "cuda" or x.data_ptr() % 16:
        raise ValueError(f"{name} kernel: x is on {x.device} or not 16-byte "
                         "aligned")
    check_layout(name, w_q=w_q, scale=scale)
    if not x.device == w_q.device == scale.device:
        raise ValueError(f"{name}: tensors on different devices")


def _launch_layer(entry: str, name: str, x, w_q, scale) -> torch.Tensor:
    _check_layer_args(name, x, w_q, scale)
    (b, k), n = x.shape, w_q.shape[1]
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(load_kernel().lib, entry)(
            x.data_ptr(), x.stride(0), w_q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), b, k, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _not_cpu_or_cuda(name: str, x) -> ValueError:
    return ValueError(f"{name}: unsupported device {x.device}")


def int8_matvec(x, w_q, scale) -> torch.Tensor:
    """x bf16 [B, K] (B <= 8), w_q int8 [K, N], scale fp32 [N] -> bf16 [B, N]:
    y[b, n] = (sum_k x[b, k] * float(w_q[k, n])) * scale[n]."""
    global matvec_launches
    if x.device.type == "cpu":
        return reference_int8_matvec(x, w_q, scale)
    if x.device.type != "cuda":
        raise _not_cpu_or_cuda("int8_matvec", x)
    out = _launch_layer("ssr_int8_matvec_f32", "int8_matvec", x, w_q, scale)
    matvec_launches += 1
    return out


def int8_matvec_layer(x, w_q, scale, mode: str) -> torch.Tensor:
    """One layer of the chain in ``mode`` ("bf16" or "int8"): one launch."""
    global chain_bf16_launches, chain_int8_launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if x.device.type == "cpu":
        return reference_int8_layer(x, w_q, scale, mode)
    if x.device.type != "cuda":
        raise _not_cpu_or_cuda("int8_matvec_layer", x)
    out = _launch_layer(f"ssr_int8_matvec_{mode}", f"int8_matvec_{mode}", x,
                        w_q, scale)
    if mode == "bf16":
        chain_bf16_launches += 1
    else:
        chain_int8_launches += 1
    return out


def int8_matvec_chain(x, w_q, scale, mode: str, n_layers: int = 16):
    """``n_layers`` chained layers, one launch each, ``h <- y[:, :K]``.
    w_q is one shared matrix [K, N] (scale [N] or [1, N]), as the TPU probe
    chains it, or one per layer [L, K, N] (scale [L, 1, N] or [L, N]).
    Returns bf16 [B, K]."""
    if w_q.dim() == 3 and w_q.shape[0] < n_layers:
        raise ValueError(f"int8_matvec_chain: {n_layers} layers but only "
                         f"{w_q.shape[0]} weight matrices")
    if w_q.shape[-1] < x.shape[1]:
        raise ValueError("int8_matvec_chain: N < K, nothing to feed back")
    h, k = x, x.shape[1]
    for layer in range(n_layers):
        w, s = _layer_weights(w_q, scale, layer)
        h = int8_matvec_layer(h, w, s, mode)[:, :k]
    return h.contiguous()


def int8_megakernel(x, w_q, scale, grid_blocks: Optional[int] = None):
    """x bf16 [B, K] (B <= 8), w_q int8 [L, K, N], scale fp32 [L, 1, N] ->
    bf16 [B, K]: L chained layers in one cooperative launch. ``grid_blocks``
    (tests) asks for a grid of that size instead of one block per tile; a
    grid the device cannot hold at once is refused with an error, never
    launched."""
    global mega_launches
    if x.device.type == "cpu":
        return reference_int8_mega(x, w_q, scale)
    if x.device.type != "cuda":
        raise _not_cpu_or_cuda("int8_megakernel", x)
    name = "int8_megakernel"
    if x.dim() != 2 or w_q.dim() != 3 or scale.dim() != 3:
        raise ValueError(f"{name}: x [B, K], w_q [L, K, N], scale [L, 1, N]; "
                         f"got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    (b, k), (n_layers, kk, n) = x.shape, w_q.shape
    if k != kk or tuple(scale.shape) != (n_layers, 1, n) or n < k:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
                         f"and scale {tuple(scale.shape)} do not fit (N >= K)")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: bfloat16 x, int8 w_q, float32 scale; got "
                        f"{x.dtype}, {w_q.dtype}, {scale.dtype}")
    if not 1 <= b <= MAX_ROWS or n % TILE_N or k % K_MULTIPLE:
        raise ValueError(f"{name}: 1 to {MAX_ROWS} rows, N a multiple of "
                         f"{TILE_N}, K of {K_MULTIPLE}; got B = {b}, K = {k}, "
                         f"N = {n}")
    check_layout(name, x=x, w_q=w_q, scale=scale)
    h = torch.empty((2, MAX_ROWS, k), dtype=torch.float32, device=x.device)
    out = torch.empty((b, k), dtype=torch.bfloat16, device=x.device)
    grid = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = load_kernel().lib.ssr_int8_mega_bf16(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), h.data_ptr(),
            out.data_ptr(), b, n_layers, k, n, int(grid_blocks or 0),
            ctypes.byref(grid), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} (grid of "
                           f"{grid.value} blocks; a cooperative grid must be "
                           f"resident at once)")
    mega_launches += 1
    return out
