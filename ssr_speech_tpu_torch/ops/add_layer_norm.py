"""Bias + residual + LayerNorm of the e830M block's prefill and decode steps
(``models.transformer``): one call takes the residual stream ``h`` [..., D]
and, where the mode has them, a product ``y`` and its bias, and returns the
new residual and its norm, ``(h', LN(h'))``.

Kernel, hand-written for Hopper (sm_90a): ``csrc/add_layer_norm.cu`` (K13). It
replaces no TPU kernel (JAX leaves these adds and norms to XLA's fusions) and
takes the place of the plain chain's ≈14 PyTorch kernels a norm. The work is
latency-bound at decode's few rows; the design is in the source.

Modes (:data:`MODES`), each rounding every add to h's dtype in the plain order:

- ``norm``: h' = h (layer 0's first norm);
- ``bias_then_residual``: h' = h + (y + bias), the out projection's order
  (``y + bias`` as ``_linear`` adds it, bias cast to y's dtype);
- ``residual_then_bias``: h' = (h + y) + bias, the last residual of JAX's
  prefill and decode, followed by the next layer's first norm or the final
  norm.

The norm is ``transformer.layer_norm``'s arithmetic: fp32 statistics in two
passes, ``(x - mean) * rsqrt(var + eps) * w + b`` in fp32, rounded once.

Route (:func:`uses_kernel`), by what the input shows: every CUDA bf16 ``h``
takes the kernel; the CPU and fp32 take the plain version
:func:`plain_add_layer_norm`. The kernel's entry :func:`kernel_add_layer_norm`
raises ``ValueError`` on a CUDA bf16 call it does not take (norm weights
other than fp32, a width D that is not a multiple of 8 or is over
:data:`MAX_D`), so such a call is never quietly the plain chain. The kernel
keeps h' bit for bit; only the order of the norm's two sums differs, so hn
lies within one bf16 ulp (more only where the final ``* w + b`` cancels to a
value far below its terms).

``launches`` counts the kernel's launches, those a CUDA graph replays
included (``cuda_build.launched``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import check_layout, launched, load

_KERNEL = "add_layer_norm"

NORM, BIAS_THEN_RESIDUAL, RESIDUAL_THEN_BIAS = MODES = (
    "norm", "bias_then_residual", "residual_then_bias")
# the widest row the kernel takes: 256 threads x 2 chunks of 8 elements
# (``kMaxD`` in the source)
MAX_D = 4096
EPS = 1e-5

# kernel launches since the last reset (a plain integer; read by chip_smoke.py)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _count(n: int) -> None:
    """n launches (``cuda_build.launched``'s counter)."""
    global launches
    launches += n


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics and affine, the
    result in x's dtype (JAX ``transformer.layer_norm``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def uses_kernel(h: torch.Tensor) -> bool:
    """Whether a call on the residual stream ``h`` is the kernel: CUDA and
    bf16 (what the kernel cannot take there, its entry refuses)."""
    return h.device.type == "cuda" and h.dtype == torch.bfloat16


def _residual(h, y, bias, mode: str) -> torch.Tensor:
    if mode == NORM:
        return h
    if mode == BIAS_THEN_RESIDUAL:
        return h + (y + bias.to(y.dtype))
    if mode == RESIDUAL_THEN_BIAS:
        return h + y + bias
    raise ValueError(f"add_layer_norm mode {mode!r}, not one of {MODES}")


def plain_add_layer_norm(h, y, bias, w, b, mode: str, eps: float = EPS
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', :func:`layer_norm` (h')) in PyTorch ops, the arithmetic the
    prefill and decode steps had before the kernel."""
    h = _residual(h, y, bias, mode)
    return h, layer_norm(h, w, b, eps)


def load_kernel():
    """Build (first call only) and bind the kernel; returns the
    ``cuda_build.BuiltLibrary``."""
    built = load(_KERNEL)
    fn = built.lib.ssr_add_layer_norm_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return built


def _check_kernel_args(h, y, bias, w, b, mode):
    if mode not in MODES:
        raise ValueError(f"add_layer_norm mode {mode!r}, not one of {MODES}")
    d = h.shape[-1]
    if not uses_kernel(h):
        raise ValueError(f"add_layer_norm kernel takes bf16 h on CUDA; got "
                         f"{h.dtype} on {h.device}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"add_layer_norm kernel takes fp32 norm weights "
                         f"(the affine is fp32); got w {w.dtype}, b {b.dtype}")
    if d % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"add_layer_norm kernel takes D a multiple of 8 up "
                         f"to {MAX_D}; got h {tuple(h.shape)}")
    vecs = dict(w=w, b=b)
    if mode != NORM:
        if y is None or y.dtype != h.dtype or y.shape != h.shape:
            raise ValueError(f"add_layer_norm kernel: y must be bf16 "
                             f"{tuple(h.shape)}, got "
                             f"{None if y is None else (y.dtype, tuple(y.shape))}")
        if bias is None or bias.dtype != h.dtype:
            raise ValueError(f"add_layer_norm kernel: bias must be bf16, got "
                             f"{None if bias is None else bias.dtype}")
        vecs["bias"] = bias
    for name, t in vecs.items():
        if t.shape != (d,):
            raise ValueError(f"add_layer_norm kernel: {name} must be [{d}], "
                             f"got {tuple(t.shape)}")
    tensors = dict(h=h, **vecs)
    if mode != NORM:
        tensors["y"] = y
    check_layout("add_layer_norm", **tensors)


def kernel_add_layer_norm(h, y, bias, w, b, mode: str, eps: float = EPS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on checked CUDA tensors, as :func:`plain_add_layer_norm`.
    Inside ``cuda_build.recording`` (a graph capture) the launch counts
    there."""
    _check_kernel_args(h, y, bias, w, b, mode)
    lib = load_kernel().lib
    d = h.shape[-1]
    rows = h.numel() // d
    hn = torch.empty_like(h)
    h_out = h if mode == NORM else torch.empty_like(h)
    if rows == 0:
        return h_out, hn

    def ptr(t):  # the operands mode ``norm`` does not touch are NULL
        return None if mode == NORM else t.data_ptr()

    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = lib.ssr_add_layer_norm_bf16(
            h.data_ptr(), ptr(y), ptr(bias), w.data_ptr(), b.data_ptr(),
            ptr(h_out), hn.data_ptr(), rows, d, MODES.index(mode), eps,
            stream)
    if err != 0:
        raise RuntimeError(f"add_layer_norm kernel launch failed: CUDA error "
                           f"{err} at h {tuple(h.shape)}, mode {mode}")
    launched(_count)
    return h_out, hn


def add_layer_norm(h: torch.Tensor, y: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], w: torch.Tensor,
                   b: torch.Tensor, mode: str, eps: float = EPS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h', LN(h')) of ``mode`` by :func:`uses_kernel`'s route; ``y`` and
    ``bias`` are not read in mode ``norm``."""
    run = kernel_add_layer_norm if uses_kernel(h) else plain_add_layer_norm
    return run(h, y, bias, w, b, mode, eps)
