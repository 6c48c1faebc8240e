"""Fused causal + segment-id attention forward (port of
``ssr_speech_tpu/ops/flash_attention.py::flash_attend_xy``).

Semantics, as in JAX: query i attends key j iff ``j <= i`` and
``seg[b, i] == seg[b, j]``; valid positions carry segment 1 and padded or
banned ones segment 0. Valid query rows therefore see exactly the un-padded
causal prefix; rows of segment 0 attend keys of their own segment, which is
finite garbage that no caller reads.

Kernel: ``csrc/flash_attention_fwd.cu``, hand-written for Hopper (sm_90a). It
replaces both TPU kernels behind the JAX wrapper, ``_kernel_attend`` (the Pallas
library flash_attention forward) and ``_splash_attend`` (the splash forward);
the flash/splash split is not carried over. At the prefill shapes of the
serving path (B = 2 CFG rows, H = 16, Dh = 128, S ~ 300-1300) the work is
4*B*H*S^2*Dh/2 flops over a few MB of Q/K/V, far above the H100's ~295 flop per
byte balance point: the kernel is bound by the tensor-core rate of the QK^T and
PV products. The simple design leaves on the table what makes flash attention
fast on Hopper: wgmma instead of mma.sync, TMA loads double-buffered against
the products instead of synchronous 16-byte loads, skipping fully masked key
tiles per warp, and a persistent schedule over (tile, head) pairs.

On a CPU tensor the wrapper takes the plain version :func:`reference_attend`
(the CPU tests); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

# kernel launches since the last reset (plain integer; read by chip_smoke.py)
launches = 0

_KERNEL = "flash_attention_fwd"
HEAD_DIM = 128


def reset_launches() -> None:
    global launches
    launches = 0


def reference_attend(q, k, v, key_valid, sm_scale):
    """Plain version: causal AND same-segment, scores and softmax in fp32,
    probabilities cast to q's dtype before the PV product (as JAX)."""
    s = q.shape[2]
    seg = key_valid.to(torch.int32)  # [B, S]
    same = seg[:, None, :] == seg[:, :, None]  # [B, Sq, Sk]
    idx = torch.arange(s, device=q.device)
    causal = idx[None, :] <= idx[:, None]
    ok = same & causal[None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(ok, zero, -1e9)[:, None, :, :]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * sm_scale + bias, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def load_kernel():
    """Build (first call only) and bind the CUDA kernel; returns the
    ``cuda_build.BuiltLibrary``."""
    from .cuda_build import load

    built = load(_KERNEL)
    fn = built.lib.ssr_flash_attention_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def _check_cuda_args(q, k, v, seg):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes bfloat16 q/k/v, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash kernel takes [B, H, S, {HEAD_DIM}], got "
                         f"{tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    b, _, s, _ = q.shape
    if seg.shape != (b, s) or seg.device != q.device:
        raise ValueError(f"segment ids must be [{b}, {s}] on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("seg", seg)):
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash kernel has no backward yet: call it on "
                           "tensors that do not require grad")


def flash_attend_xy(q, k, v, key_valid, *, sm_scale=None):
    """Fused causal + padding attention over the [text ; audio] sequence.

    q/k/v: [B, H, S, Dh] (q NOT pre-scaled); key_valid: [B, S] bool (True at
    real positions) or int segment ids. Returns [B, H, S, Dh] in q's dtype;
    valid rows match ``_attend`` with ``xy_attn_bias`` to online-softmax
    reassociation tolerance."""
    global launches
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return reference_attend(q, k, v, key_valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attend_xy: unsupported device {q.device}")
    seg = key_valid.to(torch.int32).contiguous()
    _check_cuda_args(q, k, v, seg)
    fn = load_kernel().lib.ssr_flash_attention_fwd_bf16
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                 out.data_ptr(), b, h, s, dh, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)}")
    launches += 1
    return out
