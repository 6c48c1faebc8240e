"""Fused causal + segment-id attention, forward and backward (port of
``ssr_speech_tpu/ops/flash_attention.py::flash_attend_xy``).

Semantics, as in JAX: query i attends key j iff ``j <= i`` and
``seg[b, i] == seg[b, j]``; valid positions carry segment 1 and padded or
banned ones segment 0. Valid query rows therefore see exactly the un-padded
causal prefix; rows of segment 0 attend keys of their own segment causally,
which is finite and defined (the kernels agree with the plain version on every
row) but no caller reads it.

Kernels, hand-written for Hopper (sm_90a):
- ``csrc/flash_attention_fwd.cu`` replaces both TPU forward kernels behind the
  JAX wrapper, ``_kernel_attend`` (the Pallas library flash_attention forward)
  and ``_splash_attend`` (the splash forward); the flash/splash split is not
  carried over. When a gradient is needed it also writes each row's
  log-sum-exp.
- ``csrc/flash_attention_bwd.cu`` replaces their backward (the library custom
  VJP and splash's fused dq/dkv kernel): a dq kernel and a dk/dv kernel, no
  atomics, bit-reproducible. :class:`FlashAttention` binds the pair as a
  ``torch.autograd.Function``.

At the prefill shapes of the serving path (B = 2 CFG rows, H = 16, Dh = 128, S ~ 300-1300) the work is
4*B*H*S^2*Dh/2 flops over a few MB of Q/K/V, far above the H100's ~295 flop per
byte balance point: the kernel is bound by the tensor-core rate of the QK^T and
PV products. The simple design leaves on the table what makes flash attention
fast on Hopper: wgmma instead of mma.sync, TMA loads double-buffered against
the products instead of synchronous 16-byte loads, skipping fully masked key
tiles per warp, and a persistent schedule over (tile, head) pairs. The
backward does about 2.5x the forward's tensor-core work and is bound the same
way.

On a CPU tensor the wrapper takes the plain version :func:`reference_attend`
(the CPU tests), whose backward is autograd's; on a CUDA tensor it launches
the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import check_layout, load

# kernel launches since the last reset (plain integers; read by chip_smoke.py)
launches = 0  # forward
bwd_launches = 0  # backward (one per dq + dk/dv pair)

_KERNEL = "flash_attention_fwd"
_BWD_KERNEL = "flash_attention_bwd"
HEAD_DIM = 128


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


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
    """Build (first call only) and bind the forward kernel; returns the
    ``cuda_build.BuiltLibrary``."""
    built = load(_KERNEL)
    fn = built.lib.ssr_flash_attention_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def load_bwd_kernel():
    """Build (first call only) and bind the backward kernels."""
    built = load(_BWD_KERNEL)
    fn = built.lib.ssr_flash_attention_bwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
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
    check_layout("flash", q=q, k=k, v=v, seg=seg)


def flash_forward(q, k, v, seg, sm_scale, *, with_lse: bool):
    """Launch the forward kernel on checked CUDA tensors; returns (out, lse),
    lse fp32 [B, H, S] or None."""
    global launches
    fn = load_kernel().lib.ssr_flash_attention_fwd_bf16
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                 out.data_ptr(), 0 if lse is None else lse.data_ptr(), b, h, s,
                 dh, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)}")
    launches += 1
    return out, lse


def flash_backward(q, k, v, seg, out, lse, dout, sm_scale):
    """Launch the backward kernels; returns (dq, dk, dv) in q's dtype."""
    global bwd_launches
    if dout.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError(f"flash backward takes dO like q, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    check_layout("flash backward", dout=dout, out=out, lse=lse)
    fn = load_bwd_kernel().lib.ssr_flash_attention_bwd_bf16
    b, h, s, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                 out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, h, s, dh, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err} at q {tuple(q.shape)}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel, whose backward is the backward kernels. Saves q, k,
    v, the output and the per-row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, seg, sm_scale):
        out, lse = flash_forward(q, k, v, seg, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, seg, out, lse,
                                    dout.contiguous(), ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attend_xy(q, k, v, key_valid, *, sm_scale=None):
    """Fused causal + padding attention over the [text ; audio] sequence.

    q/k/v: [B, H, S, Dh] (q NOT pre-scaled); key_valid: [B, S] bool (True at
    real positions) or int segment ids. Returns [B, H, S, Dh] in q's dtype;
    valid rows match ``_attend`` with ``xy_attn_bias`` to online-softmax
    reassociation tolerance. Differentiable: with grad enabled and any input
    requiring it, the CUDA path goes through :class:`FlashAttention`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return reference_attend(q, k, v, key_valid, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attend_xy: unsupported device {q.device}")
    seg = key_valid.to(torch.int32).contiguous()
    _check_cuda_args(q, k, v, seg)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, seg, float(sm_scale))
    return flash_forward(q, k, v, seg, sm_scale, with_lse=False)[0]
