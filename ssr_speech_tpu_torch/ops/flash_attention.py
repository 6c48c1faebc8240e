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

Both are bound by the tensor cores: the work is 4*B*H*S^2*Dh/2 flops forward
(2.5x that backward) over a few MB of Q/K/V, far above the H100's ~295 flop
per byte balance point. Every product is a ``wgmma`` of one warpgroup over 64
rows; K/V tiles (forward, dq) or Q/dO tiles (dk/dv) of 64 rows arrive by TMA
into a ring of shared-memory stages guarded by mbarriers, started by a producer
warp; and a (query tile, key tile) pair in which no pair can attend is never
loaded (:func:`tile_visits`). The shared plumbing is
``csrc/hopper_tma_wgmma.cuh``, the skip rule ``csrc/flash_attention_tiles.cuh``.

Plain versions, for the CPU tests and for holding the kernels to on the card:
:func:`reference_attend` is the dense one; :func:`tile_visits`,
:func:`tiled_forward` and :func:`tiled_backward` repeat the kernels' tile
walk (the skip rule, the online softmax, the log-sum-exp, D = rowsum(dO*O)
and the five backward products) in PyTorch.

On a CPU tensor the wrapper takes the plain version :func:`reference_attend`
(the CPU tests), whose backward is autograd's; on a CUDA tensor it launches
the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .cuda_build import check_layout, load

# kernel launches since the last reset (plain integers; read by chip_smoke.py)
launches = 0  # forward
bwd_launches = 0  # backward (one per dq + dk/dv pair)
launches_by_thread = {}  # forward launches by the launching thread's name

_KERNEL = "flash_attention_fwd"
_BWD_KERNEL = "flash_attention_bwd"
HEAD_DIM = 128
TILE = 64  # rows of the kernels' query and key tiles
MAX_SEQ = 1 << 20  # the kernels keep one flag byte a tile in shared memory


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0
    launches_by_thread.clear()


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


def _tile_ranges(seg, block: int):
    """Per tile of ``block`` rows, the [min, max] of the segment ids of its
    rows inside the sequence: two int64 [B, T]."""
    b, s = seg.shape
    t = -(-s // block)
    pad = t * block - s
    seg = seg.to(torch.int64)
    big = torch.iinfo(torch.int64).max
    lo = torch.nn.functional.pad(seg, (0, pad), value=big).view(b, t, block)
    hi = torch.nn.functional.pad(seg, (0, pad), value=-big).view(b, t, block)
    return lo.amin(-1), hi.amax(-1)


def tile_visits(seg, block_q: int = TILE, block_k: int = TILE):
    """The kernels' skip rule: bool [B, Tq, Tk], True where the (query tile,
    key tile) pair is walked. A pair is skipped above the diagonal, and
    below it when the two tiles' segment-id ranges [min, max] are disjoint
    (conservative for any integer ids); a pair that holds a diagonal element
    is always walked, so every row sees at least itself."""
    b, s = seg.shape
    qmn, qmx = _tile_ranges(seg, block_q)
    kmn, kmx = _tile_ranges(seg, block_k)
    dev = seg.device
    q_first = torch.arange(qmn.shape[1], device=dev) * block_q
    q_last = torch.clamp(q_first + block_q, max=s) - 1
    k_first = torch.arange(kmn.shape[1], device=dev) * block_k
    k_last = torch.clamp(k_first + block_k, max=s) - 1
    above = k_first[None, :] > q_last[:, None]  # [Tq, Tk]
    diagonal = ~above & (k_last[None, :] >= q_first[:, None])
    disjoint = ((kmx[:, None, :] < qmn[:, :, None])
                | (kmn[:, None, :] > qmx[:, :, None]))
    return diagonal[None] | (~above[None] & ~disjoint)


def _tile_mask(seg, q0, q1, k0, k1):
    """The per-element mask of one tile: bool [B, 1, q1 - q0, k1 - k0]."""
    qi = torch.arange(q0, q1, device=seg.device)
    kj = torch.arange(k0, k1, device=seg.device)
    ok = (kj[None, :] <= qi[:, None])[None] & (
        seg[:, q0:q1, None] == seg[:, None, k0:k1])
    return ok[:, None]


def tiled_forward(q, k, v, seg, sm_scale, block_q: int = TILE,
                  block_k: int = TILE):
    """Plain version of the forward kernel's walk: only the tiles of
    :func:`tile_visits`, an online softmax in fp32 in the log2 domain, the
    unnormalised probabilities cast to q's dtype for the PV product.
    Returns (out in q's dtype, natural-log LSE fp32 [B, H, S])."""
    b, h, s, dh = q.shape
    seg = seg.to(torch.int32)
    visits = tile_visits(seg, block_q, block_k)
    scale_log2 = sm_scale * math.log2(math.e)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    ninf = float("-inf")
    for qt in range(visits.shape[1]):
        q0, q1 = qt * block_q, min((qt + 1) * block_q, s)
        m_run = torch.full((b, h, q1 - q0), ninf, device=q.device)
        l_run = torch.zeros((b, h, q1 - q0), device=q.device)
        acc = torch.zeros((b, h, q1 - q0, dh), device=q.device)
        for kt in range(visits.shape[2]):
            vis = visits[:, qt, kt]
            if not bool(vis.any()):
                continue
            k0, k1 = kt * block_k, min((kt + 1) * block_k, s)
            x = torch.matmul(q[:, :, q0:q1].float(),
                             k[:, :, k0:k1].float().transpose(-1, -2))
            x = (x * scale_log2).masked_fill(
                ~_tile_mask(seg, q0, q1, k0, k1), ninf)
            new = torch.maximum(m_run, x.amax(-1))
            # a row with no visible key yet keeps max -inf: subtract 0 instead
            base = torch.where(new == ninf, torch.zeros_like(new), new)
            alpha = torch.exp2(m_run - base)
            p = torch.exp2(x - base[..., None])
            l_new = l_run * alpha + p.sum(-1)
            acc_new = acc * alpha[..., None] + torch.matmul(
                p.to(q.dtype), v[:, :, k0:k1]).float()
            walk = vis[:, None, None]  # rows of a batch row that skips stay
            m_run = torch.where(walk, new, m_run)
            l_run = torch.where(walk, l_new, l_run)
            acc = torch.where(walk[..., None], acc_new, acc)
        out[:, :, q0:q1] = (acc / l_run[..., None]).to(q.dtype)
        lse[:, :, q0:q1] = (m_run + torch.log2(l_run)) * math.log(2.0)
    return out, lse


def tiled_backward(q, k, v, seg, out, lse, dout, sm_scale,
                   block_q: int = TILE, block_k: int = TILE):
    """Plain version of the backward kernels' walk over the tiles of
    :func:`tile_visits`: D = rowsum(dO * O), P = exp(S * scale - L) under
    the mask, dS = P * (dO.V^T - D), and dQ += dS.K, dK += dS^T.Q,
    dV += P^T.dO accumulated in fp32 with P and dS cast to q's dtype as
    operands. Returns (dq, dk, dv) in q's dtype."""
    b, h, s, dh = q.shape
    seg = seg.to(torch.int32)
    visits = tile_visits(seg, block_q, block_k)
    dsum = (dout.float() * out.float()).sum(-1)  # [B, H, S]
    dq, dk, dv = (torch.zeros((b, h, s, dh), device=q.device)
                  for _ in range(3))
    for qt in range(visits.shape[1]):
        q0, q1 = qt * block_q, min((qt + 1) * block_q, s)
        for kt in range(visits.shape[2]):
            vis = visits[:, qt, kt]
            if not bool(vis.any()):
                continue
            k0, k1 = kt * block_k, min((kt + 1) * block_k, s)
            ok = _tile_mask(seg, q0, q1, k0, k1) & vis[:, None, None, None]
            qs, ks, vs, dos = (q[:, :, q0:q1], k[:, :, k0:k1], v[:, :, k0:k1],
                               dout[:, :, q0:q1])
            x = torch.matmul(qs.float(), ks.float().transpose(-1, -2))
            p = torch.exp(x * sm_scale - lse[:, :, q0:q1, None])
            p = torch.where(ok, p, torch.zeros_like(p))
            dp = torch.matmul(dos.float(), vs.float().transpose(-1, -2))
            ds = p * (dp - dsum[:, :, q0:q1, None])
            p_op, ds_op = p.to(q.dtype), ds.to(q.dtype)
            dq[:, :, q0:q1] += torch.matmul(ds_op, ks).float()
            dk[:, :, k0:k1] += torch.matmul(ds_op.transpose(-1, -2), qs).float()
            dv[:, :, k0:k1] += torch.matmul(p_op.transpose(-1, -2), dos).float()
    return ((dq * sm_scale).to(q.dtype), (dk * sm_scale).to(q.dtype),
            dv.to(q.dtype))


def load_kernel():
    """Build (first call only) and bind the forward kernel; returns the
    ``cuda_build.BuiltLibrary``."""
    built = load(_KERNEL)
    fn = built.lib.ssr_flash_attention_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built.lib.ssr_flash_attention_fwd_encode_ns.argtypes = []
        built.lib.ssr_flash_attention_fwd_encode_ns.restype = ctypes.c_longlong
    return built


def last_encode_us() -> float:
    """Host microseconds the last forward launch spent encoding its three
    TMA tensor maps (they hold the tensors' addresses, so every launch
    encodes them)."""
    return load_kernel().lib.ssr_flash_attention_fwd_encode_ns() / 1e3


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
    if s > MAX_SEQ:
        raise ValueError(f"flash kernel takes S <= {MAX_SEQ}, got {s}")
    if seg.shape != (b, s) or seg.device != q.device:
        raise ValueError(f"segment ids must be [{b}, {s}] on {q.device}")
    check_layout("flash", q=q, k=k, v=v, seg=seg)


def flash_forward(q, k, v, seg, sm_scale, *, with_lse: bool):
    """Launch the forward kernel on checked CUDA tensors; returns (out, lse),
    lse fp32 [B, H, S] or None."""
    global launches
    if not sm_scale > 0:  # the kernel takes the row max before scaling
        raise ValueError(f"flash kernel takes sm_scale > 0, got {sm_scale}")
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
    name = threading.current_thread().name
    launches_by_thread[name] = launches_by_thread.get(name, 0) + 1
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
