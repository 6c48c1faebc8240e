"""Fused CE head: second head matmul + log-softmax + target NLL + top-k rank,
forward and backward, without [N, C] logits in device memory (port of
``ssr_speech_tpu/ops/fused_ce.py``).

Kernels: ``csrc/fused_ce.cu``, hand-written for Hopper (sm_90a), three entry
points that replace the three Pallas TPU kernels. Each is one or two
[N, Hh] x [Hh, C] products (2*K*N*Hh*C operations each, 0.22 TFLOP at the
830M head with N = 13,230) over ~130 MB of inputs: bound by the tensor cores.

- ``ssr_fused_ce_fwd_bf16`` <- ``_fwd_kernel``: nll, logz and the top-k hit
  per row. A pre-pass computes each row's target logit in fp32 (a warp a
  row); then ONE pass over the vocabulary, ``wgmma`` on TMA-fed tiles
  (``csrc/hopper_tma_wgmma.cuh``): a block owns 128 rows as two consumer
  warpgroups beside a producer warp, walks vocab tiles of 128 columns, and
  keeps the online max/sum, the target pick-up and the rank count on the
  accumulator fragments in registers. The count leaves out the target's own
  column, so it equals the plain version's wherever no other logit lies
  within rounding of the target's.
- ``ssr_fused_ce_bwd_dw2_bf16`` <- ``_bwd_dw2_kernel``: a block owns
  (codebook, 32 vocab columns) and every row of dw2 in registers (two
  warpgroups of Hh/2 rows); row blocks of 64 stream through a TMA ring and
  serve two ``wgmma`` products each (the logits, then hidden^T . dlogits with
  the bf16-rounded dlogits); db2 is the column sum of the same dlogits. No
  atomics and a fixed order: bit-reproducible.
- ``ssr_fused_ce_bwd_dhidden_bf16`` <- ``_bwd_dhidden_kernel``: a 2-block
  cluster owns (codebook, 64 rows) and its four warpgroups split Hh (one
  block's two warpgroups up to Hh = 512); for each tile of 32 vocab columns
  each reduces its part of the logits with ``wgmma``, the fp32 partials are
  summed in one fixed order through (distributed) shared memory, the dlogits
  are formed and rounded to bf16 in registers and feed the second product,
  dhidden += dlogits . w2^T, as its A operand, against the same TMA-fed w2t
  tile. No atomics: bit-reproducible.

The three kernels read the weights as ``w2t`` [K, C, Hh], one
``transpose_w2`` a step (layout preparation, as ``_pad_inputs`` is in JAX):
its rows are 2*Hh bytes, a pitch the TMA unit takes at any C, and row t is
the contiguous read the pre-pass wants. The vocab tail is masked by bounds
inside the kernels: the JAX padding rule (rows to a multiple of 128, columns
with a -1e9 bias) has no counterpart, and columns past C never enter logz or
the rank.

:func:`tiled_ce_forward`, :func:`tiled_ce_dhidden` and :func:`tiled_ce_dw2`
are the kernels' arithmetic step for step in plain PyTorch (what the CPU tests can hold
against the JAX package). :class:`FusedCEHead` binds the kernels as a
``torch.autograd.Function``; ``hits`` gets no gradient. On a CPU tensor
:func:`fused_ce_head` takes the plain version :func:`reference_ce_head` and
autograd's backward of it; on a CUDA tensor it launches the kernels or raises.
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


def target_logits(hidden, w2t, b2, targets):
    """The forward's pre-pass in plain PyTorch: hidden[k, n] . w2t[k, t] +
    b2[k, t] in fp32 -> [K, N]; -inf where t is outside [0, C)."""
    c, hh = w2t.shape[1:]
    t = targets.long()
    valid = (t >= 0) & (t < c)
    t = t.clamp(0, c - 1)
    rows = torch.gather(w2t, 1, t[..., None].expand(-1, -1, hh))
    out = (hidden.float() * rows.float()).sum(-1) + torch.gather(b2.float(), 1, t)
    return torch.where(valid, out, out.new_tensor(float("-inf")))


def tiled_ce_forward(hidden, w2, b2, targets, top: int = TOP,
                     block_v: int = 128):
    """The forward kernel's arithmetic, step for step: the target logit
    first, then one pass over vocab tiles of ``block_v`` columns with the
    online max/sum, the target's logit picked up where its column passes, and
    the rank counted over every other column. -> (nll, logz, hits) fp32."""
    c = w2.shape[-1]
    h, t = hidden.float(), targets.long()
    tlog = target_logits(hidden, w2.transpose(1, 2), b2, targets)
    neg = h.new_full(t.shape, float("-inf"))
    m, tl = neg, neg
    l = torch.zeros_like(neg)
    cnt = torch.zeros_like(t)
    for v0 in range(0, c, block_v):
        v1 = min(v0 + block_v, c)
        x = torch.matmul(h, w2[:, :, v0:v1].float()) + b2[:, None, v0:v1].float()
        m_new = torch.maximum(m, x.max(dim=-1).values)
        l = l * torch.exp(m - m_new) + torch.exp(x - m_new[..., None]).sum(-1)
        m = m_new
        is_t = torch.arange(v0, v1, device=t.device) == t[..., None]
        tl = torch.maximum(tl, x.masked_fill(~is_t, float("-inf")).max(-1).values)
        cnt = cnt + ((x > tlog[..., None]) & ~is_t).sum(-1)
    logz = m + torch.log(l)
    return logz - tl, logz, (cnt < top).float()


def tiled_ce_dw2(hidden, w2, b2, targets, logz, g, block_n: int = 64,
                 block_v: int = 32):
    """The dw2/db2 kernel's arithmetic, step for step: for each tile of
    ``block_v`` vocab columns, row blocks of ``block_n`` in order; the block's
    logits, dlogits = (exp(logit - logz) - onehot) * g rounded to hidden's
    dtype, then dw2 += hidden^T . dlogits and db2 += its column sums, both in
    fp32. -> (dw2 [K, Hh, C], db2 [K, C]) fp32."""
    k, n, hh = hidden.shape
    c = w2.shape[-1]
    t = targets.long()
    dw2 = hidden.new_zeros((k, hh, c), dtype=torch.float32)
    db2 = hidden.new_zeros((k, c), dtype=torch.float32)
    for v0 in range(0, c, block_v):
        v1 = min(v0 + block_v, c)
        wt, bt = w2[:, :, v0:v1].float(), b2[:, None, v0:v1].float()
        cols = torch.arange(v0, v1, device=t.device)
        for r0 in range(0, n, block_n):
            rows = slice(r0, min(r0 + block_n, n))
            hb = hidden[:, rows].float()
            x = torch.matmul(hb, wt) + bt
            onehot = (cols == t[:, rows, None]).float()
            d = (torch.exp(x - logz[:, rows, None]) - onehot) * g[:, rows, None]
            d = d.to(hidden.dtype).float()
            dw2[:, :, v0:v1] += torch.matmul(hb.transpose(1, 2), d)
            db2[:, v0:v1] += d.sum(dim=1)
    return dw2, db2


def tiled_ce_dhidden(hidden, w2, b2, targets, logz, g, block_v: int = 32,
                     hh_parts: int = 4):
    """The dhidden kernel's arithmetic, step for step: for each tile of
    ``block_v`` vocab columns, the logits as the sum of the partial products
    over ``hh_parts`` column parts of Hh (parts of ceil(Hh / hh_parts), added
    in part order), then the bias; dlogits = (exp(logit - logz) - onehot) * g
    rounded to hidden's dtype; dhidden += dlogits . w2^T in fp32 over the
    tiles in order, cast to hidden's dtype at the end. -> [K, N, Hh]."""
    k, n, hh = hidden.shape
    c = w2.shape[-1]
    t = targets.long()
    h = hidden.float()
    width = -(-hh // hh_parts)
    parts = [slice(p0, min(p0 + width, hh)) for p0 in range(0, hh, width)]
    dh = torch.zeros((k, n, hh), dtype=torch.float32, device=hidden.device)
    for v0 in range(0, c, block_v):
        v1 = min(v0 + block_v, c)
        wt = w2[:, :, v0:v1].float()
        x = torch.matmul(h[..., parts[0]], wt[:, parts[0]])
        for part in parts[1:]:
            x = x + torch.matmul(h[..., part], wt[:, part])
        x = x + b2[:, None, v0:v1].float()
        onehot = (torch.arange(v0, v1, device=t.device) == t[..., None]).float()
        d = (torch.exp(x - logz[..., None]) - onehot) * g[..., None]
        dh += torch.matmul(d.to(hidden.dtype).float(), wt.transpose(1, 2))
    return dh.to(hidden.dtype)


def transpose_w2(w2):
    """w2 [K, Hh, C] -> w2t [K, C, Hh] contiguous, the layout the three
    kernels read."""
    return w2.transpose(1, 2).contiguous()


def load_kernel():
    """Build (first call only) and bind the three entry points."""
    built = load(_KERNEL)
    lib = built.lib
    if lib.ssr_fused_ce_fwd_bf16.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssr_fused_ce_fwd_bf16.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
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


def _checked_w2t(w2, w2t):
    if w2t is None:
        return transpose_w2(w2)
    k, hh, c = w2.shape
    if w2t.shape != (k, c, hh) or w2t.dtype != w2.dtype:
        raise ValueError(f"fused CE: w2t {tuple(w2t.shape)} {w2t.dtype} is not "
                         f"the transpose of w2 {tuple(w2.shape)} {w2.dtype}")
    check_layout("fused CE", w2t=w2t)
    return w2t


def ce_forward_with_target_logits(hidden, w2, b2, targets, top: int = TOP,
                                  w2t=None):
    """Forward kernels (the pre-pass, then the pass) on checked CUDA tensors
    -> (nll, logz, hits, tlogit) fp32 [K, N]; ``tlogit`` is the pre-pass's
    target logit. ``w2t`` is ``transpose_w2(w2)`` if the caller has it."""
    global fwd_launches
    k, n, hh = hidden.shape
    c = w2.shape[-1]
    w2t = _checked_w2t(w2, w2t)
    tlogit, nll, logz, hits = (torch.empty((k, n), dtype=torch.float32,
                                           device=hidden.device) for _ in range(4))
    with torch.cuda.device(hidden.device):
        _launch(load_kernel().lib.ssr_fused_ce_fwd_bf16, "forward",
                hidden.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), tlogit.data_ptr(), nll.data_ptr(),
                logz.data_ptr(), hits.data_ptr(), k, n, hh, c, top)
    fwd_launches += 1
    return nll, logz, hits, tlogit


def ce_forward(hidden, w2, b2, targets, top: int = TOP, w2t=None):
    """Forward kernel on checked CUDA tensors -> (nll, logz, hits) fp32."""
    return ce_forward_with_target_logits(hidden, w2, b2, targets, top, w2t)[:3]


def ce_backward_dhidden(hidden, w2, b2, targets, logz, g, w2t=None):
    """dhidden [K, N, Hh] in hidden's dtype; g is the nll cotangent. ``w2t``
    is ``transpose_w2(w2)`` if the caller has it."""
    global dhidden_launches
    k, n, hh = hidden.shape
    check_layout("fused CE", logz=logz, g=g)
    w2t = _checked_w2t(w2, w2t)
    dhid = torch.empty_like(hidden)
    with torch.cuda.device(hidden.device):
        _launch(load_kernel().lib.ssr_fused_ce_bwd_dhidden_bf16, "dhidden",
                hidden.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), logz.data_ptr(), g.data_ptr(),
                dhid.data_ptr(), k, n, hh, w2.shape[-1])
    dhidden_launches += 1
    return dhid


def ce_backward_dw2(hidden, w2, b2, targets, logz, g, w2t=None):
    """(dw2 [K, Hh, C], db2 [K, C]) in fp32. ``w2t`` is ``transpose_w2(w2)``
    if the caller has it."""
    global dw2_launches
    k, n, hh = hidden.shape
    c = w2.shape[-1]
    check_layout("fused CE", logz=logz, g=g)
    w2t = _checked_w2t(w2, w2t)
    dw2 = torch.empty((k, hh, c), dtype=torch.float32, device=hidden.device)
    db2 = torch.empty((k, c), dtype=torch.float32, device=hidden.device)
    with torch.cuda.device(hidden.device):
        _launch(load_kernel().lib.ssr_fused_ce_bwd_dw2_bf16, "dw2",
                hidden.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), logz.data_ptr(), g.data_ptr(),
                dw2.data_ptr(), db2.data_ptr(), k, n, hh, c)
    dw2_launches += 1
    return dw2, db2


class FusedCEHead(torch.autograd.Function):
    """Forward kernel; backward = the dhidden and dw2/db2 kernels. ``hits``
    is locally constant (zero cotangent); dw2/db2 come back in the weights'
    dtype, as the JAX VJP casts them. The transposed weights are made once
    and kept for the backward (K*C*Hh*2 bytes, 16.8 MB at the 830M head)."""

    @staticmethod
    def forward(ctx, hidden, w2, b2, targets, top):
        w2t = transpose_w2(w2)
        nll, logz, hits = ce_forward(hidden, w2, b2, targets, top, w2t)
        ctx.save_for_backward(hidden, w2, w2t, b2, targets, logz)
        ctx.mark_non_differentiable(hits)
        return nll, hits

    @staticmethod
    def backward(ctx, g_nll, _g_hits):
        hidden, w2, w2t, b2, targets, logz = ctx.saved_tensors
        g = g_nll.float().contiguous()
        dhid = ce_backward_dhidden(hidden, w2, b2, targets, logz, g, w2t)
        dw2, db2 = ce_backward_dw2(hidden, w2, b2, targets, logz, g, w2t)
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
