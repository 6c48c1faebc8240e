"""Hand-written CUDA kernels of the port against their plain PyTorch versions,
on the card: the flash-attention forward and backward, the fused CE head's
forward, dhidden and dw2/db2, and the int8 weight-streaming matvecs (K7
``int8_matvec`` and the chain K8 in both modes, with programmatic dependent
launch, without it and as a CUDA graph; the megakernel). Skipped where
torch.cuda.is_available() is false.

Run on a GPU machine (which needs neither JAX nor tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.ops import flash_attention as fa
from ssr_speech_tpu_torch.ops import fused_ce as fce
from ssr_speech_tpu_torch.ops import int8_matmul as i8

pytestmark = pytest.mark.cuda

ATOL = 2e-2  # bf16 inputs and output, unit-normal data, Dh = 128
# gradients, bf16 in and out: max |kernel - plain| / max |plain|. The plain
# backward rounds dP and dV to bf16 where the kernels accumulate in fp32, and
# the kernels round P and dS to bf16 as mma operands: each ~2^-9 relative.
REL = 2e-2


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from ssr_speech_tpu_torch.device import resolve_device, set_precision_policy

    set_precision_policy()
    return resolve_device("cuda")


def _qkv(shape, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for _ in range(3)]


SKIP_PATTERNS = ["text_pad", "audio_pad", "banned", "many_ids", "alone"]


def _segments(pattern, b, s, seed):
    """Segment ids [b, s] (int32 numpy). Besides the two original layouts,
    layouts that make the kernels skip tiles: a block of text padding, a block
    of audio padding, the unconditional CFG row's banned [1, sx), runs of ids
    beyond {0, 1} (negative and large too), and rows alone in their segment."""
    rng = np.random.default_rng(seed)
    sx = max(s // 3, 1)
    if pattern == "prefill":
        seg = np.ones((b, s), np.int32)
        seg[:, max(sx - 7, 1):sx] = 0
        seg[1:, 1:sx] = 0
    elif pattern == "train":
        seg = _train_segments(b, s, seed)
    elif pattern == "random":
        seg = rng.integers(0, 3, size=(b, s)).astype(np.int32)
    elif pattern == "text_pad":
        seg = np.ones((b, s), np.int32)
        for r in range(b):
            seg[r, rng.integers(1, sx + 1):sx] = 0
    elif pattern == "audio_pad":
        seg = np.ones((b, s), np.int32)
        for r in range(b):
            seg[r, sx + rng.integers(0, s - sx + 1):] = 0
    elif pattern == "banned":
        seg = np.ones((b, s), np.int32)
        seg[:, 1:sx] = 0
    elif pattern == "many_ids":
        ids = np.array([-7, 0, 1, 2, 5, 1 << 20, -(1 << 30)], np.int32)
        runs = rng.integers(1, max(s // 4, 2), size=(b, s))
        seg = np.stack([np.repeat(rng.choice(ids, size=s), runs[r])[:s]
                        for r in range(b)]).astype(np.int32)
    elif pattern == "alone":
        seg = np.ones((b, s), np.int32)
        seg[:, 0] = 9  # alone, and in the first tile
        seg[:, s // 2] = 7  # alone, its tile's other rows see other tiles
        seg[:, s - 1] = 3  # alone, the last row
    else:
        raise ValueError(pattern)
    return seg


@pytest.mark.parametrize("b,h,s", [(1, 1, 1), (1, 2, 63), (2, 2, 64),
                                   (2, 3, 65), (1, 2, 130), (2, 16, 333),
                                   (2, 16, 1000), (2, 2, 127), (2, 2, 128),
                                   (2, 2, 129), (2, 2, 191), (2, 4, 1152)])
@pytest.mark.parametrize("pattern", ["prefill", "random"] + SKIP_PATTERNS)
def test_flash_kernel_matches_plain(device, b, h, s, pattern):
    """Every row (not only valid ones) follows the segment semantics, so the
    kernel must agree with reference_attend on all of them."""
    q, k, v = _qkv((b, h, s, fa.HEAD_DIM), s + b, device)
    seg = torch.from_numpy(_segments(pattern, b, s, s)).to(device)
    fa.reset_launches()
    got = fa.flash_attend_xy(q, k, v, seg)
    want = fa.reference_attend(q, k, v, seg, 1.0 / math.sqrt(fa.HEAD_DIM))
    torch.cuda.synchronize()
    assert fa.launches == 1
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATOL, err


def test_flash_kernel_refuses_what_it_cannot_take(device):
    q, k, v = _qkv((1, 2, 64, fa.HEAD_DIM), 0, device)
    seg = torch.ones((1, 64), dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        fa.flash_attend_xy(q.float(), k.float(), v.float(), seg)
    with pytest.raises(ValueError):
        fa.flash_attend_xy(q[..., :64], k[..., :64], v[..., :64], seg)
    with pytest.raises(ValueError):
        fa.flash_attend_xy(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), seg)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=device)
    shifted = flat[1:].view(q.shape)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError):
        fa.flash_attend_xy(shifted, k, v, seg)
    dout = torch.ones_like(q)
    out, lse = fa.flash_forward(q, k, v, seg, 0.1, with_lse=True)
    with pytest.raises(ValueError):
        fa.flash_backward(q, k, v, seg, out, lse, dout.transpose(2, 3), 0.1)
    with pytest.raises(ValueError):
        fa.flash_backward(q, k, v, seg, out, lse, dout.float(), 0.1)
    with pytest.raises(ValueError):  # the row max is taken before scaling
        fa.flash_attend_xy(q, k, v, seg, sm_scale=-0.1)
    # longer than the kernels' tile-flag table: refused by the wrapper, and by
    # the C entry points themselves (uninitialised memory is never read)
    s = fa.MAX_SEQ + 64
    long = torch.empty((1, 1, s, fa.HEAD_DIM), dtype=torch.bfloat16, device=device)
    long_seg = torch.ones((1, s), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        fa.flash_attend_xy(long, long, long, long_seg)
    with pytest.raises(RuntimeError):
        fa.flash_forward(long, long, long, long_seg, 0.1, with_lse=False)
    long_lse = torch.empty((1, 1, s), dtype=torch.float32, device=device)
    with pytest.raises(RuntimeError):
        fa.flash_backward(long, long, long, long_seg, long, long_lse, long, 0.1)
    torch.cuda.synchronize()
    assert torch.isfinite(fa.flash_attend_xy(q, k, v, seg)).all()  # device fine


def test_tile_visits_on_the_card_covers_the_dense_mask(device):
    """tile_visits on CUDA tensors: every (query, key) pair the dense mask
    lets through lies in a visited tile, and the diagonal is visited."""
    for pattern in ["train", "random"] + SKIP_PATTERNS:
        for s in (65, 191, 1152):
            seg = torch.from_numpy(_segments(pattern, 3, s, s)).to(device)
            vis = fa.tile_visits(seg)
            t = vis.shape[1]
            ok = (seg[:, None, :] == seg[:, :, None]) & torch.ones(
                (s, s), dtype=torch.bool, device=device).tril()
            pad = t * fa.TILE - s
            ok = torch.nn.functional.pad(ok, (0, pad, 0, pad))
            need = ok.view(3, t, fa.TILE, t, fa.TILE).any(4).any(2)
            assert not (need & ~vis).any(), (pattern, s)
            assert vis.diagonal(dim1=1, dim2=2).all(), (pattern, s)


def _train_segments(b, s, seed):
    """A padded training batch's segment ids: [text ; audio], text padding
    on every row, audio padding on some."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    sx = max(s // 4, 1)
    for r in range(b):
        seg[r, :rng.integers(1, sx + 1)] = 1
        seg[r, sx:sx + rng.integers(0, s - sx + 1)] = 1
    return seg


def _rel(got, want):
    """max |got - want| / max |want| (0 where both are exactly 0)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err / scale if scale > 0 else err


def _attention_grads(q, k, v, seg, dout, kernel: bool):
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    if kernel:
        out = fa.flash_attend_xy(qg, kg, vg, seg)
    else:
        out = fa.reference_attend(qg, kg, vg, seg, 1.0 / math.sqrt(q.shape[-1]))
    out.backward(dout)
    return out.detach(), qg.grad, kg.grad, vg.grad


@pytest.mark.parametrize("b,h,s", [(1, 1, 1), (1, 2, 63), (2, 2, 64),
                                   (2, 3, 65), (1, 2, 130), (2, 4, 1000),
                                   (2, 2, 127), (2, 2, 128), (2, 2, 129),
                                   (2, 2, 191), (2, 4, 1152)])
@pytest.mark.parametrize("pattern", ["train", "random"] + SKIP_PATTERNS)
def test_flash_backward_matches_plain(device, b, h, s, pattern):
    """dq/dk/dv on every row (segment-0 rows are defined too), the
    log-sum-exp, and two backward runs bit for bit."""
    q, k, v = _qkv((b, h, s, fa.HEAD_DIM), s + 7 * b, device)
    dout = _qkv((b, h, s, fa.HEAD_DIM), s + 1, device)[0]
    seg = torch.from_numpy(_segments(pattern, b, s, s)).to(device)
    fa.reset_launches()
    got = _attention_grads(q, k, v, seg, dout, kernel=True)
    again = _attention_grads(q, k, v, seg, dout, kernel=True)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (2, 2)
    want = _attention_grads(q, k, v, seg, dout, kernel=False)
    assert _rel(got[0], want[0]) <= REL
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got[1:], want[1:], again[1:]):
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= REL, (name, _rel(g, w))
        assert torch.equal(g, g2), name
    _, lse = fa.flash_forward(q, k, v, seg.to(torch.int32), 1.0 / math.sqrt(fa.HEAD_DIM),
                              with_lse=True)
    same = seg[:, None, :] == seg[:, :, None]
    causal = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(fa.HEAD_DIM)
    scores = scores.masked_fill(~(same & causal)[:, None], -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), atol=1e-3, rtol=1e-4)


def _ce_inputs(k, n, hh, c, seed, device):
    rng = np.random.default_rng(seed)
    hidden = torch.from_numpy(rng.standard_normal((k, n, hh)).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((k, hh, c)) / math.sqrt(hh)
                           ).astype(np.float32))
    b2 = torch.from_numpy(rng.standard_normal((k, c)).astype(np.float32) * 0.1)
    tgt = torch.from_numpy(rng.integers(0, c, size=(k, n)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    bf = dict(device=device, dtype=torch.bfloat16)
    return (hidden.to(**bf), w2.to(**bf), b2.to(**bf), tgt.to(device),
            g.to(device))


def _ce_grads(hidden, w2, b2, tgt, g, kernel: bool):
    leaves = [t.clone().requires_grad_() for t in (hidden, w2, b2)]
    fn = fce.fused_ce_head if kernel else fce.reference_ce_head
    nll, hits = fn(*leaves, tgt)
    (nll * g).sum().backward()
    return nll.detach(), hits, *(t.grad for t in leaves)


def near_ties(hidden, w2, b2, tgt, rows, top=fce.TOP, tol=1e-3):
    """Whether the target logit of each [k, n] in ``rows`` lies within
    ``tol`` of the top-th largest logit (a hit decided by fp32 summation
    order)."""
    logits = torch.matmul(hidden.float(), w2.float()) + b2.float()[:, None]
    if logits.shape[-1] < top:  # every target is a hit: no tie to break
        return torch.zeros_like(rows)[rows]
    t = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
    kth = logits.topk(top, dim=-1).values[..., -1]
    return ((t - kth).abs() <= tol)[rows]


# N at the edges of the kernels' row blocks (64 and 128), C at the edges of
# their vocab tiles (32 and 128; 8 is the forward's narrow last tile; 127 is a
# row pitch of w2 that is no multiple of 16 bytes), every instance Hh / 128 of
# the dw2/db2 kernel
CE_SHAPES = [(1, 1, 128, 1), (2, 63, 128, 130), (4, 333, 256, 2056),
             (4, 1000, 1024, 2056), (2, 64, 128, 8), (2, 65, 512, 127),
             (3, 129, 1024, 128), (2, 63, 512, 136), (2, 129, 128, 2056),
             (1, 64, 384, 136), (1, 65, 640, 33), (1, 129, 768, 127),
             (1, 63, 896, 8)]


def _edge_targets(hidden, w2, b2, tgt):
    """Row 0 aims at the last column (in the masked tail's neighbourhood), the
    last row at the column that holds its maximum."""
    tgt = tgt.clone()
    c = w2.shape[-1]
    tgt[:, 0] = c - 1
    last = torch.matmul(hidden[:, -1].float()[:, None], w2.float())[:, 0] + b2.float()
    tgt[:, -1] = last.argmax(-1).to(tgt.dtype)
    return tgt


@pytest.mark.parametrize("k,n,hh,c", CE_SHAPES)
def test_fused_ce_matches_plain(device, k, n, hh, c):
    """nll, hits, dhidden, dw2 and db2 against the plain version and its
    autograd; the vocab tail (C not a multiple of 32) never enters logz."""
    hidden, w2, b2, tgt, g = _ce_inputs(k, n, hh, c, n + c, device)
    tgt = _edge_targets(hidden, w2, b2, tgt)
    args = (hidden, w2, b2, tgt, g)
    fce.reset_launches()
    got = _ce_grads(*args, kernel=True)
    again = _ce_grads(*args, kernel=True)
    torch.cuda.synchronize()
    assert (fce.fwd_launches, fce.dhidden_launches, fce.dw2_launches) == (2, 2, 2)
    want = _ce_grads(*args, kernel=False)
    # nll: fp32 logits from exact bf16 products, summed in another order
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=1e-4)
    assert torch.equal(got[0], again[0])
    bad = got[1] != want[1]
    assert near_ties(args[0], args[1], args[2], args[3], bad).all()
    assert (got[1][:, -1] == 1.0).all()  # the target holds the maximum: rank 0
    for name, gk, gp, g2 in zip(("dhidden", "dw2", "db2"), got[2:], want[2:],
                                again[2:]):
        assert gk.dtype == gp.dtype == torch.bfloat16, name
        assert _rel(gk, gp) <= REL, (name, _rel(gk, gp))
        assert torch.equal(gk, g2), name


@pytest.mark.parametrize("k,n,hh,c", [(2, 65, 128, 127), (4, 1000, 1024, 2056)])
def test_fused_ce_forward_parts(device, k, n, hh, c):
    """The forward's pre-pass (the target logit, within 1e-4 of the plain
    one), logz, and the whole forward twice bit for bit; dw2 and db2 in fp32
    as the kernel leaves them, with and without the caller's transposed w2."""
    hidden, w2, b2, tgt, g = _ce_inputs(k, n, hh, c, 3 * n + c, device)
    tgt = _edge_targets(hidden, w2, b2, tgt)
    w2t = fce.transpose_w2(w2)
    first = fce.ce_forward_with_target_logits(hidden, w2, b2, tgt)
    second = fce.ce_forward_with_target_logits(hidden, w2, b2, tgt, w2t=w2t)
    nll, logz, hits, tlogit = first
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    logits = torch.matmul(hidden.float(), w2.float()) + b2.float()[:, None]
    want_t = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
    torch.testing.assert_close(tlogit, want_t, atol=1e-4, rtol=0)
    torch.testing.assert_close(tlogit, fce.target_logits(hidden, w2t, b2, tgt),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(logz, torch.logsumexp(logits, -1), atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(nll, logz - tlogit, atol=1e-4, rtol=0)
    dw2, db2 = fce.ce_backward_dw2(hidden, w2, b2, tgt, logz, g)
    dw2_t, db2_t = fce.ce_backward_dw2(hidden, w2, b2, tgt, logz, g, w2t=w2t)
    assert dw2.dtype == db2.dtype == torch.float32
    assert torch.equal(dw2, dw2_t) and torch.equal(db2, db2_t)
    p_dw2, p_db2 = fce.tiled_ce_dw2(hidden, w2, b2, tgt, logz, g)
    assert _rel(dw2, p_dw2) <= 1e-3 and _rel(db2, p_db2) <= 1e-3
    with pytest.raises(ValueError):
        fce.ce_backward_dw2(hidden, w2, b2, tgt, logz, g, w2t=w2)


@pytest.mark.parametrize("k,n,hh,c", [(4, 13230, 1024, 2056), (4, 8000, 1024, 2056),
                                      (2, 203, 256, 131), (4, 65, 1024, 2051)])
def test_fused_ce_dhidden_kernel(device, k, n, hh, c):
    """The dhidden kernel (Hh split over a 2-block cluster at Hh = 1024, one
    block at 256) at the training batch's shape and at ragged ones: against
    the plain autograd (REL) and against its own arithmetic in plain PyTorch
    (``tiled_ce_dhidden``: the same partial sums and bf16 dlogits, so only
    the fp32 summation order differs), twice bit for bit, with and without
    the caller's transposed w2."""
    hidden, w2, b2, tgt, g = _ce_inputs(k, n, hh, c, 5 * n + c, device)
    tgt = _edge_targets(hidden, w2, b2, tgt)
    w2t = fce.transpose_w2(w2)
    _, logz, _ = fce.ce_forward(hidden, w2, b2, tgt, w2t=w2t)
    fce.reset_launches()
    got = fce.ce_backward_dhidden(hidden, w2, b2, tgt, logz, g)
    again = fce.ce_backward_dhidden(hidden, w2, b2, tgt, logz, g, w2t=w2t)
    torch.cuda.synchronize()
    assert fce.dhidden_launches == 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    leaves = [t.clone().requires_grad_() for t in (hidden, w2, b2)]
    nll, _ = fce.reference_ce_head(*leaves, tgt)
    (want,) = torch.autograd.grad(nll, leaves[:1], g)
    assert _rel(got, want) <= REL
    tiled = fce.tiled_ce_dhidden(hidden, w2, b2, tgt, logz, g)
    assert _rel(got, tiled) <= 1e-2
    with pytest.raises(ValueError):
        fce.ce_backward_dhidden(hidden, w2, b2, tgt, logz, g, w2t=w2)


def test_fused_ce_refuses_what_it_cannot_take(device):
    hidden, w2, b2, tgt, _ = _ce_inputs(2, 64, 128, 256, 0, device)
    with pytest.raises(TypeError):
        fce.fused_ce_head(hidden.float(), w2.float(), b2.float(), tgt)
    with pytest.raises(TypeError):
        fce.fused_ce_head(hidden, w2, b2, tgt.long())
    with pytest.raises(ValueError):
        fce.fused_ce_head(hidden[..., :64].contiguous(), w2[:, :64].contiguous(),
                          b2, tgt)
    with pytest.raises(ValueError):
        fce.fused_ce_head(hidden.transpose(0, 1).contiguous().transpose(0, 1),
                          w2, b2, tgt)
    flat = torch.empty(hidden.numel() + 1, dtype=hidden.dtype, device=device)
    with pytest.raises(ValueError):
        fce.fused_ce_head(flat[1:].view(hidden.shape), w2, b2, tgt)


SMALL = dict(d_model=256, nhead=2, num_layers=2, n_codebooks=4,
             audio_embedding_dim=256, text_vocab_size=30, head_hidden=64,
             max_position=1024)


# ------------------------------------------------ int8 weight streaming

I8_SHAPES = [(1, 32, 64), (2, 128, 512), (3, 96, 192), (8, 128, 512),
             (5, 1024, 2048), (2, 2048, 8192), (8, 2048, 8192),
             (9, 128, 512), (17, 256, 1024), (64, 2048, 8192), (200, 256, 512)]
CHAIN_REL = 5e-2  # 16 layers: a bf16 rounding flip in h feeds every later layer


def _i8_inputs(b, k, n, seed, device, layers=None):
    """The probes' weights: int8 in [-127, 127), scales 0.01 |normal|."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    wq = torch.from_numpy(rng.integers(-127, 127, size=lead + (k, n)).astype(np.int8))
    s = torch.from_numpy((np.abs(rng.normal(size=lead + (1, n))) * 0.01
                          ).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32))
    return x.to(device, torch.bfloat16), wq.to(device), s.to(device)


@pytest.mark.parametrize("b,k,n", I8_SHAPES)
def test_int8_matvec_matches_plain(device, b, k, n):
    rng = np.random.default_rng(b + k)
    w = torch.from_numpy(rng.normal(size=(k, n), scale=0.02).astype(np.float32))
    wq, s = i8.quantize_weight(w.to(device))
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    i8.reset_launches()
    got, again = i8.int8_matvec(x, wq, s), i8.int8_matvec(x, wq, s)
    want = i8.reference_int8_matvec(x, wq, s)
    torch.cuda.synchronize()
    assert i8.matvec_launches == 2 and got.shape == (b, n)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("b,k,n", I8_SHAPES)
def test_int8_layer_matches_plain_in_both_modes(device, b, k, n):
    x, wq, s = _i8_inputs(b, k, n, b * k, device)
    s = s.reshape(-1)
    i8.reset_launches()
    for mode in i8.MODES:
        got = i8.int8_matvec_layer(x, wq, s, mode)
        again = i8.int8_matvec_layer(x, wq, s, mode)
        want = i8.reference_int8_layer(x, wq, s, mode)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        if mode == "int8":  # exact int32 sums: bit for bit
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= REL
    assert (i8.chain_bf16_launches, i8.chain_int8_launches) == (2, 2)


@pytest.mark.parametrize("b,k,n", [(3, 288, 320), (17, 2048, 1024)])
def test_int8_layer_walks_as_its_tiled_plain_version(device, b, k, n):
    """The kernel's own walk in plain PyTorch (``tiled_int8_layer``): the
    int8 mode bit for bit; the bf16 mode within one bf16 rounding."""
    x, wq, s = _i8_inputs(b, k, n, 5 * b, device)
    s = s.reshape(-1)
    for mode in i8.MODES:
        got = i8.int8_matvec_layer(x, wq, s, mode)
        want = i8.tiled_int8_layer(x, wq, s, mode)
        torch.cuda.synchronize()
        if mode == "int8":
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= 2.0 ** -8


@pytest.mark.parametrize("b", [2, 8, 64])
def test_int8_chain_with_and_without_pdl_and_as_a_graph(device, b):
    """Programmatic dependent launch changes when a layer starts, never what
    it computes: the chain with it, without it, and captured in a CUDA graph
    and replayed agree bit for bit in both modes; the graph holds the
    programmatic edges of the 15 launches that follow another."""
    layers = 16
    x, wq, s = _i8_inputs(b, 2048, 8192, b + 1, device, layers)
    assert i8.occupancy("bf16", b) >= (2 if b <= 32 else 1)
    for mode in i8.MODES:
        run = lambda: i8.int8_matvec_chain(x, wq, s, mode, layers)  # noqa: E731
        with_pdl = run()
        i8.PDL = False
        try:
            without = run()
        finally:
            i8.PDL = True
        graph = i8.Captured(run)
        replay, again = graph().clone(), graph().clone()
        torch.cuda.synchronize()
        assert torch.equal(with_pdl, without)
        assert torch.equal(with_pdl, replay) and torch.equal(replay, again)
        assert graph.programmatic_edges >= layers - 1
        if mode == "int8":
            assert torch.equal(with_pdl, i8.reference_int8_chain(x, wq, s, mode, layers))


def test_int8_mode_rounds_half_to_even_on_the_card(device):
    k, n = 128, 192
    x = torch.zeros((2, k))
    x[0, :8] = torch.tensor([1, 3, 5, 7, -1, -3, -5, 300]) / 64.0
    x[1, :3] = torch.tensor([100.0, -100.0, 3.97])
    wq = torch.zeros((k, n), dtype=torch.int8)
    wq[torch.arange(k), torch.arange(k)] = 1
    s = torch.ones(n)
    x, wq, s = x.to(device, torch.bfloat16), wq.to(device), s.to(device)
    got = i8.int8_matvec_layer(x, wq, s, "int8")
    assert torch.equal(got, i8.reference_int8_layer(x, wq, s, "int8"))
    want0 = torch.tensor([0, 2, 2, 4, 0, -2, -2, 127]) / 32.0
    assert torch.equal(got[0, :8].float().cpu(), want0)


@pytest.mark.parametrize("b,k,n,shared", [(2, 128, 512, True), (8, 128, 512, False),
                                          (2, 2048, 8192, True),
                                          (8, 2048, 8192, False)])
def test_int8_chain_matches_plain(device, b, k, n, shared):
    layers = 16
    x, wq, s = _i8_inputs(b, k, n, k + b, device, None if shared else layers)
    i8.reset_launches()
    for mode in i8.MODES:
        got = i8.int8_matvec_chain(x, wq, s, mode, layers)
        again = i8.int8_matvec_chain(x, wq, s, mode, layers)
        want = i8.reference_int8_chain(x, wq, s, mode, layers)
        torch.cuda.synchronize()
        assert got.shape == (b, k) and torch.isfinite(got).all()
        assert torch.equal(got, again)
        if mode == "int8":
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= CHAIN_REL
    assert (i8.chain_bf16_launches, i8.chain_int8_launches) == (32, 32)


@pytest.mark.parametrize("b,layers,k,n", [(8, 3, 128, 512), (2, 16, 128, 128),
                                          (5, 4, 256, 16384), (8, 16, 2048, 8192)])
def test_int8_megakernel_matches_plain(device, b, layers, k, n):
    x, wq, s = _i8_inputs(b, k, n, layers, device, layers)
    i8.reset_launches()
    got, again = i8.int8_megakernel(x, wq, s), i8.int8_megakernel(x, wq, s)
    want = i8.reference_int8_mega(x, wq, s)
    chain = i8.int8_matvec_chain(x, wq, s, "bf16", layers)
    torch.cuda.synchronize()
    assert i8.mega_launches == 2 and got.shape == (b, k)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert _rel(got, want) <= CHAIN_REL
    assert _rel(got, chain) <= CHAIN_REL  # one launch against one per layer
    # a single layer at the tight tolerance
    one = i8.int8_megakernel(x, wq[:1], s[:1])
    assert _rel(one, i8.reference_int8_mega(x, wq[:1], s[:1])) <= REL


def test_int8_megakernel_smaller_grid_and_co_residency(device):
    """Fewer blocks than strips: each cluster walks several strips, same
    result bit for bit. An odd grid (the blocks come in 2-block clusters) is
    refused before any launch. More blocks than the device holds at once:
    refused with an error instead of a launch whose blocks would wait for
    flags that blocks never scheduled would have to raise."""
    x, wq, s = _i8_inputs(8, 256, 16384, 9, device, 3)
    full = i8.int8_megakernel(x, wq, s)
    assert torch.equal(i8.int8_megakernel(x, wq, s, grid_blocks=6), full)
    i8.reset_launches()
    with pytest.raises(ValueError, match="even"):
        i8.int8_megakernel(x, wq, s, grid_blocks=7)
    with pytest.raises(RuntimeError, match="resident"):
        i8.int8_megakernel(x, wq, s, grid_blocks=100000)
    assert i8.mega_launches == 0
    torch.cuda.synchronize()
    assert torch.equal(i8.int8_megakernel(x, wq, s), full)  # the device is fine


MEGA_SHAPES = [(8, 3, 128, 512), (2, 16, 128, 128), (5, 4, 256, 16384),
               (3, 2, 288, 640), (2, 16, 2048, 8192), (8, 16, 2048, 8192)]


def _per_column_rel(got, want):
    """max over columns of max |got - want| / max |want| in that column."""
    err = (got.float() - want.float()).abs().amax(dim=0)
    return (err / want.float().abs().amax(dim=0).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("b,layers,k,n", [(8, 3, 128, 512), (3, 2, 288, 640),
                                          (2, 4, 2048, 8192), (8, 4, 2048, 8192)])
def test_int8_megakernel_walks_as_its_tiled_plain_version(device, b, layers, k, n):
    """Layer by layer, from the kernel's own h: the first l + 1 layers
    against ``tiled_int8_mega`` of layer l on the output of the first l
    (the kernel's bits for a prefix are those of the prefix's launch). The
    walk sums in the kernel's order, the tensor cores' order inside one
    k-step aside, so the output agrees within one bf16 rounding and each of
    the layer's fp32 sums within 1e-6 of sum_i |h_i w_ij| |s_j|, the scale
    of its summation error (a column's largest of 2 rows can lie near 0).
    A block's partial rounded to bf16 before the cluster's sum is off by
    ~2^-9 of the partial: 1e-5 to 1e-4 of that scale at K = 2048."""
    x, wq, s = _i8_inputs(b, k, n, 3 * layers + b, device, layers)
    h = x
    for layer in range(layers):
        got, acc = i8.int8_megakernel(x, wq[:layer + 1], s[:layer + 1], return_acc=True)
        want, want_acc = i8.tiled_int8_mega(h, wq[layer:layer + 1], s[layer:layer + 1],
                                            return_acc=True)
        terms = (h.float().abs() @ wq[layer].float().abs()) * s[layer].abs()
        torch.cuda.synchronize()
        assert _rel(got, want) <= 2.0 ** -8, f"layer {layer}"
        err = ((acc - want_acc).abs() / terms.clamp_min(1e-30)).max().item()
        assert err <= 1e-6, f"layer {layer}: sums {err:.3g} of sum |h w| |s|"
        h = got


@pytest.mark.parametrize("b,layers,k,n", MEGA_SHAPES)
def test_int8_megakernel_return_acc_covers_every_column(device, b, layers, k, n):
    """The last layer's fp32 sums on all N columns (not only the K fed
    back) against the plain last layer taken from the kernel's own h before
    it: a column the kernel skipped reads 0 or garbage and fails here."""
    x, wq, s = _i8_inputs(b, k, n, layers + 2 * b, device, layers)
    out, acc = i8.int8_megakernel(x, wq, s, return_acc=True)
    h = i8.int8_megakernel(x, wq[:-1], s[:-1]) if layers > 1 else x
    want = (h.float() @ wq[-1].float()) * s[-1].float()
    torch.cuda.synchronize()
    assert acc.shape == (b, n) and torch.isfinite(acc).all()
    assert _per_column_rel(acc, want) <= REL
    assert torch.equal(acc[:, :k].to(torch.bfloat16), out)


@pytest.mark.parametrize("b,layers,k,n", [(8, 3, 256, 16384), (2, 16, 2048, 8192),
                                          (8, 16, 2048, 8192)])
def test_int8_megakernel_bit_identical_across_runs_and_grids(device, b, layers, k, n):
    """A fixed order and no atomics on values: two runs and any even grid
    (one cluster, a few, the kernel's own) give the same bits, output and
    last-layer sums alike."""
    x, wq, s = _i8_inputs(b, k, n, 11 * b, device, layers)
    out, acc = i8.int8_megakernel(x, wq, s, return_acc=True)
    resident = i8.mega_resident()
    for grid in (None, None, 2, 6, 64, resident - resident % 2):
        o, a = i8.int8_megakernel(x, wq, s, grid_blocks=grid, return_acc=True)
        torch.cuda.synchronize()
        assert torch.equal(o, out) and torch.equal(a, acc), grid


def test_int8_mega_stream_runs_alone(device):
    """The megakernel's weight stream without products (a measurement tool)
    launches at full width and leaves the card usable; it counts no launch
    of the megakernel."""
    _, wq, _ = _i8_inputs(2, 2048, 8192, 1, device, 16)
    i8.reset_launches()
    i8.int8_mega_stream(wq)
    i8.int8_mega_stream(wq, grid_blocks=6)
    torch.cuda.synchronize()
    assert i8.mega_launches == 0 and i8.mega_resident() >= 2


def test_int8_kernels_refuse_what_they_cannot_take(device):
    x, wq, s = _i8_inputs(2, 128, 512, 0, device)
    s1 = s.reshape(-1)
    with pytest.raises(TypeError):
        i8.int8_matvec(x.float(), wq, s1)
    with pytest.raises(TypeError):
        i8.int8_matvec(x, wq.int(), s1)
    with pytest.raises(ValueError):
        i8.int8_matvec(x, wq[:96], s1)  # K mismatch
    with pytest.raises(ValueError):
        i8.int8_matvec(x, wq[:, :100].contiguous(), s1[:100].contiguous())
    with pytest.raises(ValueError):
        i8.int8_matvec(x, wq.t().contiguous().t(), s1)  # not contiguous
    with pytest.raises(ValueError):
        i8.int8_megakernel(x.repeat(5, 1), wq[None], s[None])  # 10 rows
    assert i8.int8_matvec(x.repeat(5, 1), wq, s1).shape == (10, 512)
    with pytest.raises(ValueError):
        i8.int8_matvec(x, wq.cpu(), s1)
    with pytest.raises(ValueError):
        i8.int8_matvec_layer(x, wq, s1, "fp8")
    with pytest.raises(ValueError):
        i8.int8_megakernel(x, wq[None], s1[None])  # scale not [L, 1, N]
    with pytest.raises(ValueError):
        i8.int8_megakernel(x, wq[None, :, :64].contiguous(),
                           s[None, :, :64].contiguous())  # N < K
    # a column slice of a wider output (the chain's feedback) is taken as is
    wide = i8.int8_matvec(x, wq, s1)
    h = wide[:, :128]
    assert not h.is_contiguous()
    assert torch.equal(i8.int8_matvec(h, wq, s1),
                       i8.int8_matvec(h.contiguous(), wq, s1))


@pytest.fixture(scope="module")
def small_lm(device):
    from ssr_speech_tpu_torch.config import SSRModelConfig
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models.from_jax import lm_from_jax

    cfg = SSRModelConfig(**SMALL)
    params = tssr.init_ssr(torch.Generator().manual_seed(0), cfg)
    return (cfg, lm_from_jax(params, cfg),
            lm_from_jax(params, cfg, device=device, dtype=torch.bfloat16))


def test_prefill_on_card_matches_cpu(device, small_lm):
    """The prefill through the kernel (bf16) against the port's fp32 CPU
    prefill: the cache at every attendable position."""
    from ssr_speech_tpu_torch.inference import decode as tdecode

    cfg, cpu, gpu = small_lm
    rng = np.random.default_rng(1)
    sx, P, x_len, p_len = 64, 256, 41, 200
    x = np.full((2, sx), cfg.text_pad_token, np.int64)
    x[0, :x_len] = rng.integers(0, cfg.text_vocab_size - 1, size=x_len)
    x[1, :x_len] = cfg.text_vocab_size - 1
    prefix = np.full((4, P), cfg.tokens.empty, np.int64)
    prefix[:, :p_len] = rng.integers(0, 2048, size=(4, p_len))
    kw = dict(cfg=cfg, tmax=512, cfg_pretrained=True, aug_text=True)
    c_cpu, ban = tdecode._prefill_impl(cpu, torch.from_numpy(x),
                                       torch.from_numpy(prefix), x_len, p_len,
                                       dtype=torch.float32, **kw)
    fa.reset_launches()
    c_gpu, ban_g = tdecode._prefill_impl(
        gpu, torch.from_numpy(x).to(device), torch.from_numpy(prefix).to(device),
        x_len, p_len, dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert fa.launches == cfg.num_layers
    assert torch.equal(ban_g.cpu(), ban)
    n = sx + p_len
    for b, (lo, hi) in enumerate(ban.tolist()):
        keep = torch.ones(n, dtype=torch.bool)
        keep[lo:hi] = False
        for name in ("k", "v"):
            want = getattr(c_cpu, name)[:, b, :, :n][:, :, keep]
            got = getattr(c_gpu, name)[:, b, :, :n][:, :, keep].float().cpu()
            err = (got - want).abs().max().item()
            # bf16 weights and activations through two layers
            assert err <= 3e-2 * want.abs().max().item(), (name, b, err)


def test_generate_on_card_is_deterministic(device, small_lm):
    from ssr_speech_tpu_torch.config import DecodeConfig
    from ssr_speech_tpu_torch.inference import decode as tdecode

    cfg, _, gpu = small_lm
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2048, size=(4, 120))
    x = rng.integers(0, cfg.text_vocab_size - 1, size=(30,))
    dec = DecodeConfig(top_k=1, stop_repetition=2, aug_text=True,
                       cfg_pretrained=True, cfg_stride=5, max_gen_per_span=200)
    outs = []
    for _ in range(2):
        fa.reset_launches()
        stats = {}
        outs.append(tdecode.generate(gpu, cfg, dec, x, y, [(30, 60), (80, 100)],
                                     torch.Generator(device=device).manual_seed(0),
                                     stats=stats))
        assert fa.launches == cfg.num_layers
        assert stats["decode_steps"] > 0
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][0].shape[1] == 4
