"""The plain PyTorch versions of what the Hopper CE-head kernels do
(``ssr_speech_tpu_torch/ops/fused_ce.py``): ``tiled_ce_forward`` (the target
logit first, then one pass over vocab tiles with the online max/sum and the
rank counted without the target's column), ``tiled_ce_dhidden`` (vocab tiles in
order, the logits as partial products over parts of Hh added in part order,
dlogits rounded to the working type, dhidden accumulated in fp32) and
``tiled_ce_dw2`` (row blocks in order, dlogits rounded to the working type,
dw2 and db2 accumulated in fp32).
CPU, numpy-seeded inputs, small widths.

- Against the JAX package (``ssr_speech_tpu.ops.fused_ce.fused_ce_head`` and
  its ``jax.vjp``, as ``tests/test_torch_train.py`` runs them) in fp32: nll and
  logz within 1e-5 (only the summation order differs), hits equal wherever the
  target logit is not within 1e-4 of the 10th largest, dhidden, dw2 and db2
  within 1e-5 of their largest magnitude; over C in {1, 130, 2056}, N in {1, 63, 300} and
  block sizes that do and do not divide them.
- Against ``reference_ce_head`` and its autograd in bf16: nll within 1e-4
  (exact bf16 products, fp32 sums in another order), dhidden/dw2/db2 within 2e-2 of
  the largest magnitude (the tiled version rounds dlogits to bf16, as the
  kernels do, where autograd keeps fp32).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.ops import fused_ce as jfce
from ssr_speech_tpu_torch.ops import fused_ce as tfce

K, HH = 2, 24
SHAPES = [(n, c) for c in (1, 130, 2056) for n in (1, 63, 300)]
TIE = 1e-4


def _inputs(n, c, seed_offset=0):
    rng = np.random.default_rng(1000 * n + c + seed_offset)
    hidden = rng.standard_normal((K, n, HH)).astype(np.float32)
    w2 = (rng.standard_normal((K, HH, c)) / np.sqrt(HH)).astype(np.float32)
    b2 = rng.standard_normal((K, c)).astype(np.float32) * 0.1
    tgt = rng.integers(0, c, size=(K, n)).astype(np.int32)
    if n > 2:
        tgt[:, 0] = c - 1  # the last column, in a ragged last tile
        # a row whose target holds the maximum
        tgt[:, 1] = np.argmax(np.einsum("knh,khc->knc", hidden, w2)[:, 1] + b2, -1)
    g = rng.standard_normal((K, n)).astype(np.float32)
    return hidden, w2, b2, tgt, g


@functools.lru_cache(maxsize=None)
def _jax_side(n, c):
    """nll, hits, logz, (dhidden, dw2, db2) and the near-tie mask from the JAX
    package, once a shape."""
    hidden, w2, b2, tgt, g = _inputs(n, c)
    (nll, hits), vjp = jax.vjp(
        lambda a, b, d: jfce.fused_ce_head(a, b, d, tgt), hidden, w2, b2)
    grads = vjp((g, np.zeros_like(g)))
    logits = np.einsum("knh,khc->knc", hidden.astype(np.float64),
                       w2.astype(np.float64)) + b2[:, None]
    t_logit = np.take_along_axis(logits, tgt[..., None].astype(np.int64), -1)[..., 0]
    if c >= tfce.TOP:
        kth = np.sort(logits, -1)[..., -tfce.TOP]
        near = np.abs(t_logit - kth) <= TIE
    else:
        near = np.zeros_like(t_logit, bool)
    logz = np.asarray(nll, np.float64) + t_logit
    return (np.asarray(nll), np.asarray(hits), logz, t_logit,
            [np.asarray(x) for x in grads], near)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("block_v", [128, 96])
@pytest.mark.parametrize("n,c", SHAPES)
def test_tiled_forward_matches_jax(n, c, block_v):
    hidden, w2, b2, tgt, _ = _inputs(n, c)
    nll, hits, logz, t_logit, _, near = _jax_side(n, c)
    t_nll, t_logz, t_hits = tfce.tiled_ce_forward(*_torch(hidden, w2, b2, tgt),
                                                  block_v=block_v)
    np.testing.assert_allclose(t_nll.numpy(), nll, atol=1e-5)
    np.testing.assert_allclose(t_logz.numpy(), logz, atol=1e-5)
    differ = t_hits.numpy() != hits
    assert not (differ & ~near).any()
    if n > 2:
        assert (t_hits[:, 1] == 1.0).all()  # the target is the maximum: rank 0
    t_tl = tfce.target_logits(*_torch(hidden, np.ascontiguousarray(
        w2.transpose(0, 2, 1)), b2, tgt))
    np.testing.assert_allclose(t_tl.numpy(), t_logit, atol=1e-5)


@pytest.mark.parametrize("block_n,block_v", [(64, 32), (50, 24)])
@pytest.mark.parametrize("n,c", SHAPES)
def test_tiled_dw2_matches_jax(n, c, block_n, block_v):
    hidden, w2, b2, tgt, g = _inputs(n, c)
    _, _, logz, _, (_, dw2, db2), _ = _jax_side(n, c)
    t_dw2, t_db2 = tfce.tiled_ce_dw2(
        *_torch(hidden, w2, b2, tgt, logz.astype(np.float32), g),
        block_n=block_n, block_v=block_v)
    assert t_dw2.dtype == t_db2.dtype == torch.float32
    for name, got, want in (("dw2", t_dw2, dw2), ("db2", t_db2, db2)):
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * max(scale, 1.0), name


@pytest.mark.parametrize("block_v,hh_parts", [(32, 4), (48, 5)])
@pytest.mark.parametrize("n,c", SHAPES)
def test_tiled_dhidden_matches_jax(n, c, block_v, hh_parts):
    """(48, 5) divides neither C nor Hh = 24 (parts of 5, 5, 5, 5, 4)."""
    hidden, w2, b2, tgt, g = _inputs(n, c)
    _, _, logz, _, (dhidden, _, _), _ = _jax_side(n, c)
    got = tfce.tiled_ce_dhidden(*_torch(hidden, w2, b2, tgt, logz.astype(np.float32), g),
                                block_v=block_v, hh_parts=hh_parts)
    assert got.dtype == torch.float32 and got.shape == dhidden.shape
    scale = max(np.abs(dhidden).max(), 1e-6)
    assert np.abs(got.numpy() - dhidden).max() <= 1e-5 * max(scale, 1.0)


@pytest.mark.parametrize("n,c", [(63, 130), (300, 2056), (65, 136)])
def test_tiled_versions_match_the_plain_version_in_bf16(n, c):
    """bf16 inputs, as on the card: the forward against ``reference_ce_head``,
    dhidden and dw2/db2 (with bf16-rounded dlogits) against its autograd."""
    hidden, w2, b2, tgt, g = _inputs(n, c, seed_offset=7)
    hidden, w2, b2 = (t.to(torch.bfloat16) for t in _torch(hidden, w2, b2))
    tgt, g = _torch(tgt, g)
    leaves = [t.clone().requires_grad_() for t in (hidden, w2, b2)]
    p_nll, p_hits = tfce.reference_ce_head(*leaves, tgt)
    want = torch.autograd.grad(p_nll, leaves, g)
    nll, logz, hits = tfce.tiled_ce_forward(hidden, w2, b2, tgt)
    torch.testing.assert_close(nll, p_nll.detach(), atol=1e-4, rtol=0)
    logits = torch.matmul(hidden.double(), w2.double()) + b2.double()[:, None]
    t_logit = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
    near = (t_logit - logits.topk(tfce.TOP, -1).values[..., -1]).abs() <= 1e-3
    assert not ((hits != p_hits) & ~near).any()
    dw2, db2 = tfce.tiled_ce_dw2(hidden, w2, b2, tgt, logz, g)
    dhidden = tfce.tiled_ce_dhidden(hidden, w2, b2, tgt, logz, g)
    assert dhidden.dtype == torch.bfloat16
    for name, got, w in (("dhidden", dhidden, want[0]), ("dw2", dw2, want[1]),
                         ("db2", db2, want[2])):
        rel = (got - w.float()).abs().max() / w.float().abs().max()
        assert rel <= 2e-2, (name, rel)


def test_the_rank_leaves_out_the_targets_own_column():
    """Columns that tie with the target exactly do not count (the comparison
    is strict), and neither does the target's own column, whatever rounding
    the two computations of its logit differ by."""
    hidden = torch.ones((1, 2, 8))
    w2 = torch.zeros((1, 8, 12))
    w2[0, :, :11] = torch.arange(11.0)  # logits 0, 8, ..., 80, and 0
    w2[0, :, 11] = 5.0  # ties with column 5
    b2 = torch.zeros((1, 12))
    tgt = torch.tensor([[5, 0]], dtype=torch.int32)
    for block_v in (4, 5, 128):
        _, _, hits = tfce.tiled_ce_forward(hidden, w2, b2, tgt, top=6, block_v=block_v)
        _, p_hits = tfce.reference_ce_head(hidden, w2, b2, tgt, top=6)
        # column 5: 5 larger logits (6..10) -> a hit at top 6; column 0: 10 larger
        assert hits.tolist() == p_hits.tolist() == [[1.0, 0.0]]


def test_transpose_w2_is_the_contiguous_transpose():
    w2 = torch.arange(2 * 3 * 5, dtype=torch.float32).view(2, 3, 5)
    w2t = tfce.transpose_w2(w2)
    assert w2t.shape == (2, 5, 3) and w2t.is_contiguous()
    assert torch.equal(w2t, w2.permute(0, 2, 1))


def test_ce_bench_runs_the_plain_versions_on_the_cpu():
    """The kernels' benchmark script at a small shape on the CPU: the dense and
    the tiled plain versions, no kernel launch."""
    from ssr_speech_tpu_torch import ce_bench

    res = ce_bench.main(["--device", "cpu", "--shape", "2,70,128,130", "--iters", "1"])
    case = res["case"]
    assert case["shape"] == [2, 70, 128, 130] and "card" not in res
    assert case["nll_abs_err"] <= 1e-5 and case["hits_differ"] == 0
    assert min(case["plain_ms"], case["tiled_fwd_ms"], case["tiled_dw2_ms"]) > 0
    assert tfce.fwd_launches == tfce.dhidden_launches == tfce.dw2_launches == 0
