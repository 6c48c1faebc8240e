"""The plain PyTorch versions of what the Hopper attention kernels do beyond
the dense mask (``ssr_speech_tpu_torch/ops/flash_attention.py``): the
masked-tile skip rule ``tile_visits`` and the tiled forward/backward that walk
only the visited tiles. CPU, fp32, numpy-seeded inputs, small widths.

- ``tile_visits`` never skips a tile that holds an attending pair and always
  visits the diagonal, over random and adversarial segment layouts (ids
  beyond {0, 1}, ragged S, tiles of 64 and 128).
- ``tiled_forward`` equals the JAX package's ``reference_attend`` (and, for
  ids in {0, 1}, ``flash_attend_xy``) on every row (tol 1e-5: only the summation order
  differs) and its LSE the dense log-sum-exp (1e-5).
- ``tiled_backward`` equals ``jax.vjp`` of the JAX op (tol 1e-4: three chained
  products accumulated tile by tile; of ``reference_attend`` where the ids go
  beyond {0, 1}).
"""

import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ssr_speech_tpu.ops import flash_attention as jfa
from ssr_speech_tpu_torch.ops import flash_attention as tfa

BLOCKS = [(64, 64), (128, 64), (64, 128), (128, 128)]
LAYOUTS = ["train", "prefill", "random", "many_ids", "alone", "interleaved",
           "descending", "one_segment"]


def segments(layout: str, b: int, s: int, seed: int) -> np.ndarray:
    """Segment ids [b, s], int32."""
    rng = np.random.default_rng(seed)
    sx = max(s // 3, 1)
    seg = np.ones((b, s), np.int32)
    if layout == "train":  # [text valid | text pad | audio valid | audio pad]
        seg[:] = 0
        for r in range(b):
            seg[r, :rng.integers(1, sx + 1)] = 1
            seg[r, sx:sx + rng.integers(0, s - sx + 1)] = 1
    elif layout == "prefill":  # text padding banned; row 1.. bans [1, sx)
        seg[:, max(sx - 7, 1):sx] = 0
        seg[1:, 1:sx] = 0
    elif layout == "random":
        seg = rng.integers(0, 3, size=(b, s)).astype(np.int32)
    elif layout == "many_ids":  # runs of ids far beyond {0, 1}
        ids = np.array([-7, 0, 1, 2, 5, 1 << 20, -(1 << 30)], np.int32)
        seg = np.stack([np.repeat(rng.choice(ids, size=s),
                                  rng.integers(1, max(s // 4, 2), size=s))[:s]
                        for _ in range(b)]).astype(np.int32)
    elif layout == "alone":  # rows whose only visible key is themselves
        seg[:, 0] = 9
        seg[:, s // 2] = 7
        seg[:, s - 1] = 3
    elif layout == "interleaved":  # ranges overlap everywhere, ids alternate
        seg = (np.arange(s)[None] % 2 * 4 + np.arange(b)[:, None]).astype(np.int32)
    elif layout == "descending":  # every tile's range is disjoint from the next
        seg = np.broadcast_to((s - np.arange(s)) // 16, (b, s)).astype(np.int32)
    elif layout != "one_segment":
        raise ValueError(layout)
    return np.ascontiguousarray(seg)


def dense_mask(seg: np.ndarray) -> np.ndarray:
    s = seg.shape[1]
    return (seg[:, :, None] == seg[:, None, :]) & np.tril(np.ones((s, s), bool))


def check_visits(seg: np.ndarray, bq: int, bk: int) -> np.ndarray:
    """Asserts the two properties; returns the visits [B, Tq, Tk]."""
    b, s = seg.shape
    vis = tfa.tile_visits(torch.from_numpy(seg), bq, bk).numpy()
    tq, tk = -(-s // bq), -(-s // bk)
    assert vis.shape == (b, tq, tk) and vis.dtype == bool
    ok = np.zeros((b, tq * bq, tk * bk), bool)
    ok[:, :s, :s] = dense_mask(seg)
    need = ok.reshape(b, tq, bq, tk, bk).any(axis=(2, 4))
    assert not (need & ~vis).any(), "a tile with an attending pair is skipped"
    eye = np.zeros((tq * bq, tk * bk), bool)
    eye[np.arange(s), np.arange(s)] = True
    diagonal = eye.reshape(tq, bq, tk, bk).any(axis=(1, 3))
    assert vis[:, diagonal].all(), "a diagonal tile is skipped"
    first = np.arange(tk)[None, :] * bk > np.minimum(
        (np.arange(tq)[:, None] + 1) * bq, s) - 1
    assert not vis[:, first].any(), "a tile above the diagonal is visited"
    return vis


@pytest.mark.parametrize("bq,bk", BLOCKS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tile_visits_never_skips_an_attending_pair(layout, bq, bk):
    for s in (1, 63, 64, 65, 127, 129, 200, 333):
        check_visits(segments(layout, 3, s, s), bq, bk)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 300), st.sampled_from(BLOCKS),
       st.lists(st.tuples(st.integers(-3, 3), st.integers(1, 90)), min_size=1,
                max_size=12))
def test_tile_visits_on_drawn_run_lengths(s, blocks, runs):
    """Segment layouts as runs (id, length), repeated to length s."""
    ids = np.concatenate([np.full(n, v, np.int32) for v, n in runs])
    seg = np.resize(ids, (1, s)).astype(np.int32)
    check_visits(seg, *blocks)


def test_tile_visits_skips_what_the_layouts_allow():
    """The rule does skip: a text-pad block, an audio-pad block and the
    banned [1, sx) of the unconditional CFG row leave whole tiles unvisited,
    a single segment none; ids that interleave cannot be skipped."""
    s, sx = 1152, 416
    seg = np.zeros((2, s), np.int32)
    seg[0, :100] = 1  # text valid; [100, 416) is padding
    seg[0, sx:sx + 500] = 1  # audio valid; [916, 1152) is padding
    seg[1] = 1
    seg[1, 1:sx] = 0  # the banned prompt of the unconditional row
    vis = check_visits(seg, 64, 64)
    causal = np.tril(np.ones(vis.shape[1:], bool))
    share = (vis & causal).sum(axis=(1, 2)) / causal.sum()
    assert share[0] < 0.7 and share[1] < 0.7, share
    # audio-valid query tiles never visit the all-padding text tiles 2..5
    assert not vis[0, 7:14, 2:6].any()
    # audio-pad query tiles never visit the all-valid audio tiles 7..13
    assert not vis[0, 15:, 7:14].any()
    assert (check_visits(segments("one_segment", 1, s, 0), 64, 64)
            == causal[None]).all()
    assert (check_visits(segments("interleaved", 1, s, 0), 64, 64)
            == causal[None]).all()


# Off the TPU the JAX op reduces the ids to valid / padded (``seg != 0``): it
# is the reference for layouts with ids in {0, 1}; ``reference_attend``, the
# plain version its kernels are held to, keeps every id.
BINARY = ("train", "prefill", "one_segment")


def jax_attend(layout, q, k, v, seg, scale):
    if layout in BINARY:
        return jfa.flash_attend_xy(q, k, v, seg, sm_scale=scale)
    return jfa.reference_attend(q, k, v, seg, scale)


def _inputs(s, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 3, s, dh)).astype(np.float32)
            for _ in range(4)]


def dense_lse(q, k, seg, scale):
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) * scale
    scores = np.where(dense_mask(seg)[:, None], scores, -np.inf)
    m = scores.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(scores - m).sum(-1))).astype(np.float32)


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("s,bq,bk", [(77, 64, 64), (200, 64, 64), (200, 128, 64)])
@pytest.mark.parametrize("layout", ["train", "many_ids", "alone"])
def test_tiled_forward_matches_jax(layout, s, bq, bk, dh):
    """Every row, of any segment: the output against the JAX package's dense
    plain version and its public op, the LSE against the dense one."""
    q, k, v, _ = _inputs(s, dh, dh + s)
    seg = segments(layout, 2, s, s)
    scale = 1.0 / math.sqrt(dh)
    want = np.asarray(jfa.reference_attend(q, k, v, seg, scale))
    out, lse = tfa.tiled_forward(*(torch.from_numpy(t) for t in (q, k, v)),
                                 torch.from_numpy(seg), scale, bq, bk)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    if layout in BINARY:
        op = np.asarray(jfa.flash_attend_xy(q, k, v, seg))
        np.testing.assert_allclose(out.numpy(), op, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), dense_lse(q, k, seg, scale),
                               atol=1e-5)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("s,bq,bk", [(77, 64, 64), (200, 64, 64), (200, 64, 128)])
@pytest.mark.parametrize("layout", ["train", "many_ids", "alone"])
def test_tiled_backward_matches_jax_vjp(layout, s, bq, bk, dh):
    """dq, dk, dv on every row against jax.vjp of the JAX op, from the tiled
    forward's own output and LSE (as the kernels chain them)."""
    q, k, v, dout = _inputs(s, dh, 7 * dh + s)
    seg = segments(layout, 2, s, s)
    scale = 1.0 / math.sqrt(dh)
    _, vjp = jax.vjp(lambda a, b, c: jax_attend(layout, a, b, c, seg, scale),
                     q, k, v)
    want = vjp(dout)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dout))
    tseg = torch.from_numpy(seg)
    out, lse = tfa.tiled_forward(tq, tk, tv, tseg, scale, bq, bk)
    got = tfa.tiled_backward(tq, tk, tv, tseg, out, lse, tdo, scale, bq, bk)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)
    assert tfa.launches == tfa.bwd_launches == 0


def test_tiled_versions_agree_with_the_dense_plain_version_in_bf16():
    """The working type of the kernels: the tiled walk rounds P (and dS) to
    bf16 as operands, the dense plain version the normalised probabilities;
    both stay within the kernels' tolerance of each other."""
    s, dh = 200, 128
    q, k, v, dout = (torch.from_numpy(t).to(torch.bfloat16)
                     for t in _inputs(s, dh, 3))
    seg = torch.from_numpy(segments("train", 2, s, 5))
    scale = 1.0 / math.sqrt(dh)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tfa.reference_attend(*leaves, seg, scale)
    want = torch.autograd.grad(ref, leaves, dout)
    out, lse = tfa.tiled_forward(q, k, v, seg, scale)
    assert (out.float() - ref.float()).abs().max() <= 2e-2
    for g, w in zip(tfa.tiled_backward(q, k, v, seg, out, lse, dout, scale), want):
        assert ((g.float() - w.float()).abs().max()
                <= 2e-2 * w.float().abs().max())


def test_flash_bench_runs_the_plain_versions_on_the_cpu():
    """The kernels' benchmark script at a small shape on the CPU: the dense
    and the tiled plain versions, the tile shares, no kernel launch."""
    from ssr_speech_tpu_torch import flash_bench

    res = flash_bench.main(["--device", "cpu", "--shape", "2,2,200,16",
                            "--iters", "1"])
    (case,) = res["cases"]
    assert case["shape"] == [2, 2, 200, 16] and "card" not in res
    assert 0.0 < case["attending_share_of_causal_pairs"] < 1.0
    assert 0.0 < case["visited_share_of_causal_tiles"] <= 1.0
    assert case["plain_ms"] > 0 and case["tiled_plain_ms"] > 0
    assert tfa.launches == tfa.bwd_launches == 0
