"""Continuous-batching serving of the PyTorch port against ``ssr_speech_tpu``.

Both packages run here on the CPU in fp32 with the same parameters (the JAX
init through ``lm_from_jax``), greedy with ``cfg_pretrained`` as in
tests/test_serving.py, since JAX's PRNG streams cannot be reproduced in
torch. Covered: the paged decode step (``transformer_decode_step_paged``) on
ragged write columns with a refilled row; served results identical to JAX's
``ContinuousBatcher`` and to the port's own ``generate`` (codes, marks and
intervals), across refills, server reuse, online serving on an injected
clock and eager prefill off and on; requests beyond the geometry rejected
before any decoding; and ``inference_multi(continuous=True)`` against the
JAX pipeline (waveforms within one 16-bit LSB). The tensor-parallel case of
tests/test_serving.py waits for the port's parallelism.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.inference import serve as jserve
from ssr_speech_tpu.models import transformer as jtrf
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.inference import serve as tserve
from ssr_speech_tpu_torch.models import transformer as ttrf
from tests.test_torch_batched_decode import (CFG, LSB, PHN2NUM, TCFG, TS,
                                             _assert_same, _dec, models,
                                             one_torch_thread, tokenizers,
                                             write_wavs)
from tests.test_torch_hostcopies import port_config

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared

GEOM = [(30, 20, [(8, 15)]), (24, 14, [(5, 12)]), (36, 25, [(20, 30)]),
        (28, 18, [(4, 9), (14, 20)]), (22, 12, [(6, 10)]),
        (32, 22, [(10, 16)])]


def _requests(n, seed=21):
    """tests/test_serving.py's requests: ragged text and audio, a 2-span
    edit among them."""
    rng = np.random.default_rng(seed)
    reqs = []
    for T, sx, mask in GEOM[:n]:
        y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, T))
        x = rng.integers(0, CFG.text_vocab_size - 1, size=(sx,))
        reqs.append((x, y, mask))
    return reqs


def _greedy(aug_text):
    return _dec(aug_text=aug_text, cfg_stride=2)


def _gen():
    return torch.Generator().manual_seed(0)


def _single(model, dec, req):
    x, y, mask = req
    return tdecode.generate(model, TCFG, port_config(dec), x, y, mask, _gen())


def _server(model, dec, **kw):
    geom = dict(sx_pad=64, p_pad=128, num_task=2)
    geom.update(kw)
    return tserve.ContinuousBatcher(model, TCFG, port_config(dec), 2, **geom)


# ------------------------------------------------------------ the paged step

@pytest.mark.parametrize("read_len", [None, 9])
def test_decode_step_paged_matches_jax(models, read_len):
    """One paged step of 4 rows at ragged write columns (7, 3, 0, 5): row 2
    was just refilled and its cache row still holds the previous occupant's
    K/V. Outputs within 1e-5 of JAX's; each row's new K/V at its own column
    within 1e-6 (one fp32 projection apart), every other entry of the cache
    untouched; the step reads the generated cache up to ``read_len`` (a
    bound on the write columns) or whole, with the same result."""
    params, model = models
    rng = np.random.default_rng(5)
    L, H, Dh, D = CFG.num_layers, CFG.nhead, CFG.head_dim, CFG.d_model
    B, tp, p_len, tg = 4, 64, 40, 16
    gen_len = np.array([7, 3, 0, 5], np.int32)
    h = rng.standard_normal((B, D)).astype(np.float32)
    pk, pv = (rng.standard_normal((L, B, H, tp, Dh)).astype(np.float32)
              for _ in range(2))
    gk, gv = (rng.standard_normal((L, B, H, tg, Dh)).astype(np.float32) * 3
              for _ in range(2))
    key_banned = rng.random((B, tp)) < 0.3
    key_banned[:, p_len:] = True
    key_banned[:, 0] = False
    want_h, want_gen = jtrf.transformer_decode_step_paged(
        params["decoder"], jnp.asarray(h),
        jtrf.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.int32(p_len)),
        jtrf.KVCache(jnp.asarray(gk), jnp.asarray(gv), jnp.int32(0)),
        jnp.asarray(key_banned), jnp.asarray(gen_len), CFG,
        dtype=jnp.float32)
    gen = ttrf.KVCache(torch.from_numpy(gk.copy()), torch.from_numpy(gv.copy()),
                       0)
    got_h, got_gen = ttrf.transformer_decode_step_paged(
        model["decoder"], torch.from_numpy(h),
        ttrf.KVCache(torch.from_numpy(pk), torch.from_numpy(pv), p_len), gen,
        torch.from_numpy(key_banned), torch.from_numpy(gen_len).long(), TCFG,
        dtype=torch.float32, read_len=read_len)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=1e-5)
    written = np.zeros((B, tg), bool)
    written[np.arange(B), gen_len] = True
    for got, want, before in ((got_gen.k, want_gen.k, gk),
                              (got_gen.v, want_gen.v, gv)):
        got = got.numpy().transpose(1, 3, 0, 2, 4)  # [B, Tg, L, H, Dh]
        want = np.asarray(want).transpose(1, 3, 0, 2, 4)
        before = before.transpose(1, 3, 0, 2, 4)
        np.testing.assert_allclose(got[written], want[written], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[~written], before[~written])
        np.testing.assert_array_equal(want[~written], before[~written])


def test_refilled_row_never_reads_the_previous_occupant(models):
    """A row at write column 0 gives the same output whatever its cache row
    holds (the strict mask), equal to a fresh one-row step's."""
    _, model = models
    rng = np.random.default_rng(8)
    L, H, Dh, D = CFG.num_layers, CFG.nhead, CFG.head_dim, CFG.d_model
    tp, tg = 32, 16
    h = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32))
    pk, pv = (torch.from_numpy(rng.standard_normal((L, 2, H, tp, Dh))
                               .astype(np.float32)) for _ in range(2))
    pfx = ttrf.KVCache(pk, pv, tp)
    banned = torch.zeros((2, tp), dtype=torch.bool)
    junk = ttrf.KVCache(*(torch.from_numpy(rng.standard_normal(
        (L, 2, H, tg, Dh)).astype(np.float32) * 50) for _ in range(2)), 0)
    got, _ = ttrf.transformer_decode_step_paged(
        model["decoder"], h, pfx, junk, banned, torch.tensor([0, 6]), TCFG,
        dtype=torch.float32)
    fresh = ttrf.init_kv_cache(TCFG, 1, tg, dtype=torch.float32)
    want, _ = ttrf.transformer_decode_step_paged(
        model["decoder"], h[:1], ttrf.KVCache(pk[:, :1], pv[:, :1], tp), fresh,
        banned[:1], torch.tensor([0]), TCFG, dtype=torch.float32)
    np.testing.assert_allclose(got[:1].numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ the server

@pytest.fixture(scope="module")
def jax_served(models):
    """JAX ``serve_requests`` over the 6 requests through 2 slots, per
    aug_text (computed once for the module)."""
    params, _ = models
    reqs = _requests(6)
    return {aug: jserve.serve_requests(params, CFG, _greedy(aug), reqs,
                                       jax.random.PRNGKey(0), n_slots=2,
                                       dtype_name="float32")
            for aug in (False, True)}


@pytest.mark.parametrize("aug_text", [False, True])
def test_served_greedy_matches_jax_and_single(models, jax_served, aug_text):
    """6 requests through 2 slots (a 2-span edit and four refilled lanes
    among them): every result equals JAX's ``ContinuousBatcher`` and the
    port's own single-prompt ``generate``; stats record every prefill's
    layout and each request's token stream."""
    _, model = models
    reqs = _requests(6)
    dec = _greedy(aug_text)
    stats = {}
    served = tserve.serve_requests(model, TCFG, port_config(dec), reqs,
                                   _gen(), n_slots=2, stats=stats)
    assert len(served) == 6 and all(r is not None for r in served)
    for req, got, want in zip(reqs, served, jax_served[aug_text]):
        _assert_same(got, want)
        _assert_same(got, _single(model, dec, req))
    assert len(stats["prefill_layouts"]) == 6
    assert sorted(stats["out_tokens"]) == list(range(6))
    assert stats["decode_steps"] > 0 and len(stats["done_at"]) == 6


def test_server_reuse_across_runs(models):
    """One ContinuousBatcher serves a second wave of requests (its buffers
    reused), each result equal to ``generate``'s."""
    _, model = models
    dec = _greedy(True)
    reqs = _requests(4)
    server = _server(model, dec)
    first = server.run(reqs[:2], _gen())
    second = server.run(reqs[2:], torch.Generator().manual_seed(1))
    for req, got in zip(reqs, first + second):
        _assert_same(got, _single(model, dec, req))


def _fake_clock(step=0.002):
    """A clock that advances ``step`` seconds at every reading."""
    ticks = itertools.count()
    return lambda: next(ticks) * step


def test_online_serving_matches_single(models):
    """``run_online`` on an injected clock with staggered arrivals and a
    7-step budget (many budget exits and re-admissions): every result equal
    to ``generate``'s, completion times on the arrivals' clock."""
    _, model = models
    dec = _greedy(True)
    reqs = _requests(4)
    arrivals = [0.0, 0.0, 0.01, 0.05]
    results, done_at = _server(model, dec).run_online(
        reqs, arrivals, _gen(), clock=_fake_clock(), chunk_steps=7)
    for req, got, t, arr in zip(reqs, results, done_at, arrivals):
        assert t is not None and t >= arr
        _assert_same(got, _single(model, dec, req))


def test_geometry_rejected(models):
    _, model = models
    server = _server(model, _greedy(False), sx_pad=8, p_pad=32, num_task=1)
    with pytest.raises(ValueError, match="exceeds server geometry"):
        server.run(_requests(1))
    with pytest.raises(ValueError, match="spans"):
        _server(model, _greedy(False), num_task=1).run([_requests(4)[3]])
    x, y, mask = _requests(1)[0]
    with pytest.raises(ValueError, match="text ids out of range"):
        server.validate_request(np.array([CFG.text_vocab_size]), y, mask)


def test_oversized_request_rejected_before_decoding(models):
    """A geometry violation anywhere in the workload fails before any
    decoding starts, and the server stays usable."""
    _, model = models
    dec = _greedy(True)
    ok = _requests(2)
    server = _server(model, dec)
    big_x = np.arange(500) % 30  # beyond sx_pad
    with pytest.raises(ValueError, match="exceeds server geometry"):
        server.run(ok + [(big_x, ok[0][1], ok[0][2])])
    assert not server.state.active.any()  # nothing started
    assert server.state.cache.k.abs().sum() == 0  # nothing decoded
    results = server.run(ok, _gen())
    for req, got in zip(ok, results):
        _assert_same(got, _single(model, dec, req))


def test_eager_prefill_off_matches_on(models):
    """Eager prefill (the next request prefilled before the harvest) changes
    no result and no fill order, offline and online."""
    _, model = models
    dec = _greedy(False)
    reqs = _requests(6)
    off = _server(model, dec).run(reqs, _gen(), eager_prefill=0)
    on = _server(model, dec).run(reqs, _gen(), eager_prefill=2)
    arrivals = [0.0, 0.0, 0.005, 0.005, 0.01, 0.01]
    off_o, _ = _server(model, dec).run_online(
        reqs, arrivals, _gen(), clock=_fake_clock(), chunk_steps=7,
        eager_prefill=0)
    on_o, _ = _server(model, dec).run_online(
        reqs, arrivals, _gen(), clock=_fake_clock(), chunk_steps=7,
        eager_prefill=2)
    for a, b, c, d in zip(off, on, off_o, on_o):
        _assert_same(a, b)
        _assert_same(a, c)
        _assert_same(a, d)


# --------------------------------------------------------- the pipeline

def test_inference_multi_continuous_matches_jax_pipeline(models, tmp_path,
                                                         monkeypatch):
    """Three jobs (a watermarked edit, a TTS job, a two-span edit) through
    the continuous server with two slots, so a lane is refilled: waveforms
    within one 16-bit LSB of the JAX pipeline's ``continuous=True``."""
    from ssr_speech_tpu.inference import pipeline as jpipe
    from ssr_speech_tpu_torch.inference import pipeline as tpipe

    params, model = models
    monkeypatch.setattr(jserve, "serve_requests", functools.partial(
        jserve.serve_requests, dtype_name="float32"))
    (jatok, jttok), (tatok, tttok) = tokenizers()
    paths = write_wavs(tmp_path, [20, 28, 24])
    jobs = [dict(audio_path=paths[0], target_text="hello world",
                 mask_interval=[(5, 12)]),
            dict(audio_path=paths[1], target_text="a new sentence here",
                 mask_interval=[(20, 28)], tts=True),
            dict(audio_path=paths[2], target_text="two spans",
                 mask_interval=[(3, 7), (12, 18)])]
    dec = _dec(aug_text=True, cfg_stride=3, max_gen_per_span=40)
    want = jpipe.inference_multi(params, CFG, dec, PHN2NUM, jttok, jatok, jobs,
                                 use_watermark=True, seed=2, continuous=True,
                                 n_slots=2)
    stats = {}
    got = tpipe.inference_multi(model, TCFG, port_config(dec), PHN2NUM, tttok,
                                tatok, jobs, use_watermark=True, seed=2,
                                continuous=True, n_slots=2, stats=stats)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1] > 0
        assert np.abs(g - np.asarray(w)).max() <= LSB
    assert len(stats["output_frames"]) == 3 and stats["chunks"] >= 2
