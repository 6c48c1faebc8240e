"""Tensor-parallel serving of the port on the CPU: parameters from
``parallel.mesh.shard_params_for_serving`` over 2 and 4 spawned ranks
(gloo), fp32, local-head K/V caches and two all-reduces a layer.

- greedy ``generate`` (CFG-pretrained, so nothing is drawn) at tp 2 and 4,
  and at tp 2 with fsdp layer stacks over dp 2:
  codes and marks identical to JAX's ``generate`` (JAX's own tp test holds
  its sharded decode bit-exact to its single-device one);
- sampled (CFG, top-k/top-p, two spans), seed-batched, multi-prompt,
  continuous-batching and streamed runs at tp 2: identical to the port's
  one-process runs with the same torch generator (streamed waveforms within
  1e-6); rank 0 alone returns the served and streamed results."""

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import DecodeConfig
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.inference import serve as tserve
from ssr_speech_tpu_torch.inference import stream as tstream
from ssr_speech_tpu_torch.models.from_jax import codec_from_jax
from ssr_speech_tpu_torch.parallel.dist import spawn
from tests import torch_parallel_ranks as ranks
from tests.test_torch_batched_decode import (CFG, TCFG, _dec, models,
                                             one_torch_thread)
from tests.test_torch_hostcopies import port_config
from tests.test_torch_serving import _requests
from tests.test_torch_stream_tts import CODEC, TCODEC, _reqs
from tests.test_torch_stream_tts import _dec as _stream_dec

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared


def _prompt():
    rng = np.random.default_rng(0)
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(24,))
    y = rng.integers(0, CFG.tokens.audio_vocab_size, size=(CFG.n_codebooks, 40))
    return x, y


# greedy with cfg_pretrained: no draw at all, so JAX's key and the port's
# generator give the same codes (tests/test_torch_decode.py)
GREEDY = _dec(max_gen_per_span=64)
SAMPLED = DecodeConfig(top_k=5, top_p=0.8, temperature=1.0, aug_text=True,
                       cfg_coef=1.5, cfg_stride=3, cfg_pretrained=True,
                       stop_repetition=2, max_gen_per_span=48)
BATCHED = DecodeConfig(top_k=4, top_p=0.0, stop_repetition=-1,
                       max_gen_per_span=40)
SERVED = DecodeConfig(top_k=1, top_p=1.0, temperature=1.0, stop_repetition=-1,
                      cfg_coef=1.5, cfg_stride=2, cfg_pretrained=True,
                      aug_text=True, max_gen_per_span=120, length_cap_mult=10)


def _multi_prompts():
    x, y = _prompt()
    rng = np.random.default_rng(7)
    x2 = rng.integers(0, CFG.text_vocab_size - 1, size=(17,))
    y2 = rng.integers(0, CFG.tokens.audio_vocab_size, size=(CFG.n_codebooks, 31))
    return [(x, y, [(10, 20)]), (x2, y2, [(4, 9)])]


def _cases(tp):
    x, y = _prompt()
    cases = [("greedy", "generate", (port_config(GREEDY), x, y, [(10, 20)]))]
    if tp == 2:
        cases += [
            ("sampled", "generate", (port_config(SAMPLED), x, y,
                                     [(5, 12), (20, 28)])),
            ("batch", "generate_batch", (port_config(BATCHED), x, y,
                                         [(10, 20)], 4)),
            ("multi", "generate_multi", (port_config(BATCHED),
                                         _multi_prompts())),
            ("serve", "serve", (port_config(SERVED), _requests(4), 2)),
            ("stream", "stream", (port_config(_stream_dec()),
                                  _reqs(11, [(24, 40), (17, 28), (30, 36)]),
                                  dict(sx_pad=64, p_pad=64, chunk_frames=10,
                                       warm_chunk=8)))]
    return cases


@pytest.fixture(scope="module")
def codec_np():
    return jax.tree.map(np.asarray, jwm.init_wmencodec(jax.random.PRNGKey(1),
                                                       CODEC))


@pytest.fixture(scope="module")
def tp_runs(models, codec_np):
    params, _ = models
    params = jax.tree.map(np.asarray, params)
    runs = {2: spawn(ranks.tp_serving, 2, args=(
        params, TCFG, [(None, False, _cases(2))], codec_np, TCODEC))}
    four = spawn(ranks.tp_serving, 4, args=(  # tp 4, then fsdp over tp 2
        params, TCFG, [(None, False, _cases(4)), (2, True, _cases(4))]))
    runs[4] = [r[0] for r in four]
    runs["fsdp"] = [r[1] for r in four]
    runs[2] = [r[0] for r in runs[2]]
    return runs


def _same(got, want):
    codes, marks, iv, nm = got
    np.testing.assert_array_equal(codes, np.asarray(want[0]))
    np.testing.assert_array_equal(marks, np.asarray(want[1]))
    assert iv == want[2] and nm == want[3]


@pytest.mark.parametrize("tp", [2, 4, "fsdp"])
def test_tp_greedy_codes_equal_jax(models, tp_runs, tp):
    """tp 2, tp 4, and dp 2 x tp 2 with the layer stacks shared out over dp
    (each layer broadcast from its owner at every step)."""
    params, _ = models
    x, y = _prompt()
    want = jdecode.generate(params, CFG, GREEDY, x, y, [(10, 20)],
                            jax.random.PRNGKey(3), dtype_name="float32")
    for r in tp_runs[tp]:
        _same(r["greedy"], want)


def _one(models, name):
    _, model = models
    gen = torch.Generator().manual_seed(0)
    kind, args = {c[0]: c[1:] for c in _cases(2)}[name]
    if kind == "generate":
        return tdecode.generate(model, TCFG, *args, gen)
    if kind == "generate_batch":
        dec, x, y, mask, n = args
        return tdecode.generate_batch(model, TCFG, dec, x, y, mask, gen,
                                      n_samples=n)
    if kind == "generate_multi":
        return tdecode.generate_multi(model, TCFG, *args, gen)
    if kind == "serve":
        dec, reqs, n_slots = args
        return tserve.serve_requests(model, TCFG, dec, reqs, gen,
                                     n_slots=n_slots)
    raise ValueError(kind)


@pytest.mark.parametrize("name", ["sampled", "batch", "multi", "serve"])
def test_tp2_runs_equal_the_one_process_runs(models, tp_runs, name):
    want = _one(models, name)
    if name == "sampled":
        want = [want]
        got_of = lambda r: [r[name]]  # noqa: E731
    else:
        got_of = lambda r: r[name]  # noqa: E731
    for rank, r in enumerate(tp_runs[2]):
        if name == "serve" and rank > 0:
            assert r[name] is None  # rank 0 alone returns served results
            continue
        assert len(got_of(r)) == len(want)
        for g, w in zip(got_of(r), want):
            _same(g, w)


def test_tp2_streaming_server_equals_one_process(models, codec_np, tp_runs):
    _, model = models
    dec, reqs, geom = {c[0]: c[2] for c in _cases(2)}["stream"]
    srv = tstream.StreamingServer(model, TCFG, dec, codec_from_jax(codec_np, TCODEC),
                                  TCODEC, 2, **geom)
    want, _, _ = srv.run_online(reqs, [0.0, 0.0, 0.01],
                                generator=torch.Generator().manual_seed(0))
    got = tp_runs[2][0]["stream"]
    assert tp_runs[2][1]["stream"] is None
    for (c, w), (wc, ww) in zip(got, want):
        np.testing.assert_array_equal(c, wc)
        np.testing.assert_allclose(w, ww, atol=1e-6, rtol=0)
