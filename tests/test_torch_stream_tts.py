"""Streaming TTS of the PyTorch port against ``ssr_speech_tpu``: the cases of
tests/test_stream_tts.py other than the tensor-parallel one (which waits for
the port's parallelism). Both packages run here on the CPU in fp32 with the
same LM and causal codec parameters, greedy with ``cfg_pretrained``. Each
client's streamed codes must equal JAX's streamer's and the port's offline
generate -> causal decode -> crop, and its waveform lie within MAE 1e-5 of
both (and within the JAX test's own 2e-5 / 1e-4 of the port's offline one),
with the JAX test's emission granularity."""

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import (CodecConfig, DecodeConfig, RVQConfig,
                                   SEANetConfig)
from ssr_speech_tpu.inference import stream as jstream
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.inference import stream as tstream
from ssr_speech_tpu_torch.models.codec import quantize as tq
from ssr_speech_tpu_torch.models.codec import seanet as tseanet
from ssr_speech_tpu_torch.models.from_jax import codec_from_jax
from tests.test_torch_batched_decode import (CFG, TCFG, TS, models,
                                             one_torch_thread)
from tests.test_torch_hostcopies import port_config

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared

CODEC = CodecConfig(  # tests/test_stream_tts.py
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(4, 2), lstm=1, norm="weight_norm",
                        causal=True, pad_mode="constant"),
    rvq=RVQConfig(dimension=16, n_q=CFG.n_codebooks,
                  bins=TS.audio_vocab_size))
TCODEC = port_config(CODEC)
MAE = 1e-5


@pytest.fixture(scope="module")
def codecs():
    params = jwm.init_wmencodec(jax.random.PRNGKey(1), CODEC)
    return params, codec_from_jax(jax.tree.map(np.asarray, params), TCODEC)


def _dec(**kw):
    base = dict(top_k=1, top_p=1.0, stop_repetition=-1, cfg_coef=1.5,
                cfg_stride=2, aug_text=True, cfg_pretrained=True,
                max_gen_per_span=80, length_cap_mult=10)
    base.update(kw)
    return DecodeConfig(**base)


def _reqs(seed, shapes):
    rng = np.random.default_rng(seed)
    out = []
    for T, sx in shapes:
        y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, T))
        x = rng.integers(0, CFG.text_vocab_size - 1, size=(sx,))
        out.append((x, y))
    return out


def _offline(model, codec, dec, x, y):
    """The port's offline TTS: generate, causal decode, crop at the prompt
    boundary. Returns (codes [K, F], wav [F*hop, 1])."""
    T = y.shape[1]
    codes, _, out_iv, _ = tdecode.generate(
        model, TCFG, port_config(dec), x, y, [(T, T)],
        torch.Generator().manual_seed(0))
    s = out_iv[0][1] if T else 0
    e = out_iv[1][0] if len(out_iv) > 1 else codes.shape[2]
    with torch.no_grad():
        full = tseanet.decode(codec["decoder"], tq.rvq_decode(
            codec["quantizer"], torch.from_numpy(codes[:1]).long()),
            TCODEC.seanet).numpy()
    hop = CODEC.hop_length
    return codes[0][:, s:e], full[0, s * hop:e * hop]


def _check(got, want_jax, offline):
    (codes, wav), (jcodes, jwav), (ocodes, owav) = got, want_jax, offline
    np.testing.assert_array_equal(codes, np.asarray(jcodes))
    np.testing.assert_array_equal(codes, ocodes)
    assert wav.shape == np.asarray(jwav).shape == owav.shape
    assert np.abs(wav - np.asarray(jwav)).mean() <= MAE
    assert np.abs(wav - owav).mean() <= MAE
    np.testing.assert_allclose(wav, owav, atol=2e-5, rtol=1e-4)


def _cat(chunks):
    return (np.concatenate([c for c, _ in chunks], axis=1),
            np.concatenate([w for _, w in chunks], axis=0))


@pytest.mark.parametrize("chunk_frames", [5, 16])
def test_stream_tts_matches_jax_and_offline(models, codecs, chunk_frames):
    """``TTSStreamer``: the small first chunk, fixed-size chunks after it,
    the concatenation equal to JAX's streamer's and to the port's
    offline TTS."""
    params, model = models
    jcodec, tcodec = codecs
    (x, y), = _reqs(3, [(24, 40)])
    dec = _dec()
    geom = dict(chunk_frames=chunk_frames, sx_pad=64, p_pad=64)
    chunks = list(tstream.TTSStreamer(
        model, TCFG, port_config(dec), tcodec, TCODEC, **geom).stream(
            x, y, torch.Generator().manual_seed(0)))
    want = list(jstream.TTSStreamer(
        params, CFG, dec, jcodec, CODEC, dtype_name="float32", **geom).stream(
            x, y, jax.random.PRNGKey(0)))
    assert [c.shape for c, _ in chunks] == [c.shape for c, _ in want]
    assert chunks[0][0].shape[1] == max(chunk_frames // 2, 1)
    for c, w in chunks[1:-1]:
        assert c.shape[1] == chunk_frames
        assert w.shape[0] == chunk_frames * CODEC.hop_length
    _check(_cat(chunks), _cat(want), _offline(model, tcodec, dec, x, y))


def test_stream_tts_rejects_non_causal(models, codecs):
    _, model = models
    bad = port_config(CodecConfig(
        seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                            ratios=(4, 2), lstm=1, causal=False),
        rvq=RVQConfig(dimension=16, n_q=CFG.n_codebooks,
                      bins=TS.audio_vocab_size)))
    with pytest.raises(ValueError, match="causal"):
        tstream.TTSStreamer(model, TCFG, port_config(DecodeConfig()),
                            codecs[1], bad)
    with pytest.raises(ValueError, match="causal"):
        tstream.StreamingServer(model, TCFG, port_config(DecodeConfig()),
                                codecs[1], bad, 2)


def _servers(models, codecs, dec, **kw):
    params, model = models
    jcodec, tcodec = codecs
    geom = dict(sx_pad=64, p_pad=64)
    geom.update(kw)
    return (tstream.StreamingServer(model, TCFG, port_config(dec), tcodec,
                                    TCODEC, 2, **geom),
            jstream.StreamingServer(params, CFG, dec, jcodec, CODEC, 2,
                                    dtype_name="float32", **geom))


def test_streaming_server_matches_jax_and_offline(models, codecs):
    """3 concurrent clients through 2 lanes (the third refills a finished
    lane): each client's stream equals JAX's and its own offline TTS; first
    audio strictly before completion; ``on_chunk`` in steps of
    ``chunk_frames // 2`` frames after a first chunk that shares a step with
    the prompt's tail."""
    _, model = models
    dec = _dec()
    reqs = _reqs(11, [(24, 40), (17, 28), (30, 36)])
    F = 10
    tsrv, jsrv = _servers(models, codecs, dec, chunk_frames=F, warm_chunk=8)
    emitted = []
    results, first_at, done_at = tsrv.run_online(
        reqs, [0.0] * 3, on_chunk=lambda i, c, w, t: emitted.append((i, c)),
        generator=torch.Generator().manual_seed(0))
    want, _, _ = jsrv.run_online(reqs, [0.0] * 3, rng=jax.random.PRNGKey(0))
    f = F // 2
    for i, (x, y) in enumerate(reqs):
        _check(results[i], want[i], _offline(model, codecs[1], dec, x, y))
        assert first_at[i] is not None and first_at[i] < done_at[i]
        mine = [c for j, c in emitted if j == i]
        d = y.shape[1] - (y.shape[1] // 8) * 8  # prompt tail after the warm
        first_expect = f - (d % f) if d % f else f
        n = results[i][0].shape[1]
        assert mine[0].shape[1] == min(first_expect, n)
        assert all(c.shape[1] == f for c in mine[1:-1])
        assert sum(c.shape[1] for c in mine) == n


def test_streaming_server_rejects_tiny_chunk(models, codecs):
    _, model = models
    with pytest.raises(ValueError, match="chunk_frames"):
        tstream.StreamingServer(model, TCFG, port_config(DecodeConfig()),
                                codecs[1], TCODEC, 2,
                                chunk_frames=2 * CFG.n_codebooks)


def test_streaming_server_eager_prefill_parity(models, codecs):
    """Eager prefill changes no stream: the same codes and waveforms with
    ``eager_prefill`` 0 and 1, arrivals staggered on an injected clock."""
    dec = _dec(cfg_coef=1.0, cfg_stride=1, aug_text=False,
               max_gen_per_span=60)
    reqs = _reqs(13, [(16, 24), (24, 30), (20, 26), (18, 22)])
    clock = iter(np.arange(0, 1e6, 0.001))

    def run(eager):
        tsrv, _ = _servers(models, codecs, dec, chunk_frames=10, warm_chunk=8)
        return tsrv.run_online(reqs, [0.0, 0.0, 0.01, 0.01],
                               generator=torch.Generator().manual_seed(0),
                               clock=lambda: next(clock),
                               eager_prefill=eager)[0]

    for (c0, w0), (c1, w1) in zip(run(0), run(1)):
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_allclose(w0, w1, atol=1e-6)


def test_streaming_server_empty_prompt(models, codecs):
    """A zero-frame prompt (the target replaces everything) streams and
    equals JAX's and the offline TTS."""
    _, model = models
    dec = _dec(max_gen_per_span=60)
    (x, _), = _reqs(21, [(1, 40)])
    y0 = np.zeros((CFG.n_codebooks, 0), np.int32)
    tsrv, jsrv = _servers(models, codecs, dec, chunk_frames=16)
    results, first_at, _ = tsrv.run_online(
        [(x, y0)], [0.0], generator=torch.Generator().manual_seed(5))
    want, _, _ = jsrv.run_online([(x, y0)], [0.0], rng=jax.random.PRNGKey(5))
    assert results[0][0].shape[1] > 0 and first_at[0] is not None
    _check(results[0], want[0], _offline(model, codecs[1], dec, x, y0))
