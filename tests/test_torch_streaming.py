"""The port's streaming (chunked causal) codec against the JAX package's step
functions, on the CPU in fp32 with the same parameters (``codec_from_jax``):
the cases of tests/test_streaming.py. Codes identical, waveforms within MAE
1e-5 (as tests/test_torch_codec.py holds the offline codec), for encode
chunks of 0.1, 0.5 and 2 s of a 10 s waveform, decode chunks of 5, 25 and
100 frames, the live encode-decode loop, the watermark decoder, the masked
interleave of ``LaneDecoder`` with a lane reset; a non-causal config is
refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import CodecConfig, RVQConfig, SEANetConfig
from ssr_speech_tpu.models.codec import quantize as jq
from ssr_speech_tpu.models.codec import seanet as jseanet
from ssr_speech_tpu.models.codec import streaming as jst
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu_torch.models.codec import quantize as tq
from ssr_speech_tpu_torch.models.codec import seanet as tseanet
from ssr_speech_tpu_torch.models.codec import streaming as tst
from ssr_speech_tpu_torch.models.from_jax import codec_from_jax
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_batched_decode import one_torch_thread
from tests.test_torch_hostcopies import port_config

__all__ = ["one_torch_thread"]  # module-scoped fixture, shared

CFG = CodecConfig(  # tests/test_streaming.py
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(8, 5, 4, 2), lstm=2, norm="weight_norm",
                        causal=True, pad_mode="constant",
                        trim_right_ratio=1.0),
    rvq=RVQConfig(dimension=16, n_q=2, bins=17))
TCFG = port_config(CFG)
MAE = 1e-5


@pytest.fixture(scope="module")
def setup():
    """JAX parameters and the port's copy, a seeded 10 s waveform and its
    offline codes."""
    params = jwm.init_wmencodec(jax.random.PRNGKey(0), CFG)
    model = codec_from_jax(jax.tree.map(np.asarray, params), TCFG)
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(1, 10 * CFG.sample_rate, 1)) * 0.1
           ).astype(np.float32)
    emb = jseanet.encode(params["encoder"], wav, CFG.seanet)
    codes = np.array(jq.rvq_encode(params["quantizer"], emb))
    return params, model, wav, codes


def _jax_decode_stream(params, codes, chunk):
    sc = jst.StreamingCodec(params, CFG)
    return np.concatenate(
        [np.asarray(sc.decode_chunk(jnp.asarray(codes[:, :, i:i + chunk])))
         for i in range(0, codes.shape[2], chunk)], axis=1)


def _mae(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).mean())


@pytest.mark.parametrize("chunk_sec", [0.1, 0.5, 2.0])
def test_streaming_encode_matches_jax(setup, chunk_sec):
    """The port's chunks give the JAX stream's codes, which are the offline
    codes."""
    params, model, wav, codes = setup
    C = int(chunk_sec * CFG.sample_rate)
    assert C % CFG.hop_length == 0
    sj = jst.StreamingCodec(params, CFG)
    st = tst.StreamingCodec(model, TCFG)
    got, want = [], []
    for i in range(0, wav.shape[1], C):
        got.append(st.encode_chunk(torch.from_numpy(wav[:, i:i + C])).numpy())
        want.append(np.asarray(sj.encode_chunk(jnp.asarray(wav[:, i:i + C]))))
    got = np.concatenate(got, axis=2)
    np.testing.assert_array_equal(got, np.concatenate(want, axis=2))
    np.testing.assert_array_equal(got, codes)


@pytest.mark.parametrize("chunk_frames", [5, 25, 100])
def test_streaming_decode_matches_jax(setup, chunk_frames):
    """The port's streamed decode against the JAX stream and against the
    port's own offline causal decode."""
    params, model, _, codes = setup
    st = tst.StreamingCodec(model, TCFG)
    got = np.concatenate(
        [st.decode_chunk(torch.from_numpy(codes[:, :, i:i + chunk_frames]))
         .numpy() for i in range(0, codes.shape[2], chunk_frames)], axis=1)
    want = _jax_decode_stream(params, codes, chunk_frames)
    offline = tseanet.decode(model["decoder"], tq.rvq_decode(
        model["quantizer"], torch.from_numpy(codes)), TCFG.seanet).numpy()
    assert got.shape == want.shape == offline.shape
    assert _mae(got, want) <= MAE
    np.testing.assert_allclose(got, offline, atol=2e-6, rtol=1e-5)


def test_streaming_roundtrip_live(setup):
    """Encode a chunk, decode it at once (a real-time client's loop): the
    JAX stream's codes and waveform."""
    params, model, wav, _ = setup
    sj = jst.StreamingCodec(params, CFG)
    st = tst.StreamingCodec(model, TCFG)
    C = CFG.hop_length * 10
    got, want = [], []
    for i in range(0, wav.shape[1], C):
        ck = st.encode_chunk(torch.from_numpy(wav[:, i:i + C]))
        cj = sj.encode_chunk(jnp.asarray(wav[:, i:i + C]))
        np.testing.assert_array_equal(ck.numpy(), np.asarray(cj))
        got.append(st.decode_chunk(ck).numpy())
        want.append(np.asarray(sj.decode_chunk(cj)))
    assert _mae(np.concatenate(got, axis=1), np.concatenate(want, axis=1)) <= MAE


def test_streaming_rejects_non_causal():
    bad = port_config(CodecConfig(
        seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                            ratios=(4, 2), lstm=1, causal=False),
        rvq=RVQConfig(dimension=16, n_q=2, bins=7)))
    with pytest.raises(AssertionError):
        tst.init_encoder_state(bad.seanet)
    with pytest.raises(AssertionError):
        tst.init_decoder_state(bad.seanet)
    with pytest.raises(ValueError, match="causal"):
        tst.LaneDecoder(None, bad, 2)


def test_streaming_wm_decode_matches_jax(setup):
    """The streaming watermark decode (skip-encoder taps, label fusion,
    detector) at 25 frames a chunk against the JAX step function."""
    params, model, wav, codes = setup
    rng = np.random.default_rng(7)
    F = codes.shape[2]
    labels = rng.integers(0, 2, size=(1, F)).astype(np.int32)
    latents = np.array(jq.rvq_decode(params["quantizer"], jnp.asarray(codes)))
    sj = jst.init_wm_decoder_state(CFG.seanet)
    stt = tst.init_wm_decoder_state(TCFG.seanet)
    step = jax.jit(lambda s, z, lab, w: jst.wm_decode_step(
        params["wmdecoder"], s, z, lab, w, CFG.seanet))
    hop, fc = CFG.hop_length, 25
    got_a, got_l, want_a, want_l = [], [], [], []
    with torch.no_grad():
        for i in range(0, F, fc):
            z, lab = latents[:, i:i + fc], labels[:, i:i + fc]
            w = wav[:, i * hop:(i + fc) * hop]
            a, lg, sj = step(sj, jnp.asarray(z), jnp.asarray(lab),
                             jnp.asarray(w))
            want_a.append(np.asarray(a))
            want_l.append(np.asarray(lg))
            a, lg, stt = tst.wm_decode_step(
                model["wmdecoder"], stt, torch.from_numpy(z),
                torch.from_numpy(lab).long(), torch.from_numpy(w),
                TCFG.seanet)
            got_a.append(a.numpy())
            got_l.append(lg.numpy())
    got_a, want_a = np.concatenate(got_a, axis=1), np.concatenate(want_a, axis=1)
    assert got_a.shape == want_a.shape and _mae(got_a, want_a) <= MAE
    np.testing.assert_allclose(np.concatenate(got_l, axis=1),
                               np.concatenate(want_l, axis=1), atol=1e-4)


def test_lane_decoder_masked_interleave_matches_jax(setup):
    """Two desynchronised streams through one batched call, the second
    joining three steps late: each lane's waveform that of JAX's
    ``LaneDecoder`` on the same schedule and of the port's offline decode of
    its codes; a masked step keeps an inactive lane's state bit for bit; a
    lane reset replays a fresh stream."""
    params, model, _, codes = setup
    f = 7
    F = (codes.shape[2] // (2 * f)) * f
    K = codes.shape[1]
    lj = jst.LaneDecoder(params, CFG, n_lanes=2)
    lt = tst.LaneDecoder(model, TCFG, n_lanes=2)
    a, b = codes[0, :, :F], codes[0, :, f:F + f]
    outs = {"a": [], "b": [], "ja": [], "jb": []}
    ia = ib = step = 0
    while ia < F or ib < F:
        batch = np.zeros((2, K, f), np.int32)
        active = np.zeros((2,), bool)
        take_a = ia < F
        take_b = ib < F and step >= 3
        if take_a:
            batch[0], active[0] = a[:, ia:ia + f], True
        if take_b:
            batch[1], active[1] = b[:, ib:ib + f], True
        before = [t.clone() for t in tree_leaves(lt.state)]
        out = lt.step(batch, active).numpy()
        for old, new in zip(before, tree_leaves(lt.state)):
            for lane in (0, 1):
                if not active[lane]:
                    assert torch.equal(old[lane], new[lane])
        jout = np.asarray(lj.step(batch, active))
        if take_a:
            outs["a"].append(out[0])
            outs["ja"].append(jout[0])
            ia += f
        if take_b:
            outs["b"].append(out[1])
            outs["jb"].append(jout[1])
            ib += f
        step += 1
    for lane, seg in (("a", a), ("b", b)):
        got = np.concatenate(outs[lane], axis=0)
        assert _mae(got, np.concatenate(outs["j" + lane], axis=0)) <= MAE
        offline = tseanet.decode(model["decoder"], tq.rvq_decode(
            model["quantizer"], torch.from_numpy(seg[None])),
            TCFG.seanet).numpy()[0]
        np.testing.assert_allclose(got, offline, atol=1e-5, rtol=1e-4)
    lt.reset(np.array([True, False]))
    replay = [lt.step(np.broadcast_to(a[None, :, i:i + f], (2, K, f)).copy(),
                      np.array([True, False])).numpy()[0]
              for i in range(0, F, f)]
    np.testing.assert_allclose(np.concatenate(replay, axis=0),
                               np.concatenate(outs["a"], axis=0), atol=1e-6)


def test_lane_decoder_warm_lane_matches_stepping(setup):
    """``warm_lane`` (the prompt's bulk at batch 1, its state written into
    the lane's row) leaves the lane as stepping the same frames would, and
    the other lane untouched."""
    _, model, _, codes = setup
    K = codes.shape[1]
    warm = tst.LaneDecoder(model, TCFG, n_lanes=2)
    stepped = tst.LaneDecoder(model, TCFG, n_lanes=2)
    before = [t.clone() for t in tree_leaves(warm.state)]
    assert warm.warm_lane(1, codes[0, :, :23], chunk=10) == 20
    for i in range(0, 20, 10):
        batch = np.zeros((2, K, 10), np.int64)
        batch[1] = codes[0, :, i:i + 10]
        stepped.step(batch, np.array([False, True]))
    for w, s, old in zip(tree_leaves(warm.state),
                         tree_leaves(stepped.state), before):
        assert torch.equal(w[0], old[0])
        np.testing.assert_allclose(w[1].numpy(), s[1].numpy(), atol=1e-6)
