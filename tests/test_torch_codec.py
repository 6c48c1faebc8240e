"""The port's codec against ``ssr_speech_tpu.models.codec`` on the CPU (fp32,
same parameters through ``codec_from_jax``): codes bit-identical, waveforms
within MAE 1e-5, on tiny_codec_config() and on the CLI test's codec."""

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import (CodecConfig, RVQConfig, SEANetConfig,
                                   tiny_codec_config)
from ssr_speech_tpu.models.codec import conv as jconv
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu_torch.models.codec import conv as tconv
from ssr_speech_tpu_torch.models.codec import wmencodec as twm
from ssr_speech_tpu_torch.models.from_jax import codec_from_jax
from tests.test_torch_hostcopies import port_config

CLI_CODEC = CodecConfig(  # tests/test_cli_integration.py
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(8, 5, 4, 2), lstm=1, norm="weight_norm",
                        pad_mode="constant"),
    rvq=RVQConfig(dimension=16, n_q=4, bins=32))
CONFIGS = {"tiny": tiny_codec_config(), "cli": CLI_CODEC,
           "tiny_reflect": tiny_codec_config(seanet=SEANetConfig(
               dimension=16, n_filters=4, lstm=2, ratios=(4, 2),
               pad_mode="reflect", n_residual_layers=2))}
MAE = 1e-5


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def codec(request):
    cfg = CONFIGS[request.param]
    params = jwm.init_wmencodec(jax.random.PRNGKey(1), cfg)
    return cfg, params, codec_from_jax(jax.tree.map(np.asarray, params),
                                       port_config(cfg))


def _wav(cfg, frames, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, frames * cfg.hop_length, 1)) * 0.1
            ).astype(np.float32)


def test_encode_codes_identical(codec):
    cfg, params, model = codec
    wav = _wav(cfg, 13)
    codes_j, _, emb_j = jwm.encode(params, wav, cfg)
    codes_t, scale, emb_t = twm.encode(model, torch.from_numpy(wav), model.cfg)
    assert scale is None
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-5)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))


def test_decode_and_wmdecode_waveforms(codec):
    cfg, params, model = codec
    rng = np.random.default_rng(2)
    frames = 11
    # out-of-range ids (an untrained LM's special tokens) are clipped
    codes = rng.integers(0, cfg.rvq.bins + 6, size=(1, cfg.rvq.n_q, frames))
    wav_j = np.asarray(jwm.decode(params, codes, cfg))
    wav_t = twm.decode(model, torch.from_numpy(codes), model.cfg).numpy()
    assert wav_t.shape == wav_j.shape == (1, frames * cfg.hop_length, 1)
    assert np.abs(wav_t - wav_j).mean() <= MAE

    labels = np.zeros((1, frames), np.int32)
    labels[:, 3:7] = 1
    orig = _wav(cfg, frames, seed=3)
    orig[:, 3 * cfg.hop_length:7 * cfg.hop_length] = 0.0
    out_j, mark_j = jwm.wmdecode(params, codes, labels, orig, cfg)
    out_t, mark_t = twm.wmdecode(model, torch.from_numpy(codes),
                                 torch.from_numpy(labels).long(),
                                 torch.from_numpy(orig), model.cfg)
    assert np.abs(out_t.numpy() - np.asarray(out_j)).mean() <= MAE
    np.testing.assert_allclose(mark_t.numpy(), np.asarray(mark_j), atol=1e-4)


def test_detect_watermark_identical(codec):
    cfg, params, model = codec
    wav = _wav(cfg, 9, seed=5)
    want = np.asarray(jwm.detect_watermark(params, wav, cfg))
    got = twm.detect_watermark(model, torch.from_numpy(wav), model.cfg).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length", [3, 7, 40])
def test_reflect_padding_on_short_inputs(length):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 3)).astype(np.float32)
    want = np.asarray(jconv._pad1d(x, 5, 6, "reflect"))
    got = tconv._pad1d(torch.from_numpy(x), 5, 6, "reflect").numpy()
    np.testing.assert_array_equal(got, want)


def test_weight_norm_and_conv_transpose_match():
    key = jax.random.PRNGKey(4)
    p = jconv.init_conv_transpose(key, 8, 6, 5)
    p = dict(p, g=p["g"] * 1.7)  # a gain that differs from ||v||
    pt = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    np.testing.assert_allclose(tconv.conv_weight(pt).numpy(),
                               np.asarray(jconv.conv_weight(p)), rtol=1e-6)
    x = np.random.default_rng(0).standard_normal((1, 9, 6)).astype(np.float32)
    for causal in (False, True):
        want = np.asarray(jconv.conv_transpose1d(p, x, 4, causal=causal))
        got = tconv.conv_transpose1d(pt, torch.from_numpy(x), 4,
                                     causal=causal).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_renormalize_scale_round_trip():
    cfg = tiny_codec_config(renormalize=True)
    params = jwm.init_wmencodec(jax.random.PRNGKey(3), cfg)
    model = codec_from_jax(jax.tree.map(np.asarray, params), port_config(cfg))
    wav = _wav(cfg, 7, seed=8) * 3.0
    codes_j, scale_j, _ = jwm.encode(params, wav, cfg)
    codes_t, scale_t, _ = twm.encode(model, torch.from_numpy(wav), model.cfg)
    np.testing.assert_allclose(scale_t.numpy(), np.asarray(scale_j), rtol=1e-6)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    out_j = np.asarray(jwm.decode(params, codes_j, cfg, scale_j))
    out_t = twm.decode(model, codes_t, model.cfg, scale_t).numpy()
    assert np.abs(out_t - out_j).mean() <= MAE
    causal = tiny_codec_config(renormalize=True, seanet=SEANetConfig(
        dimension=16, n_filters=4, lstm=1, ratios=(4, 2), causal=True))
    with pytest.raises(ValueError):
        twm.preprocess(torch.from_numpy(wav), port_config(causal))
