"""The codec-training primitives of the port against the JAX package on the
CPU in fp32: the STFT, the mel filterbank and spectrogram, every loss of
``training/losses.py`` (value, and gradient on the generator output for the
ones the balancer takes), the balancer's cotangent, EMA and count over two
updates, SI-SNR, the watermark-span sampler and the RVQ forward.

Tolerances: 1e-5 relative (to the largest element of the reference) for
values and gradients; the sampler and the RVQ codes must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import RVQConfig
from ssr_speech_tpu.models.codec import quantize as jq
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.ops import stft as jstft
from ssr_speech_tpu.training import losses as jL
from ssr_speech_tpu.utils import metrics as jmetrics
from ssr_speech_tpu_torch.models.codec import quantize as tq
from ssr_speech_tpu_torch.models.codec import wmencodec as twm
from ssr_speech_tpu_torch.ops import stft as tstft
from ssr_speech_tpu_torch.training import losses as tL
from ssr_speech_tpu_torch.utils import metrics as tmetrics

REL = 1e-5
SR = 16000


def _wav(shape, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n_fft,hop,win,normalized", [
    (128, 32, None, False), (256, 64, 200, True), (512, 128, None, True)])
def test_stft_matches(n_fft, hop, win, normalized):
    x = _wav((2, 3, 1900), 0)
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, win, normalized))
    got = tstft.stft(_t(x), n_fft, hop, win, normalized)
    assert got.shape == want.shape and got.dtype == torch.complex64
    _close(got.real, want.real)
    _close(got.imag, want.imag)
    np.testing.assert_array_equal(tstft.hann_window(n_fft),
                                  jstft.hann_window(n_fft))


def test_stft_shorter_than_a_frame_is_empty():
    x = _wav((2, 100), 1)
    assert tstft.stft(_t(x), 128, 32).shape == (2, 65, 0)
    assert jstft.stft(jnp.asarray(x), 128, 32).shape == (2, 65, 0)


@pytest.mark.parametrize("sr,n_fft,n_mels,f_min,f_max", [
    (16000, 512, 64, 64.0, None), (16000, 64, 64, 64.0, None),
    (24000, 1024, 80, 0.0, 8000.0)])
def test_mel_filterbank_identical(sr, n_fft, n_mels, f_min, f_max):
    np.testing.assert_array_equal(
        tstft.mel_filterbank(sr, n_fft, n_mels, f_min, f_max),
        jstft.mel_filterbank(sr, n_fft, n_mels, f_min, f_max))


@pytest.mark.parametrize("shape,log,normalized", [
    ((2, 2048), True, False), ((2, 2100, 1), False, True),
    ((1, 3000, 2), True, True)])
def test_mel_spectrogram_matches(shape, log, normalized):
    x = _wav(shape, 2)
    args = (SR, 512, 128, 512, 32, 64.0, None, log, normalized)
    want = jstft.mel_spectrogram(jnp.asarray(x), *args)
    _close(tstft.mel_spectrogram(_t(x), *args), want)


def _loss_pair(name):
    """(jax fn, port fn) of (y_pred, x) -> scalar."""
    j, t = jL, tL
    small = dict(range_start=6, range_end=9)
    return {
        "l1": (j.l1_loss, t.l1_loss),
        "l2": (j.l2_loss, t.l2_loss),
        "mel": (lambda a, b: j.mel_l1_loss(a, b, SR),
                lambda a, b: t.mel_l1_loss(a, b, SR)),
        "msspec": (lambda a, b: j.multiscale_mel_loss(a, b, SR),
                   lambda a, b: t.multiscale_mel_loss(a, b, SR)),
        "msspec_alphas": (
            lambda a, b: j.multiscale_mel_loss(a, b, SR, alphas=True,
                                               normalized=False, **small),
            lambda a, b: t.multiscale_mel_loss(a, b, SR, alphas=True,
                                               normalized=False, **small)),
        "mstft": (j.mrstft_loss, t.mrstft_loss),
    }[name]


@pytest.mark.parametrize("name", ["l1", "l2", "mel", "msspec", "msspec_alphas",
                                  "mstft"])
def test_reconstruction_loss_and_output_grad_match(name):
    yp, x = _wav((2, 4800, 1), 3), _wav((2, 4800, 1), 4)
    jfn, tfn = _loss_pair(name)
    want, jg = jax.value_and_grad(jfn)(jnp.asarray(yp), jnp.asarray(x))
    ypt = _t(yp).requires_grad_(True)
    got = tfn(ypt, _t(x))
    (tg,) = torch.autograd.grad(got, ypt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=REL)
    _close(tg, jg)


def test_adversarial_feature_matching_and_ce_match():
    logits = _wav((3, 17, 5), 5, scale=2.0)
    for fn in ("hinge_gen_loss", "hinge_real_loss", "hinge_fake_loss",
               "mse_gen_loss", "mse_real_loss", "mse_fake_loss"):
        want = getattr(jL, fn)(jnp.asarray(logits))
        got = getattr(tL, fn)(_t(logits))
        np.testing.assert_allclose(float(got), float(want), rtol=REL,
                                   err_msg=fn)
    ff = [_wav((2, 4, 9, 3), s) for s in (6, 7)]
    fr = [_wav((2, 4, 9, 3), s) for s in (8, 9)]
    for dt in (jnp.float32, jnp.bfloat16):
        want = jL.feature_matching_loss([jnp.asarray(a).astype(dt) for a in ff],
                                        [jnp.asarray(a).astype(dt) for a in fr])
        tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
        got = tL.feature_matching_loss([_t(a).to(tdt) for a in ff],
                                       [_t(a).to(tdt) for a in fr])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=REL)
    assert float(tL.feature_matching_loss([], [])) == 0.0
    logits = _wav((2, 7, 2), 10, scale=3.0)
    labels = np.random.default_rng(1).integers(0, 2, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        float(tL.cross_entropy(_t(logits), _t(labels))),
        float(jL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=REL)


@pytest.mark.parametrize("per_batch_item,ema_decay", [(True, 0.999),
                                                      (False, 0.5)])
def test_balancer_cotangent_over_two_updates(per_batch_item, ema_decay):
    names = ["adv", "feat", "l1", "msspec"]
    weights = dict(adv=4.0, feat=4.0, l1=0.1, msspec=2.0)
    js, ts = jL.init_balancer(names), tL.init_balancer(names)
    for step in range(2):
        grads = {n: _wav((2, 640, 1), 20 + 4 * step + i, scale=10.0 ** -i)
                 for i, n in enumerate(names)}
        losses = {n: np.float32(0.5 + i + step) for i, n in enumerate(names)}
        kw = dict(per_batch_item=per_batch_item, ema_decay=ema_decay)
        cot_j, js, eff_j = jL.balancer_cotangent(
            js, {k: jnp.asarray(v) for k, v in grads.items()}, weights,
            {k: jnp.asarray(v) for k, v in losses.items()}, **kw)
        cot_t, ts, eff_t = tL.balancer_cotangent(
            ts, {k: _t(v) for k, v in grads.items()}, weights,
            {k: torch.tensor(v) for k, v in losses.items()}, **kw)
        _close(cot_t, cot_j)
        np.testing.assert_allclose(float(eff_t), float(eff_j), rtol=REL)
        for n in names:
            np.testing.assert_allclose(float(ts.ema[n]), float(js.ema[n]),
                                       rtol=REL, err_msg=n)
        assert float(ts.count) == float(js.count) == step + 1


def test_si_snr_matches():
    ref = _wav((3, 2000, 1), 11)
    est = ref + _wav((3, 2000, 1), 12, scale=0.03)
    want = jmetrics.si_snr(jnp.asarray(est), jnp.asarray(ref))
    _close(tmetrics.si_snr(_t(est), _t(ref)), want)
    _close(tmetrics.si_snr(_t(est[..., 0]), _t(ref[..., 0])), want)


@pytest.mark.parametrize("min_regions,max_regions,frames", [
    (0, 2, 20), (1, 2, 100), (2, 5, 37)])
def test_watermark_mask_identical(min_regions, max_regions, frames):
    for seed in range(4):
        want = jwm.sample_watermark_mask(np.random.default_rng(seed), 5, frames,
                                         320, min_regions, max_regions)
        got = twm.sample_watermark_mask(np.random.default_rng(seed), 5, frames,
                                        320, min_regions, max_regions)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_rvq_quantize_and_dropout_match():
    cfg = RVQConfig(dimension=16, n_q=3, bins=11)
    params = jq.init_rvq(jax.random.PRNGKey(0), cfg)
    tparams = {"embed": _t(params["embed"])}
    emb = _wav((2, 9, 16), 13, scale=1.0)
    want_q, want_codes = jq.rvq_quantize(params, jnp.asarray(emb))
    got_q, got_codes = tq.rvq_quantize(tparams, _t(emb))
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    _close(got_q, want_q)
    # dropout: each JAX draw's n_q fixed on the port's side
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        n_q = int(jax.random.randint(key, (), 1, cfg.n_q + 1))
        want_q, want_codes = jq.rvq_quantize_dropout(params, jnp.asarray(emb),
                                                     key)
        got_q, got_codes = tq.rvq_quantize_dropout(tparams, _t(emb), None,
                                                   n_q=n_q)
        np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
        _close(got_q, want_q)
    # the port's own draw: n_q in [1, n_q] from the generator, repeatable
    gen = torch.Generator().manual_seed(0)
    outs = {tuple(tq.rvq_quantize_dropout(tparams, _t(emb), gen)[0].flatten()
                  [:4].tolist()) for _ in range(12)}
    assert 1 < len(outs) <= cfg.n_q
    a = tq.rvq_quantize_dropout(tparams, _t(emb),
                                torch.Generator().manual_seed(3))[0]
    b = tq.rvq_quantize_dropout(tparams, _t(emb),
                                torch.Generator().manual_seed(3))[0]
    assert torch.equal(a, b)
