"""Multi-prompt decode of the PyTorch port against ``ssr_speech_tpu``.

Both packages run here on the CPU in fp32 with the same parameters, as in
tests/test_torch_batched_decode.py. Covered: the multi-prompt prefill
(``_prefill_multi_impl``: ragged text and prefix lengths, a segment id a row
through the flash wrapper) against JAX's, ``generate_multi`` greedy against
JAX's ``generate_multi`` (the cases of tests/test_multi_prompt.py and
tests/test_aug_context_paths.py: CFG off and on, mixed span counts, the
aug_context 5-tuples) and against the port's own ``generate``,
``inference_multi`` against the JAX pipeline (waveforms within one 16-bit
LSB, one batch and more jobs than slots).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu_torch.inference import decode as tdecode
from tests.test_torch_batched_decode import (CFG, LSB, PHN2NUM, TCFG, TS,
                                             _assert_same, _dec, models,
                                             one_torch_thread, tokenizers,
                                             write_wavs)
from tests.test_torch_hostcopies import port_config

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared


def _prompts(seed, shapes):
    rng = np.random.default_rng(seed)
    out = []
    for T, sx, mask in shapes:
        y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, T))
        x = rng.integers(0, CFG.text_vocab_size - 1, size=(sx,))
        out.append((x, y, mask))
    return out


THREE = [(30, 20, [(8, 15)]), (24, 14, [(5, 12)]), (36, 25, [(20, 30)])]
MIXED = [(22, 18, [(22, 22)]), (34, 24, [(5, 10), (18, 25)]),
         (28, 15, [(10, 16)])]


@pytest.mark.parametrize("aug_text,cfg_pretrained", [(False, True),
                                                     (True, True),
                                                     (True, False)])
def test_prefill_multi_matches_jax(models, aug_text, cfg_pretrained):
    """Three prompts with ragged text (20, 14, 25) and prefix lengths: the
    cache's K/V at every live (attended) position within 1e-5 of JAX's, and
    the bool key ban identical."""
    params, model = models
    prompts = _prompts(21, THREE)
    prefixes = [jdecode.patterns.build_inference_prefix(y, m, TS)[0]
                for _, y, m in prompts]
    S, K = len(prompts), CFG.n_codebooks
    sx, P = 64, 128
    y_prefix = np.full((S, K, P), TS.empty, np.int32)
    p_lens = np.array([p.shape[1] for p in prefixes], np.int32)
    for i, p in enumerate(prefixes):
        y_prefix[i, :, :p.shape[1]] = p
    dec = _dec(aug_text=aug_text, cfg_pretrained=cfg_pretrained)
    uncond = (None if not aug_text or cfg_pretrained else
              [np.random.default_rng(3).integers(0, CFG.n_text_tokens, size=(30,))
               for _ in prompts])
    xb, x_lens = tdecode.build_text_rows([x for x, _, _ in prompts], sx,
                                         port_config(CFG), port_config(dec),
                                         None, uncond_xs=uncond)
    tmax = 256
    want, want_ban = jdecode._prefill_multi_impl(
        params, jnp.asarray(xb, jnp.int32), jnp.asarray(y_prefix),
        jnp.asarray(x_lens, jnp.int32), jnp.asarray(p_lens), cfg=CFG,
        tmax=tmax, dtype_name="float32", cfg_pretrained=cfg_pretrained,
        aug_text=aug_text)
    got, got_ban = tdecode._prefill_multi_impl(
        model, torch.from_numpy(xb), torch.from_numpy(y_prefix).long(),
        torch.from_numpy(x_lens), torch.from_numpy(p_lens).long(), cfg=TCFG,
        tmax=tmax, dtype=torch.float32, cfg_pretrained=cfg_pretrained,
        aug_text=aug_text)
    np.testing.assert_array_equal(got_ban.numpy(), np.asarray(want_ban))
    assert got.length == int(want.length) == sx + P
    live = ~got_ban.numpy()  # [R, tmax]
    assert live.sum() > 0
    for name in ("k", "v"):
        g = getattr(got, name).numpy().transpose(1, 3, 0, 2, 4)[live]
        w = np.asarray(getattr(want, name)).transpose(1, 3, 0, 2, 4)[live]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


def _check_multi(models, dec, prompts):
    params, model = models
    want = jdecode.generate_multi(params, CFG, dec, prompts,
                                  jax.random.PRNGKey(0), dtype_name="float32")
    stats = {}
    got = tdecode.generate_multi(model, TCFG, port_config(dec), prompts,
                                 torch.Generator().manual_seed(0), stats=stats)
    assert len(got) == len(want) == len(prompts)
    for p, g, w in zip(prompts, got, want):
        _assert_same(g, w)
        x, y, mask = p[:3]
        kw = dict(prompt_x=p[3], prompt_y=p[4]) if len(p) == 5 else {}
        _assert_same(g, tdecode.generate(model, TCFG, port_config(dec), x, y,
                                         mask, torch.Generator().manual_seed(0),
                                         **kw))
    assert len(stats["p_lens"]) == len(prompts)
    return stats


@pytest.mark.parametrize("aug_text", [False, True])
def test_generate_multi_greedy_identical(models, aug_text):
    _check_multi(models, _dec(aug_text=aug_text), _prompts(21, THREE))


@pytest.mark.parametrize("aug_text", [False, True])
def test_generate_multi_mixed_span_counts_identical(models, aug_text):
    """A 1-span TTS-style job, a 2-span edit and a 1-span edit in one loop:
    each chain stops after its own span count."""
    stats = _check_multi(models, _dec(aug_text=aug_text), _prompts(33, MIXED))
    assert stats["decode_steps"] > 0


def test_generate_multi_aug_context_identical(models):
    """5-tuple prompts: the 7-frame span takes the context prepend, the
    24-frame one does not (the prepend needs less than 2 s masked)."""
    rng = np.random.default_rng(11)
    prompts = []
    for mask in ([(8, 15)], [(2, 26)]):
        y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 28))
        x = rng.integers(0, CFG.text_vocab_size - 1, size=(18,))
        prompt_y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 12))
        prompt_x = rng.integers(0, CFG.text_vocab_size - 1, size=(9,))
        prompts.append((x, y, mask, prompt_x, prompt_y))
    _check_multi(models, _dec(aug_text=True, aug_context=True), prompts)


# --------------------------------------------------------- the pipeline

@pytest.mark.parametrize("n_slots", [8, 2])
def test_inference_multi_matches_jax_pipeline(models, tmp_path, monkeypatch,
                                              n_slots):
    """Three jobs (an edit with the watermark, a TTS job, a two-span edit):
    one batch, and with two slots two static batches by text length."""
    from ssr_speech_tpu.inference import pipeline as jpipe
    from ssr_speech_tpu_torch.inference import pipeline as tpipe

    params, model = models
    monkeypatch.setattr(jdecode, "generate_multi", functools.partial(
        jdecode.generate_multi, dtype_name="float32"))
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
                                 use_watermark=True, seed=2, n_slots=n_slots)
    got = tpipe.inference_multi(model, TCFG, port_config(dec), PHN2NUM, tttok,
                                tatok, jobs, use_watermark=True, seed=2,
                                n_slots=n_slots)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1] > 0
        assert np.abs(g - np.asarray(w)).max() <= LSB

