"""Greedy decode of the PyTorch port against ``ssr_speech_tpu.inference.decode``.

Both packages run here on the CPU in fp32 with the same parameters (the JAX
init, carried across by ``lm_from_jax``). With top_k = 1 and cfg_pretrained
the token stream is deterministic, so codes and marks must be IDENTICAL.
Cases follow tests/test_lm_torch_parity.py: CFG off/on, cfg_stride 1/3,
two spans, aug_context and stop_repetition.
"""

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import DecodeConfig, tiny_ssr_config
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
from tests.test_torch_hostcopies import port_config

CFG = tiny_ssr_config()
TS = CFG.tokens
TCFG = port_config(CFG)  # the port's own config class, same values


@pytest.fixture(scope="module")
def models():
    params = jssr.init_ssr(jax.random.PRNGKey(0), CFG)
    return params, lm_from_jax(jax.tree.map(np.asarray, params), TCFG)


def _dec(**kw):
    base = dict(top_k=1, top_p=1.0, temperature=1.0, stop_repetition=-1,
                cfg_coef=1.5, cfg_pretrained=True, max_gen_per_span=400,
                length_cap_mult=10)
    base.update(kw)
    return DecodeConfig(**base)


def _both(models, dec, x, y, mask, **kw):
    params, model = models
    want = jdecode.generate(params, CFG, dec, x, y, mask,
                            jax.random.PRNGKey(0), dtype_name="float32", **kw)
    got = tdecode.generate(model, TCFG, port_config(dec), x, y, mask,
                           torch.Generator().manual_seed(0), **kw)
    return want, got


CASES = [
    dict(aug_text=False, cfg_stride=1, mask=[(8, 15)]),
    dict(aug_text=True, cfg_stride=1, mask=[(8, 15)]),
    dict(aug_text=True, cfg_stride=3, mask=[(8, 15)]),
    dict(aug_text=False, cfg_stride=1, mask=[(5, 10), (18, 24)]),
    dict(aug_text=True, cfg_stride=3, mask=[(5, 10), (18, 24)]),
    dict(aug_text=True, cfg_stride=1, mask=[(5, 10), (18, 24)],
         stop_repetition=1, silence_tokens=(3, 7, 11)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items() if k != "silence_tokens"))
def test_greedy_codes_and_marks_identical(models, case):
    case = dict(case)
    mask = case.pop("mask")
    rng = np.random.default_rng(7)
    y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 32))
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(20,))
    want, got = _both(models, _dec(**case), x, y, mask)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]


def test_explicit_uncond_rows_identical(models):
    """CFG without cfg_pretrained: the unconditional text rows are random in
    both packages (different PRNGs), so they are passed explicitly here."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 30))
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(16,))
    uncond_x = rng.integers(0, CFG.n_text_tokens, size=(16,))
    dec = _dec(aug_text=True, cfg_stride=2, cfg_pretrained=False)
    want, got = _both(models, dec, x, y, [(6, 14)], uncond_x=uncond_x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("aug_text", [False, True])
def test_aug_context_identical(models, aug_text):
    rng = np.random.default_rng(11)
    y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 28))
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(18,))
    prompt_y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 12))
    prompt_x = rng.integers(0, CFG.text_vocab_size - 1, size=(9,))
    dec = _dec(aug_text=aug_text, cfg_stride=2, aug_context=True)
    want, got = _both(models, dec, x, y, [(8, 15)], prompt_x=prompt_x,
                      prompt_y=prompt_y)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_generation_reaches_the_length_cap(models):
    """A long mask with a small length cap: the chain must stop on the cap
    (too_long forces EOG) exactly where JAX stops."""
    rng = np.random.default_rng(3)
    y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 40))
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(6,))
    dec = _dec(aug_text=True, cfg_stride=1, length_cap_mult=8)
    want, got = _both(models, dec, x, y, [(10, 40)])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("stop_repetition,temperature", [(2, 1.0), (-1, 0.7),
                                                         (3, 1.3)])
def test_advance_chains_matches_jax(stop_repetition, temperature):
    """One bookkeeping step on hand-made chains that hit every branch: a
    fresh chain, one in the EOG cascade, one finishing a span, one under
    the silence-repetition penalty, and a done chain sitting at the cap."""
    import jax.numpy as jnp

    K, card, num_task, cap = CFG.n_codebooks, TS.cardinality, 2, 10
    silence = (3, 7, 11)
    dec = _dec(stop_repetition=stop_repetition, temperature=temperature,
               silence_tokens=silence, max_gen_per_span=12)
    rng = np.random.default_rng(stop_repetition + 5)
    lg = rng.standard_normal((5, K, card)).astype(np.float32)
    lg[3, 0, 3] = 8.0  # the penalised chain's repeated silence token
    lg[3, 0, 5] = 6.0
    fields = dict(
        y_pos=np.int32(17),
        next_tokens=rng.integers(0, 32, size=(5, K)).astype(np.int32),
        out=rng.integers(0, 32, size=(5, K, cap)).astype(np.int32),
        out_len=np.array([0, 6, 7, 5, cap], np.int32),
        span_idx=np.array([0, 0, 1, 0, 1], np.int32),
        span_end=np.array([[0, 0], [0, 0], [4, 0], [0, 0], [3, 10]], np.int32),
        num_gen=np.array([0, 6, 3, 5, 7], np.int32),
        num_eog=np.array([0, 2, K - 1, 0, 1], np.int32),
        prev_token=np.array([-1, 9, 4, 3, 7], np.int32),
        consec_silence=np.array([0, 1, 0, 4, 2], np.int32),
        num_cfg=np.array([1, 2, 3, 1, 2], np.int32),
        done=np.array([False, False, False, False, True]))
    num_cfg = np.array([2, 3, 1, 2, 2], np.int32)
    kw = dict(num_task=num_task, length_cap=40, n_tasks=num_task)
    sent = np.arange(TS.mts, TS.mts + TS.max_n_spans, dtype=np.int32)

    js = jdecode.ChainState(cache=None, key=None,
                            **{k: jnp.asarray(v) for k, v in fields.items()})
    want = jdecode._advance_chains(
        js, jnp.asarray(lg), jax.random.PRNGKey(0), jnp.asarray(num_cfg),
        ts=TS, sentinel_ids=jnp.asarray(sent), static_ban=jdecode._static_ban(TS),
        silence=jnp.asarray(silence, jnp.int32), dec=dec, **kw)

    ts_fields = {k: torch.from_numpy(np.asarray(v)).long()
                 for k, v in fields.items() if k not in ("y_pos", "done")}
    st = tdecode.ChainState(y_pos=17, done=torch.from_numpy(fields["done"]),
                            **ts_fields)
    got = tdecode._advance_chains(
        st, torch.from_numpy(lg), torch.Generator().manual_seed(0),
        torch.from_numpy(num_cfg).long(), ts=TCFG.tokens,
        sentinel_ids=torch.from_numpy(sent).long(),
        static_ban=tdecode._static_ban(TCFG.tokens, "cpu"),
        silence=torch.tensor(silence), dec=port_config(dec), **kw)
    assert got.y_pos == int(want["y_pos"])
    for key in ("next_tokens", "out", "out_len", "span_idx", "span_end",
                "num_gen", "num_eog", "prev_token", "consec_silence",
                "num_cfg", "done"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(want[key]), err_msg=key)
