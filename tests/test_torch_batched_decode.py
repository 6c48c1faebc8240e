"""Seed-batched decode of the PyTorch port against ``ssr_speech_tpu``.

Both packages run here on the CPU in fp32 with the same parameters (the JAX
init, carried across by ``lm_from_jax``), as in tests/test_torch_decode.py.
Covered: the shared-prompt decode step (``transformer_decode_step_shared``)
in both forms of its key ban, ``_advance_chains`` on vector chain state,
``generate_batch`` greedy (identical codes, marks and intervals to JAX's
``generate_batch`` and to the port's own ``generate``; the cases of
tests/test_batched_decode.py and tests/test_aug_context_paths.py), sampled
chains that differ, and ``inference_batch`` against the JAX pipeline on tiny
codec bundles (waveforms within one 16-bit LSB).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import (CodecConfig, DecodeConfig, RVQConfig,
                                   SEANetConfig, tiny_ssr_config)
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.models import transformer as jtrf
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.models import transformer as ttrf
from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
from tests.test_torch_hostcopies import port_config

CFG = tiny_ssr_config()
TS = CFG.tokens
TCFG = port_config(CFG)  # the port's own config class, same values
LSB = 1.0 / 32768


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The decode loops run thousands of tiny ops, which one intra-op thread
    runs faster, and parallel test workers then do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    params = jssr.init_ssr(jax.random.PRNGKey(0), CFG)
    return params, lm_from_jax(jax.tree.map(np.asarray, params), TCFG)


def _dec(**kw):
    base = dict(top_k=1, top_p=1.0, temperature=1.0, stop_repetition=-1,
                cfg_coef=1.5, cfg_stride=2, cfg_pretrained=True,
                max_gen_per_span=120, length_cap_mult=10)
    base.update(kw)
    return DecodeConfig(**base)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]


# ------------------------------------------------------- the shared step

@pytest.mark.parametrize("ban", ["range", "bool"])
@pytest.mark.parametrize("S", [1, 3])
def test_decode_step_shared_matches_jax(models, S, ban):
    """One step of 2 groups x S chains over a prefix cache of 40 filled
    slots of 64 and 5 generated positions: outputs within 1e-5, and the new
    K/V written at the generated cache's fill point within 1e-6 of JAX's
    (one fp32 projection apart: XLA's and torch's GEMMs round differently),
    the rest of the cache untouched."""
    params, model = models
    rng = np.random.default_rng(S)
    L, H, Dh, D = CFG.num_layers, CFG.nhead, CFG.head_dim, CFG.d_model
    G, tp, p_len, tg, gpos = 2, 64, 40, 16, 5
    B = G * S
    h = rng.standard_normal((B, D)).astype(np.float32)
    pk, pv = (rng.standard_normal((L, G, H, tp, Dh)).astype(np.float32)
              for _ in range(2))
    gk, gv = (rng.standard_normal((L, B, H, tg, Dh)).astype(np.float32)
              for _ in range(2))
    if ban == "range":
        key_banned = np.array([[12, 16], [1, 16]], np.int32)
    else:  # per-group dead keys, and every slot from the fill point on
        key_banned = rng.random((G, tp)) < 0.3
        key_banned[:, p_len:] = True
        key_banned[:, 0] = False
    want_h, want_gen = jtrf.transformer_decode_step_shared(
        params["decoder"], jnp.asarray(h),
        jtrf.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.int32(p_len)),
        jtrf.KVCache(jnp.asarray(gk), jnp.asarray(gv), jnp.int32(gpos)),
        jnp.asarray(key_banned), CFG, n_groups=G, dtype=jnp.float32)
    gen = ttrf.KVCache(torch.from_numpy(gk.copy()), torch.from_numpy(gv.copy()),
                       gpos)
    got_h, got_gen = ttrf.transformer_decode_step_shared(
        model["decoder"], torch.from_numpy(h),
        ttrf.KVCache(torch.from_numpy(pk), torch.from_numpy(pv), p_len), gen,
        torch.from_numpy(key_banned).long() if ban == "range"
        else torch.from_numpy(key_banned), TCFG, n_groups=G,
        dtype=torch.float32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=1e-5)
    assert got_gen.length == int(want_gen.length) == gpos + 1
    for got, want, before in ((got_gen.k, want_gen.k, gk),
                              (got_gen.v, want_gen.v, gv)):
        np.testing.assert_allclose(got[:, :, :, gpos].numpy(),
                                   np.asarray(want)[:, :, :, gpos], rtol=0,
                                   atol=1e-6)
        got = got.numpy()
        np.testing.assert_array_equal(np.delete(got, gpos, axis=3),
                                      np.delete(before, gpos, axis=3))


# ----------------------------------------------- vector chain bookkeeping

@pytest.mark.parametrize("stop_repetition,temperature", [(2, 1.0), (-1, 0.7)])
def test_advance_chains_vector_state_matches_jax(stop_repetition, temperature):
    """One bookkeeping step with a per-chain audio position, length cap and
    span count (the multi-prompt form): a chain stopped by its own length
    cap, one whose span count ends it, one in the EOG cascade, a done chain
    at the cap, and a fresh one."""
    K, card, num_task, cap = CFG.n_codebooks, TS.cardinality, 2, 10
    silence = (3, 7, 11)
    dec = _dec(stop_repetition=stop_repetition, temperature=temperature,
               silence_tokens=silence, max_gen_per_span=12)
    rng = np.random.default_rng(stop_repetition + 11)
    lg = rng.standard_normal((5, K, card)).astype(np.float32)
    fields = dict(
        y_pos=np.array([39, 17, 25, 60, 3], np.int32),
        next_tokens=rng.integers(0, 32, size=(5, K)).astype(np.int32),
        out=rng.integers(0, 32, size=(5, K, cap)).astype(np.int32),
        out_len=np.array([2, 7, 6, cap, 0], np.int32),
        span_idx=np.array([0, 0, 0, 1, 0], np.int32),
        span_end=np.array([[0, 0], [0, 0], [0, 0], [3, 10], [0, 0]], np.int32),
        num_gen=np.array([2, 3, 6, 7, 0], np.int32),
        num_eog=np.array([0, K - 1, 2, 1, 0], np.int32),
        prev_token=np.array([9, 4, 3, 7, -1], np.int32),
        consec_silence=np.array([1, 0, 4, 2, 0], np.int32),
        num_cfg=np.array([1, 3, 2, 2, 1], np.int32),
        done=np.array([False, False, False, True, False]))
    num_cfg = np.array([2, 1, 3, 2, 2], np.int32)
    length_cap = np.array([40, 90, 30, 40, 50], np.int32)
    n_tasks = np.array([2, 1, 2, 2, 1], np.int32)
    sent = np.arange(TS.mts, TS.mts + TS.max_n_spans, dtype=np.int32)

    js = jdecode.ChainState(cache=None, key=None,
                            **{k: jnp.asarray(v) for k, v in fields.items()})
    want = jdecode._advance_chains(
        js, jnp.asarray(lg), jax.random.PRNGKey(0), jnp.asarray(num_cfg),
        ts=TS, sentinel_ids=jnp.asarray(sent), static_ban=jdecode._static_ban(TS),
        silence=jnp.asarray(silence, jnp.int32), dec=dec, num_task=num_task,
        length_cap=jnp.asarray(length_cap), n_tasks=jnp.asarray(n_tasks))

    ts_fields = {k: torch.from_numpy(np.asarray(v)).long()
                 for k, v in fields.items() if k != "done"}
    st = tdecode.ChainState(done=torch.from_numpy(fields["done"]), **ts_fields)
    got = tdecode._advance_chains(
        st, torch.from_numpy(lg), torch.Generator().manual_seed(0),
        torch.from_numpy(num_cfg).long(), ts=TCFG.tokens,
        sentinel_ids=torch.from_numpy(sent).long(),
        static_ban=tdecode._static_ban(TCFG.tokens, "cpu"),
        silence=torch.tensor(silence), dec=port_config(dec),
        num_task=num_task, length_cap=torch.from_numpy(length_cap).long(),
        n_tasks=torch.from_numpy(n_tasks).long())
    assert bool(np.asarray(want["done"])[1]) and not fields["done"][1]
    for key in ("y_pos", "next_tokens", "out", "out_len", "span_idx",
                "span_end", "num_gen", "num_eog", "prev_token",
                "consec_silence", "num_cfg", "done"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(want[key]), err_msg=key)


# ------------------------------------------------------------ generate_batch

def _prompt(seed, T=32, sx=20):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, T))
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(sx,))
    return x, y, rng


BATCH_CASES = [
    dict(aug_text=False, mask=[(8, 15)], n=3),
    dict(aug_text=True, mask=[(5, 10), (18, 24)], n=3),
    dict(aug_text=True, mask=[(8, 15)], n=2, cfg_pretrained=False),
]


@pytest.mark.parametrize("case", BATCH_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_generate_batch_greedy_identical(models, case):
    """Greedy chains of one prompt: identical to JAX's generate_batch and to
    the port's own single-chain generate. Without cfg_pretrained the uncond
    text row is passed explicitly (the PRNGs differ)."""
    params, model = models
    case = dict(case)
    mask, n = case.pop("mask"), case.pop("n")
    x, y, rng = _prompt(7)
    uncond_x = (rng.integers(0, CFG.n_text_tokens, size=x.shape)
                if case.get("cfg_pretrained") is False else None)
    dec = _dec(**case)
    want = jdecode.generate_batch(params, CFG, dec, x, y, mask,
                                  jax.random.PRNGKey(0), n_samples=n,
                                  uncond_x=uncond_x, dtype_name="float32")
    stats = {}
    got = tdecode.generate_batch(model, TCFG, port_config(dec), x, y, mask,
                                 torch.Generator().manual_seed(0), n,
                                 uncond_x=uncond_x, stats=stats)
    single = tdecode.generate(model, TCFG, port_config(dec), x, y, mask,
                              torch.Generator().manual_seed(0),
                              uncond_x=uncond_x)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        _assert_same(g, w)
        _assert_same(g, single)
    assert stats["out_tokens"].shape[0] == n and stats["decode_steps"] > 0


@pytest.mark.parametrize("aug_text", [False, True])
def test_generate_batch_aug_context_identical(models, aug_text):
    """The aug_context prepend on the batched path (a 7-frame span with a
    prompt given): identical to JAX's generate_batch."""
    params, model = models
    x, y, rng = _prompt(11, T=28, sx=18)
    prompt_y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, 12))
    prompt_x = rng.integers(0, CFG.text_vocab_size - 1, size=(9,))
    dec = _dec(aug_text=aug_text, aug_context=True)
    kw = dict(prompt_x=prompt_x, prompt_y=prompt_y)
    want = jdecode.generate_batch(params, CFG, dec, x, y, [(8, 15)],
                                  jax.random.PRNGKey(0), n_samples=2,
                                  dtype_name="float32", **kw)
    got = tdecode.generate_batch(model, TCFG, port_config(dec), x, y,
                                 [(8, 15)], torch.Generator().manual_seed(0),
                                 2, **kw)
    # the prepend is on: 12 prompt frames go in front, and come off again
    assert tdecode._apply_aug_context(port_config(dec), x, y, [(8, 15)],
                                      prompt_x, prompt_y)[3] == 12
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_sampled_chains_differ(models):
    """Pure sampling (top_k 0, temperature 1.2) from the port's generator:
    the chains are not all the same, and every generated code is a code."""
    _, model = models
    x, y, _ = _prompt(8, T=30, sx=16)
    dec = DecodeConfig(top_k=0, top_p=1.0, temperature=1.2,
                       stop_repetition=-1, aug_text=False,
                       max_gen_per_span=80, length_cap_mult=10)
    results = tdecode.generate_batch(model, TCFG, port_config(dec), x, y,
                                     [(10, 20)],
                                     torch.Generator().manual_seed(1), 4)
    assert len({r[0].tobytes() for r in results}) > 1
    for codes, marks, _, _ in results:
        assert codes.shape[1] == CFG.n_codebooks
        assert np.all(codes[0][:, marks[0] == 1] < TS.cardinality)


# --------------------------------------------------------- the pipeline

TINY_CODEC = CodecConfig(
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(8, 5, 4, 2), lstm=1, norm="weight_norm",
                        pad_mode="constant"),
    rvq=RVQConfig(dimension=16, n_q=CFG.n_codebooks, bins=TS.audio_vocab_size))
PHN2NUM = {c: i for i, c in enumerate("abcdefghijklmnopqrstuvwxyz_ ")}


def tokenizers():
    """(JAX, port) audio and text tokenizers over one tiny codec's
    parameters (the recipe of tests/test_multi_prompt.py)."""
    from ssr_speech_tpu.data import tokenizer as jtok
    from ssr_speech_tpu.models.codec import wmencodec as jwm
    from ssr_speech_tpu_torch.data import tokenizer as ttok
    from ssr_speech_tpu_torch.models.from_jax import codec_from_jax

    cparams = jwm.init_wmencodec(jax.random.PRNGKey(1), TINY_CODEC)
    tcodec = codec_from_jax(jax.tree.map(np.asarray, cparams),
                            port_config(TINY_CODEC))
    return ((jtok.AudioTokenizer(cparams, TINY_CODEC), jtok.TextTokenizer()),
            (ttok.AudioTokenizer(tcodec, port_config(TINY_CODEC)),
             ttok.TextTokenizer()))


def write_wavs(tmp_path, frames):
    from ssr_speech_tpu.utils import audio as audio_io

    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(frames):
        path = str(tmp_path / f"in{i}.wav")
        audio_io.write_wav(path, (rng.normal(size=(1, n * TINY_CODEC.hop_length))
                                  * 0.1).astype(np.float32),
                           TINY_CODEC.sample_rate)
        paths.append(path)
    return paths


@pytest.mark.parametrize("use_watermark,tts", [(True, False), (False, True)])
def test_inference_batch_matches_jax_pipeline(models, tmp_path, monkeypatch,
                                              use_watermark, tts):
    from ssr_speech_tpu.inference import pipeline as jpipe
    from ssr_speech_tpu_torch.inference import pipeline as tpipe

    params, model = models
    monkeypatch.setattr(jdecode, "generate_batch", functools.partial(
        jdecode.generate_batch, dtype_name="float32"))
    (jatok, jttok), (tatok, tttok) = tokenizers()
    (path,) = write_wavs(tmp_path, [30])
    dec = _dec(aug_text=True, cfg_stride=3, max_gen_per_span=40)
    mask = [(22, 30)] if tts else [(5, 12)]
    want = jpipe.inference_batch(params, CFG, dec, PHN2NUM, jttok, jatok, path,
                                 "hello world", mask, n_samples=2,
                                 use_watermark=use_watermark, tts=tts)
    stats = {}
    got = tpipe.inference_batch(model, TCFG, port_config(dec), PHN2NUM, tttok,
                                tatok, path, "hello world", mask, n_samples=2,
                                use_watermark=use_watermark, tts=tts,
                                stats=stats)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1] > 0
        assert np.abs(g - np.asarray(w)).max() <= LSB
    assert len(stats["output_frames"]) == 2
