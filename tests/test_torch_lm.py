"""The port's LM modules against ``ssr_speech_tpu`` on the CPU in fp32, with
the same parameters (the JAX init through ``lm_from_jax``) and the same
numpy-seeded inputs: the fused attention (whose CPU path is its plain
version, as the JAX wrapper's is off-TPU), masks, the sampling filter, the
training forward's loss and metrics, the prefill cache and a decode step."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import SSRModelConfig, tiny_ssr_config
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.models import transformer as jtrf
from ssr_speech_tpu.ops import flash_attention as jfa
from ssr_speech_tpu.ops import masking as jmask
from ssr_speech_tpu.ops import sampling as jsamp
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models import transformer as ttrf
from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
from tests.test_torch_hostcopies import port_config
from ssr_speech_tpu_torch.ops import flash_attention as tfa
from ssr_speech_tpu_torch.ops import masking as tmask
from ssr_speech_tpu_torch.ops import sampling as tsamp

TOL = dict(atol=1e-5, rtol=1e-5)
KW = dict(num_layers=2, n_codebooks=4, text_vocab_size=30, trm_dropout=0.0,
          text_embedding_dropout=0.0, text_positional_embedding_dropout=0.0,
          audio_positional_embedding_dropout=0.0, attn_impl="flash")
CONFIGS = {
    "tiny_dh16": tiny_ssr_config(attn_impl="flash"),
    # head_dim 128: the kernel's geometry
    "dh128": SSRModelConfig(d_model=256, nhead=2, audio_embedding_dim=256,
                            head_hidden=64, max_position=512, **KW),
    # the materialised [B, H, S, S] path, the config default
    "tiny_einsum": tiny_ssr_config(),
}


def _seg_patterns(b, s, sx, x_len):
    """The prefill's segment ids: text padding banned on every row, the
    cfg_pretrained unconditional row (1) banned on [1, sx)."""
    seg = np.ones((b, s), np.int32)
    seg[:, x_len:sx] = 0
    seg[1:, 1:sx] = 0
    return seg


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("s,sx,x_len", [(77, 20, 13), (200, 64, 41)])
def test_flash_attend_matches_jax_on_valid_rows(dh, s, sx, x_len):
    rng = np.random.default_rng(dh + s)
    q, k, v = (rng.standard_normal((2, 3, s, dh)).astype(np.float32)
               for _ in range(3))
    seg = _seg_patterns(2, s, sx, x_len)
    want = np.asarray(jfa.flash_attend_xy(q, k, v, seg != 0))
    got = tfa.flash_attend_xy(*(torch.from_numpy(t) for t in (q, k, v)),
                              torch.from_numpy(seg != 0)).numpy()
    valid = seg != 0
    for b in range(2):
        np.testing.assert_allclose(got[b][:, valid[b]], want[b][:, valid[b]],
                                   **TOL)
    assert tfa.launches == 0  # CPU tensors take the plain version


def test_masks_match_jax():
    x_lens, y_lens = np.array([8, 5]), np.array([16, 11])
    want = np.asarray(jmask.xy_attn_bias(x_lens, y_lens, 8, 16))
    got = tmask.xy_attn_bias(torch.from_numpy(x_lens), torch.from_numpy(y_lens),
                             8, 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.min() == -1e9


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (1, 1.0), (5, 1.0),
                                         (0, 0.8), (3, 0.5), (0, 0.3)])
def test_sampling_filter_matches_jax(top_k, top_p):
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((2, 4, 40)).astype(np.float32)
    logits[0, 0, :6] = logits[0, 0, 6]  # ties at the threshold survive
    logits = np.round(logits, 1)  # many ties: stable-sort order matters
    want = np.asarray(jsamp.top_k_top_p_filter(logits, top_k, top_p))
    got = tsamp.top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    if top_k == 1:
        gen = torch.Generator().manual_seed(0)
        single = (got > -np.inf).sum(-1) == 1
        picked = tsamp.sample_tokens(gen, torch.from_numpy(logits), top_k=1,
                                     top_p=top_p).numpy()
        np.testing.assert_array_equal(picked[single],
                                      logits.argmax(-1)[single])


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lm(request):
    cfg = CONFIGS[request.param]
    params = jssr.init_ssr(jax.random.PRNGKey(2), cfg)
    return cfg, params, lm_from_jax(jax.tree.map(np.asarray, params),
                                    port_config(cfg))


def test_heads_norm_and_positions_match_jax(lm):
    cfg, params, model = lm
    rng = np.random.default_rng(1)
    h = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        tssr.predict_logits(model, torch.from_numpy(h)).numpy(),
        np.asarray(jssr.predict_logits(params, h)), **TOL)
    w = rng.standard_normal(cfg.d_model).astype(np.float32)
    np.testing.assert_allclose(
        ttrf.layer_norm(torch.from_numpy(h), torch.from_numpy(w),
                        torch.from_numpy(w)).numpy(),
        np.asarray(jtrf.layer_norm(h, w, w)), **TOL)
    np.testing.assert_allclose(tssr.sine_table(300, cfg.d_model).numpy(),
                               np.asarray(jssr.sine_table(300, cfg.d_model)),
                               atol=2e-5)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, sx, sy = 2, 11, 29
    ts = cfg.tokens
    y = rng.integers(0, ts.audio_vocab_size, size=(B, sy, cfg.n_codebooks))
    y[:, 0] = ts.sos
    y[0, 9] = ts.mts
    y[1, 4:6] = ts.empty
    y[1, 21:] = ts.pad
    return dict(x=rng.integers(0, cfg.text_vocab_size, size=(B, sx)),
                x_lens=np.array([sx, 7]), y=y, y_lens=np.array([sy, 21]))


@pytest.mark.parametrize("predict_all", [False, True])
def test_ssr_forward_loss_and_metrics_match_jax(lm, predict_all):
    cfg, params, model = lm
    batch = _batch(cfg, 4)
    want = jssr.ssr_forward(params, cfg, {k: jnp.asarray(v) for k, v in
                                          batch.items()},
                            remat=False, predict_all=predict_all)
    got = tssr.ssr_forward(model, model.cfg, {k: torch.from_numpy(v) for k, v in
                                        batch.items()},
                           predict_all=predict_all)
    for key in ("loss", "effective_ntoken", "loss_by_codebook",
                "top10acc_by_codebook", "top10acc"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("aug_text", [False, True])
def test_prefill_cache_and_decode_step_match_jax(lm, aug_text):
    """Cache entries at non-banned positions after the prefill, then one
    decode step's output and new cache column."""
    cfg, params, model = lm
    rng = np.random.default_rng(9)
    K, sx, P, x_len, p_len = cfg.n_codebooks, 64, 128, 23, 70
    B = 2 if aug_text else 1
    x = np.full((B, sx), cfg.text_pad_token, np.int32)
    x[:, :x_len] = rng.integers(0, cfg.text_vocab_size - 1, size=x_len)
    if aug_text:
        x[1, :x_len] = cfg.text_vocab_size - 1
    prefix = np.full((K, P), cfg.tokens.empty, np.int32)
    prefix[:, :p_len] = rng.integers(0, cfg.tokens.audio_vocab_size,
                                     size=(K, p_len))
    tmax = 256
    kw = dict(tmax=tmax, cfg_pretrained=True, aug_text=aug_text)
    jcache, jban = jdecode._prefill_impl(
        params, jnp.asarray(x), jnp.asarray(prefix), jnp.asarray(x_len),
        jnp.asarray(p_len), dtype_name="float32", cfg=cfg, **kw)
    tcache, tban = tdecode._prefill_impl(
        model, torch.from_numpy(x).long(), torch.from_numpy(prefix).long(),
        x_len, p_len, dtype=torch.float32, cfg=model.cfg, **kw)
    np.testing.assert_array_equal(tban.numpy(), np.asarray(jban))
    assert tcache.length == int(jcache.length) == sx + p_len
    n = sx + p_len
    keep = np.ones((B, n), bool)
    for b, (lo, hi) in enumerate(np.asarray(jban)):
        keep[b, lo:hi] = False
    for name in ("k", "v"):
        got = getattr(tcache, name)[:, :, :, :n].numpy()
        want = np.asarray(getattr(jcache, name))[:, :, :, :n]
        for b in range(B):
            np.testing.assert_allclose(got[:, b][:, :, keep[b]],
                                       want[:, b][:, :, keep[b]], **TOL)

    h = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    jout, jc2 = jtrf.transformer_decode_step(params["decoder"], h, jcache, jban,
                                             cfg, dtype=jnp.float32)
    tout, tc2 = ttrf.transformer_decode_step(model["decoder"],
                                             torch.from_numpy(h), tcache, tban,
                                             model.cfg, dtype=torch.float32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert tc2.length == int(jc2.length) == n + 1
    np.testing.assert_allclose(tc2.k[:, :, :, n].numpy(),
                               np.asarray(jc2.k)[:, :, :, n], **TOL)


def test_decode_step_attention_sees_exactly_the_fill():
    """Keys past the fill point are never read: garbage there changes
    nothing (JAX masks them; the port does not read them)."""
    cfg = CONFIGS["tiny_dh16"]
    params = jssr.init_ssr(jax.random.PRNGKey(3), cfg)
    model = lm_from_jax(jax.tree.map(np.asarray, params), port_config(cfg))
    cache = ttrf.init_kv_cache(model.cfg, 1, 16, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    cache = ttrf.KVCache(cache.k, cache.v, 5)
    ban = torch.tensor([[1, 2]])
    h = torch.randn((1, cfg.d_model), generator=gen)
    a, _ = ttrf.transformer_decode_step(model["decoder"], h, cache, ban, model.cfg,
                                        dtype=torch.float32)
    cache.k[:, :, :, 7:] = 1e3
    cache = ttrf.KVCache(cache.k, cache.v, 5)
    b, _ = ttrf.transformer_decode_step(model["decoder"], h, cache, ban, model.cfg,
                                        dtype=torch.float32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
