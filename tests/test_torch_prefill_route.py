"""The prefill's attention route (``models/transformer.py::
transformer_prefill``): the flash kernel where its inputs are bf16 at head
width 128, the einsum ``_attend`` over JAX's additive mask everywhere else.

On the CPU, against JAX (imported inside the fixtures, so that the card's
machine, which has no JAX, can collect this file): the fp32 prefill's whole
cache, banned rows included, and the greedy decode of a head-width-16 LM and
of a head-width-128 LM, each equal to JAX's ``_prefill_impl`` /
``generate(dtype_name="float32")``, the single and the shared prompt paths.
The route is taken once, before the layer loop, from the config and the
dtype, and nothing catches an error of the kernel. On the card (marker
``cuda``): a head-width-16 CLI edit in bf16 launches the kernel 0 times and
gives the tokens of its CPU run, and a wav within the bf16 tolerance of it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_prefill_route.py
"""

import csv
import inspect

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.config import DecodeConfig, tiny_ssr_config
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.models import transformer as ttrf

GEOMETRIES = {"head16": dict(), "head128": dict(d_model=256, nhead=2,
                                                audio_embedding_dim=256)}


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def models(request):
    """(JAX config, JAX params, the port's config, the port's model)."""
    import jax

    from ssr_speech_tpu.config import tiny_ssr_config as jtiny
    from ssr_speech_tpu.models import ssr as jssr
    from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
    from tests.test_torch_hostcopies import port_config

    cfg = jtiny(**GEOMETRIES[request.param])
    params = jssr.init_ssr(jax.random.PRNGKey(3), cfg)
    tcfg = port_config(cfg)
    return cfg, params, tcfg, lm_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg)


def _prompt(tcfg, seed=5):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, tcfg.tokens.audio_vocab_size,
                     size=(tcfg.n_codebooks, 40))
    x = rng.integers(0, tcfg.text_vocab_size - 1, size=(23,))
    return x, y


def test_fp32_prefill_fills_the_cache_as_jax(models):
    """[x ; prefix] padded to its buckets, CFG rows with cfg_pretrained: every
    cache entry of every layer and row (the banned ones too: the einsum
    route takes JAX's mask on every query) within 1e-5 of JAX's."""
    import jax.numpy as jnp

    from ssr_speech_tpu.inference import decode as jdecode

    cfg, params, tcfg, model = models
    assert not ttrf.prefill_uses_kernel(tcfg, torch.float32)
    rng = np.random.default_rng(0)
    sx, P, x_len, p_len = 64, 128, 41, 97
    x = rng.integers(0, tcfg.text_vocab_size, size=(2, sx)).astype(np.int32)
    y = rng.integers(0, tcfg.tokens.audio_vocab_size,
                     size=(tcfg.n_codebooks, P)).astype(np.int32)
    kw = dict(tmax=256, cfg_pretrained=True, aug_text=True)
    jcache, jban = jdecode._prefill_impl(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(x_len, jnp.int32),
        jnp.asarray(p_len, jnp.int32), cfg=cfg, dtype_name="float32", **kw)
    cache, ban = tdecode._prefill_impl(
        model, torch.from_numpy(x).long(), torch.from_numpy(y).long(), x_len,
        p_len, cfg=tcfg, dtype=torch.float32, **kw)
    np.testing.assert_array_equal(ban.numpy(), np.asarray(jban))
    assert int(cache.length) == int(jcache.length) == sx + p_len
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(got[..., :sx + P, :].numpy(),
                                   np.asarray(want)[..., :sx + P, :],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batch3"])
def test_fp32_greedy_decode_matches_jax(models, batch):
    import jax

    from ssr_speech_tpu.config import DecodeConfig as JDecodeConfig
    from ssr_speech_tpu.inference import decode as jdecode

    cfg, params, tcfg, model = models
    kw = dict(top_k=1, top_p=1.0, stop_repetition=-1, cfg_coef=1.5,
              cfg_stride=2, aug_text=True, cfg_pretrained=True,
              max_gen_per_span=60, length_cap_mult=10)
    x, y = _prompt(tcfg)
    mask = [(12, 25)]
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    if batch:
        want = jdecode.generate_batch(params, cfg, JDecodeConfig(**kw), x, y,
                                      mask, key, batch, dtype_name="float32")
        got = tdecode.generate_batch(model, tcfg, DecodeConfig(**kw), x, y,
                                     mask, gen, batch)
    else:
        want = [jdecode.generate(params, cfg, JDecodeConfig(**kw), x, y, mask,
                                 key, dtype_name="float32")]
        got = [tdecode.generate(model, tcfg, DecodeConfig(**kw), x, y, mask,
                                gen)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] and g[3] == w[3]


class KernelCalled(RuntimeError):
    pass


def _lm(cfg, dtype):
    from ssr_speech_tpu_torch.models import ssr
    from ssr_speech_tpu_torch.models.from_jax import lm_from_jax

    from ssr_speech_tpu_torch.utils import prng

    return lm_from_jax(ssr.init_ssr(prng.PRNGKey(0), cfg), cfg, dtype=dtype)


@pytest.mark.parametrize("geometry,dtype,kernel", [
    ("head16", torch.float32, False), ("head16", torch.bfloat16, False),
    ("head128", torch.float32, False), ("head128", torch.bfloat16, True)])
def test_route_is_decided_once_before_the_loop(monkeypatch, geometry, dtype,
                                               kernel):
    """``prefill_uses_kernel`` is asked once a prefill; the einsum route never
    reaches the kernel's wrapper, and on the kernel's route an error the
    wrapper raises leaves ``generate`` uncaught."""
    cfg = tiny_ssr_config(**GEOMETRIES[geometry])
    asked, calls = [], []
    real = ttrf.prefill_uses_kernel

    def spy(c, d):
        asked.append((c.head_dim, d))
        return real(c, d)

    def wrapper(*args):
        calls.append(args[0].shape)
        raise KernelCalled("the kernel's wrapper was reached")

    monkeypatch.setattr(ttrf, "prefill_uses_kernel", spy)
    monkeypatch.setattr(ttrf, "flash_attend_xy", wrapper)
    dec = DecodeConfig(top_k=1, stop_repetition=-1, max_gen_per_span=8,
                       aug_text=True, cfg_pretrained=True)
    x, y = _prompt(cfg)
    run = lambda: tdecode.generate(_lm(cfg, dtype), cfg, dec, x, y, [(12, 25)],
                                   torch.Generator().manual_seed(0))
    if kernel:
        with pytest.raises(KernelCalled):
            run()
        assert len(calls) == 1  # the first layer's, then the error went up
    else:
        run()
        assert calls == []
    assert asked == [(cfg.head_dim, dtype)]


def test_no_handler_around_the_prefill_route():
    """The route's source: decided from the config and dtype, no ``try``."""
    src = inspect.getsource(ttrf.transformer_prefill)
    assert "prefill_uses_kernel(cfg, dtype)" in src
    assert (src.index("prefill_uses_kernel(cfg, dtype)")
            < src.index("_inference_layers("))
    for fn in (ttrf.transformer_prefill, ttrf.prefill_uses_kernel,
               ttrf._inference_layers, tdecode._prefill_impl,
               tdecode._prefill_multi_impl):
        assert "except" not in inspect.getsource(fn)
    assert ttrf.prefill_uses_kernel(tiny_ssr_config(d_model=256, nhead=2),
                                    torch.bfloat16)
    assert not ttrf.prefill_uses_kernel(tiny_ssr_config(), torch.bfloat16)


# -------------------------------------------------------------- on the card

ATOL = 2e-2  # bf16 LM against the fp32 CPU run: the decoder's rounding


@pytest.mark.cuda
def test_head16_cli_edit_on_the_card_matches_its_cpu_run(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from ssr_speech_tpu_torch.config import CodecConfig, RVQConfig, SEANetConfig
    from ssr_speech_tpu_torch.inference import cli
    from ssr_speech_tpu_torch.models import ssr
    from ssr_speech_tpu_torch.models.codec import wmencodec as wm
    from ssr_speech_tpu_torch.models.pretrained import save_bundle
    from ssr_speech_tpu_torch.ops import flash_attention as fa
    from ssr_speech_tpu_torch.utils import audio as audio_io
    from ssr_speech_tpu_torch.utils import prng

    cfg = tiny_ssr_config()  # head width 16
    codec_cfg = CodecConfig(
        seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                            ratios=(8, 5, 4, 2), lstm=1),
        rvq=RVQConfig(dimension=16, n_q=cfg.n_codebooks,
                      bins=cfg.tokens.audio_vocab_size))
    save_bundle(str(tmp_path / "lm.pkl"),
                params=ssr.init_ssr(prng.PRNGKey(0), cfg),
                model_config=cfg,
                phn2num={c: i for i, c in enumerate("abcdefghijklmnopqrstuvwxyz_")})
    save_bundle(str(tmp_path / "codec.pkl"),
                params=wm.init_wmencodec(prng.PRNGKey(1), codec_cfg),
                config=codec_cfg)
    words = ["but", "when", "i", "had", "approached", "so", "near", "to", "them"]
    rng = np.random.default_rng(0)
    audio_io.write_wav(str(tmp_path / "in.wav"),
                       (rng.normal(size=(1, 48000)) * 0.1).astype(np.float32),
                       16000)
    with open(tmp_path / "align.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["word", "start", "end"])
        for i, word in enumerate(words):
            w.writerow([word, round(i * 0.3 + 0.05, 3), round((i + 1) * 0.3, 3)])
    runs = {}
    for device in ("cpu", "cuda"):
        before = fa.launches
        runs[device] = cli.main([
            "--device", device, "--model_path", str(tmp_path / "lm.pkl"),
            "--codec_path", str(tmp_path / "codec.pkl"),
            "--orig_audio", str(tmp_path / "in.wav"),
            "--orig_transcript", " ".join(words),
            "--target_transcript", "but when i saw the mirage so near to them",
            "--alignment_file", str(tmp_path / "align.csv"),
            "--output_dir", str(tmp_path / device), "--savename", "edit",
            "--top_k", "1", "--stop_repetition", "-1", "--use_watermark",
            "--aug_text", "--cfg_pretrained", "--cfg_stride", "5"])
        runs[device]["k1"] = fa.launches - before
    assert runs["cuda"]["k1"] == 0 and runs["cpu"]["k1"] == 0
    np.testing.assert_array_equal(runs["cuda"]["out_tokens"],
                                  runs["cpu"]["out_tokens"])
    got, _ = audio_io.read_wav(runs["cuda"]["out_path"])
    want, _ = audio_io.read_wav(runs["cpu"]["out_path"])
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= ATOL
