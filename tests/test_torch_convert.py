"""Checkpoint conversion of the port against ``ssr_speech_tpu``'s.

The published files are absent, so the state dicts are made here in the
layout ``models/convert.py`` reads (its docstring, :13-17: a torch Conv1d is
[Cout, Cin, K], a ConvTranspose1d [Cin, Cout, K] with the kernel flipped, a
Linear [Out, In]; the key names of the reference modules). ``lm_state_dict``
and ``codec_state_dict`` invert the converters' mapping on JAX-initialised
parameters, so a conversion must give those parameters back.

- Both packages' converters give equal leaves, bit for bit, and raise the
  same ``ValueError`` on a stray key and on a geometry mismatch
  (``tests/test_pretrained.py:139-170``).
- A ``.pth`` LM bundle ``{model, config (argparse namespace), phn2num}``
  through the port's ``load_lm`` decodes greedily to the same codes as the
  ``.pkl`` of JAX's conversion; a codec ``.th`` through ``load_codec`` and
  through ``prep encode`` gives the codes of that ``.pkl`` (the published
  default geometry, random weights).
- ``fetch_checkpoint`` on local files (``tests/test_pretrained.py:23-35,
  69``); the port refuses URLs and hub ids, which need the network.
"""

import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import (CodecConfig, DecodeConfig, RVQConfig,
                                   SEANetConfig, SSRModelConfig, TokenSpace)
from ssr_speech_tpu.models import convert as jcvt
from ssr_speech_tpu.models import pretrained as jpretrained
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.utils import checkpoint as jckpt
from ssr_speech_tpu_torch import train_codec
from ssr_speech_tpu_torch.data import prep as tprep
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.models import convert as tcvt
from ssr_speech_tpu_torch.models import pretrained as tpretrained
from ssr_speech_tpu_torch.utils import audio as taudio
from tests.test_torch_batched_decode import one_torch_thread
from tests.test_torch_hostcopies import port_config

__all__ = ["one_torch_thread"]  # module-scoped fixture, shared

CPU = torch.device("cpu")
TINY_CODEC = CodecConfig(
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(4, 2), lstm=1),
    rvq=RVQConfig(dimension=16, n_q=2, bins=7))


# ------------------------------------------- the converters' layout, inverted

def _conv_sd(sd, prefix, p, transposed=False):
    base = f"{prefix}.convtr.convtr" if transposed else f"{prefix}.conv.conv"
    sd[f"{base}.bias"] = p["b"]
    for key, name in (("v", "weight_v"), ("w", "weight")):
        if key in p:
            sd[f"{base}.{name}"] = (p[key].transpose(1, 2, 0)[:, :, ::-1].copy()
                                    if transposed else p[key].transpose(2, 1, 0))
    if "g" in p:
        sd[f"{base}.weight_g"] = p["g"].reshape(-1, 1, 1)


def _res_sd(sd, prefix, p):
    _conv_sd(sd, f"{prefix}.block.1", p["conv1"])
    _conv_sd(sd, f"{prefix}.block.3", p["conv2"])


def _lstm_sd(sd, prefix, p):
    for i, lay in enumerate(p["layers"]):
        for key, name in (("wih", "weight_ih"), ("whh", "weight_hh"),
                          ("bih", "bias_ih"), ("bhh", "bias_hh")):
            sd[f"{prefix}.lstm.{name}_l{i}"] = lay[key]


def _encoder_sd(sd, prefix, p, cfg):
    idx = 0
    _conv_sd(sd, f"{prefix}.model.{idx}", p["conv_in"])
    idx += 1
    for g in p["groups"]:
        for r in g["res"]:
            _res_sd(sd, f"{prefix}.model.{idx}", r)
            idx += 1
        idx += 1  # activation
        _conv_sd(sd, f"{prefix}.model.{idx}", g["down"])
        idx += 1
    if cfg.seanet.lstm:
        _lstm_sd(sd, f"{prefix}.model.{idx}", p["lstm"])
        idx += 1
    idx += 1  # activation
    _conv_sd(sd, f"{prefix}.model.{idx}", p["conv_out"])


def _decoder_sd(sd, prefix, p, cfg):
    idx = 0
    _conv_sd(sd, f"{prefix}.model.{idx}", p["conv_in"])
    idx += 1
    if cfg.seanet.lstm:
        _lstm_sd(sd, f"{prefix}.model.{idx}", p["lstm"])
        idx += 1
    for g in p["groups"]:
        idx += 1  # activation
        _conv_sd(sd, f"{prefix}.model.{idx}", g["up"], transposed=True)
        idx += 1
        for r in g["res"]:
            _res_sd(sd, f"{prefix}.model.{idx}", r)
            idx += 1
    idx += 1  # activation
    _conv_sd(sd, f"{prefix}.model.{idx}", p["conv_out"])


def codec_state_dict(params, cfg):
    """JAX-layout wmencodec params -> the reference's flat state dict."""
    sd = {}
    _encoder_sd(sd, "encoder", params["encoder"], cfg)
    _decoder_sd(sd, "decoder", params["decoder"], cfg)
    wmd = params["wmdecoder"]
    _decoder_sd(sd, "wmdecoder", wmd["decoder"], cfg)
    _encoder_sd(sd, "wmdecoder.skip_encoder", wmd["skip_encoder"], cfg)
    _encoder_sd(sd, "wmdecoder.wm_encoder", wmd["wm_encoder"], cfg)
    sd["wmdecoder.wm_embed.weight"] = wmd["wm_embed"]
    for i, proj in enumerate(wmd["projs"]):
        _conv_sd(sd, f"wmdecoder.wm_proj{i}.1", proj["conv"])
    _conv_sd(sd, "wmdecoder.wm_predictor.1", wmd["predictor"]["conv"])
    for k, e in enumerate(params["quantizer"]["embed"]):
        sd[f"quantizer.vq.layers.{k}._codebook.embed"] = e
        # training state the converter may ignore
        sd[f"quantizer.vq.layers.{k}._codebook.cluster_size"] = np.ones(
            e.shape[0], np.float32)
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def lm_state_dict(params, cfg):
    """JAX-layout SSR LM params -> the reference's flat state dict."""
    sd = {}
    lay = params["decoder"]["layers"]
    names = dict(ln1_w="norm1.weight", ln1_b="norm1.bias",
                 qkv_w="self_attn.in_proj_weight",
                 qkv_b="self_attn.in_proj_bias",
                 out_w="self_attn.out_proj.weight",
                 out_b="self_attn.out_proj.bias", ln2_w="norm2.weight",
                 ln2_b="norm2.bias", ffn1_w="linear1.weight",
                 ffn1_b="linear1.bias", ffn2_w="linear2.weight",
                 ffn2_b="linear2.bias")
    for l in range(cfg.num_layers):
        for key, name in names.items():
            t = lay[key][l]
            sd[f"decoder.layers.{l}.{name}"] = t.T if key.endswith("_w") \
                and t.ndim == 2 else t
    sd["decoder.norm.weight"] = params["decoder"]["final_ln_w"]
    sd["decoder.norm.bias"] = params["decoder"]["final_ln_b"]
    sd["text_embedding.word_embeddings.weight"] = params["text_emb"]
    for k in range(cfg.n_codebooks):
        sd[f"audio_embedding.{k}.word_embeddings.weight"] = params["audio_emb"][k]
        sd[f"predict_layer.{k}.0.weight"] = params["head1_w"][k].T
        sd[f"predict_layer.{k}.0.bias"] = params["head1_b"][k]
        sd[f"predict_layer.{k}.2.weight"] = params["head2_w"][k].T
        sd[f"predict_layer.{k}.2.bias"] = params["head2_b"][k]
    sd["text_positional_embedding.alpha"] = params["text_pos_alpha"]
    sd["audio_positional_embedding.alpha"] = params["audio_pos_alpha"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the converters

@pytest.fixture(scope="module")
def lm_namespace():
    v = 16
    return argparse.Namespace(  # the argparse namespace the reference pickles
        n_special=5, audio_vocab_size=v, empty_token=v, eog=v + 1,
        audio_pad_token=v + 2, eos=v + 3, sos=v + 4, mts=v + 5,
        max_n_spans=3, text_vocab_size=30, text_pad_token=30, n_codebooks=4,
        d_model=32, nhead=4, num_decoder_layers=2, audio_embedding_dim=32,
        trm_dropout=0.0, predict_mask_token=1, predict_all=0)


@pytest.fixture(scope="module")
def lm(lm_namespace):
    ns = vars(lm_namespace)
    cfg = SSRModelConfig(
        d_model=ns["d_model"], nhead=ns["nhead"],
        num_layers=ns["num_decoder_layers"], n_codebooks=ns["n_codebooks"],
        audio_embedding_dim=ns["audio_embedding_dim"],
        text_vocab_size=ns["text_vocab_size"],
        tokens=TokenSpace(audio_vocab_size=ns["audio_vocab_size"],
                          max_n_spans=ns["max_n_spans"]))
    params = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(3), cfg))
    return cfg, params, lm_state_dict(params, cfg)


def test_lm_converters_give_equal_leaves(lm):
    cfg, params, sd = lm
    want = jcvt.convert_ssr_lm(dict(sd), cfg)
    got = tcvt.convert_ssr_lm(dict(sd), port_config(cfg))
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)  # the helper inverts the mapping


def test_codec_converters_give_equal_leaves():
    params = jax.tree.map(np.asarray,
                          jwm.init_wmencodec(jax.random.PRNGKey(1), TINY_CODEC))
    sd = codec_state_dict(params, TINY_CODEC)
    want = jcvt.convert_wmencodec(dict(sd), TINY_CODEC)
    got = tcvt.convert_wmencodec(dict(sd), port_config(TINY_CODEC))
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)


def test_both_converters_refuse_the_same_layouts(lm):
    """A stray tensor and a geometry mismatch (the config says 1 layer, the
    file has 2) raise the same ValueError in both packages."""
    cfg, _, sd = lm
    sd = dict(sd)
    sd["decoder.layers.0.mystery_weight"] = sd["decoder.norm.weight"]
    msgs = []
    for mod, c in ((jcvt, cfg), (tcvt, port_config(cfg))):
        with pytest.raises(ValueError, match="mystery_weight") as e:
            mod.convert_ssr_lm(sd, c)
        msgs.append(str(e.value))
    del sd["decoder.layers.0.mystery_weight"]
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    for mod, c in ((jcvt, cfg1), (tcvt, port_config(cfg1))):
        with pytest.raises(ValueError, match="not consumed") as e:
            mod.convert_ssr_lm(sd, c)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]


def test_load_torch_file_reads_a_nested_checkpoint(tmp_path):
    path = str(tmp_path / "x.th")
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    torch.save({"best_state": {"model": {"a.weight": torch.from_numpy(w)}}},
               path)
    for mod in (jcvt, tcvt):
        got = mod.load_torch_file(path, key="best_state")
        np.testing.assert_array_equal(got["model"]["a.weight"], w)


# ------------------------------------------------------------------ loaders

def _greedy_codes(model, cfg):
    rng = np.random.default_rng(4)
    ts = cfg.tokens
    y = rng.integers(0, ts.audio_vocab_size, size=(cfg.n_codebooks, 30))
    x = rng.integers(0, cfg.text_vocab_size - 1, size=(12,))
    dec = port_config(DecodeConfig(top_k=1, top_p=1.0, stop_repetition=-1,
                                   cfg_coef=1.5, cfg_stride=2, aug_text=True,
                                   cfg_pretrained=True, max_gen_per_span=40,
                                   length_cap_mult=10))
    codes, marks, _, _ = tdecode.generate(
        model, cfg, dec, x, y, [(10, 18)], torch.Generator().manual_seed(0))
    return codes, marks


def test_pth_lm_decodes_like_the_pkl_of_jax_conversion(lm, lm_namespace,
                                                       tmp_path):
    cfg, params, sd = lm
    pth = str(tmp_path / "English.pth")
    torch.save(dict(model={k: torch.tensor(v) for k, v in sd.items()},
                    config=lm_namespace, phn2num={"a": 0, "b": 1}), pth)
    jparams, jcfg, jphn = jpretrained.load_lm(pth)
    pkl = str(tmp_path / "lm.pkl")
    jckpt.save_bundle(pkl, params=jparams, model_config=dataclasses.asdict(jcfg),
                      phn2num=jphn)

    got_params, got_cfg, got_phn = tpretrained.load_lm_params(pth)
    assert got_cfg == port_config(jcfg) and got_phn == jphn
    _assert_trees_equal(got_params, jax.tree.map(np.asarray, jparams))

    m_pth, c_pth, _ = tpretrained.load_lm(pth, CPU)
    m_pkl, c_pkl, _ = tpretrained.load_lm(pkl, CPU)
    m_dir, _, _ = tpretrained.load_lm(str(tmp_path), CPU)  # dir + English.pth
    assert c_pth == c_pkl
    codes, marks = _greedy_codes(m_pth, c_pth)
    assert codes.shape[-1] > 30
    for model in (m_pkl, m_dir):
        c2, k2 = _greedy_codes(model, c_pkl)
        np.testing.assert_array_equal(c2, codes)
        np.testing.assert_array_equal(k2, marks)


@pytest.fixture(scope="module")
def default_codec(tmp_path_factory):
    """A ``wmencodec.th`` at the published default geometry with seeded
    random weights (shapes from JAX's init, values from numpy), and the
    ``.pkl`` of JAX's conversion of it."""
    d = tmp_path_factory.mktemp("codec")
    cfg = CodecConfig()
    shapes = jax.eval_shape(lambda k: jwm.init_wmencodec(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(s.dtype), shapes)
    th = str(d / "wmencodec.th")
    torch.save({"best_state": {k: torch.tensor(v) for k, v in
                               codec_state_dict(params, cfg).items()}}, th)
    tok = jpretrained.load_codec(th)
    pkl = str(d / "codec.pkl")
    jckpt.save_bundle(pkl, params=jax.tree.map(np.asarray, tok.params),
                      config=dataclasses.asdict(cfg))
    rng = np.random.default_rng(12)
    wavs = []
    for i, seconds in enumerate((0.5, 0.3)):
        path = str(d / f"u{i}.wav")
        taudio.write_wav(path, (rng.standard_normal((1, int(16000 * seconds)))
                                * 0.1).astype(np.float32), 16000)
        wavs.append(path)
    return dict(dir=d, th=th, pkl=pkl, params=params, wavs=wavs)


def test_th_codec_encodes_like_the_pkl_of_jax_conversion(default_codec):
    c = default_codec
    th_params, th_cfg = tpretrained.load_codec_params(c["th"])
    _assert_trees_equal(th_params, c["params"])
    assert th_cfg == tpretrained.load_codec_params(c["pkl"])[1]
    wav = taudio.load_for_codec(c["wavs"][0], 16000, 320)
    got = tpretrained.load_codec(c["th"], CPU).encode(wav)[0]
    want = tpretrained.load_codec(c["pkl"], CPU).encode(wav)[0]
    assert got.shape == (1, 4, wav.shape[1] // 320)
    np.testing.assert_array_equal(got, want)
    # train_codec starts from a .th through the same converter
    start = train_codec.load_start_params(c["th"], port_config(CodecConfig()))
    _assert_trees_equal(start, c["params"])


def test_prep_encode_of_the_th_equals_the_pkls(default_codec, tmp_path):
    c = default_codec
    mf = str(tmp_path / "m.jsonl")
    with open(mf, "w") as f:
        f.write("\n".join(json.dumps({"path": p}) for p in c["wavs"]))
    outs = []
    for name in ("th", "pkl"):
        out = str(tmp_path / name)
        stats = tprep.main(["encode", "--manifest", mf, "--codec_path",
                            c[name], "--save_dir", out, "--bucket_frames",
                            "8", "--device", "cpu"])
        assert stats["files"] == 2
        outs.append({f: open(os.path.join(out, f)).read()
                     for f in sorted(os.listdir(out))})
    assert outs[0] == outs[1] and len(outs[0]) == 2


# ------------------------------------------------------------ fetch, locally

def test_fetch_local_file_and_dir(tmp_path):
    f = tmp_path / "ckpt.pkl"
    f.write_bytes(b"x")
    assert tpretrained.fetch_checkpoint(str(f)) == str(f)
    (tmp_path / "wmencodec.th").write_bytes(b"x")
    got = tpretrained.fetch_checkpoint(str(tmp_path), filename="wmencodec.th")
    assert got == str(tmp_path / "wmencodec.th")
    assert got == jpretrained.fetch_checkpoint(str(tmp_path),
                                               filename="wmencodec.th")
    with pytest.raises(FileNotFoundError):
        tpretrained.fetch_checkpoint(str(tmp_path), filename="nope.th")
    with pytest.raises(FileNotFoundError):
        tpretrained.fetch_checkpoint(str(tmp_path / "missing.pkl"))


def test_fetch_checks_a_known_sha256(tmp_path):
    f = tmp_path / "English.pth"
    f.write_bytes(b"checkpoint-bytes")
    digest = tpretrained.file_sha256(str(f))
    assert digest == jpretrained.file_sha256(str(f))
    assert tpretrained.fetch_checkpoint(str(f), sha256=digest) == str(f)
    with pytest.raises(ValueError, match="SHA256 mismatch"):
        tpretrained.fetch_checkpoint(str(f), sha256="0" * 64)


def test_fetch_refuses_the_network():
    with pytest.raises(AssertionError):  # as JAX: a hub id needs a file name
        tpretrained.fetch_checkpoint("westbrook/SSR-Speech-English")
    with pytest.raises(RuntimeError, match="local path"):
        tpretrained.fetch_checkpoint("westbrook/SSR-Speech-English",
                                     filename="English.pth")
    with pytest.raises(RuntimeError, match="local path"):
        tpretrained.fetch_checkpoint("https://example.invalid/wmencodec.th")
