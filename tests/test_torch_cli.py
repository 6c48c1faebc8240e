"""The port's CLI against the JAX CLI on the CPU, on tiny random bundles (the
recipe of tests/test_cli_integration.py): the same edit and TTS requests,
English and Mandarin (``--language zh``: a char-level diff, CFG stride 1),
greedy, with the JAX decode pinned to fp32, must write the same wav, and so
must ``--sample_batch_size 3``'s three. Also: the port's bundles load in the
JAX package, its init matches the JAX init's structure, its CLI imports no
JAX, and it refuses what it cannot run (no alignment source, no card)."""

import csv
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import (CodecConfig, RVQConfig, SEANetConfig,
                                   tiny_codec_config, tiny_ssr_config)
from ssr_speech_tpu.inference import cli as jcli
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models import pretrained as jpretrained
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.utils import audio as audio_io
from ssr_speech_tpu.utils import checkpoint as ckpt
from ssr_speech_tpu_torch.inference import cli as tcli
from ssr_speech_tpu_torch.models import pretrained as tpretrained
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models.codec import wmencodec as twm
from ssr_speech_tpu_torch.utils import prng
from tests.test_torch_hostcopies import NO_JAX_PACKAGE, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_ssr_config(text_vocab_size=40)
CODEC = CodecConfig(
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(8, 5, 4, 2), lstm=1, norm="weight_norm",
                        pad_mode="constant"),
    rvq=RVQConfig(dimension=16, n_q=CFG.n_codebooks,
                  bins=CFG.tokens.audio_vocab_size))
WORDS = ["but", "when", "i", "had", "approached", "so", "near", "to", "them"]
# the Mandarin requests (tests/test_cli_integration.py's zh edit): one phone
# id a character, a character-level alignment
ZH_CHARS = "今天气很好不错"
ZH_ORIG = "今天天气很好"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    phn2num = {c: i for i, c in enumerate(
        "abcdefghijklmnopqrstuvwxyz_.!?,' " + ZH_CHARS)}
    lm_path = str(d / "bundle.pkl")
    ckpt.save_bundle(lm_path, params=jssr.init_ssr(jax.random.PRNGKey(0), CFG),
                     model_config=dataclasses.asdict(CFG), phn2num=phn2num)
    codec_path = str(d / "codec.pkl")
    ckpt.save_bundle(codec_path,
                     params=jwm.init_wmencodec(jax.random.PRNGKey(1), CODEC),
                     config=dataclasses.asdict(CODEC))
    rng = np.random.default_rng(0)
    wav_path = str(d / "in.wav")
    audio_io.write_wav(wav_path,
                       (rng.normal(size=(1, 48000)) * 0.1).astype(np.float32),
                       16000)
    dur = 3.0
    align_path = str(d / "align.csv")
    step = dur / (len(WORDS) + 1)
    with open(align_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["word", "start", "end"])
        for i, word in enumerate(WORDS):
            w.writerow([word, round(i * step + 0.05, 3), round((i + 1) * step, 3)])
    # a character-level alignment of a Mandarin transcript over the same wav
    zh_align = str(d / "zh_align.csv")
    step = dur / (len(ZH_ORIG) + 1)
    with open(zh_align, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["word", "start", "end"])
        for i, ch in enumerate(ZH_ORIG):
            w.writerow([ch, round(i * step + 0.05, 3), round((i + 1) * step, 3)])
    return dict(lm=lm_path, codec=codec_path, wav=wav_path, align=align_path,
                zh_align=zh_align, dir=d)


def _argv(a, out_dir, name, *extra):
    return ["--model_path", a["lm"], "--codec_path", a["codec"],
            "--orig_audio", a["wav"], "--orig_transcript", " ".join(WORDS),
            "--alignment_file", a["align"], "--output_dir", str(out_dir),
            "--savename", name, "--top_k", "1", "--stop_repetition", "-1",
            *extra]


REQUESTS = {
    "edit_watermark_cfg": ["--target_transcript",
                           "but when i saw the mirage so near to them",
                           "--use_watermark", "--aug_text", "--cfg_pretrained",
                           "--cfg_stride", "5"],
    "tts": ["--target_transcript", "a brand new sentence to speak", "--tts",
            "--prompt_length", "2.0"],
    # Mandarin: a char-level diff, the CFG combine every step (stride 1)
    "zh_edit_cfg_stride1": ["--language", "zh", "--orig_transcript", ZH_ORIG,
                            "--target_transcript", "今天天气不错",
                            "--alignment_file", "{zh_align}",
                            "--use_watermark", "--aug_text",
                            "--cfg_pretrained", "--cfg_stride", "1"],
    "zh_tts": ["--language", "zh", "--orig_transcript", ZH_ORIG,
               "--target_transcript", "不错", "--alignment_file", "{zh_align}",
               "--tts", "--prompt_length", "1.5"],
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_cli_matches_jax_cli(artifacts, monkeypatch, name):
    out = artifacts["dir"] / "out"
    extra = [arg.format(**artifacts) for arg in REQUESTS[name]]
    stats = tcli.main(_argv(artifacts, out, f"torch_{name}", "--device", "cpu",
                            *extra))
    monkeypatch.setattr(jdecode, "generate", functools.partial(
        jdecode.generate, dtype_name="float32"))
    jcli.main(_argv(artifacts, out, f"jax_{name}", *extra))
    got, sr = audio_io.read_wav(str(out / f"torch_{name}.wav"))
    want, sr_j = audio_io.read_wav(str(out / f"jax_{name}.wav"))
    assert sr == sr_j == 16000
    assert got.shape == want.shape and got.shape[-1] > 0
    assert got.shape[-1] == stats["out_samples"]
    assert np.isfinite(got).all()
    # 16-bit PCM of waveforms that agree to ~1e-6: at most one LSB apart
    assert np.abs(got - want).max() <= 1.0 / 32768 + 1e-9
    assert stats["decode_steps"] > 0


def test_port_bundles_load_in_jax(tmp_path):
    """A bundle written by the port's save_bundle from its own init is a JAX
    bundle: the JAX loader reads it, with the JAX init's tree structure and,
    from the same seed, JAX's values bit for bit
    (``tests/test_torch_prng.py``)."""
    params = tssr.init_ssr(prng.PRNGKey(0), port_config(CFG))
    path = str(tmp_path / "lm.pkl")
    tpretrained.save_bundle(path, params=params, model_config=port_config(CFG),
                            phn2num={"a": 0})
    jparams, jcfg, phn2num = jpretrained.load_lm(path)
    assert jcfg == CFG and phn2num == {"a": 0}
    ref = jssr.init_ssr(jax.random.PRNGKey(0), CFG)
    assert (jax.tree.structure(jparams) == jax.tree.structure(ref))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    model, _, _ = tpretrained.load_lm(path, torch.device("cpu"))
    np.testing.assert_array_equal(model["decoder"]["layers"]["qkv_w"].numpy(),
                                  params["decoder"]["layers"]["qkv_w"].numpy())


@pytest.mark.parametrize("cfg", [tiny_codec_config(), CODEC],
                         ids=["tiny", "cli"])
def test_codec_init_structure_matches_jax(cfg):
    """The port's codec init from the same seed: JAX's tree, and JAX's
    values within 1e-6 relative (the draws bit for bit, weight norm's gains
    a reduction order apart)."""
    ours = twm.init_wmencodec(prng.PRNGKey(0), port_config(cfg))
    ref = jwm.init_wmencodec(jax.random.PRNGKey(0), cfg)
    ours = jax.tree.map(lambda t: t.numpy(), ours)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)


ALIGN = [(w, round(i * 0.3 + 0.05, 3), round((i + 1) * 0.3, 3))
         for i, w in enumerate(WORDS)]


@pytest.mark.parametrize("helper,args", [
    ("word_span_to_time", (ALIGN, (0, 0))),
    ("word_span_to_time", (ALIGN, (3, 3))),
    ("word_span_to_time", (ALIGN, (2, 5))),
    ("word_span_to_time", (ALIGN, (9, 9))),
    ("spans_to_mask_intervals", (ALIGN, [(1, 2), (2, 4), (7, 9)], 2.8)),
    ("cut_prompt_for_tts", (ALIGN, 1.0)),
    ("cut_prompt_for_tts", (ALIGN, 0.1)),
    ("tts_trim_offset", (ALIGN, "BUT")),
    ("tts_trim_offset", (ALIGN, "mirage")),
    ("tts_trim_offset", (ALIGN[:1], "mirage")),
    ("tts_trim_offset", ([], "but")),
])
def test_pipeline_host_helpers_match_jax(helper, args):
    """The port restates these host helpers (the JAX module imports JAX)."""
    from ssr_speech_tpu.inference import pipeline as jpipe
    from ssr_speech_tpu_torch.inference import pipeline as tpipe

    assert getattr(tpipe, helper)(*args) == getattr(jpipe, helper)(*args)


def test_cli_imports_no_jax():
    """The port imports neither JAX nor the JAX package: importing its CLI
    and running the parser in a fresh interpreter leaves ``jax`` and every
    ``ssr_speech_tpu.*`` module out of sys.modules."""
    code = ("import sys; from ssr_speech_tpu_torch.inference import cli; "
            "cli.build_parser().parse_args(['--model_path', 'm', "
            "'--codec_path', 'c', '--orig_audio', 'a', "
            "'--target_transcript', 't']); "
            "import ssr_speech_tpu_torch.models.pretrained, "
            "ssr_speech_tpu_torch.inference.pipeline, "
            "ssr_speech_tpu_torch.inference.edit; " + NO_JAX_PACKAGE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cli_sample_batch_size_matches_jax_cli(artifacts, monkeypatch):
    """--sample_batch_size 3: the seeds decoded in one loop, one wav a seed
    (``{savename}_seed{seed + i}``), each within one LSB of the JAX CLI's;
    greedy, so the three are the same."""
    out = artifacts["dir"] / "out_batch"
    extra = REQUESTS["edit_watermark_cfg"] + ["--sample_batch_size", "3",
                                              "--seed", "4"]
    stats = tcli.main(_argv(artifacts, out, "torch_b", "--device", "cpu",
                            *extra))
    monkeypatch.setattr(jdecode, "generate_batch", functools.partial(
        jdecode.generate_batch, dtype_name="float32"))
    jcli.main(_argv(artifacts, out, "jax_b", *extra))
    assert stats["n_samples"] == 3 and stats["decode_steps"] > 0
    assert stats["out_paths"] == [str(out / f"torch_b_seed{i}.wav")
                                  for i in (4, 5, 6)]
    for i in (4, 5, 6):
        got, sr = audio_io.read_wav(str(out / f"torch_b_seed{i}.wav"))
        want, sr_j = audio_io.read_wav(str(out / f"jax_b_seed{i}.wav"))
        assert sr == sr_j == 16000
        assert got.shape == want.shape and got.shape[-1] > 0
        assert np.abs(got - want).max() <= 1.0 / 32768 + 1e-9


def test_cli_refuses_what_it_does_not_run(artifacts, tmp_path):
    base = _argv(artifacts, tmp_path, "x", "--target_transcript", "so near")
    # the aligner flags are ported: with an alignment file none is consulted
    # (tests/test_torch_aligners.py drives them through fakes)
    stats = tcli.main(base + ["--device", "cpu", "--sample_batch_size", "2",
                              "--whisper_model", "w", "--align_model", "a"])
    assert stats["n_samples"] == 2 and stats["out_finite"]
    no_align = [a for a in base if a != base[base.index("--alignment_file") + 1]
                and a != "--alignment_file"]
    no_align.remove("--orig_transcript")
    no_align.remove(" ".join(WORDS))
    with pytest.raises(SystemExit, match="alignment_file"):
        tcli.main(no_align + ["--device", "cpu"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(base)  # --device defaults to cuda: no silent CPU run


def test_inference_multi_refuses_continuous(monkeypatch):
    """``continuous=True`` no longer raises (the continuous-batching server
    is ported): it goes to ``serve.serve_requests`` and never to the static
    batches of ``generate_multi``."""
    from ssr_speech_tpu_torch.inference import pipeline as tpipe

    calls = []
    monkeypatch.setattr(tpipe.serve, "serve_requests",
                        lambda *a, **kw: calls.append(kw) or [])
    monkeypatch.setattr(tpipe.decode_mod, "generate_multi",
                        lambda *a, **kw: pytest.fail("static batches ran"))
    lm = {"text_emb": torch.zeros(1)}
    assert tpipe.inference_multi(lm, port_config(CFG), None, {}, None, None,
                                 [], continuous=True, n_slots=3) == []
    assert len(calls) == 1 and calls[0]["n_slots"] == 3
