"""The port's batch serving CLI against the JAX ``serve_cli`` on the CPU, on
the tiny bundles of tests/test_serve_cli.py: static sorted batches,
``--continuous`` and ``--stream`` write the same wavs (within one 16-bit
LSB), greedy, with the JAX decode pinned to fp32; the stream mode's
manifests and chunks add up to its wavs, and it refuses edit jobs."""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest

from ssr_speech_tpu.inference import cli as jcli
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.inference import serve as jserve
from ssr_speech_tpu.inference import serve_cli as jserve_cli
from ssr_speech_tpu.inference import stream as jstream
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.utils import audio as audio_io
from ssr_speech_tpu.utils import checkpoint as ckpt
from ssr_speech_tpu_torch.inference import serve_cli as tserve_cli
from tests.test_serve_cli import (CAUSAL_CODEC, CODEC, _tts_jobs, artifacts)
from tests.test_torch_batched_decode import one_torch_thread

__all__ = ["artifacts", "one_torch_thread"]  # module-scoped fixtures, shared

LSB = 1.0 / 32768 + 1e-9
GREEDY = ["--top_k", "1", "--stop_repetition", "-1", "--n_slots", "2"]


@pytest.fixture(autouse=True)
def jax_fp32(monkeypatch):
    """The JAX CLI's decode in fp32 (its default is bf16), and its codec
    loader on the tiny config (as tests/test_serve_cli.py does)."""
    monkeypatch.setattr(jdecode, "generate_multi", functools.partial(
        jdecode.generate_multi, dtype_name="float32"))
    monkeypatch.setattr(jserve, "serve_requests", functools.partial(
        jserve.serve_requests, dtype_name="float32"))
    monkeypatch.setattr(jstream, "StreamingServer", functools.partial(
        jstream.StreamingServer, dtype_name="float32"))


def _jax_codec(monkeypatch, params, cfg):
    from ssr_speech_tpu.data.tokenizer import AudioTokenizer

    monkeypatch.setattr(jcli, "load_codec",
                        lambda path: AudioTokenizer(params, cfg))


def _same_wavs(dir_a, dir_b, names):
    for name in names:
        got, sr = audio_io.read_wav(os.path.join(dir_a, name + ".wav"))
        want, sr_j = audio_io.read_wav(os.path.join(dir_b, name + ".wav"))
        assert sr == sr_j == 16000
        assert got.shape == want.shape and got.shape[-1] > 0, name
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= LSB, name


@pytest.mark.parametrize("mode", ["sorted", "continuous"])
def test_serve_cli_matches_jax(artifacts, monkeypatch, tmp_path, mode):
    """Two edits and a TTS job through two slots (two static batches, or
    one refilled lane): each wav within one LSB of the JAX CLI's."""
    _jax_codec(monkeypatch, ckpt.load_bundle(artifacts["codec"])["params"],
               CODEC)
    argv = ["--model_path", artifacts["lm"], "--codec_path",
            artifacts["codec"], "--jobs", artifacts["jobs"], *GREEDY]
    if mode == "continuous":
        argv += ["--continuous", "--aug_text", "--cfg_pretrained",
                 "--use_watermark"]
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    stats = tserve_cli.main(argv + ["--output_dir", out_t, "--device", "cpu"])
    jserve_cli.main(argv + ["--output_dir", out_j])
    _same_wavs(out_t, out_j, ["edit0", "tts1", "edit2"])
    assert stats["out_finite"] and len(stats["out_paths"]) == 3
    assert stats["decode_steps"] > 0
    if mode == "continuous":
        assert len(stats["prefill_layouts"]) == 3 and stats["chunks"] >= 2


@pytest.fixture(scope="module")
def causal_bundle(artifacts):
    """The causal codec of tests/test_serve_cli.py's stream test, as a
    bundle the port's loader reads (config included)."""
    params = jwm.init_wmencodec(jax.random.PRNGKey(2), CAUSAL_CODEC)
    path = os.path.join(artifacts["dir"], "causal_codec.pkl")
    ckpt.save_bundle(path, params=params,
                     config=dataclasses.asdict(CAUSAL_CODEC))
    return path, params


def test_serve_cli_stream_matches_jax(artifacts, causal_bundle, monkeypatch,
                                      tmp_path):
    """``--stream``: two TTS jobs through two lanes; each wav within one LSB
    of the JAX CLI's, the emission manifest time-ordered, its samples and
    the saved chunks adding up to the wav."""
    path, params = causal_bundle
    _jax_codec(monkeypatch, params, CAUSAL_CODEC)
    jobs = str(tmp_path / "tts_jobs.jsonl")
    _tts_jobs(artifacts, jobs, ["s0", "s1"])
    argv = ["--model_path", artifacts["lm"], "--codec_path", path, "--jobs",
            jobs, "--stream", "--chunk_frames", "10", "--save_chunks",
            *GREEDY]
    out_t, out_j = str(tmp_path / "torch"), str(tmp_path / "jax")
    stats = tserve_cli.main(argv + ["--output_dir", out_t, "--device", "cpu"])
    jserve_cli.main(argv + ["--output_dir", out_j])
    _same_wavs(out_t, out_j, ["s0", "s1"])
    for name, st in zip(["s0", "s1"], stats["streams"]):
        wav, _ = audio_io.read_wav(os.path.join(out_t, name + ".wav"))
        with open(os.path.join(out_t, name + ".stream.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        assert len(lines) == st["chunks"] >= 1
        ts = [line["t"] for line in lines]
        assert ts == sorted(ts)
        assert sum(line["samples"] for line in lines) == wav.shape[-1]
        cdir = os.path.join(out_t, name + ".chunks")
        cat = np.concatenate([audio_io.read_wav(os.path.join(cdir, c))[0]
                              for c in sorted(os.listdir(cdir))], axis=-1)
        np.testing.assert_allclose(cat, wav, atol=1e-4)
        assert st["first_at"] <= st["done_at"]


def test_serve_cli_stream_rejects_edit_jobs(artifacts, tmp_path):
    with pytest.raises(SystemExit, match="tts"):
        tserve_cli.main([
            "--model_path", artifacts["lm"], "--codec_path",
            artifacts["codec"], "--jobs", artifacts["jobs"], "--output_dir",
            str(tmp_path / "bad"), "--stream", "--chunk_frames", "10",
            "--n_slots", "2", "--device", "cpu"])


def test_serve_cli_refuses_what_it_does_not_run(artifacts, tmp_path):
    """A job with neither an alignment file nor an aligner flag exits, and
    the default device is the card: no silent CPU run. (The aligner flags
    are ported: tests/test_torch_aligners.py drives them through fakes.)"""
    import torch

    base = ["--model_path", artifacts["lm"], "--codec_path",
            artifacts["codec"], "--jobs", artifacts["jobs"], "--output_dir",
            str(tmp_path / "refused")]
    bare = str(tmp_path / "bare.jsonl")
    with open(artifacts["jobs"]) as f, open(bare, "w") as g:
        for line in f:
            job = json.loads(line)
            del job["alignment_file"]
            g.write(json.dumps(job) + "\n")
    argv = [bare if a == artifacts["jobs"] else a for a in base]
    with pytest.raises(SystemExit, match="alignment_file"):
        tserve_cli.main(argv + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tserve_cli.main(base)
