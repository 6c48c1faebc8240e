"""The port's aligners against ``ssr_speech_tpu``'s: the CTC trellis and word
grouping (``tests/test_forced_align.py``), the numeral scan and the
composition of ``resolve_alignment`` (``tests/test_asr_alignment.py``), with
the JAX tests' fakes patched into the port's modules, since the whisper and
wav2vec2 models need downloaded weights.

Through the CLIs: the port's ``cli.main`` with a faked ``--whisper_model``,
and with ``--align_model --orig_transcript``, writes the same wav as the same
request with the equivalent ``--alignment_file``; ``--tts --whisper_model``
(spelled ``--whisper_model_name``) cuts the written output at the fake
re-transcription's first target word, as the JAX CLI does; a ``serve_cli``
job without an ``alignment_file`` resolves through the fakes. Each fake
records the device it was built on: the CLI's ``--device``. (The CLIs' wavs
against the JAX CLIs' are held in tests/test_torch_cli.py and
tests/test_torch_serve_cli.py.)
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from ssr_speech_tpu.utils import forced_align as jfa
from ssr_speech_tpu_torch.inference import cli as tcli
from ssr_speech_tpu_torch.inference import serve_cli as tserve_cli
from ssr_speech_tpu_torch.utils import asr as tasr
from ssr_speech_tpu_torch.utils import audio as taudio
from ssr_speech_tpu_torch.utils import forced_align as tfa
from tests.test_asr_alignment import (RECORDED_ALIGNED, RECORDED_ASR, FakeTok,
                                      FakeW2V, FakeWhisper)
from tests.test_forced_align import _emissions
from tests.test_torch_batched_decode import one_torch_thread
from tests.test_torch_cli import WORDS, _argv, artifacts

__all__ = ["artifacts", "one_torch_thread"]  # module-scoped fixtures, shared

CPU = torch.device("cpu")


# ------------------------------------------------- tests/test_forced_align.py

@pytest.mark.parametrize("path,tokens,want", [
    ([1, 1, 0, 2, 2, 2, 0, 0, 3], [1, 2, 3], [(0, 2), (3, 6), (8, 9)]),
    ([1, 1, 0, 1, 1], [1, 1], [(0, 2), (3, 5)]),  # a repeat needs a blank
    ([1, 2, 3], [1, 2, 3], [(0, 1), (1, 2), (2, 3)]),  # skip transition
], ids=["known_path", "repeat_needs_blank", "skip"])
def test_ctc_align_recovers_known_paths(path, tokens, want):
    lp = _emissions(path, V=5)
    assert tfa.ctc_forced_align(lp, tokens, blank=0) == want
    assert jfa.ctc_forced_align(lp, tokens, blank=0) == want


def test_ctc_align_noisy_emissions():
    rng = np.random.default_rng(0)
    path = [0, 0, 1, 1, 1, 0, 2, 2, 0, 0, 3, 3, 3, 0]
    lp = _emissions(path, V=6, strength=6.0)
    lp = lp + rng.normal(scale=0.5, size=lp.shape)
    lp = lp - np.log(np.exp(lp).sum(axis=1, keepdims=True))
    spans = tfa.ctc_forced_align(lp, [1, 2, 3], blank=0)
    assert spans == jfa.ctc_forced_align(lp, [1, 2, 3], blank=0)
    assert spans[0][0] >= 0 and spans[0][1] <= spans[1][0] + 1
    assert 1 <= spans[0][0] <= 3 and 5 <= spans[1][0] <= 7
    assert 9 <= spans[2][0] <= 11


def test_ctc_align_refuses_too_few_frames():
    lp = _emissions([1, 0, 1], V=3)
    for mod in (tfa, jfa):
        with pytest.raises(ValueError, match="infeasible"):
            mod.ctc_forced_align(lp, [1, 1, 1], blank=0)


def test_tokens_to_word_times():
    spans = [(0, 2), (2, 3), (3, 4), (5, 6), (6, 8)]
    toks = list("hi|yo")
    words = tfa.tokens_to_word_times(spans, toks, sec_per_frame=0.02)
    assert words == jfa.tokens_to_word_times(spans, toks, sec_per_frame=0.02)
    assert [w for w, _, _ in words] == ["hi", "yo"]
    assert words[0][1] == pytest.approx(0.0)
    assert words[0][2] == pytest.approx(0.06)
    assert words[1][1] == pytest.approx(0.10)
    assert words[1][2] == pytest.approx(0.16)


# ------------------------------------------------ tests/test_asr_alignment.py

def test_numeral_suppress_ids_matches_reference_rule():
    assert tasr.numeral_suppress_ids(FakeTok()) == [2, 3, 4, 9]


def test_resolve_alignment_whisper_only(monkeypatch):
    monkeypatch.setattr(tasr, "WhisperAligner", FakeWhisper)
    words = tcli.resolve_alignment("/fake/utt.wav", "", device=CPU,
                                   whisper_model="openai/whisper-tiny")
    assert words == RECORDED_ASR
    assert FakeWhisper.built[-1] == "openai/whisper-tiny"


def test_resolve_alignment_whisper_then_forced_align(monkeypatch):
    monkeypatch.setattr(tasr, "WhisperAligner", FakeWhisper)
    monkeypatch.setattr(tfa, "Wav2Vec2Aligner", FakeW2V)
    words = tcli.resolve_alignment("/fake/utt.wav", "", device=CPU,
                                   whisper_model="openai/whisper-tiny",
                                   align_model="w2v2-base")
    assert words == RECORDED_ALIGNED
    assert FakeW2V.built[-1] == "w2v2-base"


def test_resolve_alignment_known_transcript_skips_asr(monkeypatch):
    class NoAsrW2V(FakeW2V):
        def align(self, audio_path, transcript):
            assert transcript == "hello there world"
            return list(RECORDED_ALIGNED)

    monkeypatch.setattr(tfa, "Wav2Vec2Aligner", NoAsrW2V)
    words = tcli.resolve_alignment("/fake/utt.wav", "hello there world",
                                   device=CPU, align_model="w2v2-base")
    assert words == RECORDED_ALIGNED


def test_resolve_alignment_needs_a_source():
    with pytest.raises(SystemExit, match="alignment_file"):
        tcli.resolve_alignment("/fake/utt.wav", "x", device=CPU)


def test_aligners_import_transformers_only_when_built(monkeypatch):
    """The gated import raises ImportError naming the package when
    ``transformers`` is absent (as on the card's machine)."""
    import builtins

    real = builtins.__import__

    def no_transformers(name, *a, **k):
        if name.split(".")[0] == "transformers":
            raise ModuleNotFoundError("No module named 'transformers'",
                                      name="transformers")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    for build in (lambda: tfa.Wav2Vec2Aligner("m", CPU),
                  lambda: tasr.WhisperAligner("m", CPU)):
        with pytest.raises(ImportError, match="transformers"):
            build()


# ------------------------------------------------------------- through CLIs

def _csv_words(path):
    with open(path) as f:
        return [(r[0], float(r[1]), float(r[2])) for r in csv.reader(f)
                if r and r[0] != "word"]


def _fakes(monkeypatch, mods, orig_audio, words, out_words=None):
    """Whisper and wav2vec2 fakes in ``mods`` (asr, forced_align): both give
    ``words`` for ``orig_audio``; Whisper gives ``out_words`` for any other
    file (the TTS trim's re-transcription). Returns the devices they were
    built on."""
    asr_mod, fa_mod = mods
    built = []

    class Whisper:
        def __init__(self, model_id, device="cpu", *a, **k):
            built.append(("whisper", model_id, str(device)))

        def transcribe(self, audio_path):
            if audio_path == orig_audio:
                return list(words)
            return list(out_words)

    class W2V:
        def __init__(self, model_id, device="cpu", *a, **k):
            built.append(("w2v", model_id, str(device)))

        def align(self, audio_path, transcript):
            assert audio_path == orig_audio
            assert transcript == " ".join(w for w, _, _ in words)
            return list(words)

    monkeypatch.setattr(asr_mod, "WhisperAligner", Whisper)
    monkeypatch.setattr(fa_mod, "Wav2Vec2Aligner", W2V)
    return built


def _without_alignment_file(argv):
    i = argv.index("--alignment_file")
    return argv[:i] + argv[i + 2:]


EDIT = ["--target_transcript", "but when i saw the mirage so near to them",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def reference(artifacts, tmp_path_factory):
    """The edit with the alignment file: (argv, wav)."""
    argv = _argv(artifacts, tmp_path_factory.mktemp("ref"), "ref", *EDIT)
    tcli.main(argv)
    out = argv[argv.index("--output_dir") + 1]
    return argv, taudio.read_wav(os.path.join(out, "ref.wav"))[0]


@pytest.mark.parametrize("flags,want_built", [
    (["--whisper_model", "fake-whisper"], ["whisper"]),
    (["--align_model", "fake-w2v"], ["w2v"]),
    (["--whisper_model", "fake-whisper", "--align_model", "fake-w2v"],
     ["whisper", "w2v"]),
], ids=["whisper", "align_model", "whisper_then_align"])
def test_cli_with_faked_aligners_writes_the_alignment_files_wav(
        artifacts, reference, monkeypatch, tmp_path, flags, want_built):
    words = _csv_words(artifacts["align"])
    built = _fakes(monkeypatch, (tasr, tfa), artifacts["wav"], words)
    argv = _without_alignment_file(reference[0])
    if flags[0] == "--whisper_model":
        # ASR supplies the transcript: none on the command line
        i = argv.index("--orig_transcript")
        argv = argv[:i] + argv[i + 2:]
    tcli.main(argv + ["--output_dir", str(tmp_path), "--savename", "faked",
                      *flags])
    assert [b[0] for b in built] == want_built
    assert all(b[2] == "cpu" for b in built)
    got, sr = taudio.read_wav(str(tmp_path / "faked.wav"))
    assert sr == 16000 and got.shape == reference[1].shape
    assert got.shape[-1] > 0
    np.testing.assert_array_equal(got, reference[1])


def test_cli_tts_trim_by_whisper(artifacts, monkeypatch, tmp_path):
    """``--tts --whisper_model_name base.en``: the written output is
    re-transcribed by ``openai/whisper-base.en`` and rewritten from the
    first target word's start (JAX ``cli.py:256-265``)."""
    words = _csv_words(artifacts["align"])
    out_words = [("a", 0.25, 0.4), ("brand", 0.45, 0.7)]
    built = _fakes(monkeypatch, (tasr, tfa), artifacts["wav"], words,
                   out_words)
    writes = []
    real_write = taudio.write_wav

    def recording(path, wav, rate):
        writes.append((path, np.array(wav)))
        real_write(path, wav, rate)

    monkeypatch.setattr(taudio, "write_wav", recording)
    stats = tcli.main(_argv(
        artifacts, tmp_path, "trim", "--target_transcript",
        "a brand new sentence to speak", "--tts", "--prompt_length", "2.0",
        "--whisper_model_name", "base.en", "--device", "cpu"))
    assert built == [("whisper", "openai/whisper-base.en", "cpu")]
    cut = int(0.25 * 16000)
    assert stats["trimmed_samples"] == cut
    assert [w[0] for w in writes] == [str(tmp_path / "trim.wav")] * 2
    full, trimmed = writes[0][1], writes[1][1]
    assert full.shape[0] == stats["out_samples"] > cut
    np.testing.assert_array_equal(trimmed, full[cut:])
    got, _ = taudio.read_wav(str(tmp_path / "trim.wav"))
    assert got.shape[-1] == stats["out_samples"] - cut


def test_serve_cli_job_without_alignment_file_resolves_through_fakes(
        artifacts, monkeypatch, tmp_path):
    words = _csv_words(artifacts["align"])
    built = _fakes(monkeypatch, (tasr, tfa), artifacts["wav"], words)
    jobs = []
    for i, target in enumerate(("but when i saw them so near",
                                "but when i had approached the sea")):
        job = dict(orig_audio=artifacts["wav"], orig_transcript=" ".join(WORDS),
                   target_transcript=target, savename=f"job{i}")
        jobs.append(job)
    paths = {}
    for name, with_file in (("files", True), ("faked", False)):
        path = str(tmp_path / f"{name}.jsonl")
        with open(path, "w") as f:
            for job in jobs:
                row = dict(job, alignment_file=artifacts["align"]) \
                    if with_file else job
                f.write(json.dumps(row) + "\n")
        paths[name] = path
    base = ["--model_path", artifacts["lm"], "--codec_path", artifacts["codec"],
            "--top_k", "1", "--stop_repetition", "-1", "--device", "cpu"]
    tserve_cli.main(base + ["--jobs", paths["files"], "--output_dir",
                            str(tmp_path / "files")])
    assert built == []  # the files need no aligner
    tserve_cli.main(base + ["--jobs", paths["faked"], "--output_dir",
                            str(tmp_path / "faked"), "--align_model", "w2v"])
    assert built == [("w2v", "w2v", "cpu")] * 2
    for job in jobs:
        name = job["savename"] + ".wav"
        got, _ = taudio.read_wav(os.path.join(tmp_path, "faked", name))
        want, _ = taudio.read_wav(os.path.join(tmp_path, "files", name))
        assert got.shape == want.shape and got.shape[-1] > 0
        np.testing.assert_array_equal(got, want)
