"""The port's quality-eval CLI (``ssr_speech_tpu_torch/eval_quality.py``)
against ``tools/eval_quality.py`` on the same manifests: the same report
(SI-SNR, WER/CER from the rows' transcripts or from a stand-in Whisper over
the generated audio; the speaker and ViSQOL paths stay off), a stereo pair
mixed to mono, and a missing ViSQOL binary refused by name."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from ssr_speech_tpu.utils import asr as jasr
from ssr_speech_tpu.utils import audio as audio_io
from ssr_speech_tpu_torch import eval_quality as teval
from ssr_speech_tpu_torch.utils import asr as tasr

REPO = Path(__file__).resolve().parent.parent


def _load_tool():
    path = REPO / "tools" / "eval_quality.py"
    spec = importlib.util.spec_from_file_location("eval_quality_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _manifest(tmp_path, rows_extra, channels=1):
    rng = np.random.default_rng(0)
    sr = 16000
    rows = []
    for i, extra in enumerate(rows_extra):
        ref = (rng.normal(size=(channels, sr)) * 0.1).astype(np.float32)
        gen = ref + (rng.normal(size=(channels, sr)) * 0.02).astype(np.float32)
        rp, gp = str(tmp_path / f"r{i}.wav"), str(tmp_path / f"g{i}.wav")
        audio_io.write_wav(rp, ref, sr)
        audio_io.write_wav(gp, gen, sr)
        rows.append({"ref": rp, "gen": gp, **extra})
    path = tmp_path / "pairs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def _both(tmp_path, argv, capsys):
    out_j, out_t = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    _load_tool().main(argv + ["--out", out_j])
    printed_j = json.loads(capsys.readouterr().out)
    got = teval.main(argv + ["--out", out_t, "--device", "cpu"])
    printed_t = json.loads(capsys.readouterr().out)
    want = json.loads(Path(out_j).read_text())
    assert printed_j == want and printed_t == got
    assert json.loads(Path(out_t).read_text()) == got
    return got, want


@pytest.mark.parametrize("language,rows,channels", [
    ("en", [{"text": "hello world", "hyp": "hello word"}] * 2, 1),
    ("zh", [{"text": "今天天气很好", "hyp": "今天天气不错"}], 1),
    ("en", [{}, {}], 2),
], ids=["en-transcripts", "zh-transcripts", "stereo-no-text"])
def test_reports_equal(tmp_path, capsys, language, rows, channels):
    pairs = _manifest(tmp_path, rows, channels)
    got, want = _both(tmp_path, ["--pairs", pairs, "--language", language],
                      capsys)
    assert got.keys() == want.keys() and got["skipped"] == want["skipped"]
    assert got["n"] == want["n"] == len(rows)
    for key in ("si_snr_db", "wer", "cer"):
        assert (key in got) == (key in want)
        if key in got:
            assert got[key] == pytest.approx(want[key], abs=1e-5), key
    assert got["si_snr_db"] > 10


class FakeWhisper:
    """Stands in for ``WhisperAligner``: its pipeline 'transcribes' every
    clip as the same text (never a real model: that would download)."""

    def __init__(self, model_id, device="cpu", **_):
        self.model_id = model_id
        self.pipe = lambda inputs, **kw: {"text": "hello word",
                                          "chunks": []}


def test_whisper_transcripts_equal(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(jasr, "WhisperAligner", FakeWhisper)
    monkeypatch.setattr(tasr, "WhisperAligner", FakeWhisper)
    pairs = _manifest(tmp_path, [{"text": "hello world"}] * 2)
    got, want = _both(tmp_path, ["--pairs", pairs, "--whisper_model",
                                 "stand-in"], capsys)
    assert got["wer"] == want["wer"] == pytest.approx(0.5)
    assert got["cer"] == pytest.approx(want["cer"], abs=1e-6)


def test_missing_visqol_binary_is_named(tmp_path):
    pairs = _manifest(tmp_path, [{}])
    with pytest.raises(FileNotFoundError, match="visqol binary not found"):
        teval.main(["--pairs", pairs, "--device", "cpu", "--visqol_bin",
                    str(tmp_path / "no_visqol")])
