"""The port's two rehearsals on the CPU: the train->serve lifecycle
(``ssr_speech_tpu_torch/lifecycle_rehearsal.py``) and the data-prep pipeline
(``ssr_speech_tpu_torch/prep_rehearsal.py``).

Fast: the lifecycle at 2 codec and 2 LM steps and the prep rehearsal
``--tiny --n_utts 4``: every stage runs, the report has every key of the JAX
tool's report (``tools/*_rehearsal.py``, read from their source) and the
artifacts exist. Slow-marked: tests/test_lifecycle.py's three tests, their
thresholds unchanged, on the port's lifecycle at the JAX test's step counts
(500 codec, 220 LM).
"""

import ast
import json
import os
from pathlib import Path

import pytest

from ssr_speech_tpu_torch import lifecycle_rehearsal, prep_rehearsal

REPO = Path(__file__).resolve().parent.parent


def jax_report_keys(tool: str) -> set:
    """The keys a ``tools/`` rehearsal puts in its report: the ``report =
    {...}`` literal and every ``report["key"] = ...``."""
    tree = ast.parse((REPO / "tools" / tool).read_text())
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if getattr(target, "id", None) == "report" \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(target, ast.Subscript) \
                    and getattr(target.value, "id", None) == "report":
                keys.add(target.slice.value)
    return keys


def test_lifecycle_rehearsal_runs_every_stage(tmp_path):
    out = tmp_path / "lifecycle"
    report = lifecycle_rehearsal.main(["--out", str(out), "--device", "cpu",
                                       "--codec_steps", "2", "--lm_steps", "2"])
    assert report["ok"]
    assert set(report) == jax_report_keys("lifecycle_rehearsal.py")
    assert set(json.loads((out / "report.json").read_text())) == set(report)
    for path in ("codec_exp/codec_bundle.pkl", "lm_exp/bundle.pkl",
                 "cli_out/tts.wav", "cli_out/edit.wav", "dataset/vocab.txt",
                 "dataset/manifest/train.txt", "align0.csv"):
        assert (out / path).is_file(), path
    assert len(os.listdir(out / "dataset" / "codes")) == report["n_utts"]
    ms, me = report["edit_mask"]
    assert 0 < ms < me
    assert report["token_truth_frames"] > 0


def test_prep_rehearsal_runs_every_stage(tmp_path):
    out = tmp_path / "prep"
    report = prep_rehearsal.main(["--out", str(out), "--n_utts", "4",
                                  "--tiny", "--device", "cpu"])
    assert report["ok"] and report["n_utts"] == 4 and report["tiny"]
    assert set(report) == jax_report_keys("prep_rehearsal.py")
    assert report["kept_utts"] >= 3  # min_frames drops at most the shortest
    ds = out / "dataset"
    assert len((ds / "vocab.txt").read_text().splitlines()) > 10
    assert json.loads((out / "report.json").read_text())["n_utts"] == 4
    # the tag round trip reached the phoneme files (utt00000 carries a tag)
    phn0 = (ds / "phonemes" / "utt00000.txt").read_text()
    assert any(t in phn0.split(" ") for t in ("<MUSIC>", "<SIL>")), phn0
    # training consumed them: a bundle was written
    assert any(f.endswith(".pkl") for f in os.listdir(out / "exp"))


# ------------- tests/test_lifecycle.py's three tests, on the port (slow)

@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lifecycle_full"))
    return lifecycle_rehearsal.main(["--out", out, "--device", "cpu",
                                     "--codec_steps", "500",
                                     "--lm_steps", "220"])


@pytest.mark.slow
def test_lifecycle_overfit_lm_reproduces_training_utterance(report):
    assert report["token_match"] >= 0.9, report
    assert abs(report["token_gen_frames"] - report["token_truth_frames"]) <= 3


@pytest.mark.slow
def test_lifecycle_watermark_flags_generated_spans(report):
    assert report["tts_flagged"] is True, report
    assert report["tts_wm_fraction"] >= 0.85, report
    assert report["clean_flagged"] is False, report
    assert report["clean_wm_fraction"] <= 0.15, report
    assert report["edit_prefix_fp"] <= 0.15, report
    assert report["edit_suffix_fp"] <= 0.15, report
    assert report["edit_gen_coverage"] >= 0.8, report


@pytest.mark.slow
def test_lifecycle_artifacts_and_stages(report):
    assert report["ok"]
    ms, me = report["edit_mask"]
    assert 0 < ms < me
    assert report["edit_gen_len"] > 0
