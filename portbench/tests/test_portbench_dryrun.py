"""The command itself, through its own argument parsing, on a machine
without a card: no fallback to the CPU, no result line, a non-zero exit;
and from a directory that holds only BENCHMARK.json and portbench/, no
result either."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench.lib import common


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "e830m-edit-1client",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    out = _run(common.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "not measured" in out.stderr


def test_needs_the_program(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_control_fails_on_the_card():
    """On the card at the cells' own sizes: the port's run is correct, and
    a control run (the reference in a lower precision in the program's
    place, judged by the same checks) is not, with a number over its
    limit."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell, numbers in (("e830m-edit-1client", ("logit_gap_mean", "wav_rel_err")),
                          ("wmencodec-prep-encode", ("latent_rel_err", "code_gap")),
                          ("e830m-serve-open", ("logit_gap_mean",))):
        for control in ("0", "1"):
            out = subprocess.run(
                [sys.executable, "portbench/run.py", "--workload", cell,
                 "--seed", str(2 ** 31 + 77), "--seconds", "20", "--trace", "0",
                 "--control", control],
                cwd=common.ROOT, capture_output=True, text=True, timeout=900)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            failed = [c["name"] for c in line["checks"] if not c["ok"]]
            if control == "0":
                assert line["correct"], line["checks"]
            else:
                assert not line["correct"], line["checks"]
                assert set(failed) & set(numbers), line["checks"]
