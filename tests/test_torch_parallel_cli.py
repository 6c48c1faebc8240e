"""The parallel CLIs of the port over 2 spawned ranks on the CPU (gloo):
``train_lm --tp 2`` (and ``--sequence_parallel``) for 2 steps, resumed for a
third, against the one-process run of the same flags (losses rtol 1e-4:
the tp step's sums in another order), rank 0's bundle read by a one-device
``Trainer``; ``train_codec --data_parallel`` for 2 steps against the
one-process run (metrics rel 2e-3, the JAX dp test's tolerance); and the
refusal of ``--tp`` without a world to split."""

import os
import pickle

import numpy as np
import pytest

from ssr_speech_tpu_torch import train_codec, train_lm
from ssr_speech_tpu_torch.parallel.dist import spawn
from ssr_speech_tpu_torch.training.trainer import Trainer
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests import torch_parallel_ranks as ranks
from tests.test_torch_trainer import TINY
from tests.test_training import make_synth_corpus


def test_train_lm_tp2_matches_one_process_and_resumes(tmp_path):
    root = make_synth_corpus(tmp_path)
    base = ["--dataset_dir", root, "--encodec_folder_name", "codes", *TINY,
            "--num_steps", "1"]
    one = train_lm.main(["--exp_dir", str(tmp_path / "one"), *base])
    exp = str(tmp_path / "tp")
    res = spawn(ranks.run_train_lm, 2, args=(
        ["--exp_dir", exp, "--tp", "2", "--sequence_parallel", *base],
        ["--exp_dir", exp, "--tp", "2", "--resume", *base[:-2],
         "--num_steps", "2"]))
    want = [h["loss"] for h in one.history]
    for r in res:
        got = [h["loss"] for h in r["history"]]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert [h["step"] for h in r["resumed"]] == [2]
        assert np.isfinite(r["resumed"][0]["loss"])
    assert sorted(os.listdir(exp)) == sorted(os.listdir(tmp_path / "one"))
    # rank 0's bundle is the whole model: a one-device trainer loads it
    with open(os.path.join(exp, "bundle.pkl"), "rb") as f:
        bundle = pickle.load(f)
    tr = Trainer(one.cfg, one.tcfg, lambda e: iter(()), device="cpu",
                 exp_dir=str(tmp_path / "reload"))
    tr.load_bundle(os.path.join(exp, "bundle.pkl"))
    assert tr.progress["step"] == bundle["progress"]["step"] == 3
    for got, want in zip(tree_leaves(tr.model.tree()),
                         tree_leaves(bundle["params"])):
        np.testing.assert_array_equal(got.detach().numpy(), want)


def test_train_lm_tp_refuses_a_world_of_one(tmp_path):
    with pytest.raises(SystemExit, match="torchrun"):
        train_lm.main(["--exp_dir", str(tmp_path / "x"), "--dataset_dir",
                       str(tmp_path), "--tp", "2", *TINY])


def test_train_codec_data_parallel_matches_one_process(tmp_path):
    from tests.test_torch_train_codec_cli import TINY as CTINY, _argv
    from tests.test_codec_cli import make_manifest
    from ssr_speech_tpu_torch.config import config_to_json
    from tests.test_torch_hostcopies import port_config

    mf = make_manifest(tmp_path, n=3, dur=1.0)
    cfg_json = str(tmp_path / "codec.json")
    with open(cfg_json, "w") as f:
        f.write(config_to_json(port_config(CTINY)))
    argv = lambda exp, *x: _argv(tmp_path, mf, cfg_json, exp, "--updates", "2",  # noqa: E731
                                 "--save_every", "2", *x)
    one = train_codec.main(argv(str(tmp_path / "one")))
    exp = str(tmp_path / "dp")
    res = spawn(ranks.run_train_codec, 2, args=(argv(exp, "--data_parallel"),))
    for r in res:
        assert len(r["history"]) == 2
        for got, want in zip(r["history"], one["history"]):
            for k in want:
                if k != "wall_s":
                    assert got[k] == pytest.approx(want[k], rel=2e-3, abs=2e-5), k
        assert r["eval_sisnr"][0][1] == pytest.approx(one["eval_sisnr"][0][1],
                                                      rel=2e-3)
    assert [h["g_loss"] for h in res[0]["history"]] == [
        h["g_loss"] for h in res[1]["history"]]
    assert os.path.isfile(os.path.join(exp, "codec_bundle.pkl"))
