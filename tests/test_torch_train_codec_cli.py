"""The port's ``train_codec`` and ``detect_cli`` on the CPU at tiny
geometry: ``main`` over a seeded manifest, starting from a codec bundle the
JAX package wrote, writes ``config.json``, the bundle and the generate
stage's samples (stub ViSQOL); the JAX package's ``load_bundle`` reads that
bundle, its frozen parts are the start bundle's bit for bit, and both
packages' ``detect_cli`` give the same per-frame decisions on it."""

import dataclasses
import json
import os
import stat

import jax
import numpy as np
import pytest

from ssr_speech_tpu import train_codec as jtrain_codec
from ssr_speech_tpu.config import config_to_json
from ssr_speech_tpu.inference import detect_cli as jdetect
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.utils import checkpoint as jckpt
from ssr_speech_tpu_torch import train_codec
from ssr_speech_tpu_torch.inference import detect_cli as tdetect
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests.test_codec_cli import make_manifest
from tests.test_torch_codec_train import TINY
from tests.test_visqol import STUB


def _visqol_stub(root):
    (root / "bazel-bin").mkdir(parents=True)
    (root / "model").mkdir()
    exe = root / "bazel-bin" / "visqol"
    exe.write_text(STUB)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(root)


def _argv(tmp, mf, cfg_json, exp, *extra):
    return ["--device", "cpu", "--manifest", mf, "--exp_dir", exp,
            "--config_json", cfg_json, "--batch_size", "2",
            "--segment_duration", "0.5", "--updates", "3", "--epochs", "1",
            "--save_every", "2", "--eval_every", "2", "--disc_scales", "2",
            "--wm_min_regions", "1", "--loader_threads", "0", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_codec")
    mf = make_manifest(tmp, n=3, dur=1.0)
    cfg_json = str(tmp / "codec.json")
    with open(cfg_json, "w") as f:
        f.write(config_to_json(TINY))
    start = str(tmp / "start.pkl")
    params = jax.tree.map(np.asarray, jwm.init_wmencodec(jax.random.PRNGKey(4),
                                                         TINY))
    jckpt.save_bundle(start, params=params, config=dataclasses.asdict(TINY))
    exp = str(tmp / "exp")
    run = train_codec.main(_argv(tmp, mf, cfg_json, exp, "--codec_path", start,
                                 "--generate_every", "3", "--visqol_bin",
                                 _visqol_stub(tmp / "visqol"),
                                 "--profile_steps", "2"))
    return dict(tmp=tmp, mf=mf, cfg_json=cfg_json, start=start, exp=exp,
                run=run, params=params)


def test_main_trains_and_writes_config_bundle_and_samples(trained):
    run, exp = trained["run"], trained["exp"]
    assert run["steps"] == 3 and len(run["history"]) == 3
    for row in run["history"]:
        assert all(np.isfinite(v) for v in row.values()), row
    assert [s for s, _ in run["eval_sisnr"]] == [2]
    assert np.isfinite(run["eval_sisnr"][0][1])
    with open(os.path.join(exp, "config.json")) as f:
        assert f.read() == config_to_json(TINY)
    assert run["bundle"] == os.path.join(exp, "codec_bundle.pkl")
    epochs = [d for d in os.listdir(run["samples_dir"]) if d.startswith("epoch_")]
    assert epochs == ["epoch_0"]
    files = os.listdir(os.path.join(run["samples_dir"], "epoch_0"))
    # the generate stage at step 3 and at the end: two rows each, with the
    # sample, its prompt and its provenance
    assert sum(f.endswith("_prompt.wav") for f in files) == 4
    assert sum(f.endswith(".json") for f in files) == 4
    assert len(files) == 12
    summary = os.path.join(exp, "profile", "summary.json")
    with open(summary) as f:
        assert json.load(f)["steps"] == 2
    state = run["state"]
    assert float(state.balancer.count) == 3 and int(state.step) == 3


def test_bundle_read_by_jax_frozen_parts_unchanged(trained):
    bundle = jckpt.load_bundle(trained["run"]["bundle"])
    assert bundle["step"] == 2
    assert bundle["config"] == dataclasses.asdict(TINY)
    got, start = bundle["params"], trained["params"]
    assert jax.tree.structure(got) == jax.tree.structure(start)
    for part in ("encoder", "decoder", "quantizer"):
        for a, b in zip(jax.tree.leaves(got[part]), jax.tree.leaves(start[part])):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b)
    boot = jtrain_codec.bootstrap_wm_from_codec(
        jax.tree.map(np.asarray, trained["params"]))
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got["wmdecoder"]), jax.tree.leaves(boot["wmdecoder"]))]
    assert sum(moved) > 0.9 * len(moved)  # the EMA of the trained weights


def test_detect_cli_decisions_equal_in_both_packages(trained, capsys):
    bundle = trained["run"]["bundle"]
    wavs = [str(trained["tmp"] / f"a{i}.wav") for i in range(2)]
    jdetect.main(["--codec_path", bundle, "--audio", *wavs, "--frames"])
    want = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    tdetect.main(["--codec_path", bundle, "--audio", *wavs, "--frames",
                  "--device", "cpu"])
    got = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g == w
        assert g["frames"] == len(g["per_frame"]) == 50


def test_bootstrap_equals_jax():
    params = jax.tree.map(np.asarray, jwm.init_wmencodec(jax.random.PRNGKey(0),
                                                         TINY))
    want = jtrain_codec.bootstrap_wm_from_codec(jax.tree.map(np.copy, params))
    got = train_codec.bootstrap_wm_from_codec(jax.tree.map(np.copy, params))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_refusals(trained):
    tmp = trained["tmp"]
    argv = _argv(tmp, trained["mf"], trained["cfg_json"], str(tmp / "x"))
    # a .th converts (tests/test_torch_convert.py); a missing one is an error
    with pytest.raises(FileNotFoundError):
        train_codec.main(argv + ["--codec_path", str(tmp / "wmencodec.th")])
    cuda = list(argv)
    cuda[1] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train_codec.main(cuda)
    with pytest.raises(RuntimeError, match="cuda"):
        tdetect.main(["--codec_path", trained["run"]["bundle"], "--audio",
                      str(tmp / "a0.wav")])


def test_precision_bf16_and_data_parallel_on_one_device(trained):
    """``--precision bfloat16`` trains fp32 parameters with finite losses;
    ``--data_parallel`` is a no-op on one device."""
    tmp = trained["tmp"]
    import torch

    with torch.backends.mkldnn.flags(enabled=False):  # see test_torch_codec_train
        run = train_codec.main(_argv(tmp, trained["mf"], trained["cfg_json"],
                                     str(tmp / "bf16"), "--precision",
                                     "bfloat16", "--data_parallel",
                                     "--updates", "2", "--save_every", "5"))
    assert run["steps"] == 2 and run["bundle"] is None
    assert all(np.isfinite(v) for row in run["history"] for v in row.values())
    assert all(p.dtype == torch.float32 for p in tree_leaves(run["state"].wm_params))


def test_profile_summary_groups_the_codec_steps_kernels(tmp_path):
    """``--profile_steps``' summary sorts the codec step's kernels (names as
    the card's profiler gives them) into convolution, FFT, LSTM, optimizer,
    elementwise and reduction; cuDNN's implicit-GEMM convolutions count as
    convolution, not GEMM."""
    from ssr_speech_tpu_torch.utils.profiler import summarize_trace

    names = ["void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3>(...)",
             "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs",
             "void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3>(...)",
             "void regular_fft_factor<128u, EPT<8u>, 4u, 2u>(...)",
             "void elemWiseRNNcell<float, float, float, (cudnnRNNMode_t)2>",
             "void at::native::(anonymous namespace)::multi_tensor_apply_kernel",
             "void at::native::vectorized_elementwise_kernel<4, ...>",
             "void at::native::reduce_kernel<512, 1, ...>",
             "void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn>"]
    events = [{"cat": "kernel", "name": n, "ts": 100 * i, "dur": 10}
              for i, n in enumerate(names)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = summarize_trace(str(path))["device_ms_per_step"]
    assert got == {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0,
                   "fused_ce": 0.0, "rnn": 0.01, "convolution": 0.03,
                   "fft": 0.01, "optimizer": 0.01, "gemm": 0.01,
                   "elementwise": 0.01, "reduction": 0.01, "other": 0.0}
