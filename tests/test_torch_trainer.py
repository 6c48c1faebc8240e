"""The port's train step, trainer and ``train_lm`` CLI against
``ssr_speech_tpu`` on the CPU in fp32 with dropout off: one and three train
steps against JAX ``make_train_step(mesh=None)`` (with gradient
accumulation, and a NaN batch that is skipped), and the CLI on the synthetic
corpus: train, resume, bundles that the JAX package reads (its
``ssr_forward`` gives the port's loss, its ``Trainer`` resumes the optimizer
state), and ``--load_model_from`` a JAX bundle.

Tolerances: losses and metrics rtol 1e-5; parameters after the steps within
rtol 1e-4 plus 1e-6 absolute (the gradients agree to ~1e-5 relative, and an
optimizer step moves a weight by ~lr times its RMS)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import (MaskingConfig, OptimConfig, TrainConfig,
                                   tiny_ssr_config)
from ssr_speech_tpu.data.batching import BucketBatcher
from ssr_speech_tpu.data.dataset import SpeechDataset
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.training import optim as joptim
from ssr_speech_tpu.training.trainer import Trainer as JTrainer
from ssr_speech_tpu.training.trainer import make_train_step as jmake_train_step
from ssr_speech_tpu.utils import checkpoint as jckpt
from ssr_speech_tpu_torch import train_lm as ttrain_lm
from ssr_speech_tpu_torch.models.from_jax import trainable_lm_from_jax
from ssr_speech_tpu_torch.models.pretrained import load_lm
from ssr_speech_tpu_torch.training import optim as toptim
from ssr_speech_tpu_torch.training.trainer import make_train_step
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_hostcopies import (NO_JAX_PACKAGE, jax_config,
                                         port_config)
from tests.test_training import make_synth_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROPOUT = dict(trm_dropout=0.0, text_embedding_dropout=0.0,
                  text_positional_embedding_dropout=0.0,
                  audio_positional_embedding_dropout=0.0)
CFG = tiny_ssr_config(**NO_DROPOUT)


def _batch(rng, B=4, sx=10, sy=32):
    ts = CFG.tokens
    y = rng.integers(0, ts.audio_vocab_size, size=(B, sy, CFG.n_codebooks))
    y[1, 7] = ts.mts
    return dict(x=rng.integers(0, CFG.text_vocab_size, size=(B, sx)).astype(np.int32),
                x_lens=np.array([sx, sx - 3, sx, 4], np.int32),
                y=y.astype(np.int32), y_lens=np.array([sy, 20, sy - 5, sy], np.int32))


def _tcfg(name, accum):
    return TrainConfig(
        precision="float32", gradient_accumulation_steps=accum,
        codebook_weight=(5.0, 1.0, 0.5, 0.1),
        optim=OptimConfig(optimizer_name=name,
                          lr=0.03 if name == "scaledadam" else 1e-3,
                          warmup_batches=2.0, pseudo_epoch_size=1000,
                          clipping_update_period=2),
        masking=MaskingConfig(predict_mask_token=True, predict_all=False))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-6, err_msg=what)


def _without_key_bias(x):
    """Drop the key third of ``qkv_b``-shaped leaves ([L, 3D], the bias and
    its optimizer moments): its gradient is zero up to rounding (a softmax is
    invariant to a per-query shift), and Adam scales that noise to steps of
    ~lr in either package."""
    x = np.asarray(x)
    d = CFG.d_model
    if x.shape != (CFG.num_layers, 3 * d):
        return x
    return np.concatenate([x[..., :d], x[..., 2 * d:]], axis=-1)


@pytest.mark.parametrize("name,accum", [("scaledadam", 1), ("adamw", 2)])
def test_train_steps_match_jax(name, accum):
    tcfg = _tcfg(name, accum)
    params = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(0), CFG))
    jopt, _ = joptim.build_optimizer(tcfg.optim, total_steps=100)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    jstep = jmake_train_step(CFG, tcfg, jopt)
    topt, _ = toptim.build_optimizer(port_config(tcfg.optim), total_steps=100)
    model = trainable_lm_from_jax(params, port_config(CFG))
    tstate = topt.init(model.tree())
    tstep = make_train_step(model.cfg, port_config(tcfg), topt, torch.device("cpu"))
    rng = np.random.default_rng(4)
    for i in range(3):
        batch = _batch(rng)
        if accum > 1:
            batch = {k: np.stack([v[0::2], v[1::2]]) for k, v in batch.items()}
        jparams, jstate, jm = jstep(jparams, jstate, batch, jax.random.PRNGKey(i))
        tm = tstep(model, tstate, batch, torch.Generator().manual_seed(i))
        assert tm["skipped"] == float(jm["skipped"]) == 0.0
        for key in ("loss", "top10acc", "ntokens", "top10acc_by_codebook"):
            np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        if i in (0, 2):
            for j, (got, want) in enumerate(zip(tree_leaves(model.tree()),
                                                jax.tree.leaves(jparams))):
                _close(_without_key_bias(got.detach()), _without_key_bias(want),
                       f"param leaf {j} after step {i + 1}")
    got = [t.float() for t in tree_leaves(tstate)]
    want = jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        _close(_without_key_bias(g), _without_key_bias(np.asarray(w, np.float32)),
               f"optimizer state leaf {j}")


def test_nan_batch_is_skipped_like_jax():
    """A non-finite loss leaves the parameters and the optimizer state as
    they were, in both packages."""
    tcfg = _tcfg("scaledadam", 1)
    params = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(0), CFG))
    params["text_emb"] = params["text_emb"].copy()
    params["text_emb"][0, 0] = np.nan
    batch = _batch(np.random.default_rng(0))
    batch["x"][0, 0] = 0
    jopt, _ = joptim.build_optimizer(tcfg.optim)
    jparams = jax.tree.map(jnp.asarray, params)
    _, _, jm = jmake_train_step(CFG, tcfg, jopt)(jparams, jopt.init(jparams),
                                                 batch, jax.random.PRNGKey(0))
    topt, _ = toptim.build_optimizer(port_config(tcfg.optim))
    model = trainable_lm_from_jax(params, port_config(CFG))
    tstate = topt.init(model.tree())
    before = [t.detach().clone() for t in tree_leaves((model.tree(), tstate))]
    tm = make_train_step(model.cfg, port_config(tcfg), topt, torch.device("cpu"))(
        model, tstate, batch, torch.Generator())
    assert tm["skipped"] == float(jm["skipped"]) == 1.0
    after = tree_leaves((model.tree(), tstate))
    for a, b in zip(after, before):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0, equal_nan=True)
    assert all(p.grad is None for p in tree_leaves(model.tree()))


TINY = ["--d_model", "64", "--nhead", "4", "--num_decoder_layers", "2",
        "--audio_vocab_size", "32", "--text_vocab_size", "40",
        "--n_codebooks", "4", "--num_epochs", "1", "--val_every_n_steps", "2",
        "--print_every_n_steps", "1", "--early_stop_step", "100000",
        "--max_num_tokens", "2000", "--num_buckets", "2",
        "--audio_min_length", "2.0", "--audio_max_length", "10.0",
        "--text_min_length", "5", "--optimizer_name", "scaledadam",
        "--lr", "0.01", "--codebook_weight", "5,1,0.5,0.1",
        "--device", "cpu", "--precision", "float32", "--trm_dropout", "0",
        "--text_positional_embedding_dropout", "0",
        "--audio_positional_embedding_dropout", "0"]


def _first_batch(argv):
    """The CLI's first training batch, rebuilt by the JAX package's dataset
    and batcher from the CLI's configs (as JAX-package objects) and seed."""
    args = ttrain_lm.build_parser().parse_args(argv)
    cfg, tcfg = (jax_config(c) for c in ttrain_lm.configs_from_args(
        args, torch.device("cpu")))
    ds = SpeechDataset(cfg, tcfg.data, tcfg.masking, "train", seed=args.seed)
    return cfg, tcfg, next(iter(BucketBatcher(ds, cfg, tcfg.data, seed=args.seed)(0)))


def _jax_loss(params, cfg, tcfg, batch):
    loss = jax.jit(lambda p, b: jssr.ssr_forward(
        p, cfg, b, remat=False,
        predict_mask_token=tcfg.masking.predict_mask_token,
        predict_all=tcfg.masking.predict_all,
        codebook_weight=tcfg.codebook_weight)["loss"])
    return float(loss(jax.tree.map(jnp.asarray, params),
                      {k: jnp.asarray(v) for k, v in batch.items()}))


def test_train_lm_cli_resume_and_bundles_interoperate(tmp_path):
    root = make_synth_corpus(tmp_path)
    exp = str(tmp_path / "exp")
    base = ["--dataset_dir", root, "--encodec_folder_name", "codes", *TINY]
    tr = ttrain_lm.main(["--exp_dir", exp, "--num_steps", "2",
                         "--keep_step_checkpoints", "2", *base])
    assert [h["step"] for h in tr.history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0.0 for h in tr.history)
    bundle = jckpt.load_bundle(os.path.join(exp, "bundle.pkl"))
    assert bundle["progress"]["step"] == 3 and bundle["phn2num"]
    assert jckpt.latest_checkpoint(os.path.join(exp, "checkpoints"))

    # JAX ssr_forward on the port's saved params gives the port's loss
    cfg, tcfg, batch = _first_batch(["--exp_dir", exp, *base])
    port = tr.eval_step(tr.model, batch)
    assert float(port["loss"]) == pytest.approx(
        _jax_loss(bundle["params"], cfg, tcfg, batch), rel=1e-5)
    # the serving loader reads the training bundle
    served, served_cfg, _ = load_lm(os.path.join(exp, "bundle.pkl"),
                                    torch.device("cpu"))
    assert served_cfg == port_config(cfg)
    # the JAX trainer resumes from it: params and optimizer state line up
    jtr = JTrainer(cfg, dataclasses.replace(tcfg, num_steps=2), None,
                   exp_dir=str(tmp_path / "jax_exp"))
    jtr.load_bundle(os.path.join(exp, "bundle.pkl"))
    for got, want in zip(jax.tree.leaves(jtr.params), tree_leaves(tr.model.tree())):
        np.testing.assert_array_equal(np.asarray(got), want.detach().numpy())
    for got, want in zip(jax.tree.leaves(jtr.opt_state), tree_leaves(tr.opt_state)):
        np.testing.assert_array_equal(np.asarray(got), want.float().numpy())

    # --resume continues the step count, the optimizer and the dropout stream
    tr2 = ttrain_lm.main(["--exp_dir", exp, "--num_steps", "4", "--resume", *base])
    assert [h["step"] for h in tr2.history] == [3, 4]
    assert int(tr2.opt_state[0]) == 5

    # --load_model_from a JAX bundle starts from JAX's weights
    jparams = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(3), cfg))
    jopt, _ = joptim.build_optimizer(tcfg.optim)
    jpath = str(tmp_path / "jax_bundle.pkl")
    jckpt.save_bundle(jpath, params=jparams, opt_state=jopt.init(jparams),
                      model_config=dataclasses.asdict(cfg), phn2num={"a": 0},
                      rng_state=np.asarray(jax.random.PRNGKey(9)))
    tr3 = ttrain_lm.main(["--exp_dir", str(tmp_path / "exp3"), "--num_steps", "1",
                          "--load_model_from", jpath, *base])
    assert tr3.history[0]["loss"] == pytest.approx(
        _jax_loss(jparams, cfg, tcfg, batch), rel=1e-5)


def test_trainer_needs_a_device():
    """The port's Trainer runs where its caller says: no default device."""
    from ssr_speech_tpu_torch.training.trainer import Trainer

    with pytest.raises(TypeError, match="device"):
        Trainer(None, None, None)


def test_train_lm_imports_no_jax(tmp_path):
    """The port's training CLI, run for two steps in a fresh interpreter,
    leaves ``jax`` and every ``ssr_speech_tpu.*`` module out of sys.modules."""
    root = make_synth_corpus(tmp_path, n=8)
    argv = ["--exp_dir", str(tmp_path / "exp"), "--dataset_dir", root,
            "--encodec_folder_name", "codes", "--num_steps", "1", *TINY]
    code = ("import sys; from ssr_speech_tpu_torch import train_lm; "
            f"train_lm.main({argv!r}); " + NO_JAX_PACKAGE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_split_microbatches_takes_strided_rows_and_pads_with_empty_rows():
    from ssr_speech_tpu_torch.training.trainer import split_microbatches

    batch = _batch(np.random.default_rng(1), B=4)
    batch = {k: np.concatenate([v, v[:1]]) for k, v in batch.items()}  # B = 5
    micro = split_microbatches(batch, 2, port_config(CFG))
    assert micro["x"].shape == (2, 3, batch["x"].shape[1])
    np.testing.assert_array_equal(micro["y"][0], batch["y"][0::2])
    np.testing.assert_array_equal(micro["y"][1, :2], batch["y"][1::2])
    assert micro["x_lens"][1, 2] == micro["y_lens"][1, 2] == 0
    assert (micro["x"][1, 2] == CFG.text_pad_token).all()
    assert (micro["y"][1, 2] == CFG.tokens.pad).all()


def test_profile_summary_groups_kernels_and_counts_idle_time(tmp_path):
    """Device time by group, busy time as the union of overlapping kernels,
    and the idle share of the span, from a Chrome trace."""
    import json

    from ssr_speech_tpu_torch.utils.profiler import summarize_trace

    def kernel(name, ts, dur):
        return {"cat": "kernel", "name": name, "ts": ts, "dur": dur}

    events = [kernel("(anonymous namespace)::flash_fwd_kernel(...)", 0, 100),
              kernel("(anonymous namespace)::flash_bwd_dq_kernel(...)", 50, 100),
              kernel("nvjet_tst_192x192_h_bz_coopB_TNN", 400, 200),
              kernel("(anonymous namespace)::ce_dw2_kernel(...)", 700, 100),
              kernel("void at::native::vectorized_elementwise_kernel", 900, 100),
              {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5000}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = summarize_trace(str(path), steps=2)
    assert s["kernels_per_step"] == 2.5
    assert s["device_ms_per_step"] == {
        "flash_attention_fwd": 0.05, "flash_attention_bwd": 0.05,
        "fused_ce": 0.05, "rnn": 0.0, "convolution": 0.0, "fft": 0.0,
        "optimizer": 0.0, "gemm": 0.1, "elementwise": 0.05, "reduction": 0.0,
        "other": 0.0}
    assert s["busy_ms_per_step"] == pytest.approx(0.275)  # 550 us of 1000
    assert s["span_ms_per_step"] == pytest.approx(0.5)
    assert s["idle_share"] == pytest.approx(0.45)
    assert s["top"][0]["name"].startswith("nvjet") and len(s["top"]) == 5
