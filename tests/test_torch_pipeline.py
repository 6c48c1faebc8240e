"""The port's GPipe pipeline against the JAX package's on the CPU.

``pipeline_transformer`` at pp 2 and 4 and at pp 2 x tp 2 against JAX's
(forward, einsum and fused attention), ``make_pp_train_step`` against JAX's
step over the same (pp, dp, tp) layout and against the port's own
gradient-accumulation step, and a ``Trainer`` pipeline loop. Ranks are
spawned over gloo (``tests/torch_parallel_ranks.py``, torch only).
Tolerances (fp32): forwards 1e-5 absolute (JAX's own pipeline tests); the
train step's loss rtol 1e-6 and parameters rtol 1e-5 atol 1e-7 against the
accumulation step, rtol 1e-4 atol 1e-6 against JAX (the port's train-step
parity tolerance)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import OptimConfig, TrainConfig, tiny_ssr_config
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.ops.masking import make_pad_mask
from ssr_speech_tpu.parallel import pipeline as jpl
from ssr_speech_tpu.training import optim as joptim
from ssr_speech_tpu_torch.models.from_jax import trainable_lm_from_jax
from ssr_speech_tpu_torch.parallel.dist import spawn
from ssr_speech_tpu_torch.training import optim as toptim
from ssr_speech_tpu_torch.training.trainer import make_train_step
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests import torch_parallel_ranks as ranks
from tests.test_torch_hostcopies import port_config

M, MBS, SX, SY = 4, 4, 5, 9
B = M * MBS
NO_DROPOUT = dict(trm_dropout=0.0, text_positional_embedding_dropout=0.0,
                  audio_positional_embedding_dropout=0.0,
                  text_embedding_dropout=0.0)


def _cfg(**kw):
    return tiny_ssr_config(num_layers=4, **kw)


def _batch(cfg):
    rng = np.random.default_rng(0)
    return dict(
        x=rng.integers(0, cfg.text_vocab_size, (B, SX)).astype(np.int32),
        x_lens=np.array([5, 4, 3, 5] * M, np.int32),
        y=rng.integers(0, cfg.tokens.audio_vocab_size,
                       (B, SY, cfg.n_codebooks)).astype(np.int32),
        y_lens=np.array([9, 7, 8, 6] * M, np.int32))


CFG = _cfg()
CFG_FUSED = _cfg(attn_impl="splash")
PARAMS = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(0), CFG))
FORWARD = [(2, 1), (4, 1), (2, 2)]


def _embedded(cfg):
    batch = _batch(cfg)
    h, bias, _ = jssr.ssr_embed(PARAMS, cfg, batch, deterministic=True)
    kv = ~jnp.concatenate([make_pad_mask(batch["x_lens"], SX),
                           make_pad_mask(batch["y_lens"], SY)], axis=1)
    return (h.reshape(M, MBS, *h.shape[1:]), bias.reshape(M, MBS, *bias.shape[1:]),
            kv.reshape(M, MBS, kv.shape[1]))


def _tcfg(attn):
    return TrainConfig(precision="float32", gradient_accumulation_steps=M,
                       optim=OptimConfig(optimizer_name="adamw", lr=1e-3))


STEP_CFGS = {"einsum": _cfg(**NO_DROPOUT),
             "fused": _cfg(attn_impl="splash", remat="dots_masks", **NO_DROPOUT)}


@pytest.fixture(scope="module")
def jax_forward():
    out = {}
    for pp, tp in FORWARD:
        h_mb, bias_mb, _ = _embedded(CFG)
        mesh = jpl.make_pp_mesh(8, pp=pp, tp=tp)
        out[(pp, tp)] = np.asarray(jpl.pipeline_transformer(
            PARAMS["decoder"], h_mb, bias_mb, CFG, mesh, deterministic=True,
            dtype=jnp.float32))
    h_mb, _, kv_mb = _embedded(CFG_FUSED)
    mesh = jpl.make_pp_mesh(8, pp=2, tp=2)
    dummy = jnp.zeros((M, MBS, 1, 1, 1), jnp.float32)
    out["fused"] = np.asarray(jpl.pipeline_transformer(
        PARAMS["decoder"], h_mb, dummy, CFG_FUSED, mesh, deterministic=True,
        dtype=jnp.float32, remat="dots_masks", key_valid_mb=kv_mb))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    out = {}
    for attn, cfg in STEP_CFGS.items():
        tcfg = _tcfg(attn)
        opt, _ = joptim.build_optimizer(tcfg.optim, 100)
        mesh = jpl.make_pp_mesh(8, pp=2, tp=2)
        step = jpl.make_pp_train_step(cfg, tcfg, opt, mesh, n_micro=M)
        p = jpl.shard_params_pp(mesh, jax.tree.map(jnp.asarray, PARAMS))
        p2, _, m = step(p, opt.init(p), _batch(cfg), jax.random.PRNGKey(7))
        out[attn] = (jax.tree.map(np.asarray, p2), float(m["loss"]),
                     float(m["ntokens"]))
    return out


@pytest.fixture(scope="module")
def port():
    cases = []
    for pp, tp in FORWARD:
        h_mb, bias_mb, _ = _embedded(CFG)
        cases.append(dict(kind="forward", name=f"fwd_{pp}x{tp}", pp=pp, tp=tp,
                          cfg=port_config(CFG), params=PARAMS,
                          h_mb=np.asarray(h_mb), bias_mb=np.asarray(bias_mb)))
    h_mb, _, kv_mb = _embedded(CFG_FUSED)
    cases.append(dict(kind="forward", name="fwd_fused", pp=2, tp=2,
                      cfg=port_config(CFG_FUSED), params=PARAMS,
                      h_mb=np.asarray(h_mb), key_valid_mb=np.asarray(kv_mb),
                      remat="dots_masks"))
    for attn, cfg in STEP_CFGS.items():
        cases.append(dict(kind="step", name=f"step_{attn}", pp=2, tp=2,
                          cfg=port_config(cfg), tcfg=port_config(_tcfg(attn)),
                          params=PARAMS, batch=_batch(cfg), n_micro=M))
    out = {}
    for world in (2, 4):
        mine = [c for c in cases if c["pp"] * c["tp"] == world]
        res = spawn(ranks.pipeline_cases, world, args=(mine,))
        out.update({name: [r[name] for r in res] for name in res[0]})
    return out


@pytest.mark.parametrize("layout", FORWARD, ids=lambda l: f"pp{l[0]}xtp{l[1]}")
def test_pipeline_forward_matches_jax(port, jax_forward, layout):
    want = jax_forward[layout]
    for r in port[f"fwd_{layout[0]}x{layout[1]}"]:  # every stage has it
        assert float(np.max(np.abs(r["out"] - want))) < 1e-5


def test_pipeline_forward_fused_matches_jax_on_valid_rows(port, jax_forward):
    """Fused attention (the plain version of K1 on the CPU), pp 2 x tp 2:
    padded rows are finite garbage by design in both, so valid rows only."""
    _, _, kv_mb = _embedded(CFG_FUSED)
    valid = np.asarray(kv_mb)
    got, want = port["fwd_fused"][0]["out"], jax_forward["fused"]
    for m in range(M):
        for b in range(MBS):
            np.testing.assert_allclose(got[m, b][valid[m, b]],
                                       want[m, b][valid[m, b]],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("attn", ["einsum", "fused"])
def test_pp_train_step_matches_jax(port, jax_steps, attn):
    want, loss, ntok = jax_steps[attn]
    for r in port[f"step_{attn}"]:
        assert r["skipped"] == 0.0
        assert r["loss"] == pytest.approx(loss, rel=1e-5)
        assert r["ntokens"] == ntok
        for a, b in zip(jax.tree.leaves(r["params"]), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("attn", ["einsum", "fused"])
def test_pp_train_step_matches_the_accumulation_step(port, attn):
    """The port's pp 2 x tp 2 step against its own one-device step at
    gradient accumulation M over the same contiguous microbatches."""
    cfg, tcfg = port_config(STEP_CFGS[attn]), port_config(_tcfg(attn))
    opt, _ = toptim.build_optimizer(tcfg.optim, 100)
    model = trainable_lm_from_jax(PARAMS, cfg)
    state = opt.init(model.tree())
    batch = {k: v.reshape((M, MBS) + v.shape[1:])
             for k, v in _batch(STEP_CFGS[attn]).items()}
    m = make_train_step(cfg, tcfg, opt, torch.device("cpu"))(
        model, state, batch, torch.Generator().manual_seed(7))
    r = port[f"step_{attn}"][0]
    assert r["loss"] == pytest.approx(float(m["loss"]), rel=1e-6)
    assert r["ntokens"] == float(m["ntokens"])
    for a, b in zip(jax.tree.leaves(r["params"]), tree_leaves(model.tree())):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-5, atol=1e-7)


def test_pp_step_refuses_what_jax_refuses():
    from ssr_speech_tpu_torch.parallel import pipeline as tpl
    from ssr_speech_tpu_torch.training.trainer import Trainer

    mesh = tpl.make_pp_mesh(pp=1)
    with pytest.raises(ValueError, match="n_micro"):
        tpl.microbatches(_batch(CFG), 3, mesh)
    with pytest.raises(ValueError, match="sequence_parallel"):
        Trainer(port_config(CFG), port_config(_tcfg("einsum")), lambda e: iter(()),
                device="cpu", mesh=mesh, pp=2, sequence_parallel=True)


def test_trainer_pipeline_loop(tmp_path):
    """``Trainer`` with pp=2 x dp=2 (4 ranks, two microbatches): two steps
    with finite, identical losses on every rank; only rank 0 writes the
    bundle, and it loads into a one-device ``Trainer``."""
    from ssr_speech_tpu.config import DataConfig, MaskingConfig
    from ssr_speech_tpu_torch.training.trainer import Trainer
    from tests.test_training import make_synth_corpus

    root = make_synth_corpus(tmp_path, n=16)
    exp = str(tmp_path / "exp_pp")
    dcfg = DataConfig(dataset_dir=root, encodec_folder_name="codes",
                      audio_min_length=2.0, audio_max_length=10.0,
                      text_min_length=5, num_buckets=2, max_num_tokens=3000,
                      exp_dir=exp)
    tcfg = TrainConfig(precision="float32", num_steps=1, val_every_n_steps=100,
                       print_every_n_steps=1, early_stop_step=100,
                       optim=OptimConfig(optimizer_name="adamw", lr=1e-4,
                                         clipping_scale=None),
                       masking=MaskingConfig(), data=dcfg)
    cfg = port_config(tiny_ssr_config())
    res = spawn(ranks.trainer_pp_loop, 4,
                args=(cfg, port_config(tcfg), root, exp, 2))
    for r in res:
        assert r["step"] >= 2
        losses = [h["loss"] for h in r["history"]]
        assert all(np.isfinite(losses))
        assert losses == [h["loss"] for h in res[0]["history"]]
    assert os.path.isfile(os.path.join(exp, "bundle.pkl"))
    one = Trainer(cfg, port_config(tcfg), lambda e: iter(()), device="cpu",
                  exp_dir=str(tmp_path / "one"))
    one.load_bundle(os.path.join(exp, "bundle.pkl"))
    assert one.progress["step"] >= 2
