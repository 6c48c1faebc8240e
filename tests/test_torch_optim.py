"""The port's optimizers and LR schedules against ``ssr_speech_tpu`` over 12
steps on the CPU: the same params (stacked [L, ...] leaves, a size-1 scalar,
nested dicts) and the same numpy-seeded gradients each step. After every step
the parameters, and at the end every leaf of the optimizer state (which the
port keeps in ``jax.tree.leaves`` order), must agree.

Tolerances: parameters within 1e-6 absolute + 1e-5 relative and fp32 states
within 1e-5 relative (the same fp32 arithmetic, op by op); the bf16-moment
state within one bf16 step (2^-8 relative), since a fp32 value one ulp off
can round to the neighbouring bf16 value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import OptimConfig
from ssr_speech_tpu.training import optim as joptim
from ssr_speech_tpu_torch.training import optim as toptim
from ssr_speech_tpu_torch.utils.tree import tree_leaves, tree_map

STEPS = 12


def _params(rng):
    return {"w": rng.normal(size=(3, 5, 6)).astype(np.float32),
            "b": rng.normal(size=(3, 6)).astype(np.float32) * 0.1,
            "alpha": np.asarray([0.7], np.float32),
            "head": {"x": rng.normal(size=(4, 4)).astype(np.float32) * 2.0,
                     "tiny": np.full((2, 3), 1e-6, np.float32)}}


def _run(jopt, topt, scale=0.1, inject_big_grad_at=None):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    tparams = tree_map(lambda a: torch.nn.Parameter(torch.from_numpy(a.copy())), p0)
    tstate = topt.init(tparams)
    g_rng = np.random.default_rng(1)
    for step in range(STEPS):
        grads = jax.tree.map(
            lambda a: (g_rng.normal(size=a.shape) * scale).astype(np.float32), p0)
        if step == inject_big_grad_at:  # trips the median clipping
            grads["w"] = grads["w"] * 100.0
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                      jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        topt.update_(tree_map(torch.from_numpy, grads), tstate, tparams)
        for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-5, err_msg=f"step {step}")
    return tstate, jstate


def _assert_states_match(tstate, jstate, rtol=1e-5):
    got = [t.float().numpy() for t in tree_leaves(tstate)]
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(jstate)]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-7, err_msg=f"leaf {i}")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_scaled_adam_matches_jax(moments):
    """size_update_period = clipping_update_period = 4: the learned-size
    step, the median clip (a large gradient at step 9, after the threshold
    is set at step 8) and the clamped scalar path all run."""
    cfg = OptimConfig(optimizer_name="scaledadam", lr=0.03, clipping_scale=2.0,
                      size_update_period=4, clipping_update_period=4,
                      moments_dtype=moments, warmup_batches=5.0,
                      reduce_lr_start_step=10, pseudo_epoch_size=6)
    jopt, _ = joptim.build_optimizer(cfg)
    topt, _ = toptim.build_optimizer(cfg)
    tstate, jstate = _run(jopt, topt, inject_big_grad_at=9)
    assert int(tstate[0]) == int(jstate.step) == STEPS
    assert np.isfinite(float(tstate[3])) and float(tstate[3]) == pytest.approx(
        float(jstate.norm_threshold), rel=1e-5)
    if moments == "bfloat16":
        assert tree_leaves(tstate[1])[0].dtype == torch.bfloat16
    _assert_states_match(tstate, jstate, rtol=1e-5 if moments == "float32"
                         else 2 ** -8)


@pytest.mark.parametrize("name", ["eve", "adamw"])
def test_eve_and_adamw_match_jax(name):
    """AdamW clips by the global norm first (gradient scale 1.0 trips the
    clip at 1.0); Eve's weight decay applies only above target_rms."""
    cfg = OptimConfig(optimizer_name=name, lr=0.01, warmup_fraction=0.25,
                      weight_decay=0.05, gradient_clip_val=1.0)
    jopt, _ = joptim.build_optimizer(cfg, total_steps=20)
    topt, _ = toptim.build_optimizer(cfg, total_steps=20)
    tstate, jstate = _run(jopt, topt, scale=1.0)
    _assert_states_match(tstate, jstate)


def test_schedules_match_jax():
    eden = dict(base_lr=0.05, lr_batches=3000, lr_epochs=4, warmup_batches=500,
                pseudo_epoch_size=3000)
    warm = dict(base_lr=1e-3, total_steps=100, warmup_fraction=0.1)
    steps = list(range(STEPS)) + [499, 500, 2999, 3000, 10000]
    for make_j, make_t, kw in ((joptim.eden_schedule, toptim.eden_schedule, eden),
                               (joptim.linear_warmup_schedule,
                                toptim.linear_warmup_schedule, warm)):
        js, ts = make_j(**kw), make_t(**kw)
        for s in steps:
            assert ts(s) == pytest.approx(float(js(s)), rel=1e-6, abs=1e-12), s
