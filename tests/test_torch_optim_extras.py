"""The port's optimizer extras against ``ssr_speech_tpu.training.optim_extras``
on the CPU.

- The cosine, inverse-sqrt and polynomial-decay schedules equal JAX's in
  float32 at the steps of ``tests/test_optim_extras2.py``.
- D-Adaptation Adam over 12 steps on a tree of parameters (a matrix, a
  vector, a 3-d tensor, a scalar), with weight decay and with a growth
  limit: parameters, ``d`` and every state leaf within rtol 1e-5 (atol 1e-7
  of the leaf's scale) of JAX's, whose whole-model sums run in another order.
  The state lines up leaf for leaf with ``DAdaptAdamState`` / ``_DAdaptLeaf``
  and is carried across in both directions: JAX's state after 6 steps
  resumed by the port, and the port's by JAX, give the 12-step result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.training import optim_extras as jextras
from ssr_speech_tpu_torch.training import optim_extras as textras
from ssr_speech_tpu_torch.utils.tree import tree_leaves, tree_map

RTOL, ATOL = 1e-5, 1e-7


@pytest.mark.parametrize("name,args,steps", [
    ("cosine_schedule", (0.1, 1000, 100, 0.05, 1.0),
     [0, 10, 100, 500, 999, 1000, 1500]),
    ("inverse_sqrt_schedule", (0.2, 50, 0.01), [0, 5, 49, 50, 200, 1000]),
    ("polynomial_decay_schedule", (0.3, 1000, 50, 0.01, 5, 2.0),
     [0, 3, 10, 60, 500, 1000, 1200]),
])
def test_schedules_equal_jax_in_float32(name, args, steps):
    want = getattr(jextras, name)(*args)
    got = getattr(textras, name)(*args)
    for step in steps:
        assert np.float32(got(step)) == np.float32(want(step)), step


SHAPES = {"a": (5, 3), "b": [(7,), (2, 2, 2)], "c": (1,)}


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(SHAPES["a"]).astype(np.float32),
            "b": [rng.standard_normal(s).astype(np.float32)
                  for s in SHAPES["b"]],
            "c": rng.standard_normal(SHAPES["c"]).astype(np.float32)}


def _grads(step):
    """A steady direction plus noise: D-Adaptation grows ``d`` on it."""
    return jax.tree.map(lambda a, b: a + np.float32(0.3) * b, _params(100),
                        _params(200 + step))


def _jax_run(kw, params, state, steps):
    opt = jextras.dadapt_adam(**kw)
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params) if state is None else state
    for step in steps:
        updates, state = opt.update(jax.tree.map(jnp.asarray, _grads(step)),
                                    state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    return params, state


def _torch_run(kw, params, state, steps):
    opt = textras.dadapt_adam(**kw)
    params = tree_map(lambda x: torch.tensor(np.asarray(x)), params)
    state = opt.init(params) if state is None else state
    for step in steps:
        opt.update_(tree_map(torch.from_numpy, _grads(step)), state, params)
    return params, state


def _to_jax_state(tstate, like):
    leaves = [jnp.asarray(t.numpy()) for t in tree_leaves(tstate)]
    return jax.tree.unflatten(jax.tree.structure(like), leaves)


def _to_torch_state(jstate, like):
    leaves = iter([torch.tensor(np.asarray(x)) for x in jax.tree.leaves(jstate)])
    return tree_map(lambda _: next(leaves), like)


def _close(got, want, what):
    got = [np.asarray(g.numpy() if hasattr(g, "numpy") else g) for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want) > 0, what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0),
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("kw", [dict(lr=1.0, weight_decay=0.01),
                                dict(lr=0.5, growth_rate=1.5, d0=1e-4)],
                         ids=["decay", "growth"])
def test_dadapt_adam_matches_jax_and_resumes_across(kw):
    init = _params(0)
    jp, js = _jax_run(kw, init, None, range(12))
    tp, ts = _torch_run(kw, init, None, range(12))
    _close(tree_leaves(tp), jax.tree.leaves(jp), "params")
    # leaf for leaf: the JAX state's leaves in jax.tree order
    assert len(tree_leaves(ts)) == len(jax.tree.leaves(js)) == 3 * 4 + 3
    _close(tree_leaves(ts), jax.tree.leaves(js), "state")
    assert float(ts[1]) > kw.get("d0", 1e-6)  # d was learned
    assert int(ts[3]) == int(js.step) == 12

    # 6 steps in one package, 6 more in the other, both ways
    jp6, js6 = _jax_run(kw, init, None, range(6))
    tp6, ts6 = _torch_run(kw, init, None, range(6))
    tp_r, ts_r = _torch_run(kw, jax.tree.map(np.asarray, jp6),
                            _to_torch_state(js6, ts6), range(6, 12))
    jp_r, js_r = _jax_run(kw, tree_map(lambda t: t.numpy(), tp6),
                          _to_jax_state(ts6, js6), range(6, 12))
    for params, state, what in ((tp_r, ts_r, "jax->torch"),
                                (jp_r, js_r, "torch->jax")):
        leaves_p = (tree_leaves(params) if what == "jax->torch"
                    else jax.tree.leaves(params))
        leaves_s = (tree_leaves(state) if what == "jax->torch"
                    else jax.tree.leaves(state))
        _close(leaves_p, jax.tree.leaves(jp), what + " params")
        _close(leaves_s, jax.tree.leaves(js), what + " state")


def test_dadapt_adam_keeps_d_until_a_gradient_flows():
    opt = textras.dadapt_adam()
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    opt.update_({"w": torch.zeros(3)}, state, params)
    assert float(state[1]) == pytest.approx(1e-6)
    assert torch.equal(params["w"], torch.ones(3))
    assert int(state[3]) == 1
