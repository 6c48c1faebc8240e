"""The port's tensor, sequence, data and fsdp parallelism against the JAX
package's mesh on the CPU.

Ranks are spawned (``parallel.dist.spawn``, gloo, one thread each) and run
the torch-only bodies of ``tests/torch_parallel_ranks.py``; the JAX side runs
here on the virtual 8-device mesh the JAX tests use. Every spawn runs several
checks. Tolerances (fp32): loss and top-10 sums rtol 1e-5; gradients rtol
5e-4 atol 1e-5 (tp splits the row-parallel reductions, as in JAX's own
``test_sharded_grads_match_single_device``); parameters after one optimizer
step rtol 1e-4 atol 1e-6 (the train-step parity tolerance of
``test_torch_trainer.py``); the collectives' gradients rtol 1e-5."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssr_speech_tpu.config import (MaskingConfig, OptimConfig, TrainConfig,
                                   tiny_ssr_config)
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.parallel import mesh as jmesh
from ssr_speech_tpu.training import optim as joptim
from ssr_speech_tpu.training.trainer import make_train_step as jmake_train_step
from ssr_speech_tpu_torch.parallel.dist import spawn
from tests import torch_parallel_ranks as ranks
from tests.test_torch_hostcopies import port_config

NO_DROPOUT = dict(trm_dropout=0.0, text_embedding_dropout=0.0,
                  text_positional_embedding_dropout=0.0,
                  audio_positional_embedding_dropout=0.0)
CFG = tiny_ssr_config(nhead=4, num_layers=2, **NO_DROPOUT)
CFG_DROP = tiny_ssr_config(nhead=4, num_layers=2)
CFG_4 = tiny_ssr_config(nhead=4, num_layers=4, **NO_DROPOUT)  # 2 a rank


def _tcfg(name):
    return TrainConfig(
        precision="float32", codebook_weight=(5.0, 1.0, 0.5, 0.1),
        optim=OptimConfig(optimizer_name=name,
                          lr=0.03 if name == "scaledadam" else 1e-3,
                          warmup_batches=2.0, pseudo_epoch_size=1000,
                          clipping_update_period=2),
        masking=MaskingConfig(predict_mask_token=True, predict_all=False))


def make_batch(B=8, sx=12, sy=36, seed=0):
    rng = np.random.default_rng(seed)
    ts = CFG.tokens
    y = rng.integers(0, ts.audio_vocab_size, size=(B, sy, CFG.n_codebooks))
    y[1, 7] = ts.mts
    return dict(
        x=rng.integers(0, CFG.text_vocab_size - 1, size=(B, sx)).astype(np.int32),
        x_lens=np.array([sx, sx - 3, sx, 4, sx, 7, sx - 1, sx], np.int32)[:B],
        y=y.astype(np.int32),
        y_lens=np.array([sy, 20, sy - 5, sy, 30, sy, 11, sy], np.int32)[:B])


PARAMS = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(0), CFG))
BATCH = make_batch()
LAYOUTS = [(2, 1), (1, 2), (2, 2)]


def _case(name, dp, tp, **kw):
    cfg = kw.pop("cfg", CFG)
    tcfg = kw.pop("tcfg", _tcfg("scaledadam"))
    return dict(name=name, dp=dp, tp=tp, cfg=port_config(cfg),
                tcfg=port_config(tcfg), **kw)


CASES = (
    [_case(f"grads_{dp}x{tp}", dp, tp) for dp, tp in LAYOUTS]
    + [_case("sp_1x2", 1, 2, sp=True), _case("sp_1x4", 1, 4, sp=True),
       _case("fsdp_2x1", 2, 1, fsdp=True), _case("fsdp_2x2", 2, 2, fsdp=True),
       _case("scaledadam_2x2", 2, 2, step=True),
       _case("adamw_2x2", 2, 2, step=True, tcfg=_tcfg("adamw")),
       _case("poison_2x1", 2, 1, step=True, poison=CFG.text_vocab_size - 1),
       _case("dropout_2x2", 2, 2, step=True, sp=True, cfg=CFG_DROP),
       _case("memory_2x1", 2, 1, memory=True, cfg=CFG_4)])


@pytest.fixture(scope="module")
def port():
    """All the cases over 2 and over 4 ranks: two spawns."""
    batch = dict(BATCH)
    poisoned = dict(BATCH)
    x = batch["x"].copy()
    out = {}
    for world in (2, 4):
        cases = [c for c in CASES if c["dp"] * c["tp"] == world]
        plain = [c for c in cases if c.get("poison") is None]
        res = spawn(ranks.lm_cases, world, args=(plain, PARAMS, batch))
        pois = [c for c in cases if c.get("poison") is not None]
        if pois:
            xp = x.copy()
            xp[5, 0] = CFG.text_vocab_size - 1  # a row of dp rank 1 only
            poisoned["x"] = xp
            res2 = spawn(ranks.lm_cases, world, args=(pois, PARAMS, poisoned))
            res = [{**a, **b} for a, b in zip(res, res2)]
        out[world] = res
    return {name: [r[name] for r in out[w]] for w in out for name in out[w][0]}


def _jax_loss(params, batch, cfg=CFG):
    o = jssr.ssr_forward(params, cfg, batch, deterministic=True,
                         codebook_weight=(5.0, 1.0, 0.5, 0.1),
                         predict_mask_token=True, predict_all=False)
    return o["loss"], o["top10acc"]


@pytest.fixture(scope="module")
def jax_ref():
    """Loss, top-10 and gradients of the JAX forward over each (dp, tp)
    mesh of the 8 virtual devices."""
    out = {}
    batch = jax.tree.map(jnp.asarray, BATCH)
    for dp, tp in LAYOUTS:
        mesh = jmesh.make_mesh(n_devices=dp * tp, tp=tp)
        with mesh:
            sp = jmesh.shard_tree(mesh, PARAMS, jmesh.ssr_param_specs(PARAMS))
            sb = jmesh.shard_tree(mesh, batch, jmesh.batch_specs())
            (loss, acc), grads = jax.jit(jax.value_and_grad(
                _jax_loss, has_aux=True))(sp, sb)
        out[(dp, tp)] = (float(loss), float(acc), jax.tree.map(np.asarray, grads))
    return out


def _grads_close(got, want, what):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=1e-5,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_loss_and_top10_match_jax_mesh(port, jax_ref, layout):
    res = port[f"grads_{layout[0]}x{layout[1]}"]
    loss, acc, _ = jax_ref[layout]
    for r in res:  # every rank holds the global sums
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["top10acc"], acc, rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_gradients_match_jax_mesh(port, jax_ref, layout):
    res = port[f"grads_{layout[0]}x{layout[1]}"]
    _grads_close(res[0]["grads"], jax_ref[layout][2], f"{layout}")


@pytest.mark.parametrize("name", ["sp_1x2", "sp_1x4", "fsdp_2x1", "fsdp_2x2"])
def test_sequence_parallel_and_fsdp_match_jax(port, jax_ref, name):
    """Megatron-SP at tp 2 and 4 and the fsdp layer stacks: the same loss
    and gradients as JAX's mesh forward."""
    res = port[name]
    loss, acc, grads = jax_ref[(1, 2)]
    np.testing.assert_allclose(res[0]["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(res[0]["top10acc"], acc, rtol=1e-5)
    _grads_close(res[0]["grads"], grads, name)


def _without_key_bias(x):
    """The key third of ``qkv_b`` and its moments dropped: its gradient is
    zero up to rounding (a softmax is invariant to a per-query shift), and
    Adam turns that noise into steps of ~lr (as in ``test_torch_trainer``)."""
    x = np.asarray(x)
    d = CFG.d_model
    if x.shape != (CFG.num_layers, 3 * d):
        return x
    return np.concatenate([x[..., :d], x[..., 2 * d:]], axis=-1)


@pytest.mark.parametrize("name", ["scaledadam", "adamw"])
def test_one_optimizer_step_matches_jax_mesh_step(port, name):
    """One train step over a dp=2 x tp=2 mesh against JAX ``make_train_step``
    over the same mesh of the 8 virtual devices: the parameters and the
    gathered optimizer state; the optimizer's scalars (ScaledAdam's clipping
    buffer and threshold, the step counts, the per-leaf RMS) the same on
    every rank."""
    tcfg = _tcfg(name)
    opt, _ = joptim.build_optimizer(tcfg.optim, total_steps=100)
    mesh = jmesh.make_mesh(n_devices=4, tp=2)
    jparams = jax.tree.map(jnp.asarray, PARAMS)
    state = opt.init(jparams)
    step = jmake_train_step(CFG, tcfg, opt, mesh)
    with mesh:
        jp, jstate, jm = step(jparams, state, BATCH, jax.random.PRNGKey(0))
    res = port[f"{name}_2x2"]
    assert res[0]["skipped"] == float(jm["skipped"]) == 0.0
    np.testing.assert_allclose(res[0]["loss"], float(jm["loss"]), rtol=1e-5)
    for j, (g, w) in enumerate(zip(jax.tree.leaves(res[0]["params"]),
                                   jax.tree.leaves(jp))):
        np.testing.assert_allclose(_without_key_bias(g), _without_key_bias(w),
                                   rtol=1e-4, atol=1e-6, err_msg=f"leaf {j}")
    got = jax.tree.leaves(res[0]["opt_state"])
    want = jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        # a first Adam step is about lr * sign(g) an element, so an element
        # whose gradient is at rounding level moves by a share of the step
        # (as the key bias does): the moments within 1% of the leaf's largest
        w = _without_key_bias(np.asarray(w, np.float32))
        np.testing.assert_allclose(
            _without_key_bias(np.asarray(g, np.float32)), w, rtol=1e-4,
            atol=1e-6 + 1e-2 * float(np.abs(w).max(initial=0.0)),
            err_msg=f"optimizer state leaf {j}")
    for r in res[1:]:
        for a, b in zip(r["opt_scalars"], res[0]["opt_scalars"]):
            np.testing.assert_array_equal(a, b)


def test_nan_skip_is_decided_on_every_rank(port):
    """A NaN only in dp rank 1's rows: both ranks skip and keep their
    parameters."""
    res = port["poison_2x1"]
    for r in res:
        assert r["skipped"] == 1.0
        want = np.array(PARAMS["decoder"]["layers"]["ffn1_w"])
        np.testing.assert_array_equal(r["params"]["decoder"]["layers"]["ffn1_w"], want)


def test_replicated_leaves_stay_identical_with_dropout(port):
    """Dropout on, sequence parallel, dp=2 x tp=2: after a step every leaf
    that tp replicates is bit-identical on the tp ranks that share it, and
    every leaf bit-identical over dp."""
    res = port["dropout_2x2"]
    assert res[0]["skipped"] == 0.0
    by_coord = {r["coords"]: r["local"] for r in res}
    specs = jmesh.ssr_param_specs(PARAMS)
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for dp in (0, 1):
        a, b = by_coord[(dp, 0)], by_coord[(dp, 1)]
        for spec, x, y in zip(flat_specs, jax.tree.leaves(a), jax.tree.leaves(b)):
            if "tp" not in tuple(spec):
                np.testing.assert_array_equal(x, y)
    for tp in (0, 1):
        for x, y in zip(jax.tree.leaves(by_coord[(0, tp)]),
                        jax.tree.leaves(by_coord[(1, tp)])):
            np.testing.assert_array_equal(x, y)
    # the masks did act: the step differs from the dropout-free one
    assert not np.allclose(res[0]["loss"], port["scaledadam_2x2"][0]["loss"])


@pytest.fixture(scope="module")
def collectives():
    return spawn(ranks.collective_grads, 2, args=(3,))


def _plain_mlp(inp):
    import torch

    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    a = torch.from_numpy(inp["a"]).requires_grad_(True)
    b = torch.from_numpy(inp["b"]).requires_grad_(True)
    y = x @ a @ b
    (y * torch.from_numpy(inp["w"])).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(), da=a.grad.numpy(),
                db=b.grad.numpy())


@pytest.mark.parametrize("form", ["mlp", "sp"])
def test_megatron_operators_give_the_unsharded_gradients(collectives, form):
    """copy_to_tp/reduce_from_tp and split/gather/scatter_seq around a
    column- then row-parallel product: the output and every gradient equal
    the unsharded product's (once, not tp times)."""
    want = _plain_mlp(collectives[0]["inputs"])
    for r in collectives:
        for key in want:
            np.testing.assert_allclose(r[form][key], want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{form} {key}")


def test_fsdp_layer_broadcast_sums_gradients_onto_the_owner(collectives):
    import torch

    inp = collectives[0]["inputs"]
    stack = torch.from_numpy(inp["stack"]).requires_grad_(True)
    h = torch.from_numpy(inp["x"])
    for l in range(stack.shape[0]):
        h = torch.tanh(h @ stack[l])
    (h * torch.from_numpy(inp["w"])[..., :4]).sum().backward()
    # both ranks take the same loss: the owner's gradient is their sum
    for r in collectives:
        np.testing.assert_allclose(r["fsdp"]["y"], h.detach().numpy(), rtol=1e-5)
        np.testing.assert_allclose(r["fsdp"]["dstack"],
                                   len(collectives) * stack.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", ["none", "full", "dots_masks"])
def test_fsdp_memory_against_dp(port, remat):
    """fsdp = 2 against dp = 2 on a 4-layer LM (2 layers a rank): the local
    parameters' layer stacks are halved; under ``full`` and ``dots_masks``
    no gathered layer of the forward is alive when the backward starts, and
    autograd saves the same bytes as dp; under ``none`` the products keep
    every gathered layer for the backward (documented in
    ``models/transformer.py::_GatheredLayers``). Every ``_FsdpLayer``
    backward allocates one layer (the reduce), plus, once a stack, the
    owner's local gradient buffer, never a stack a layer."""
    for r in port["memory_2x1"]:
        dp, fs = r[f"dp {remat}"], r[f"fsdp {remat}"]
        layer, n = r["layer_bytes"], r["layers"]
        assert dp["local_bytes"] - fs["local_bytes"] == n // 2 * layer
        assert fs["gathered"] == 12 * n and dp["gathered"] == 0
        if remat == "none":  # at least each layer's four matrices
            assert fs["alive"] >= 4 * n
            assert 0 < fs["saved"] - dp["saved"] <= n * layer
        else:
            assert fs["alive"] == 0 and fs["alive_bytes"] == 0
            assert fs["saved"] == dp["saved"]
        calls = fs["calls"]
        assert len(calls) == 12 * n and not dp["calls"]
        for c in calls:
            assert c["stack"] == n // 2 * c["layer"]
            assert c["bytes"] == c["layer"] + (c["stack"] if c["made"] else 0)
        assert sum(c["made"] for c in calls) == 12  # one buffer a stack


@pytest.fixture(scope="module")
def round_trips():
    return spawn(ranks.shard_round_trip, 4, args=(PARAMS,))


@pytest.mark.parametrize("fsdp", [False, True])
def test_shard_and_gather_tree_round_trip_splitting_q_k_v(round_trips, fsdp):
    d = CFG.d_model
    full = PARAMS["decoder"]["layers"]["qkv_w"]
    for r in round_trips:
        r = r[fsdp]
        for a, b in zip(jax.tree.leaves(r["back"]), jax.tree.leaves(PARAMS)):
            np.testing.assert_array_equal(a, b)
        dp, tp = r["coords"]
        half = d // 2
        want = np.concatenate([full[..., j * d + tp * half:j * d + (tp + 1) * half]
                               for j in range(3)], axis=-1)
        if fsdp:
            want = want[dp * (CFG.num_layers // 2):(dp + 1) * (CFG.num_layers // 2)]
        np.testing.assert_array_equal(r["qkv_w"], want)
