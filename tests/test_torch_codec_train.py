"""The port's codec train steps against ``ssr_speech_tpu.training.
codec_trainer`` on the CPU in fp32, from the same state (JAX's init carried
across by ``codec_train_state_from_jax``) and the same numpy-seeded batches.

Tolerances:
- metrics within 1e-4 relative;
- the gradient each optimizer was fed (the watermark decoder's and the
  discriminator's, (mu - b1 mu_old) / (1 - b1)) and the Adam mu and nu
  within 1e-4 of each leaf's largest magnitude, and never closer than
  1e-4 of the step's largest gradient over all leaves: fp32 sums in
  another order, and the discriminator's gradient is the difference of
  the fake and real batches' sums, which cancel (measured at worst: 1.8e-5
  of the largest in the watermark step, 5.1e-5 in the plain-codec step's
  five-scale discriminator);
- parameters (and the EMA) after a step within 1e-6 where the update
  carries signal: at every step so far |g| > 1e-3 x the leaf's max |g|,
  > 1e-7 x the step's max |g| over all leaves and > 100 x Adam's eps,
  and after the second step also |mu| > 1e-3 x the leaf's max |mu|.
  Adam's first update is +-lr wherever the gradient is nonzero, so an
  element whose gradient is rounding noise (a leaf that is zero in exact
  arithmetic: a weight-normed direction of one element) moves by +-lr in
  either package; near eps the update depends on |g| itself (lr eps
  dg / g^2 stays under 1e-6 for g > 100 eps at the gradient tolerance);
  where the second gradient cancels the first, mu / sqrt(nu) is
  ill-conditioned; at least a quarter of each tree is compared;
- frozen parameters bit-identical;
- the bf16 step within 2% of the fp32 step (``test_codec_train_step_
  bf16_matches_f32``'s bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import CodecConfig, RVQConfig, SEANetConfig
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.training import codec_trainer as jct
from ssr_speech_tpu_torch.models.codec import seanet as tseanet
from ssr_speech_tpu_torch.models.codec import wmencodec as twm
from ssr_speech_tpu_torch.models.from_jax import (
    codec_train_state_from_jax, codec_train_state_to_numpy)
from ssr_speech_tpu_torch.training import codec_trainer as tct
from ssr_speech_tpu_torch.utils import prng
from ssr_speech_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_hostcopies import port_config

TINY = CodecConfig(  # tests/test_codec_training.py
    sample_rate=16000,
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(8, 5, 4, 2), lstm=1, norm="weight_norm",
                        pad_mode="constant"),
    rvq=RVQConfig(dimension=16, n_q=2, bins=11),
)
TTINY = port_config(TINY)
FRAMES = 8
LR = 1e-3
METRIC_REL = 1e-4
MOMENT_REL = 1e-4
PARAM_ATOL = 1e-6
SIGNAL = 1e-3  # of the leaf's max |g|
MOMENT_FLOOR = 1e-4  # of the step's max |g|
MASK_FLOOR = 1e-7  # of the step's max |g|
EPS_MARGIN = 100 * 1e-8  # Adam's eps


def _batch(seed):
    rng = np.random.default_rng(seed)
    hop = TINY.hop_length
    wav = (rng.normal(size=(2, FRAMES * hop, 1)) * 0.1).astype(np.float32)
    labels, keep = jwm.sample_watermark_mask(rng, 2, FRAMES, hop, min_regions=1)
    return wav, labels, keep


def _np_state(state):
    return jax.tree.map(np.array, state)


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.array(a)) for a in batch)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's state at init and after each of two steps (numpy), and its
    metrics; the port's optimizers."""
    state, opts = jct.init_codec_train_state(jax.random.PRNGKey(0), TINY,
                                             lr=LR, disc_scales=2)
    step = jct.make_codec_train_step(TINY, opts)
    states, metrics = [_np_state(state)], []
    for seed in (0, 1):
        state, m = step(state, *(jnp.asarray(a) for a in _batch(seed)))
        states.append(_np_state(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


@pytest.fixture(scope="module")
def port_steps(jax_steps):
    states, _ = jax_steps
    state = codec_train_state_from_jax(states[0], TTINY)
    _, opts = tct.init_codec_train_state(prng.PRNGKey(0), TTINY, lr=LR,
                                         disc_scales=2)
    step = tct.make_codec_train_step(TTINY, opts)
    out, metrics, grads_left = [], [], []
    for seed in (0, 1):
        state, m = step(state, *_torch_batch(_batch(seed)))
        grads_left.append([p.grad for p in tree_leaves(state.wm_params)
                           + tree_leaves(state.disc_params)])
        out.append(codec_train_state_to_numpy(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return out, metrics, grads_left


def _signal(leaves):
    top = max(np.abs(g).max() for g in leaves)
    return [(np.abs(g) > SIGNAL * np.abs(g).max())
            & (np.abs(g) > max(MASK_FLOOR * top, EPS_MARGIN)) for g in leaves]


def _moments_close(got, want, name):
    top = max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=max(MOMENT_REL * np.abs(w).max(),
                                   MOMENT_FLOOR * top),
            err_msg=f"{name} leaf {i}")


def _params_close(got, want, masks, name):
    checked = 0
    for i, (g, w, m) in enumerate(zip(got, want, masks)):
        np.testing.assert_allclose(g[m], w[m], rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{name} leaf {i}")
        checked += int(m.sum())
    assert checked > 0.25 * sum(m.size for m in masks), (name, checked)


def _adam_grad(new_state, old_state, field):
    """The gradient each package fed its optimizer: (mu - b1 mu_old) /
    (1 - b1)."""
    mu = jax.tree.leaves(new_state[field][0][1])
    mu_old = jax.tree.leaves(old_state[field][0][1])
    return [(m - 0.5 * o) / 0.5 for m, o in zip(mu, mu_old)]


@pytest.mark.parametrize("step", [0, 1])
def test_metrics_match(jax_steps, port_steps, step):
    want = jax_steps[1][step]
    got = port_steps[1][step]
    assert sorted(got) == sorted(want) == sorted(
        ["cls_loss", "d_loss", "g_loss", "adv", "feat", "l1", "msspec"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_REL, err_msg=k)


# fields of the state tuple: 0 wm, 1 frozen, 2 disc, 3 g_opt, 4 d_opt,
# 5 balancer, 6 ema, 7 step
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("part", ["wm", "disc"])
def test_gradients_moments_and_update_match(jax_steps, port_steps, step, part):
    jstates, _ = jax_steps
    old, want = jstates[step], jstates[step + 1]
    got = port_steps[0][step]
    p_field, o_field = (0, 3) if part == "wm" else (2, 4)
    g_want = _adam_grad(want, old, o_field)
    g_got = _adam_grad(got, old, o_field)
    _moments_close(g_got, g_want, f"{part} grad")
    for k, name in ((1, "mu"), (2, "nu")):
        _moments_close(jax.tree.leaves(got[o_field][0][k]),
                       jax.tree.leaves(want[o_field][0][k]), f"{part} {name}")
    assert int(got[o_field][0][0]) == int(want[o_field][0][0]) == step + 1
    masks = _signal(g_want)
    if step == 1:  # both gradients and the first moment carry signal
        first = _signal(_adam_grad(old, jstates[0], o_field))
        mu = _signal(jax.tree.leaves(want[o_field][0][1]))
        masks = [a & b & c for a, b, c in zip(masks, first, mu)]
    _params_close(jax.tree.leaves(got[p_field]), jax.tree.leaves(want[p_field]),
                  masks, f"{part} params")
    if part == "wm":
        _params_close(jax.tree.leaves(got[6]), jax.tree.leaves(want[6]), masks,
                      "ema")


@pytest.mark.parametrize("step", [0, 1])
def test_frozen_bit_identical_balancer_and_step(jax_steps, port_steps, step):
    jstates, _ = jax_steps
    got, want = port_steps[0][step], jstates[step + 1]
    for a, b, c in zip(jax.tree.leaves(got[1]), jax.tree.leaves(want[1]),
                       jax.tree.leaves(jstates[0][1])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    ema_got, count_got = got[5]
    assert float(count_got) == float(want[5].count) == step + 1
    for k in want[5].ema:
        np.testing.assert_allclose(ema_got[k], want[5].ema[k], rtol=METRIC_REL,
                                   err_msg=k)
    assert int(got[7]) == int(want[7]) == step + 1


def test_no_gradient_left_on_any_parameter(port_steps):
    """``autograd.grad`` never writes ``.grad``: neither the watermark
    decoder nor the discriminator carries one after a step."""
    for grads in port_steps[2]:
        assert all(g is None for g in grads)


def test_state_round_trips_through_numpy(jax_steps):
    state = codec_train_state_from_jax(jax_steps[0][1], TTINY)
    back = codec_train_state_to_numpy(state)
    want = jax_steps[0][1]
    for field in range(8):
        a, b = jax.tree.leaves(back[field]), jax.tree.leaves(want[field])
        assert len(a) == len(b) > 0, field
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert all(p.requires_grad for p in tree_leaves(state.wm_params)
               + tree_leaves(state.disc_params))
    assert not any(p.requires_grad for p in tree_leaves(state.frozen))


def test_bf16_step_within_two_percent_of_fp32(jax_steps):
    """The bf16 step (activations of the watermark decoder, detector and
    discriminator passes in bf16; parameters, losses and optimizers fp32)
    against the fp32 step from the same state. oneDNN is off for the bf16
    run: this CPU build's oneDNN bf16 conv1d gives wrong sums at stride 8
    (an error of the size of the output), which no card path uses."""
    init = jax_steps[0][0]
    batch = _torch_batch(_batch(3))
    runs = {}
    for dt in ("float32", "bfloat16"):
        state = codec_train_state_from_jax(init, TTINY)
        _, opts = tct.init_codec_train_state(prng.PRNGKey(0), TTINY, lr=LR,
                                             disc_scales=2)
        with torch.backends.mkldnn.flags(enabled=dt == "float32"):
            state, m = tct.make_codec_train_step(
                TTINY, opts, compute_dtype=dt)(state, *batch)
        runs[dt] = (state, {k: float(v) for k, v in m.items()})
    (s32, m32), (sbf, mbf) = runs["float32"], runs["bfloat16"]
    for k in m32:
        assert np.isfinite(mbf[k]), k
        assert abs(m32[k] - mbf[k]) <= 0.02 * abs(m32[k]) + 1e-4, (k, m32[k],
                                                                   mbf[k])
    for p, q in zip(tree_leaves(s32.wm_params), tree_leaves(sbf.wm_params)):
        assert q.dtype == torch.float32
        assert float((p - q).abs().max()) <= 2.1 * LR


@pytest.fixture(scope="module")
def compression_steps():
    state, opts = jct.init_compression_train_state(jax.random.PRNGKey(2), TINY,
                                                   lr=LR)
    init = _np_state(state)
    wav = _batch(4)[0]
    new, m = jct.make_compression_train_step(TINY, opts)(state,
                                                          jnp.asarray(wav))
    return init, _np_state(new), {k: float(v) for k, v in m.items()}, wav


def test_compression_step_matches(compression_steps):
    init, want, jm, wav = compression_steps
    state = codec_train_state_from_jax(init, TTINY)
    for part in ("encoder", "decoder"):
        tree_map(lambda t: t.requires_grad_(True), state.frozen[part])
    _, opts = tct.init_compression_train_state(prng.PRNGKey(0), TTINY, lr=LR)
    state, tm = tct.make_compression_train_step(TTINY, opts)(
        state, torch.from_numpy(wav))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=METRIC_REL,
                                   err_msg=k)
    got = codec_train_state_to_numpy(state)
    g_want = _adam_grad(want, init, 3)
    _moments_close(_adam_grad(got, init, 3), g_want, "codec grad")
    # the optimizer's tree is {decoder, encoder}: the same leaves in order
    trained = {k: want[1][k] for k in ("encoder", "decoder")}
    _params_close(jax.tree.leaves({k: got[1][k] for k in trained}),
                  jax.tree.leaves(trained), _signal(g_want), "codec params")
    np.testing.assert_array_equal(got[1]["quantizer"]["embed"],
                                  init[1]["quantizer"]["embed"])
    _moments_close(_adam_grad(got, init, 4), _adam_grad(want, init, 4),
                   "disc grad")


def test_compression_without_straight_through_leaves_the_encoder(jax_steps):
    state = codec_train_state_from_jax(jax_steps[0][0], TTINY)
    for part in ("encoder", "decoder"):
        tree_map(lambda t: t.requires_grad_(True), state.frozen[part])
    enc0 = [p.detach().clone() for p in tree_leaves(state.frozen["encoder"])]
    opts = tct.make_optimizers(LR)
    state.g_opt = opts[0].init(dict(encoder=state.frozen["encoder"],
                                    decoder=state.frozen["decoder"]))
    wav = torch.from_numpy(_batch(5)[0])
    state, m = tct.make_compression_train_step(
        TTINY, opts, straight_through=False)(state, wav)
    assert all(np.isfinite(float(v)) for v in m.values())
    for a, b in zip(enc0, tree_leaves(state.frozen["encoder"])):
        assert torch.equal(a, b.detach())


def test_seanet_functions_carry_gradients():
    """The trainer calls ``seanet.encode``, ``wm_decode`` and
    ``detect_watermark_logits`` under autograd: every parameter they use
    gets a gradient. The inference wrappers of ``wmencodec`` run without
    autograd."""
    params = tree_map(lambda t: t.requires_grad_(True),
                      twm.init_wmencodec(prng.PRNGKey(0), TTINY))
    wav, labels, _ = _torch_batch(_batch(6))
    sn = TTINY.seanet
    emb = tseanet.encode(params["encoder"], wav, sn)
    y, mark = tseanet.wm_decode(params["wmdecoder"], emb, labels.long(), wav, sn)
    clean = tseanet.detect_watermark_logits(params["wmdecoder"], wav, sn)
    leaves = tree_leaves(params["encoder"]) + tree_leaves(params["wmdecoder"])
    grads = torch.autograd.grad(y.square().sum() + mark.square().sum()
                                + clean.square().sum(), leaves,
                                allow_unused=True)
    assert all(g is not None for g in grads)
    # zero only where it is exact: a weight-normed direction [1, 1, Cout] of
    # one element per output channel, w = g * sign(v)
    assert all(float(g.abs().max()) > 0 or tuple(g.shape[:2]) == (1, 1)
               for g in grads)
    assert sum(float(g.abs().max()) > 0 for g in grads) > 0.9 * len(grads)
    codes, _, _ = twm.encode(params, wav, TTINY)
    out, mk = twm.wmdecode(params, codes, labels.long(), wav, TTINY)
    assert not (out.requires_grad or mk.requires_grad)
    assert not twm.detect_watermark(params, wav, TTINY).requires_grad


def test_kmeans_init_matches_with_the_same_initial_indices():
    """From the same seed the port draws JAX's starting rows a stage
    (``prng.choice`` against ``jax.random.choice(replace=False)`` in
    ``kmeans_init_codebooks``'s key order, exactly), so the codebooks agree
    without handing the port JAX's draw."""
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(300, TINY.rvq.dimension)).astype(np.float32)
    key, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    want = np.asarray(jct.kmeans_init_codebooks(key, TINY, jnp.asarray(emb),
                                                iters=5))
    for _ in range(TINY.rvq.n_q):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(
            prng.choice(tsub, emb.shape[0], TINY.rvq.bins).numpy(),
            np.asarray(jax.random.choice(sub, emb.shape[0], (TINY.rvq.bins,),
                                         replace=False)))
    got = tct.kmeans_init_codebooks(prng.PRNGKey(0), TTINY,
                                    torch.from_numpy(emb), iters=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.isfinite(got).all()


def test_reconstruct_and_eval_sisnr_match(jax_steps):
    jstate = jax_steps[0][1]
    wav = _batch(7)[0]
    rebuilt = jct.CodecTrainState(*jstate)
    want = np.asarray(jct.reconstruct(rebuilt, TINY, jnp.asarray(wav)))
    state = codec_train_state_from_jax(jstate, TTINY)
    got = tct.reconstruct(state, TTINY, torch.from_numpy(wav))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(tct.evaluate_sisnr(state, TTINY, torch.from_numpy(wav))),
        float(jct.evaluate_sisnr(rebuilt, TINY, jnp.asarray(wav))),
        rtol=1e-4)


def test_unknown_loss_key_and_missing_adv_refused():
    opts = tct.make_optimizers()
    with pytest.raises(ValueError, match="unknown loss"):
        tct.make_codec_train_step(TTINY, opts, balance_weights={
            "adv": 1, "feat": 1, "nope": 1})
    with pytest.raises(ValueError, match="adv"):
        tct.make_codec_train_step(TTINY, opts, balance_weights={"l1": 1})
