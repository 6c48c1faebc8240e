"""The port's icefall toolbox (``ssr_speech_tpu_torch/ops/scaling.py``)
against ``ssr_speech_tpu.ops.scaling`` on the CPU in fp32, and the
transformer's double-swish activations against the JAX LM.

Tolerances: forwards within 1e-6 (absolute, unit-scale inputs); gradients
through each ``autograd.Function`` against ``jax.vjp`` within 1e-5 relative
to the largest gradient element; a tiny LM's training loss and every
gradient within 1e-4 relative (plus 1e-4 of the leaf's largest magnitude,
as tests/test_torch_train.py); greedy codes identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import DecodeConfig, tiny_ssr_config
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.ops import scaling as jsc
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models.from_jax import (lm_from_jax,
                                                  trainable_lm_from_jax)
from ssr_speech_tpu_torch.ops import scaling as tsc
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_hostcopies import port_config

FWD_ATOL = 1e-6
GRAD_REL = 1e-5


def _x(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=FWD_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_REL * np.abs(want).max())


def test_double_swish_and_basic_norm_forward():
    x = _x((3, 7, 16), 0, scale=2.0)
    _close(tsc.double_swish(_t(x)), jsc.double_swish(jnp.asarray(x)))
    log_eps = jsc.init_basic_norm(0.25)
    assert float(tsc.init_basic_norm(0.25)) == float(log_eps)
    for dim in (-1, 1):
        _close(tsc.basic_norm(_t(x), _t(log_eps), dim),
               jsc.basic_norm(jnp.asarray(x), log_eps, dim))


@pytest.mark.parametrize("channel_dim", [-1, 1])
@pytest.mark.parametrize("scale,shift", [(1.0, 0.0), (0.05, 0.3), (300.0, -2.0)])
def test_balancer_factors_match(channel_dim, scale, shift):
    """Both factors, in the regimes that clip them (mean |x| below min_abs
    and above max_abs, positive share above max_positive)."""
    x = _x((4, 6, 10), 1, scale, shift)
    for args in ((channel_dim, 0.2, 100.0, 0.02, 0.04),
                 (channel_dim, 0.0, 1.0, 0.5, 0.3)):
        _close(tsc.compute_scale_factor(_t(x), *args),
               jsc.compute_scale_factor(jnp.asarray(x), *args))
    for args in ((channel_dim, 0.05, 0.95, 0.01, 0.04),
                 (channel_dim, 0.45, 0.55, 0.5, 0.3),
                 (channel_dim, 0.0, 1.0, 0.01, 0.04)):
        _close(tsc.compute_sign_factor(_t(x), *args),
               jsc.compute_sign_factor(jnp.asarray(x), *args))


def _vjp_both(jfn, tfn, x, g):
    """(forward_j, grad_j, forward_t, grad_t) of each fn at x against the
    cotangent g."""
    yj, vjp = jax.vjp(jfn, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    yt = tfn(xt)
    (gt,) = torch.autograd.grad(yt, xt, _t(g))
    return yj, gj, yt.detach(), gt


@pytest.mark.parametrize("kind", ["balancer", "balancer_ch1", "balanced_swish",
                                  "balanced_norm", "deterministic"])
def test_balancer_gradient_surgery(kind):
    x = _x((5, 9, 12), 2, scale=0.1, shift=0.02)  # under min_abs: active
    g = _x(x.shape, 3)
    log_eps = jsc.init_basic_norm()
    fns = {
        "balancer": (jsc.activation_balancer, tsc.activation_balancer),
        "balancer_ch1": (lambda v: jsc.activation_balancer(v, 1, max_abs=0.05),
                         lambda v: tsc.activation_balancer(v, 1, max_abs=0.05)),
        "balanced_swish": (jsc.balanced_double_swish, tsc.balanced_double_swish),
        "balanced_norm": (lambda v: jsc.balanced_basic_norm(v, log_eps),
                          lambda v: tsc.balanced_basic_norm(v, _t(log_eps))),
        "deterministic": (
            lambda v: jsc.balanced_double_swish(v, deterministic=True),
            lambda v: tsc.balanced_double_swish(v, deterministic=True)),
    }
    yj, gj, yt, gt = _vjp_both(*fns[kind], x, g)
    _close(yt, yj)
    _grad_close(gt, gj)
    if kind == "balancer":  # the surgery really changed the gradient
        assert np.abs(np.asarray(gj) - g).max() > 1e-3


def _correlated(shape, seed):
    """Features with one dominant direction: whitening metric over 2 and a
    variance share over 0.2 on the top eigendirection."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape[:-1] + (1,))
    mix = rng.standard_normal((1, shape[-1]))
    noise = 0.3 * rng.standard_normal(shape)
    return (base * mix + noise).astype(np.float32)


@pytest.mark.parametrize("num_groups", [1, 2])
def test_whiten_metric_and_gradient(num_groups):
    x = _correlated((6, 11, 8), 4)
    g = _x(x.shape, 5)
    want = float(jsc.whitening_metric(jnp.asarray(x), num_groups))
    got = float(tsc.whitening_metric(_t(x), num_groups))
    assert want > 2.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    yj, gj, yt, gt = _vjp_both(lambda v: jsc.whiten(v, num_groups, 2.0, 0.05),
                               lambda v: tsc.whiten(v, num_groups, 2.0, 0.05),
                               x, g)
    _close(yt, yj)
    _grad_close(gt, gj)
    assert np.abs(np.asarray(gj) - g).max() > 1e-3
    # under the limit the backward is an exact passthrough in both
    _, gj, _, gt = _vjp_both(lambda v: jsc.whiten(v, num_groups, 1e9),
                             lambda v: tsc.whiten(v, num_groups, 1e9), x, g)
    np.testing.assert_array_equal(np.asarray(gj), g)
    np.testing.assert_array_equal(gt.numpy(), g)


@pytest.mark.parametrize("channel_dim,max_var", [(-1, 0.2), (1, 0.2), (-1, 0.99)])
def test_max_eig_state_and_gradient(channel_dim, max_var):
    x = _correlated((7, 9, 6), 6)
    if channel_dim == 1:
        x = np.ascontiguousarray(np.swapaxes(x, 1, 2))
    g = _x(x.shape, 7)
    c = x.shape[channel_dim]
    d_j = jsc.init_max_eig_direction(c)
    d_t = tsc.init_max_eig_direction(c)
    _close(d_t, d_j)

    def jfn(v):
        return jsc.max_eig(v, d_j, channel_dim, max_var)[0]

    def tfn(v):
        return tsc.max_eig(v, d_t, channel_dim, max_var)[0]

    _, new_j, vp_j = jsc.max_eig(jnp.asarray(x), d_j, channel_dim, max_var)
    _, new_t, vp_t = tsc.max_eig(_t(x), d_t, channel_dim, max_var)
    _close(new_t, new_j)
    np.testing.assert_allclose(float(vp_t), float(vp_j), rtol=1e-6)
    yj, gj, yt, gt = _vjp_both(jfn, tfn, x, g)
    _close(yt, yj)
    _grad_close(gt, gj)
    active = float(vp_j) >= max_var
    assert active == (max_var == 0.2)
    assert (np.abs(np.asarray(gj) - g).max() > 1e-4) == active


def test_with_loss_and_scaled_init():
    x, y = _x((3, 4), 8), _x((5,), 9)
    xt = _t(x).requires_grad_(True)
    yt = _t(y).requires_grad_(True)
    out = tsc.with_loss(xt, yt)
    np.testing.assert_array_equal(out.detach().numpy(), x)
    gx, gy = torch.autograd.grad(out, [xt, yt], torch.ones(3, 4))
    jout, vjp = jax.vjp(jsc.with_loss, jnp.asarray(x), jnp.asarray(y))
    jgx, jgy = vjp(jnp.ones((3, 4)))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))
    init = lambda: {"w": torch.ones(2, 3), "b": [torch.full((2,), 2.0)]}  # noqa: E731
    out = tsc.scaled_init(init, 0.25)()
    assert float(out["w"].sum()) == 1.5 and float(out["b"][0][0]) == 0.5
    jout = jsc.scaled_init(lambda: {"w": jnp.ones((2, 3))}, 0.25)()
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))


# ------------------------------------------------------ the LM activations

ACTIVATIONS = ["double_swish", "balanced_double_swish"]


@pytest.fixture(scope="module", params=ACTIVATIONS)
def lm(request):
    cfg = tiny_ssr_config(activation=request.param, trm_dropout=0.0,
                          text_embedding_dropout=0.0,
                          text_positional_embedding_dropout=0.0,
                          audio_positional_embedding_dropout=0.0)
    params = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(3), cfg))
    # small FFN inputs (mean |x| under the balancer's min_abs of 0.2), so
    # that the balancer's backward changes the gradients
    layers = params["decoder"]["layers"]
    layers["ffn1_w"] = layers["ffn1_w"] * np.float32(0.05)
    layers["ffn1_b"] = layers["ffn1_b"] * np.float32(0.05)
    return cfg, params


def _batch(cfg):
    rng = np.random.default_rng(11)
    b, sx, sy = 2, 9, 23
    ts = cfg.tokens
    y = rng.integers(0, ts.audio_vocab_size, size=(b, sy, cfg.n_codebooks))
    y[:, 0] = ts.sos
    y[0, 7] = ts.mts
    y[1, 17:] = ts.pad
    return dict(x=rng.integers(0, cfg.text_vocab_size, size=(b, sx)),
                x_lens=np.array([sx, 6]), y=y, y_lens=np.array([sy, 17]))


def test_activation_training_loss_and_grads_match_jax(lm):
    """The training forward (deterministic=False: the balancer's backward
    is active) against ``jax.value_and_grad`` of JAX's ``ssr_forward``."""
    cfg, params = lm
    batch = _batch(cfg)

    def jloss(p):
        out = jssr.ssr_forward(p, cfg, {k: jnp.asarray(v) for k, v in
                                        batch.items()},
                               deterministic=False, rng=jax.random.PRNGKey(0),
                               remat=False)
        return out["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    model = trainable_lm_from_jax(params, port_config(cfg))
    got = tssr.ssr_forward(model, model.cfg,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           deterministic=False,
                           generator=torch.Generator().manual_seed(0))
    got["loss"].backward()
    np.testing.assert_allclose(float(got["loss"].detach()), float(want),
                               rtol=1e-4)
    for p, w in zip(tree_leaves(model.tree()), tree_leaves(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_activation_greedy_codes_identical(lm):
    cfg, params = lm
    tcfg = port_config(cfg)
    model = lm_from_jax(params, tcfg)
    rng = np.random.default_rng(2)
    y = rng.integers(0, cfg.tokens.audio_vocab_size, size=(cfg.n_codebooks, 30))
    x = rng.integers(0, cfg.text_vocab_size - 1, size=(16,))
    dec = DecodeConfig(top_k=1, top_p=1.0, temperature=1.0, stop_repetition=-1,
                       cfg_coef=1.5, cfg_pretrained=True, max_gen_per_span=400,
                       length_cap_mult=10, aug_text=True, cfg_stride=2)
    for mask in ([(8, 14)], [(4, 9), (17, 22)]):
        want = jdecode.generate(params, cfg, dec, x, y, mask,
                                jax.random.PRNGKey(0), dtype_name="float32")
        got = tdecode.generate(model, tcfg, port_config(dec), x, y, mask,
                               torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:4] == want[2:4]


def test_training_differs_from_eval_only_by_the_balancer(lm):
    """``deterministic`` reaches the FFN: with balanced_double_swish the
    training forward's gradients differ from the eval forward's, with
    double_swish they do not (no dropout in this config)."""
    cfg, params = lm
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    grads = []
    for det in (True, False):
        model = trainable_lm_from_jax(params, port_config(cfg))
        tssr.ssr_forward(model, model.cfg, batch, deterministic=det,
                         generator=torch.Generator().manual_seed(0)
                         )["loss"].backward()
        grads.append(model["decoder"]["layers"]["ffn1_w"].grad.clone())
    same = torch.equal(grads[0], grads[1])
    assert same == (cfg.activation == "double_swish")
