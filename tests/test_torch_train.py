"""The port's training forward and its kernels' gradients against
``ssr_speech_tpu`` on the CPU in fp32: the same numpy-seeded inputs and the
same parameters (the JAX init, made trainable by ``trainable_lm_from_jax``)
go through ``jax.vjp`` / ``jax.value_and_grad`` of the JAX functions and
through torch autograd of the port's. The CUDA wrappers take their plain
versions on CPU tensors, as the JAX wrappers take theirs off-TPU.

Tolerances (fp32 throughout): 1e-5 absolute for the attention and CE-head
gradients at unit-scale inputs (only the summation order differs); for the
whole model, every gradient leaf within rtol 1e-4 plus 1e-4 of that leaf's
largest magnitude (sums over thousands of terms in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import SSRModelConfig, tiny_ssr_config
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.ops import flash_attention as jfa
from ssr_speech_tpu.ops import fused_ce as jfce
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models import transformer as ttrf
from ssr_speech_tpu_torch.models.from_jax import (lm_to_numpy,
                                                  trainable_lm_from_jax)
from ssr_speech_tpu_torch.ops import flash_attention as tfa
from ssr_speech_tpu_torch.ops import fused_ce as tfce
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_hostcopies import port_config

ATOL = 1e-5
NO_DROPOUT = dict(trm_dropout=0.0, text_embedding_dropout=0.0,
                  text_positional_embedding_dropout=0.0,
                  audio_positional_embedding_dropout=0.0)
CW = (5.0, 1.0, 0.5, 0.1)


def _segments(pattern, b, s):
    """Key validity [B, S]: the prefill's (text padding banned on every row,
    the unconditional row's prompt banned) or a padded training batch's
    (text padding, and audio padding on some rows)."""
    valid = np.ones((b, s), bool)
    sx = s // 3
    if pattern == "prefill":
        valid[:, sx - 5:sx] = False
        valid[1:, 1:sx] = False
    else:
        valid[:, sx - 7:sx] = False
        valid[0, s - 11:] = False
    return valid


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("s", [77, 200])
@pytest.mark.parametrize("pattern", ["prefill", "train"])
def test_flash_attention_grads_match_jax(dh, s, pattern):
    """dq, dk, dv (and the output) on every row: segment-0 rows follow the
    same rule in both packages."""
    rng = np.random.default_rng(dh + s)
    q, k, v, dout = (rng.standard_normal((2, 3, s, dh)).astype(np.float32)
                     for _ in range(4))
    valid = _segments(pattern, 2, s)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attend_xy(a, b, c, valid),
                       q, k, v)
    want = vjp(dout)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = tfa.flash_attend_xy(*leaves, torch.from_numpy(valid))
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=ATOL)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)
    assert tfa.launches == tfa.bwd_launches == 0


@pytest.mark.parametrize("k,n,hh,c", [(2, 77, 24, 130), (4, 300, 64, 2056)])
def test_fused_ce_head_and_grads_match_jax(k, n, hh, c):
    """nll, hits and the VJP of nll (hits get no cotangent), with N and C
    not multiples of 128."""
    rng = np.random.default_rng(n)
    hidden = rng.standard_normal((k, n, hh)).astype(np.float32)
    w2 = (rng.standard_normal((k, hh, c)) / np.sqrt(hh)).astype(np.float32)
    b2 = rng.standard_normal((k, c)).astype(np.float32) * 0.1
    tgt = rng.integers(0, c, size=(k, n)).astype(np.int32)
    g = rng.standard_normal((k, n)).astype(np.float32)
    (nll, hits), vjp = jax.vjp(
        lambda a, b, d: jfce.fused_ce_head(a, b, d, tgt), hidden, w2, b2)
    want = vjp((g, np.zeros_like(g)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (hidden, w2, b2)]
    t_nll, t_hits = tfce.fused_ce_head(*leaves, torch.from_numpy(tgt))
    (t_nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t_nll.detach().numpy(), np.asarray(nll),
                               atol=ATOL)
    np.testing.assert_array_equal(t_hits.numpy(), np.asarray(hits))
    for name, t, w in zip(("dhidden", "dw2", "db2"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)
    assert tfce.fwd_launches == tfce.dhidden_launches == tfce.dw2_launches == 0


CONFIGS = {
    "tiny_dh16": tiny_ssr_config(**NO_DROPOUT),
    # head_dim 128, the kernels' geometry
    "dh128": SSRModelConfig(d_model=256, nhead=2, num_layers=2, n_codebooks=4,
                            audio_embedding_dim=256, text_vocab_size=30,
                            head_hidden=64, max_position=512, **NO_DROPOUT),
}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, sx, sy = 2, 11, 29
    ts = cfg.tokens
    y = rng.integers(0, ts.audio_vocab_size, size=(B, sy, cfg.n_codebooks))
    y[:, 0] = ts.sos
    y[0, 9] = ts.mts
    y[1, 4:6] = ts.empty
    y[1, 21:] = ts.pad
    return dict(x=rng.integers(0, cfg.text_vocab_size, size=(B, sx)),
                x_lens=np.array([sx, 7]), y=y, y_lens=np.array([sy, 21]))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def lm(request):
    cfg = CONFIGS[request.param]
    return cfg, jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(5), cfg))


@pytest.mark.parametrize("attn,ce,predict_all", [
    ("einsum", "unfused", False), ("einsum", "fused", True),
    ("flash", "unfused", True), ("flash", "fused", False)])
def test_ssr_forward_loss_metrics_and_every_grad_match_jax(lm, attn, ce,
                                                           predict_all):
    cfg, params = lm
    cfg = dataclasses.replace(cfg, attn_impl=attn, ce_impl=ce)
    batch = _batch(cfg, 3)
    kw = dict(predict_all=predict_all, codebook_weight=CW)

    def jloss(p):
        out = jssr.ssr_forward(p, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
                               remat=False, **kw)
        return out["loss"], out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = trainable_lm_from_jax(params, port_config(cfg))
    got = tssr.ssr_forward(model, model.cfg, {k: torch.from_numpy(v) for k, v in
                                        batch.items()}, **kw)
    got["loss"].backward()
    for key in ("loss", "effective_ntoken", "loss_by_codebook",
                "top10acc_by_codebook", "top10acc"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=2e-5, atol=1e-5,
                                   err_msg=key)
    names = [name for name, _ in sorted(_named_leaves(params))]
    for name, p, w in zip(names, tree_leaves(model.tree()),
                          tree_leaves(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix, tree


def test_trainable_params_round_trip(lm):
    """JAX pytree -> fp32 nn.Parameters in the same nesting -> numpy, bit
    for bit, without aliasing the arrays it came from."""
    cfg, params = lm
    model = trainable_lm_from_jax(params, port_config(cfg))
    assert all(isinstance(p, torch.nn.Parameter) and p.dtype == torch.float32
               for p in tree_leaves(model.tree()))
    back = lm_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    before = params["text_emb"].copy()
    with torch.no_grad():
        model["text_emb"].add_(1.0)
    np.testing.assert_array_equal(params["text_emb"], before)
    np.testing.assert_array_equal(lm_to_numpy(model)["text_emb"], before + 1.0)


def test_dropout_keeps_its_share_and_repeats_with_the_seed():
    x = torch.ones(400_000)
    for rate in (0.1, 0.5):
        gen = torch.Generator().manual_seed(0)
        y = ttrf.dropout(x, rate, gen, deterministic=False)
        kept = (y != 0).float().mean().item()
        assert abs(kept - (1 - rate)) <= 0.01, (rate, kept)
        torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                              1 / (1 - rate)))
    assert ttrf.dropout(x, 0.1, None, deterministic=True) is x

    cfg = dataclasses.replace(tiny_ssr_config(), trm_dropout=0.2)
    params = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(0), cfg))
    model = trainable_lm_from_jax(params, port_config(cfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}

    def loss(seed):
        gen = torch.Generator().manual_seed(seed)
        return tssr.ssr_forward(model, model.cfg, batch, deterministic=False,
                                generator=gen)["loss"].item()

    assert loss(7) == loss(7)
    assert loss(7) != loss(8)
    with pytest.raises(ValueError, match="Generator"):
        tssr.ssr_forward(model, model.cfg, batch, deterministic=False)
