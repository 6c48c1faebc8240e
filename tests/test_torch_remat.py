"""Activation checkpointing of the port's training forward (``--remat``).

A tiny LM with dropout on (``trm_dropout`` > 0, ``deterministic=False``),
with the einsum and the flash attention, its parameters from JAX's init.
Every mode must give the same loss and the same gradients as ``none``, bit
for bit on the CPU (the recompute runs the same ops on the same inputs), and
leave the dropout generator where ``none`` leaves it: a recompute replays the
layer's masks from the state it took before the layer ran. Two consecutive
steps give the same masks as two un-checkpointed steps. The default rule is
JAX ``train_lm``'s, and ``train_lm --remat full --device cpu`` runs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu import train_lm as jtrain_lm
from ssr_speech_tpu.config import tiny_ssr_config
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu_torch import train_lm
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models import transformer as ttrf
from ssr_speech_tpu_torch.models.from_jax import trainable_lm_from_jax
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_batched_decode import one_torch_thread
from tests.test_torch_hostcopies import port_config
from tests.test_torch_train import _batch

__all__ = ["one_torch_thread"]  # module-scoped fixture, shared

CFG = tiny_ssr_config(trm_dropout=0.3, text_embedding_dropout=0.1,
                      text_positional_embedding_dropout=0.1,
                      audio_positional_embedding_dropout=0.1)
MODES = ("full", "dots", "dots_masks", "mixed")


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(5), CFG))


@pytest.fixture(scope="module")
def unchecked(params):
    """``none``'s one and two passes, by attention."""
    return {(attn, n): _steps(params, attn, "none", n=n)
            for attn in ("einsum", "flash") for n in (1, 2)}


def _steps(params, attn, remat, n=1, seed=7):
    """``n`` forward/backward passes of one model, the generator carried
    across them. Returns each pass's loss, the gradients summed over the
    passes, and the generator's state after them."""
    cfg = port_config(dataclasses.replace(CFG, attn_impl=attn))
    model = trainable_lm_from_jax(params, cfg)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for i in range(n):
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3 + i).items()}
        out = tssr.ssr_forward(model, cfg, batch, deterministic=False,
                               generator=gen, remat=remat)
        out["loss"].backward()
        losses.append(out["loss"].detach())
    grads = [p.grad.clone() for p in tree_leaves(model.tree())]
    return losses, grads, gen.get_state()


@pytest.mark.parametrize("attn", ["einsum", "flash"])
@pytest.mark.parametrize("mode", MODES)
def test_every_mode_equals_none_bit_for_bit(params, unchecked, attn, mode):
    want_loss, want_grads, want_state = unchecked[(attn, 1)]
    got_loss, got_grads, got_state = _steps(params, attn, mode)
    assert torch.equal(got_loss[0], want_loss[0])
    assert len(got_grads) == len(want_grads) > 20
    for g, w in zip(got_grads, want_grads):
        assert torch.equal(g, w)
    assert torch.equal(got_state, want_state)


@pytest.mark.parametrize("mode", ["full", "dots_masks"])
def test_two_steps_draw_the_masks_of_two_unchecked_steps(params, unchecked,
                                                         mode):
    """The generator is carried into the next step as an un-checkpointed step
    leaves it, so the second step's masks (and loss) are unchanged."""
    want_loss, want_grads, want_state = unchecked[("flash", 2)]
    got_loss, got_grads, got_state = _steps(params, "flash", mode, n=2)
    assert not torch.equal(want_loss[0], want_loss[1])
    for g, w in zip(got_loss + got_grads, want_loss + want_grads):
        assert torch.equal(g, w)
    assert torch.equal(got_state, want_state)


def test_recompute_draws_from_the_snapshot():
    """A checkpointed body that draws from the generator sees the same draw
    in the recompute as in the forward (a fresh draw would change the
    gradient), and the generator ends where the forward left it."""
    x = torch.randn(5, requires_grad=True)
    gen = torch.Generator().manual_seed(3)
    seen = []

    def body(h):
        u = torch.rand(h.shape, generator=gen)
        seen.append(u.clone())
        return h * u

    y = ttrf.checkpoint_layer(body, "full", gen)(x)
    after = gen.get_state()
    y.sum().backward()
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    assert torch.equal(x.grad, seen[0])
    assert torch.equal(gen.get_state(), after)
    with pytest.raises(ValueError, match="remat mode"):
        ttrf.checkpoint_layer(body, "sometimes", gen)


def test_no_recompute_without_autograd(params):
    """Under no_grad (evaluation) every mode is the plain forward."""
    cfg = port_config(dataclasses.replace(CFG, attn_impl="flash"))
    model = trainable_lm_from_jax(params, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    with torch.no_grad():
        outs = [tssr.ssr_forward(model, cfg, batch, remat=m)["loss"]
                for m in ("none", "dots_masks")]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("attn,want", [("flash", "dots_masks"),
                                       ("splash", "dots_masks"),
                                       ("einsum", "full")])
def test_default_rule_is_jax_train_lms(attn, want, tmp_path):
    assert ttrf.default_remat(attn) == want
    argv = ["--exp_dir", str(tmp_path), "--dataset_dir", str(tmp_path),
            "--attn_impl", attn, "--device", "cpu"]
    args = train_lm.build_parser().parse_args(argv)
    cfg, _ = train_lm.configs_from_args(args, torch.device("cpu"))
    assert cfg.remat == want
    # the JAX CLI states the same rule in its --remat help
    jhelp = jtrain_lm.build_parser().format_help()
    assert "dots_masks with flash" in " ".join(jhelp.split())
    args = train_lm.build_parser().parse_args(argv + ["--remat", "none"])
    assert train_lm.configs_from_args(args, torch.device("cpu"))[0].remat == "none"


def test_train_lm_remat_full_runs_on_the_cpu(tmp_path):
    from tests.test_torch_trainer import TINY
    from tests.test_training import make_synth_corpus

    root = make_synth_corpus(tmp_path)
    trainer = train_lm.main([
        "--exp_dir", str(tmp_path / "exp"), "--dataset_dir", root,
        "--encodec_folder_name", "codes", "--num_steps", "1", *TINY,
        "--trm_dropout", "0.1", "--remat", "full"])
    assert trainer.cfg.remat == "full"
    assert [h["step"] for h in trainer.history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0.0
               for h in trainer.history)


@pytest.mark.parametrize("mode,calls", [("none", 2), ("full", 4),
                                        ("dots", 4), ("dots_masks", 4)])
def test_attention_runs_again_in_the_recompute(params, mode, calls,
                                               monkeypatch):
    """The attention kernel is no matrix product of PyTorch's: every mode but
    ``none`` runs it again in the recompute (on the card, K1 launches twice a
    layer and step)."""
    n = [0]
    real = ttrf.flash_attend_xy

    def counted(*a, **k):
        n[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(ttrf, "flash_attend_xy", counted)
    _steps(params, "flash", mode)
    assert n[0] == calls


def test_policy_keeps_products_and_only_dots_masks_keeps_masks():
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    aten = torch.ops.aten
    for keep in (False, True):
        policy = ttrf._keep_policy(keep)
        assert policy(None, aten.mm.default) == save
        assert policy(None, aten.bmm.default) == save
        assert policy(None, aten.lt.Scalar) != save
        ttrf._in_mask.on = True
        try:
            assert (policy(None, aten.lt.Scalar) == save) == keep
        finally:
            ttrf._in_mask.on = False
