"""Data-parallel watermark-codec training of the port: one step over 2
spawned ranks (gloo, the batch's rows split in two) against the port's
one-process step and JAX's step on the whole batch, at the JAX dp test's
tolerances (metrics rel 2e-3 abs 2e-5; the trained parameters rtol 1e-2
atol 1e-4: fp32 sums in another order over the split batch), and every
rank's state bit-identical to the other's (EMA included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.training import codec_trainer as jct
from ssr_speech_tpu_torch.models.from_jax import (
    codec_train_state_from_jax, codec_train_state_to_numpy)
from ssr_speech_tpu_torch.parallel.dist import spawn
from ssr_speech_tpu_torch.training import codec_trainer as tct
from tests import torch_parallel_ranks as ranks
from tests.test_torch_codec_train import TINY, TTINY

B, DUR, LR = 8, 0.4, 1e-3


@pytest.fixture(scope="module")
def runs():
    T = int(DUR * TINY.sample_rate) // TINY.hop_length * TINY.hop_length
    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(B, T, 1)) * 0.1).astype(np.float32)
    labels, keep = jwm.sample_watermark_mask(rng, B, T // TINY.hop_length,
                                             TINY.hop_length)
    jstate, opts = jct.init_codec_train_state(jax.random.PRNGKey(0), TINY, lr=LR)
    start = codec_train_state_to_numpy(codec_train_state_from_jax(jstate, TTINY))
    jstep = jct.make_codec_train_step(TINY, opts, ema_decay=0.99)
    js, jm = jstep(jstate, jnp.asarray(wav), jnp.asarray(labels), jnp.asarray(keep))
    jax_out = (codec_train_state_to_numpy(codec_train_state_from_jax(js, TTINY)),
               {k: float(v) for k, v in jm.items()})
    state = codec_train_state_from_jax(start, TTINY)
    step = tct.make_codec_train_step(TTINY, tct.make_optimizers(LR), ema_decay=0.99)
    state, m = step(state, *(torch.from_numpy(np.array(a))
                             for a in (wav, labels, keep)))
    one = (codec_train_state_to_numpy(state), {k: float(v) for k, v in m.items()})
    dp = spawn(ranks.codec_dp_step, 2, args=(start, TTINY, wav, labels, keep, LR))
    return dict(jax=jax_out, one=one, dp=dp)


@pytest.mark.parametrize("ref", ["one", "jax"])
def test_dp_codec_step_matches_the_whole_batch_step(runs, ref):
    want_state, want_m = runs[ref]
    for r in runs["dp"]:
        for k in want_m:
            assert r["metrics"][k] == pytest.approx(want_m[k], rel=2e-3,
                                                    abs=2e-5), k
        for field in (0, 2, 6):  # watermark decoder, discriminator, EMA
            for a, b in zip(jax.tree.leaves(r["state"][field]),
                            jax.tree.leaves(want_state[field])):
                np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-4)


def test_dp_ranks_hold_identical_state(runs):
    a, b = runs["dp"]
    assert a["metrics"] == b["metrics"]
    for x, y in zip(jax.tree.leaves(a["state"]), jax.tree.leaves(b["state"])):
        np.testing.assert_array_equal(x, y)
