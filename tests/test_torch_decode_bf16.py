"""The port's bf16 windowed decode steps against JAX's bf16 steps on the CPU.

``tests/test_torch_decode_graph.py`` holds the windowed steps to JAX in fp32;
this file holds the dtype the card serves in. For each step kind (single
``transformer_decode_step``, ``_shared``, ``_paged``) both packages start
from one bf16 cache filled by JAX's bf16 prefill and take 300 greedy steps,
the port reading its generated keys through the stage window that holds the
fill (``cache_stage_sizes``), JAX its whole buffer. Both are fed the same
token each step (JAX's greedy choice: teacher forcing, so the two walks stay
on one path however their logits round). Per step: the largest difference
of the fp32 logits of the heads, and per row and codebook whether the argmax
agrees. An argmax that differs where JAX's top two logits are more than
twice the step's difference apart is a fault (the rule of ``chip_smoke.py``
``argmax_check``); within that, a tie.

Measured on this CPU at the tiny width (d_model 64, 4 heads, 2 layers, 4
codebooks of 32, JAX's init from seed 0): no argmax differs outside a tie in
any kind. Single: the logits differ by at most 5.1e-3, and 13 of 2,400
argmaxes differ, all ties, the first at step 11 (top-two margin 2.3e-4,
error 2.4e-3). Shared: at most 4.3e-3, 19 of 4,800 ties, the first at step
21 (margin 3.3e-4, error 2.7e-3). Paged: at most 4.4e-3, 17 of 4,800 ties,
the first at step 27 (margin 7.8e-5, error 3.2e-3). The steps round apart
as two bf16 GEMM orders do; where two logits tie within that, greedy
chains part. ROADMAP's known differences record it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.models import transformer as jtrf
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models import transformer as ttrf
from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
from tests.test_torch_batched_decode import CFG, TCFG, models, one_torch_thread

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared

BF16 = torch.bfloat16
STEPS = 300
PROMPT = 96


def _torch_bf16(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.uint16).astype(np.int16)
                            ).view(BF16)


def _prefill(params, rows, tmax, seed):
    """JAX's bf16 prefill of ``rows`` random prompts of PROMPT positions
    into a bf16 cache of ``tmax`` slots."""
    rng = np.random.default_rng(seed)
    h = jnp.asarray(rng.standard_normal((rows, PROMPT, CFG.d_model)),
                    jnp.float32)
    causal = np.where(np.tril(np.ones((PROMPT, PROMPT), bool)), 0.0, -1e9)
    cache = jtrf.init_kv_cache(CFG, rows, tmax, dtype=jnp.bfloat16)
    _, cache = jtrf.transformer_prefill(
        params["decoder"], h, jnp.asarray(causal, jnp.float32)[None, None],
        cache, CFG, dtype=jnp.bfloat16)
    return cache


def _embed(params, tokens, pos, pe):
    """Row r's next input: the sum of its K codebook embeddings and the sine
    position (fp32, fed to both packages)."""
    emb = np.asarray(params["audio_emb"])  # [K, card, D]
    h = sum(emb[k][tokens[:, k]] for k in range(CFG.n_codebooks))
    return (h + pe[pos]).astype(np.float32)


class Walk:
    """Per-step logit differences and argmax agreement of the two walks."""

    def __init__(self):
        self.err, self.ties, self.faults, self.agree = [], [], [], 0

    def step(self, step, jl, tl):
        err = float(np.abs(jl - tl).max())
        self.err.append(err)
        ja, ta = jl.argmax(-1), tl.argmax(-1)
        top2 = np.sort(jl, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        for idx in zip(*np.nonzero(ja != ta)):
            (self.ties if margin[idx] <= 2 * err else self.faults).append(
                (step, idx, float(margin[idx]), err))
        self.agree += int((ja == ta).sum())
        return ja


def _logits(params, model, jout, tout):
    jl = np.asarray(jssr.predict_logits(params, jout.astype(jnp.float32)))
    tl = tssr.predict_logits(model, tout).numpy()
    return jl, tl


def walk_single(params, model):
    B = 2
    tmax = PROMPT + STEPS + 4
    jc = _prefill(params, B, tmax, 0)
    tk, tv = _torch_bf16(jc.k).clone(), _torch_bf16(jc.v).clone()
    sizes = ttrf.cache_stage_sizes(tmax)
    banned = np.array([[40, 56], [1, 56]], np.int64)  # a hidden text span
    step = jax.jit(lambda p, h, k, v, pos, b: jtrf.transformer_decode_step(
        p, h, jtrf.KVCache(k, v, pos), b, CFG, dtype=jnp.bfloat16))
    pe = tssr.sine_table(1024, CFG.d_model).numpy()
    tokens = np.zeros((B, CFG.n_codebooks), np.int64)
    walk, k, v = Walk(), jc.k, jc.v
    for i in range(STEPS):
        pos = PROMPT + i
        h = _embed(params, tokens, np.full(B, i), pe)
        jout, jcache = step(params["decoder"], jnp.asarray(h), k, v,
                            jnp.int32(pos), jnp.asarray(banned))
        k, v = jcache.k, jcache.v
        tout, _ = ttrf.transformer_decode_step(
            model["decoder"], torch.from_numpy(h),
            ttrf.KVCache(tk, tv, torch.tensor([pos])), torch.from_numpy(banned),
            TCFG, dtype=BF16, window=ttrf.stage_window(sizes, pos + 1))
        ja = walk.step(i, *_logits(params, model, jout, tout))
        tokens = np.repeat(ja[:1], B, axis=0)  # the cond row's choice
    return walk


def walk_shared(params, model):
    G, S = 2, 2
    B = G * S
    tg = STEPS + 4
    pfx = _prefill(params, G, PROMPT, 1)
    pk, pv = _torch_bf16(pfx.k), _torch_bf16(pfx.v)
    gk = torch.zeros((CFG.num_layers, B, CFG.nhead, tg, CFG.head_dim), dtype=BF16)
    gv = torch.zeros_like(gk)
    jk, jv = (jnp.zeros(gk.shape, jnp.bfloat16) for _ in range(2))
    sizes = ttrf.cache_stage_sizes(tg)
    banned = np.array([[40, 56], [1, 56]], np.int64)
    step = jax.jit(lambda p, h, k, v, g, b: jtrf.transformer_decode_step_shared(
        p, h, pfx, jtrf.KVCache(k, v, g), b, CFG, n_groups=G,
        dtype=jnp.bfloat16))
    pe = tssr.sine_table(1024, CFG.d_model).numpy()
    tokens = np.zeros((B, CFG.n_codebooks), np.int64)
    tokens[1::2] = 1  # the chains of a group start apart
    walk = Walk()
    for i in range(STEPS):
        h = _embed(params, tokens, np.full(B, i), pe)
        jout, jgen = step(params["decoder"], jnp.asarray(h), jk, jv,
                          jnp.int32(i), jnp.asarray(banned))
        jk, jv = jgen.k, jgen.v
        tout, _ = ttrf.transformer_decode_step_shared(
            model["decoder"], torch.from_numpy(h),
            ttrf.KVCache(pk, pv, torch.tensor([PROMPT])),
            ttrf.KVCache(gk, gv, torch.tensor([i])), torch.from_numpy(banned),
            TCFG, n_groups=G, dtype=BF16,
            window=ttrf.stage_window(sizes, i + 1))
        tokens = walk.step(i, *_logits(params, model, jout, tout))
    return walk


def walk_paged(params, model):
    B = 4  # 2 lanes, cond rows then uncond rows
    tg = STEPS + 4
    pfx = _prefill(params, B, PROMPT, 2)
    pk, pv = _torch_bf16(pfx.k), _torch_bf16(pfx.v)
    gk = torch.zeros((CFG.num_layers, B, CFG.nhead, tg, CFG.head_dim), dtype=BF16)
    gv = torch.zeros_like(gk)
    jk, jv = (jnp.zeros(gk.shape, jnp.bfloat16) for _ in range(2))
    sizes = ttrf.cache_stage_sizes(tg)
    banned = np.zeros((B, PROMPT), bool)
    banned[B // 2:, 1:56] = True  # the uncond rows' hidden prompt
    banned[:, 40:56] = True
    lag = np.array([0, 7, 0, 7])  # the second lane was refilled 7 steps later
    step = jax.jit(lambda p, h, k, v, b, n: jtrf.transformer_decode_step_paged(
        p, h, pfx, jtrf.KVCache(k, v, 0), b, n, CFG, dtype=jnp.bfloat16))
    pe = tssr.sine_table(1024, CFG.d_model).numpy()
    tokens = np.zeros((B, CFG.n_codebooks), np.int64)
    walk = Walk()
    for i in range(STEPS):
        gen_len = np.maximum(i - lag, 0)
        h = _embed(params, tokens, gen_len, pe)
        jout, jgen = step(params["decoder"], jnp.asarray(h), jk, jv,
                          jnp.asarray(banned), jnp.asarray(gen_len, jnp.int32))
        jk, jv = jgen.k, jgen.v
        tout, _ = ttrf.transformer_decode_step_paged(
            model["decoder"], torch.from_numpy(h),
            ttrf.KVCache(pk, pv, PROMPT), ttrf.KVCache(gk, gv, 0),
            torch.from_numpy(banned), torch.from_numpy(gen_len), TCFG,
            dtype=BF16, read_len=ttrf.stage_window(sizes, int(gen_len.max()) + 1))
        ja = walk.step(i, *_logits(params, model, jout, tout))
        tokens = np.concatenate([ja[:B // 2], ja[:B // 2]])  # cond choices
    return walk


WALKS = {"single": walk_single, "shared": walk_shared, "paged": walk_paged}


@pytest.mark.parametrize("kind", list(WALKS))
def test_bf16_windowed_steps_agree_with_jax_outside_ties(models, kind):
    params, _ = models
    model = lm_from_jax(jax.tree.map(np.asarray, params), TCFG, dtype=BF16)
    walk = WALKS[kind](params, model)
    assert len(walk.err) == STEPS
    assert not walk.faults, walk.faults[:5]
    # the steps round apart as bf16 does, no more: a fault of the step
    # (a wrong mask, a stale cache column) moves the logits by O(1)
    assert max(walk.err) < 0.02, max(walk.err)
