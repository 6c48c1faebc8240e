"""The port's on-device decode loop on the CPU: the windowed decode steps with
a device position, the U-step bodies that the CUDA graphs capture, and the
guard that those bodies are capturable.

Both packages run here in fp32 with the same parameters (the JAX init
through ``lm_from_jax``), as in tests/test_torch_batched_decode.py.

(a) Each decode step with its fill on the device and a static read window
    (``transformer_decode_step``, ``_shared``, ``_paged``) against the same
    step with a host fill and against JAX's step on the same inputs: outputs
    within 1e-6 of the host-fill step and 1e-5 of JAX's (XLA's and torch's
    fp32 GEMMs round apart), identical greedy argmax over the heads, the new
    K/V written where the host-fill step writes them.
(b) The U-step bodies (``decode._chain_body`` for the single and shared
    paths, ``serve._serve_chunk_body`` for the server's chunk) in their loops
    against a loop of one step at a time with the conditions tested on the
    host (the loops as they ran before the graphs): identical ``out``,
    ``span_end``, ``out_len``, ``done`` and step counts, with no-op steps
    past ``max_steps``, ``cap_total``, the server's exit and its budget;
    sampled chains too where no step past the end draws. Then
    ``generate_batch``'s greedy chains identical to JAX's ``generate`` over
    tests/test_decode_fuzz.py's seeded sweep (tests/test_torch_decode_sweep.
    py holds ``generate``, ``generate_multi`` and ``serve_requests``).
(c) A capturability guard: each body, run twice under a
    ``TorchDispatchMode``, calls no operator that synchronises with the host
    or has a data-dependent shape, and reads and writes tensors of the same
    shapes and strides both times.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models import transformer as jtrf
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.inference import graphs
from ssr_speech_tpu_torch.inference import serve as tserve
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models import transformer as ttrf
from tests.test_decode_fuzz import _random_case
from tests.test_torch_batched_decode import (CFG, TCFG, TS, _assert_same,
                                             _dec, models, one_torch_thread)
from tests.test_torch_hostcopies import port_config

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared

F32 = torch.float32


def _argmax_heads(model, out):
    return tssr.predict_logits(model, out).argmax(-1)


# ------------------------------------------------ (a) the windowed steps

@pytest.mark.parametrize("window", [None, 22, 40])
def test_single_step_device_position(models, window):
    """A step at position 21 of a 40-slot cache, its fill a device tensor,
    read through a window of 22 (the fill plus the new token), 40 (the whole
    buffer) or the default (the whole buffer): the host-fill step's output
    within 1e-6, JAX's within 1e-5, the same argmax, the same K/V written,
    keys past the position masked whatever they hold."""
    params, model = models
    rng = np.random.default_rng(2)
    L, H, Dh, D = CFG.num_layers, CFG.nhead, CFG.head_dim, CFG.d_model
    B, T, pos = 2, 40, 21
    h = rng.standard_normal((B, D)).astype(np.float32)
    k, v = (rng.standard_normal((L, B, H, T, Dh)).astype(np.float32)
            for _ in range(2))
    ban = np.array([[10, 14], [1, 14]], np.int64)
    want, _ = jtrf.transformer_decode_step(
        params["decoder"], jnp.asarray(h),
        jtrf.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)),
        jnp.asarray(ban), CFG, dtype=jnp.float32)
    host = ttrf.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                        pos)
    ref, ref_c = ttrf.transformer_decode_step(
        model["decoder"], torch.from_numpy(h), host, torch.from_numpy(ban),
        TCFG, dtype=F32)
    dk, dv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    dk[:, :, :, pos + 1:] = 1e3  # beyond the position: never attended
    got, got_c = ttrf.transformer_decode_step(
        model["decoder"], torch.from_numpy(h),
        ttrf.KVCache(dk, dv, torch.tensor([pos])), torch.from_numpy(ban),
        TCFG, dtype=F32, window=window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.equal(_argmax_heads(model, got), _argmax_heads(model, ref))
    assert int(got_c.length) == ref_c.length == pos + 1
    for got_t, ref_t in ((dk, ref_c.k), (dv, ref_c.v)):
        assert torch.equal(got_t[:, :, :, :pos], ref_t[:, :, :, :pos])
        assert torch.equal(got_t[0, :, :, pos], ref_t[0, :, :, pos])
        torch.testing.assert_close(got_t[:, :, :, pos], ref_t[:, :, :, pos],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("ban", ["range", "bool"])
@pytest.mark.parametrize("window", [6, 16])
def test_shared_step_device_fills(models, ban, window):
    """The shared step with both fills on the device (prefix 40 of 64, 5
    generated of 16), the prefix read whole and the generated cache through
    a window of 6 or 16: the host-fill step within 1e-6, JAX's within 1e-5,
    the same argmax, the new K/V where the host-fill step writes them."""
    params, model = models
    rng = np.random.default_rng(7)
    L, H, Dh, D = CFG.num_layers, CFG.nhead, CFG.head_dim, CFG.d_model
    G, S, tp, p_len, tg, gpos = 2, 2, 64, 40, 16, 5
    B = G * S
    h = rng.standard_normal((B, D)).astype(np.float32)
    pk, pv = (rng.standard_normal((L, G, H, tp, Dh)).astype(np.float32)
              for _ in range(2))
    gk, gv = (rng.standard_normal((L, B, H, tg, Dh)).astype(np.float32)
              for _ in range(2))
    if ban == "range":
        key_banned = np.array([[12, 16], [1, 16]], np.int64)
    else:
        key_banned = rng.random((G, tp)) < 0.3
        key_banned[:, p_len:] = True
        key_banned[:, 0] = False
    want, _ = jtrf.transformer_decode_step_shared(
        params["decoder"], jnp.asarray(h),
        jtrf.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.int32(p_len)),
        jtrf.KVCache(jnp.asarray(gk), jnp.asarray(gv), jnp.int32(gpos)),
        jnp.asarray(key_banned), CFG, n_groups=G, dtype=jnp.float32)
    tb = torch.from_numpy(key_banned)
    host_gen = ttrf.KVCache(torch.from_numpy(gk.copy()),
                            torch.from_numpy(gv.copy()), gpos)
    ref, _ = ttrf.transformer_decode_step_shared(
        model["decoder"], torch.from_numpy(h),
        ttrf.KVCache(torch.from_numpy(pk), torch.from_numpy(pv), p_len),
        host_gen, tb, TCFG, n_groups=G, dtype=F32)
    pk_junk = pk.copy()
    if ban == "range":  # past the prefix fill: masked whatever it holds
        pk_junk[:, :, :, p_len:] = 1e3
    dev_gen = ttrf.KVCache(torch.from_numpy(gk.copy()),
                           torch.from_numpy(gv.copy()), torch.tensor([gpos]))
    got, got_gen = ttrf.transformer_decode_step_shared(
        model["decoder"], torch.from_numpy(h),
        ttrf.KVCache(torch.from_numpy(pk_junk), torch.from_numpy(pv),
                     torch.tensor([p_len])),
        dev_gen, tb, TCFG, n_groups=G, dtype=F32, window=window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.equal(_argmax_heads(model, got), _argmax_heads(model, ref))
    assert int(got_gen.length) == gpos + 1
    for got_t, ref_t in ((dev_gen.k, host_gen.k), (dev_gen.v, host_gen.v)):
        assert torch.equal(torch.cat([got_t[:, :, :, :gpos],
                                      got_t[:, :, :, gpos + 1:]], 3),
                           torch.cat([ref_t[:, :, :, :gpos],
                                      ref_t[:, :, :, gpos + 1:]], 3))
        assert torch.equal(got_t[0, :, :, gpos], ref_t[0, :, :, gpos])
        torch.testing.assert_close(got_t[:, :, :, gpos],
                                   ref_t[:, :, :, gpos], rtol=0, atol=1e-6)


def test_paged_step_stage_window(models):
    """The paged step through a stage window of 8 columns (the write
    columns at most 7) against its whole-buffer read and JAX's: within 1e-6
    and 1e-5, the same argmax, the same cache."""
    params, model = models
    rng = np.random.default_rng(9)
    L, H, Dh, D = CFG.num_layers, CFG.nhead, CFG.head_dim, CFG.d_model
    B, tp, p_len, tg = 4, 64, 40, 128
    gen_len = np.array([7, 3, 0, 5], np.int64)
    h = rng.standard_normal((B, D)).astype(np.float32)
    pk, pv = (rng.standard_normal((L, B, H, tp, Dh)).astype(np.float32)
              for _ in range(2))
    gk, gv = (rng.standard_normal((L, B, H, tg, Dh)).astype(np.float32)
              for _ in range(2))
    key_banned = rng.random((B, tp)) < 0.3
    key_banned[:, p_len:] = True
    key_banned[:, 0] = False
    want, _ = jtrf.transformer_decode_step_paged(
        params["decoder"], jnp.asarray(h),
        jtrf.KVCache(jnp.asarray(pk), jnp.asarray(pv), jnp.int32(p_len)),
        jtrf.KVCache(jnp.asarray(gk), jnp.asarray(gv), jnp.int32(0)),
        jnp.asarray(key_banned), jnp.asarray(gen_len), CFG,
        dtype=jnp.float32)
    outs, caches = [], []
    for read_len in (None, 8):
        gen = ttrf.KVCache(torch.from_numpy(gk.copy()),
                           torch.from_numpy(gv.copy()), 0)
        out, gen = ttrf.transformer_decode_step_paged(
            model["decoder"], torch.from_numpy(h),
            ttrf.KVCache(torch.from_numpy(pk), torch.from_numpy(pv), p_len),
            gen, torch.from_numpy(key_banned), torch.from_numpy(gen_len),
            TCFG, dtype=F32, read_len=read_len)
        outs.append(out)
        caches.append(gen)
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.equal(_argmax_heads(model, outs[1]),
                       _argmax_heads(model, outs[0]))
    # every layer's K/V land in one scatter after the loop: only layer 0's
    # is the same to the bit (the rest follow the attention's rounding)
    torch.testing.assert_close(caches[1].k, caches[0].k, rtol=0, atol=1e-6)
    assert torch.equal(caches[1].k[0], caches[0].k[0])


# ------------------------------------------- (b) the bodies in their loops

def _prompt(seed, T=30, sx=20, mask=((8, 15),)):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, TS.audio_vocab_size, size=(CFG.n_codebooks, T))
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(sx,))
    return x, y, list(mask)


def _consts(dec):
    return dict(pe=tssr.sine_table(TCFG.max_position, TCFG.d_model),
                silence=torch.tensor(dec.silence_tokens),
                static_ban=tdecode._static_ban(TS, "cpu"))


def _per_step_single(model, dec, p, cache, banned, gen):
    """One chain, one step at a time: the host fill grows, the loop stops
    on the host when the chain is done or ``max_steps`` steps are taken."""
    c = _consts(dec)
    aug = dec.aug_text
    cache = ttrf.KVCache(cache.k.clone(), cache.v.clone(), cache.length)
    s = tdecode._init_chain_state(p["p_len"], p["sentinels"], 1,
                                  TCFG.n_codebooks, p["num_task"], TS,
                                  p["cap_total"])
    max_steps = min(p["cap_total"], cache.max_len - cache.length)
    steps = 0
    while steps < max_steps and not bool(s.done.all()):
        h = tdecode._embed_step_tokens(model, TCFG, s.next_tokens, c["pe"],
                                       s.y_pos, aug, F32)
        out_h, cache = ttrf.transformer_decode_step(
            model["decoder"], h, cache, banned, TCFG, dtype=F32)
        lg, num_cfg = tdecode._mix_cfg(tssr.predict_logits(model, out_h), s,
                                       dec, 1, aug)
        s = tdecode._advance_chains(
            s, lg, gen, num_cfg, ts=TS, dec=dec, num_task=p["num_task"],
            length_cap=p["x_len"] * dec.length_cap_mult,
            n_tasks=p["num_task"], sentinel_ids=p["sentinels"],
            static_ban=c["static_ban"], silence=c["silence"])
        steps += 1
    return s, steps


def _one(model, dec, seed, tmax=None, mask=((8, 15),)):
    x, y, mask = _prompt(seed, mask=mask)
    p = tdecode._one_prompt(model, TCFG, dec, x, y, mask,
                            torch.Generator().manual_seed(0), None, None,
                            None, "test")
    if tmax is None:
        tmax = tdecode._bucket(p["sx_pad"] + p["p_pad"] + p["cap_total"]
                               + p["num_task"] + 8, tdecode.TMAX_BUCKET)
    return p, tmax


SINGLE_CASES = {
    "greedy": dict(dec=dict(aug_text=True), seed=1),
    "sampled": dict(dec=dict(aug_text=True, top_k=0, top_p=0.9,
                             temperature=1.1, stop_repetition=2), seed=2),
    # 13 steps of cap, not a multiple of the unroll: no-op steps follow
    "cap_total": dict(dec=dict(aug_text=False, max_gen_per_span=13), seed=3),
    # the cache (no larger than the prefill) fills before the cap
    "cache_full": dict(dec=dict(aug_text=True, max_gen_per_span=400), seed=4,
                       tight=True),
    "two_spans": dict(dec=dict(aug_text=True, cfg_stride=3), seed=5,
                      mask=((4, 9), (14, 20))),
}


@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_single_body_matches_per_step_loop(models, case):
    """``_generate_impl`` (the single body, eager on the CPU) against the
    per-step loop from the same prefill and generator seed."""
    _, model = models
    spec = SINGLE_CASES[case]
    dec = port_config(_dec(**spec["dec"]))
    p, tmax = _one(model, dec, spec["seed"], mask=spec.get("mask", ((8, 15),)))
    if spec.get("tight"):
        tmax = p["sx_pad"] + p["p_pad"]
    cache, banned = tdecode._prefill_impl(
        model, p["xb"], p["prefix"], p["x_len"], p["p_len"], cfg=TCFG,
        tmax=tmax, dtype=F32, cfg_pretrained=True, aug_text=dec.aug_text)
    want, steps = _per_step_single(model, dec, p, cache, banned,
                                   torch.Generator().manual_seed(11))
    stats = {}
    out, span_end, out_len = tdecode._generate_impl(
        model, cache, banned, torch.Generator().manual_seed(11),
        p["sentinels"], p["x_len"], p["p_len"], cfg=TCFG, dec=dec,
        num_task=p["num_task"], cap_total=p["cap_total"],
        aug_text=dec.aug_text, dtype=F32, stats=stats)
    ws = tdecode.single_workspace(model, TCFG, dec, rows=cache.k.shape[1],
                                  tmax=tmax, num_task=p["num_task"],
                                  cap_total=p["cap_total"], dtype=F32)
    assert stats["decode_steps"] == steps
    if case == "cap_total":  # no-op steps end the last replay
        assert steps == 13
    if case == "cache_full":
        assert steps == tmax - cache.length or bool(want.done.all())
    assert torch.equal(out, want.out[0])
    assert torch.equal(span_end, want.span_end[0])
    assert int(out_len) == int(want.out_len[0])
    assert torch.equal(ws.state.done, want.done)
    assert int(ws.pfx.length) == cache.length + steps


def _per_step_shared(model, dec, pfx, banned, gen, y_pos0, length_cap,
                     n_tasks, num_task, cap_total, S):
    c = _consts(dec)
    aug = dec.aug_text
    rows = S * (2 if aug else 1)
    g = ttrf.init_kv_cache(TCFG, rows, tdecode._bucket(cap_total + 8, 128),
                           dtype=F32)
    sent = torch.arange(TS.mts, TS.mts + TS.max_n_spans)
    s = tdecode._init_chain_state(y_pos0, sent, S, TCFG.n_codebooks,
                                  num_task, TS, cap_total)
    steps = 0
    while steps < cap_total and not bool(s.done.all()):
        h = tdecode._embed_step_tokens(model, TCFG, s.next_tokens, c["pe"],
                                       s.y_pos, aug, F32)
        out_h, g = ttrf.transformer_decode_step_shared(
            model["decoder"], h, pfx, g, banned, TCFG,
            n_groups=pfx.k.shape[1], dtype=F32)
        lg, num_cfg = tdecode._mix_cfg(tssr.predict_logits(model, out_h), s,
                                       dec, S, aug)
        s = tdecode._advance_chains(
            s, lg, gen, num_cfg, ts=TS, dec=dec, num_task=num_task,
            length_cap=length_cap, n_tasks=n_tasks, sentinel_ids=sent,
            static_ban=c["static_ban"], silence=c["silence"])
        steps += 1
    return s, steps


SHARED_CASES = {
    "greedy": dict(dec=dict(aug_text=True), S=3),
    "sampled": dict(dec=dict(aug_text=True, top_k=0, top_p=0.8,
                             stop_repetition=3), S=2),
    "cap_total": dict(dec=dict(aug_text=False, max_gen_per_span=13), S=3),
}


@pytest.mark.parametrize("case", list(SHARED_CASES))
def test_shared_body_matches_per_step_loop(models, case):
    """``_generate_batched_impl`` (the shared body over one prompt's cache)
    against the per-step loop from the same prefill and generator seed."""
    _, model = models
    spec = SHARED_CASES[case]
    dec = port_config(_dec(**spec["dec"]))
    S = spec["S"]
    p, _ = _one(model, dec, 6)
    tmax = tdecode._bucket(p["sx_pad"] + p["p_pad"] + 8, 256)
    pfx, banned = tdecode._prefill_impl(
        model, p["xb"], p["prefix"], p["x_len"], p["p_len"], cfg=TCFG,
        tmax=tmax, dtype=F32, cfg_pretrained=True, aug_text=dec.aug_text)
    want, steps = _per_step_shared(
        model, dec, pfx, banned, torch.Generator().manual_seed(3),
        p["p_len"], p["x_len"] * dec.length_cap_mult, p["num_task"],
        p["num_task"], p["cap_total"], S)
    stats = {}
    out, span_end, out_len = tdecode._generate_batched_impl(
        model, pfx, banned, torch.Generator().manual_seed(3), p["sentinels"],
        p["x_len"], p["p_len"], cfg=TCFG, dec=dec, num_task=p["num_task"],
        cap_total=p["cap_total"], aug_text=dec.aug_text, n_samples=S,
        dtype=F32, stats=stats)
    ws = tdecode.shared_workspace(
        model, TCFG, dec, groups=pfx.k.shape[1], n_chains=S, tmax=tmax,
        banned_bool=False, num_task=p["num_task"],
        cap_total=p["cap_total"], aug_text=dec.aug_text, dtype=F32)
    assert stats["decode_steps"] == steps
    if case == "cap_total":
        assert steps == p["cap_total"] == 13
    assert torch.equal(out, want.out)
    assert torch.equal(span_end, want.span_end)
    assert torch.equal(out_len, want.out_len)
    assert torch.equal(ws.state.done, want.done)


def _per_step_chunk(model, srv, st, budget):
    """The server's chunk one step at a time, its condition read on the
    host before each step, the generated cache read whole."""
    c = _consts(srv.dec)
    dec, S, aug = srv.dec, srv.S, srv.aug
    steps = 0
    while steps < budget:
        live = st.active & ~st.done
        if not bool(live.any() & ~(st.active & st.done).any()):
            break
        h = tdecode._embed_step_tokens(model, TCFG, st.next_tokens, c["pe"],
                                       st.y_pos, aug, F32)
        out_h, _ = ttrf.transformer_decode_step_paged(
            model["decoder"], h, srv._pfx, st.cache, srv._banned, st.gen_len,
            TCFG, dtype=F32)
        lg, num_cfg = tdecode._mix_cfg(tssr.predict_logits(model, out_h), st,
                                       dec, S, aug)
        upd = tdecode._advance_chains(
            st, lg, None, num_cfg, ts=TS, dec=dec, num_task=srv.num_task,
            length_cap=srv._x_lens * dec.length_cap_mult,
            n_tasks=srv._n_tasks, sentinel_ids=srv._sentinels_dev,
            static_ban=c["static_ban"], silence=c["silence"])
        adv = torch.cat([live, live]) if aug else live
        st = dataclasses.replace(st, **tserve._chain_fields(upd),
                                 gen_len=st.gen_len + adv.long())
        steps += 1
    return st, steps


def _clone_state(st):
    fields = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    out = {k: v.clone() for k, v in fields.items() if torch.is_tensor(v)}
    out["cache"] = ttrf.KVCache(st.cache.k.clone(), st.cache.v.clone(), 0)
    return dataclasses.replace(st, **out)


@pytest.mark.parametrize("budgets", [(5, 13, 2 ** 30), (2 ** 30, 2 ** 30),
                                     (25, 25, 25, 25)],
                         ids=["5-13-open", "open", "25s"])
def test_serve_chunks_match_per_step_loop(models, budgets):
    """Chunks of the server (2 slots, greedy under CFG, a 2-span edit among
    the requests, refills between chunks) against the per-step chunk on a
    copy of the state: the same state, write columns and steps after each
    chunk, whether it ends on its budget (5, 13, 25: 25 steps are 4 replays,
    7 steps of them no-ops) or when a chain finishes."""
    _, model = models
    dec = port_config(_dec(aug_text=True, cfg_stride=2))
    reqs = [_prompt(20 + i, mask=m) for i, m in
            enumerate((((8, 15),), ((4, 9), (14, 20)), ((6, 12),)))]
    srv = tserve.ContinuousBatcher(model, TCFG, dec, 2, sx_pad=64, p_pad=128,
                                   num_task=2)
    queue = list(enumerate(reqs))
    for slot in range(2):
        idx, (x, y, mask) = queue.pop(0)
        srv._fill_slot(slot, idx, x, y, mask)
    for budget in budgets:
        ref, ref_steps = _per_step_chunk(model, srv, _clone_state(srv.state),
                                         budget)
        srv.stats = {}
        srv._run_chunk(budget)
        assert srv.stats["decode_steps"] == ref_steps
        assert int(srv.state.steps) == ref_steps <= budget
        for f in dataclasses.fields(tdecode.ChainState):
            assert torch.equal(getattr(srv.state, f.name),
                               getattr(ref, f.name)), f.name
        assert torch.equal(srv.state.gen_len, ref.gen_len)
        for slot in np.nonzero(srv._harvestable())[0]:
            srv._harvest_slot(int(slot))
            if queue:
                idx, (x, y, mask) = queue.pop(0)
                srv._fill_slot(int(slot), idx, x, y, mask)
            else:
                srv._park(int(slot))
    srv.stats = None


@pytest.mark.parametrize("trial", range(8))
def test_sweep_batch_identical_to_jax(models, trial):
    """``generate_batch`` (2 chains over one prompt cache, the shared body)
    under tests/test_decode_fuzz.py's seeded sweep: both greedy chains give
    JAX ``generate``'s codes, marks and intervals."""
    params, model = models
    dec, x, y, mask, px, py = _random_case(np.random.default_rng(1000 + trial))
    want = jdecode.generate(params, CFG, dec, x, y, mask,
                            jax.random.PRNGKey(0), prompt_x=px, prompt_y=py,
                            dtype_name="float32")
    for got in tdecode.generate_batch(model, TCFG, port_config(dec), x, y,
                                      mask, torch.Generator().manual_seed(0),
                                      2, prompt_x=px, prompt_y=py):
        _assert_same(got, want)


# ------------------------------------------------ (c) the capturability guard

# operators a CUDA graph cannot hold: a host synchronisation, or an output
# whose shape depends on the data
SYNCING = {"aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
           "aten::equal", "aten::nonzero", "aten::nonzero_static",
           "aten::masked_select", "aten::masked_scatter", "aten::unique",
           "aten::_unique2", "aten::unique_consecutive", "aten::unique_dim",
           "aten::repeat_interleave", "aten::lift_fresh",
           "aten::lift_fresh_copy", "aten::_assert_async",
           "aten::_assert_scalar", "aten::bincount", "aten::histc"}


class _Guard(TorchDispatchMode):
    """Records each operator with the shapes, strides and dtypes of every
    tensor it reads or writes."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        leaves, _ = tree_flatten((args, kwargs, out))
        tensors = [(tuple(t.shape), t.stride(), t.dtype, t.device.type)
                   for t in leaves if isinstance(t, torch.Tensor)]
        self.calls.append((func._schema.name, tensors))
        return out


def _guarded_runs(body, window, gen):
    runs = []
    for _ in range(2):
        with _Guard() as guard:
            body(window, gen)
        runs.append(guard.calls)
    return runs


def _single_body(model):
    dec = port_config(_dec(aug_text=True, stop_repetition=2, top_k=0,
                           top_p=0.9))
    p, tmax = _one(model, dec, 1)
    ws = tdecode.single_workspace(model, TCFG, dec, rows=2, tmax=tmax,
                                  num_task=p["num_task"],
                                  cap_total=p["cap_total"], dtype=F32)
    cache, banned = tdecode._prefill_impl(
        model, p["xb"], p["prefix"], p["x_len"], p["p_len"], cfg=TCFG,
        tmax=tmax, dtype=F32, cfg_pretrained=True, aug_text=True,
        cache=ws.prefill_cache())
    ws.load(cache)
    ws.start(banned, p["p_len"], p["sentinels"], p["x_len"] * 10,
             p["num_task"], p["cap_total"], TS.empty)
    body = tdecode._chain_body(model, ws, cfg=TCFG, dec=dec,
                               num_task=p["num_task"], aug_text=True,
                               dtype=F32)
    return body, ws.windows[0]


def _shared_body(model):
    dec = port_config(_dec(aug_text=True))
    reqs = [(x, y, m) for x, y, m in (_prompt(3), _prompt(4, mask=((4, 9),
                                                                  (14, 20))))]
    stats = {}
    tdecode.generate_multi(model, TCFG, dec, reqs, torch.Generator(),
                           stats=stats)
    ws = next(w for w in graphs.kept()
              if w.gen is not None and w.banned.dtype == torch.bool)
    ws.step.zero_()
    ws.state.done.fill_(False)
    body = tdecode._chain_body(model, ws, cfg=TCFG, dec=dec,
                               num_task=ws.state.span_end.shape[1],
                               aug_text=True, dtype=F32)
    return body, ws.windows[0]


def _paged_body(model):
    dec = port_config(_dec(aug_text=True, cfg_stride=2))
    srv = tserve.ContinuousBatcher(model, TCFG, dec, 2, sx_pad=64, p_pad=128,
                                   num_task=2)
    for slot, (x, y, mask) in enumerate((_prompt(5), _prompt(6))):
        srv._fill_slot(slot, slot, x, y, mask)
    srv.state.budget.fill_(2 ** 30)
    return tserve._serve_chunk_body(model, srv), srv._windows[0]


@pytest.mark.parametrize("path", ["single", "shared", "paged"])
def test_bodies_are_capturable(models, path):
    """Two consecutive runs of the body (each ``graphs.UNROLL`` steps, the
    second as a replay would follow the first): no syncing or
    data-dependent operator, and the same operators on tensors of the same
    shapes, strides and dtypes, none moved between devices."""
    _, model = models
    body, window = {"single": _single_body, "shared": _shared_body,
                    "paged": _paged_body}[path](model)
    first, second = _guarded_runs(body, window, torch.Generator())
    names = {name for name, _ in first + second}
    assert not names & SYNCING, sorted(names & SYNCING)
    assert len(first) == len(second) > 100 * graphs.UNROLL
    assert first == second
    assert all(dev == "cpu" for _, ts in first for *_, dev in ts)
