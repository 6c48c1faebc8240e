"""The port's MLA + MoE block (``models/mla_moe.py``) against the plain
float32 reference ``tests/plain_mla_moe.py`` at a tiny size on the CPU:
d 64, 4 heads, latent 32 + rope 16, nope 16, v 16, 3 layers (1 dense, 2
MoE), 8 experts top-2 with 1 shared, expert width 32. Covered: the prefill
and single steps teacher-forced against the full forward's logits; greedy
``decode.generate`` and the continuous server (a lane refilled mid-flight)
against the reference's argmax; the absorbed decode attention against the
expanded one; the router against a hand computation; the routing counters
against a hand count; RoPE positions unmoved by the text padding; the
config's JSON; the paths that refuse the block; and that no module of the
inference layer names a block (``models.ssr.decoder_block`` chooses)."""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.config import DecodeConfig, TokenSpace
from ssr_speech_tpu_torch.inference import decode
from ssr_speech_tpu_torch.inference import serve
from ssr_speech_tpu_torch.models import mla_moe, ssr
from ssr_speech_tpu_torch.ops import mla_attention, moe_experts, patterns
from tests import plain_mla_moe as plain

CFG = mla_moe.MLAMoEConfig(
    d_model=64, nhead=4, num_layers=3, n_codebooks=4, audio_embedding_dim=64,
    text_vocab_size=40, tokens=TokenSpace(audio_vocab_size=32), head_hidden=32,
    max_position=512, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=16, v_head_dim=16, intermediate_size=64,
    moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
    n_shared_experts=1, first_k_dense_replace=1)
DEC = DecodeConfig(top_k=1, top_p=0.8, stop_repetition=-1, cfg_coef=1.5,
                   cfg_stride=2, aug_text=True, cfg_pretrained=True,
                   max_gen_per_span=24, length_cap_mult=4)
TOL = 1e-4  # fp32 on both sides: only the order of sums differs


@pytest.fixture(scope="module")
def lm():
    tree = mla_moe.init_params(torch.Generator().manual_seed(3), CFG)
    # EOG suppressed, so that a span runs to its length cap
    tree["head2_b"][:, CFG.tokens.eog] = -1e9
    return mla_moe.lm_from_tree(tree, CFG), plain.PlainMLAMoE(tree, CFG)


def _request(seed, T=20, span=(6, 12), sx=14):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG.text_vocab_size - 1, size=sx),
            rng.integers(0, CFG.tokens.audio_vocab_size, size=(4, T)), [span])


def _greedy_gap(ref, x, y, mask, stream):
    """The widest gap by which a served audio token's guided reference
    logit lies below the reference's best (0 where the served token is the
    reference's argmax)."""
    ts = CFG.tokens
    prefix, _, _, _ = patterns.build_inference_prefix(np.asarray(y, np.int32),
                                                      mask, ts)
    fed = np.concatenate([np.full((4, 1), ts.mts), stream[:, :-1]], 1)
    lg = plain.decode_logits(ref, x, prefix, fed,
                             uncond_text=np.array([CFG.text_vocab_size - 1]),
                             cfg_coef=DEC.cfg_coef, cfg_stride=DEC.cfg_stride)
    tok = torch.as_tensor(stream.T, dtype=torch.long)
    vocab = ts.audio_vocab_size
    free = tok < vocab
    audio = lg[..., :vocab]
    gap = audio.max(-1).values - audio.gather(-1, tok.clamp(max=vocab - 1)[..., None])[..., 0]
    assert int(free.sum()) > 8
    return float(gap[free].max())


def test_prefill_and_steps_match_the_full_forward(lm):
    """``decode._prefill_impl`` then ``mla_moe.decode_step`` over fed tokens
    (cond and uncond rows), each step's logits against the reference's full
    forward at that audio position."""
    model, ref = lm
    x, y, mask = _request(1)
    ts = CFG.tokens
    prefix, _, _, _ = patterns.build_inference_prefix(y.astype(np.int32), mask, ts)
    p_len, x_len, sx_pad, p_pad = prefix.shape[1], len(x), 64, 128
    xb, _ = decode.build_text_rows([x], sx_pad, CFG, DEC, None)
    pre = np.full((4, p_pad), ts.empty)
    pre[:, :p_len] = prefix
    cache, banned = decode._prefill_impl(
        model, torch.as_tensor(xb), torch.as_tensor(pre), x_len, p_len, cfg=CFG,
        tmax=256, dtype=torch.float32, cfg_pretrained=True, aug_text=True)
    fed = np.random.default_rng(2).integers(0, ts.audio_vocab_size, size=(4, 6))
    pe = ssr.sine_table(CFG.max_position, CFG.d_model)
    got = []
    with torch.no_grad():
        for t in range(fed.shape[1]):
            h = decode._embed_step_tokens(model, CFG, torch.as_tensor(fed[None, :, t]),
                                          pe, p_len + t, True, torch.float32)
            out, cache = mla_moe.decode_step(model["decoder"], h, cache, banned, CFG,
                                             y_pos=torch.full((1,), p_len + t),
                                             dtype=torch.float32)
            got.append(ssr.predict_logits(model, out))
    got = torch.stack(got)  # [n, 2, K, card]
    audio = np.concatenate([prefix, fed], 1)
    cond = ref.logits(x, audio, fed.shape[1])
    uncond = ref.logits(np.array([CFG.text_vocab_size - 1]), audio, fed.shape[1])
    torch.testing.assert_close(got[:, 0], cond, rtol=TOL, atol=TOL)
    torch.testing.assert_close(got[:, 1], uncond, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["edit", "tts"])
def test_generate_greedy_matches_the_reference(lm, kind):
    model, ref = lm
    x, y, mask = _request(4) if kind == "edit" else _request(5, T=12, span=(12, 12))
    stats = {}
    codes, marks, _, _ = decode.generate(model, CFG, DEC, x, y, mask,
                                         torch.Generator().manual_seed(0),
                                         stats=stats)
    n = int(np.asarray(marks).sum()) + CFG.n_codebooks
    assert _greedy_gap(ref, x, y, mask, stats["out_tokens"][:, :n]) <= TOL


def test_continuous_server_refills_against_the_reference(lm):
    """Three requests through two lanes: the third is spliced into the lane
    the first freed while the second is mid-flight. Each served stream is
    the reference's argmax, and the routing counters count the live lanes'
    rows of every step."""
    model, ref = lm
    reqs = [_request(7), _request(8, T=16, span=(3, 9), sx=10),
            _request(9, T=12, span=(12, 12))]
    srv = serve.ContinuousBatcher(model, CFG, DEC, 2, sx_pad=64, p_pad=128)
    stats = {}
    srv.stats = stats
    results, _ = srv.run_online(reqs, [0.0, 0.0, 0.0], torch.Generator().manual_seed(0),
                                chunk_steps=4)
    assert all(r is not None for r in results)
    for i, (x, y, mask) in enumerate(reqs):
        n = int(np.asarray(results[i][1]).sum()) + CFG.n_codebooks
        assert _greedy_gap(ref, x, y, mask, stats["out_tokens"][i][:, :n]) <= TOL
    pairs = 2 * CFG.num_experts_per_tok * stats["lane_steps"]  # CFG rows x choices
    assert stats["lane_steps"] < 2 * stats["decode_steps"]  # a lane was parked
    assert stats["expert_tokens"].shape == (CFG.n_moe_layers, CFG.n_routed_experts)
    assert (stats["expert_tokens"].sum(1) == pairs).all()
    assert (stats["expert_steps"].max() <= stats["decode_steps"])


@pytest.mark.parametrize("gen_len", [[5, 0, 3], [7, 7, 1]])
def test_absorbed_attention_matches_expanded(gen_len):
    """The paged step's absorbed attention (q_nope W_k over the latents,
    then W_v) against attention over expanded per-head keys and values, on
    rows at ragged generated lengths (0: a lane just refilled, whose cache
    row holds the previous occupant's latents)."""
    g = torch.Generator().manual_seed(11)
    B, H, nope, rope_d, r, v_d, tp, tg = 3, 4, 16, 8, 32, 16, 10, 9
    W = r + rope_d
    q_nope, q_pe = torch.randn(B, H, nope, generator=g), torch.randn(B, H, rope_d, generator=g)
    kvb_k, kvb_v = torch.randn(H, nope, r, generator=g), torch.randn(H, r, v_d, generator=g)
    pfx, gen = torch.randn(B, tp, W, generator=g), torch.randn(B, tg, W, generator=g)
    cur = torch.randn(B, W, generator=g)
    banned = torch.zeros(B, tp, dtype=torch.bool)
    banned[0, 3:6] = True
    banned[2, 1:] = True
    gl = torch.tensor(gen_len)
    scale = (nope + rope_d) ** -0.5
    q = torch.cat([torch.einsum("bhn,hnc->bhc", q_nope, kvb_k), q_pe], -1)
    got = torch.einsum("bhc,hcv->bhv", mla_attention.plain_paged_mla_attention(
        q, cur, pfx, gen, banned, gl, tp, tg, scale, r), kvb_v)
    for b in range(B):
        keys = torch.cat([pfx[b][~banned[b]], gen[b, :gen_len[b]], cur[b, None]])
        k = torch.cat([torch.einsum("tc,hnc->htn", keys[:, :r], kvb_k),
                       keys[None, :, r:].expand(H, -1, -1)], -1)
        v = torch.einsum("tc,hcv->htv", keys[:, :r], kvb_v)
        qb = torch.cat([q_nope[b], q_pe[b]], -1)
        p = torch.softmax(torch.einsum("hd,htd->ht", qb, k) * scale, -1)
        torch.testing.assert_close(got[b], torch.einsum("ht,htv->hv", p, v),
                                   rtol=1e-5, atol=1e-5)


def test_router_against_a_hand_computation():
    """Sigmoid scores, the choice on score + e_bias (here it passes over
    the highest score), the chosen scores normalised and scaled."""
    cfg = dataclasses.replace(CFG, n_routed_experts=4, num_experts_per_tok=2)
    b = torch.tensor([[1.0, -2.0]])
    router = torch.tensor([[0.5, -1.0, 2.0, 0.0], [0.25, 0.0, 0.5, -0.5]])
    bias = torch.tensor([0.0, 0.3, -0.4, 0.1])
    idx, w = mla_moe.route(b, router, bias, cfg)
    logit = [0.5 - 0.5, -1.0, 2.0 - 1.0, 1.0]
    s = [1.0 / (1.0 + math.exp(-v)) for v in logit]
    choice = sorted(range(4), key=lambda e: -(s[e] + float(bias[e])))[:2]
    assert sorted(idx[0].tolist()) == sorted(choice) == [1, 3]
    want = {e: s[e] / (s[1] + s[3]) * 2.446 for e in choice}
    for e, wt in zip(idx[0].tolist(), w[0].tolist()):
        assert wt == pytest.approx(want[e], rel=1e-6)


@pytest.mark.parametrize("live", [True, False, (True, False, True)],
                         ids=["True", "False", "parked"])
def test_routing_counters_against_a_hand_count(live):
    """Each expert's live (row, choice) pairs and whether it had any; a row
    that is not live gets nothing from the routed experts."""
    g = torch.Generator().manual_seed(5)
    E, D, Fe = 4, 8, 4
    idx = torch.tensor([[0, 2], [2, 3], [0, 2]])
    rows = torch.tensor(live if isinstance(live, tuple) else (live,) * 3)
    counts = torch.zeros(2, E, dtype=torch.int32)
    out = moe_experts.plain_moe_experts(
        torch.randn(3, D, generator=g), idx, torch.rand(3, 2, generator=g),
        torch.randn(E, 2 * Fe, D, generator=g), torch.randn(E, D, Fe, generator=g),
        counts=counts, live=rows)
    assert out.shape == (3, D)
    want = {True: [[2, 0, 3, 1], [1, 0, 1, 1]], False: [[0] * 4, [0] * 4],
            (True, False, True): [[2, 0, 2, 0], [1, 0, 1, 0]]}[live]
    assert counts.tolist() == want
    assert bool((out[~rows] == 0).all())
    assert bool((out[rows] != 0).all()) if rows.any() else True


def test_rope_positions_unmoved_by_text_padding(lm):
    """The same request prefilled with the text block padded to 64 and to
    128: every layer's latents of the audio positions agree."""
    model, _ = lm
    x, y, mask = _request(12)
    ts = CFG.tokens
    prefix, _, _, _ = patterns.build_inference_prefix(y.astype(np.int32), mask, ts)
    p_len = prefix.shape[1]
    lat = []
    for sx_pad in (64, 128):
        xb, _ = decode.build_text_rows([x], sx_pad, CFG, DEC, None)
        cache, _ = decode._prefill_impl(
            model, torch.as_tensor(xb), torch.as_tensor(prefix), len(x), p_len,
            cfg=CFG, tmax=256, dtype=torch.float32, cfg_pretrained=True,
            aug_text=True)
        lat.append(cache.c[:, :, sx_pad:sx_pad + p_len])
    torch.testing.assert_close(lat[0], lat[1], rtol=1e-5, atol=1e-5)


def test_config_json_round_trip():
    assert mla_moe.config_from_json(mla_moe.config_to_json(CFG)) == CFG
    moon = mla_moe.MLAMoEConfig()
    assert mla_moe.config_from_json(mla_moe.config_to_json(moon)) == moon
    assert (moon.latent_dim, moon.qk_head_dim, moon.n_moe_layers) == (576, 192, 26)


def _refusals():
    from ssr_speech_tpu_torch.models.from_jax import int8_ffn_from_jax
    from ssr_speech_tpu_torch.parallel.mesh import shard_params_for_serving

    x, y, mask = _request(3)
    gen = torch.Generator().manual_seed(0)
    return dict(
        generate_batch=lambda m: decode.generate_batch(m, CFG, DEC, x, y, mask, gen, 2),
        generate_multi=lambda m: decode.generate_multi(m, CFG, DEC, [(x, y, mask)], gen),
        training=lambda m: ssr.ssr_forward(m, CFG, {}),
        tensor_parallel=lambda m: shard_params_for_serving(None, m),
        int8=lambda m: int8_ffn_from_jax(m))


@pytest.mark.parametrize("path", ["generate_batch", "generate_multi", "training",
                                  "tensor_parallel", "int8"])
def test_paths_refuse_the_block(lm, path):
    with pytest.raises(ValueError, match="MLA"):
        _refusals()[path](lm[0])


def test_inference_names_no_block():
    """``models.ssr.decoder_block`` is the one place that knows the blocks:
    no module of ``inference/`` imports the MLA + MoE module, asks
    ``is_mla_moe`` or tests a config against ``MLAMoEConfig``."""
    names = re.compile(r"\bmla_moe\b|\bis_mla_moe\b|\bMLAMoEConfig\b")
    root = Path(ssr.__file__).parents[1] / "inference"
    found = [f"{p.name}:{i}: {line.strip()}"
             for p in sorted(root.glob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if names.search(line)]
    assert found == []
