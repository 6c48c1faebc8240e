"""The ``moonlight-serve-open-16lane`` cell at a tiny geometry on the CPU:
its loop through ``run.measure`` (correct, with the cell's metrics), its
control run judged not correct, and its plain reference
(``reference/lm_mla_moe.py``) against the CPU tests' independent copy
(``tests/plain_mla_moe.py``) on the same seeded weights."""

import numpy as np
import torch

from portbench.lib import common, harness, port_mla_moe, weights_mla_moe
from portbench.reference import lm_mla_moe
from portbench.tests import tiny

CELL = "moonlight-serve-open-16lane"
CPU = torch.device("cpu")


def tiny_cfg() -> dict:
    cfg = common.config("ssr-moonlight-a3b-greedy")
    cfg.update(hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
               v_head_dim=16, intermediate_size=64, moe_intermediate_size=32,
               n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               head_hidden=32)
    cfg["tokens"] = dict(audio_vocab_size=64, n_special=5, max_n_spans=3)
    return cfg


def context(control=False, trace=False) -> harness.Context:
    mix = common.traffic_params("serve-open-16lane")
    mix.update(rate_per_s=3.0, edit_block=[[19, 6], [23, 8]],
               tts_block=[[10, 13], [12, 15]], max_gen_per_span=32, lanes=2,
               chunk_steps=8)
    wl = common.workload(CELL)
    wl["judge_steps"] = 200
    wl["limits"] = dict(wl["limits"], logit_gap_mean=1e-6, min_tokens_compared=10)
    return harness.Context(cell=CELL, workload=wl, cfg=tiny_cfg(), mix=mix,
                           device=CPU, seed=2 ** 31 + 99, seconds=4.0,
                           trace=trace, control=control)


def test_dry_run_is_correct_and_reports_the_cell():
    out, metrics, _ = tiny.measure(context(trace=True))
    assert all(c["ok"] for c in out.checks), out.checks
    for name in ("decode_ms_per_step.moe16", "decode_mfu.moe16",
                 "experts_touched.moe16", "admit_ms.moe16"):
        assert name in metrics, name
    assert 1 <= metrics["experts_touched.moe16"]["value"] <= 8
    # no kernel on the CPU: the device-trace rooflines read nothing
    assert "k11_roofline.moe16" not in metrics
    assert "k12_roofline.moe16" not in metrics


def test_control_run_is_not_correct():
    out, _, _ = tiny.measure(context(control=True))
    failed = {c["name"] for c in out.checks if not c["ok"]}
    assert "logit_gap_mean" in failed


def test_reference_matches_the_independent_copy():
    from tests import plain_mla_moe

    cfg = tiny_cfg()
    W = weights_mla_moe.lm_weights(cfg, 11, CPU, torch.float32)
    rng = np.random.default_rng(0)
    x, y = rng.integers(0, 119, size=9), rng.integers(0, 64, size=(4, 13))
    got = lm_mla_moe.LM(W, cfg, torch.float32).logits(x, y, 13)
    want = plain_mla_moe.PlainMLAMoE(W, port_mla_moe.lm_config(cfg)).logits(x, y, 13)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    b16 = lm_mla_moe.LM(W, cfg, torch.bfloat16).logits(x, y, 13)
    f8 = lm_mla_moe.LM(W, cfg, torch.bfloat16, fp8=True).logits(x, y, 13)
    e16, e8 = (b16 - want).abs().max(), (f8 - want).abs().max()
    assert 0 < e16 < 0.1 and e8 > 2 * e16
