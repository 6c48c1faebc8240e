"""``loops/serve_open.py``'s open-loop speech-editing service with the LM
of Moonlight-16B-A3B's block (``configs/ssr-moonlight-a3b-greedy.json``):
edits and TTS requests arrive on a fixed schedule and
``ContinuousBatcher.run_online`` serves them through its lanes, here each
step's experts through K11 and its latent attention through K12.

End to end as there: ``latency_p95_s`` and ``latency_p90_s`` over every
request of the window, from when it was due to when its codes were
harvested. Checked after the window as there, against this block's plain
reference (``lib/judge_mla_moe.py``): ``logit_gap_mean`` over a seeded
sample of the served requests (the longest first), its tokens whose
reference routing came near a tie left out, ``codes_mismatch`` of
the codes rebuilt from their tokens, no failed request and no capture in
the window. The server's routing counters (``stats["expert_tokens"]``,
``["expert_steps"]``, the live rows') ride in the outcome for the
per-layer readers; a traced burst records K12's launches and its requests'
sizes beside its stats, for the rooflines.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import (harness, judge_lm, judge_mla_moe, port,
                           port_mla_moe, profile, traffic, weights)
from portbench.loops import serve_open
from portbench.loops.serve_open import TRACE_REQUESTS, _captures, _tuples


class Service(serve_open.Service):
    """``serve_open.Service`` with this block's LM (``lib/port_mla_moe``):
    the server sized for every request the mix can draw, its graphs
    captured by a warm-up burst."""

    def __init__(self, ctx: harness.Context):
        from ssr_speech_tpu_torch.device import set_precision_policy
        from ssr_speech_tpu_torch.inference import serve

        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        if cfg["decode"]["top_k"] != 1:
            raise ValueError("the open-loop cell judges greedy tokens only: "
                             "its configuration decodes with top_k 1")
        set_precision_policy()
        self.ctx = ctx
        mcfg = port_mla_moe.lm_config(cfg)
        self.lm = port_mla_moe.lm(cfg, ctx.seed, dev)
        dec = port.decode_config(cfg, length_cap_mult=mix["length_cap_mult"],
                                 max_gen_per_span=mix["max_gen_per_span"])
        warm = traffic.serve_requests(
            mix, cfg, ctx.seed + 7_919,
            len(mix["edit_block"]) + len(mix["tts_block"]))
        sx_pad, p_pad, num_task = serve.serve_geometry(mcfg, dec, _tuples(warm))
        self.srv = serve.ContinuousBatcher(self.lm, mcfg, dec, mix["lanes"],
                                           sx_pad=sx_pad, p_pad=p_pad,
                                           num_task=num_task)
        self.gen = weights.generator(ctx.seed, 200, dev)
        self.kw = dict(chunk_steps=mix["chunk_steps"],
                       eager_prefill=mix["eager_prefill"])
        self.serve(warm, [0.0] * len(warm))
        harness.sync(dev)

    def burst(self, reqs):
        """The traced burst: ``reqs`` all due at once; its stats with the
        steps in which K12 ran (``k12_steps``: its launches over a step's,
        the steps a replay runs past a chunk's end included) and its
        requests' sizes (``units``)."""
        from ssr_speech_tpu_torch.ops import mla_attention

        mla_attention.reset_launches()
        results, _, _, stats = self.serve(reqs, [0.0] * len(reqs), {})
        harness.sync(self.ctx.device)
        stats.update(
            k12_steps=mla_attention.launches / self.srv.cfg.num_layers,
            units=[_sizes(r, res, self.ctx.cfg) for r, res in zip(reqs, results)])
        return stats


def _sizes(req, result, cfg):
    """x_len, p_len and the generated frames of a served request."""
    return dict(x_len=len(req["x"]),
                p_len=(req["frames"] - (req["span"][1] - req["span"][0])
                       + traffic.prefix_overhead(cfg)),
                gen_frames=int(np.asarray(result[1]).sum()))


def run(ctx: harness.Context) -> harness.Outcome:
    from ssr_speech_tpu_torch.device import compute_dtype

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    n = int(round(mix["rate_per_s"] * ctx.seconds))
    reqs = traffic.serve_requests(mix, cfg, ctx.seed, n)
    times = traffic.arrivals(mix["rate_per_s"], n, ctx.seed)
    svc = Service(ctx)
    captured = _captures(svc.srv)
    setup_s = time.perf_counter() - ctx.t_start

    results, done_at, wall, stats = svc.serve(reqs, times, {})
    in_window = _captures(svc.srv) - captured
    units, failed = [], 0
    for r, res, t_done in zip(reqs, results, done_at):
        if res is None or t_done is None:
            failed += 1
            continue
        codes, marks, _, _ = res
        units.append(dict(req=r, codes=codes, marks=marks,
                          latency_s=t_done - times[r["index"]],
                          stream=stats["out_tokens"][r["index"]],
                          **_sizes(r, res, cfg)))
    lat = np.array([u["latency_s"] for u in units])
    q = lambda p: float(np.quantile(lat, p)) if len(lat) else float("inf")
    served = sum(u["gen_frames"] for u in units) / cfg["codec"]["frame_rate"]
    steps = max(stats.get("decode_steps", 0), 1)
    touched, spread = float("nan"), float("nan")
    if "expert_steps" in stats:
        touched = stats["expert_steps"].sum(1).mean() / steps
        tok = stats["expert_tokens"]
        spread = float((tok.max(1) / np.maximum(tok.mean(1), 1e-9)).mean())
    ctx.log(f"requests {len(units)} of {n}, latency p50 {q(0.5):.3f} s, "
            f"p90 {q(0.9):.3f} s, p95 {q(0.95):.3f} s, served "
            f"{served / wall:.2f} audio-s/s over {wall:.2f} s, last done "
            f"{max(done_at):.2f} s after the start (last arrival "
            f"{times[-1]:.2f} s); {1e3 * stats.get('decode_s', 0) / steps:.2f} "
            f"ms a step, {touched:.1f} experts a MoE layer a step, max / mean "
            f"load {spread:.2f}")
    traced, summary = [], None
    if ctx.trace:
        burst = traffic.serve_requests(mix, cfg, ctx.seed + 104_729, TRACE_REQUESTS)
        traced, summary = profile.traced(lambda: [svc.burst(burst)])
    peak = harness.peak_bytes(dev)
    del svc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = judge(ctx, units, compute_dtype(dev))
    ctx.log(f"judged in {time.perf_counter() - t_judge:.1f} s")
    checks.append(harness.check("failed_requests", float(failed), 0.0))
    checks.append(harness.check("captures_in_window", float(in_window), 0.0))
    return harness.Outcome(
        e2e=dict(latency_p95_s=q(0.95), latency_p90_s=q(0.9), setup_s=setup_s),
        units=units, attempted=n, failed=failed, checks=checks,
        memory_peak_bytes=peak, profile=summary, traced=traced,
        extra=dict(stats=stats))


def judge(ctx: harness.Context, units, lm_dtype):
    cfg = ctx.cfg
    limits = ctx.workload["limits"]
    K = cfg["n_codebooks"]
    picked = harness.sample(units, ctx.seed, key=lambda u: u["gen_frames"],
                            want=ctx.workload["judge_steps"])
    items = [dict(x=u["req"]["x"], y=u["req"]["y"], span=u["req"]["span"],
                  stream=judge_lm.served_stream(u["stream"], u["gen_frames"], K))
             for u in picked]
    gap, compared, built = judge_mla_moe.judge(ctx, items, lm_dtype)
    mismatch = sum(judge_lm.codes_mismatch(u, it, kept, K)[0]
                   for u, it, (_, kept) in zip(picked, items, built))
    return [harness.check("logit_gap_mean", gap, limits["logit_gap_mean"]),
            harness.check("codes_mismatch", mismatch, limits["codes_mismatch"]),
            harness.check("tokens_compared", float(compared),
                          float(limits["min_tokens_compared"]), least=True)]
