"""A speech-editing service, open loop: edits and TTS requests arrive on a
fixed schedule (``lib/traffic.arrivals``) whatever the server's progress,
and ``ContinuousBatcher.run_online`` serves them through its lanes (each
lane two rows under CFG): admission prefills, splices into free lanes,
chunks of replayed paged decode steps, harvests.

End to end: ``latency_p95_s`` and ``latency_p90_s``, the 95th and 90th
percentiles over every request of the window of the time from when it was
due to when its codes were harvested (the server's own clock of the
arrivals); the median, the count, the served audio seconds a second and
how far the last completion trailed the last arrival are printed beside
them. Checked
after the window: the served tokens of a seeded sample of the requests
(the longest first) against the plain reference (``logit_gap_mean``) and
the codes rebuilt from them (``codes_mismatch``). The server holds one
decoding configuration for all its lanes, so the cell's configuration
decodes greedily (``top_k`` 1): only greedy tokens are judged by their
logit gap. A control run judges the control's tokens in their place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import harness, judge_lm, port, profile, traffic, weights

TRACE_REQUESTS = 12  # a burst profiled after the window of a --trace 1 run


def _captures(srv) -> int:
    return srv._loop.captures + sum(st.prefill.captures + st.splice.captures
                                    for st in srv._staging)


def _tuples(reqs):
    return [(r["x"], r["y"], [r["span"]]) for r in reqs]


class Service:
    """The program's set-up: the LM, the server sized for every request
    the mix can draw, its graphs captured by a warm-up burst."""

    def __init__(self, ctx: harness.Context):
        from ssr_speech_tpu_torch.device import set_precision_policy
        from ssr_speech_tpu_torch.inference import serve

        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        if cfg["decode"]["top_k"] != 1:
            raise ValueError("the open-loop cell judges greedy tokens only: "
                             "its configuration decodes with top_k 1")
        set_precision_policy()
        self.ctx = ctx
        mcfg = port.lm_config(cfg)
        self.lm = port.lm(cfg, ctx.seed, dev)
        dec = port.decode_config(cfg, length_cap_mult=mix["length_cap_mult"],
                                 max_gen_per_span=mix["max_gen_per_span"])
        # warm-up: every size once, all due at once (every lane busy, a
        # request staged), from another stream
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

    def serve(self, reqs, times, stats=None):
        """run_online over ``reqs`` due at ``times``; returns (results,
        completion times, wall seconds, the server's stats)."""
        self.srv.stats = stats
        t0 = time.perf_counter()
        with profile.span("run_online"):
            results, done_at = self.srv.run_online(_tuples(reqs), list(times),
                                                   self.gen, **self.kw)
        wall = time.perf_counter() - t0
        self.srv.stats = None
        return results, done_at, wall, stats


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
    K = cfg["n_codebooks"]
    units, failed = [], 0
    for r, res, t_done in zip(reqs, results, done_at):
        if res is None or t_done is None:
            failed += 1
            continue
        codes, marks, _, _ = res
        gen_frames = int(np.asarray(marks).sum())
        units.append(dict(req=r, codes=codes, marks=marks, gen_frames=gen_frames,
                          latency_s=t_done - times[r["index"]],
                          stream=stats["out_tokens"][r["index"]],
                          x_len=len(r["x"]),
                          p_len=(r["frames"] - (r["span"][1] - r["span"][0])
                                 + traffic.prefix_overhead(cfg))))
    lat = np.array([u["latency_s"] for u in units])
    q = lambda p: float(np.quantile(lat, p)) if len(lat) else float("inf")
    served = sum(u["gen_frames"] for u in units) / cfg["codec"]["frame_rate"]
    ctx.log(f"requests {len(units)} of {n}, latency p50 {q(0.5):.3f} s, "
            f"p90 {q(0.9):.3f} s, p95 {q(0.95):.3f} s, served "
            f"{served / wall:.2f} audio-s/s over {wall:.2f} s, last done "
            f"{max(done_at):.2f} s after the start (last arrival "
            f"{times[-1]:.2f} s)")
    traced, summary = [], None
    if ctx.trace:
        burst = traffic.serve_requests(mix, cfg, ctx.seed + 104_729, TRACE_REQUESTS)
        traced, summary = profile.traced(
            lambda: [svc.serve(burst, [0.0] * len(burst), {})[3]])
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
        units=units,
        attempted=n, failed=failed, checks=checks, memory_peak_bytes=peak,
        profile=summary, traced=traced, extra=dict(stats=stats))


def judge(ctx: harness.Context, units, lm_dtype):
    cfg = ctx.cfg
    limits = ctx.workload["limits"]
    K = cfg["n_codebooks"]
    picked = harness.sample(units, ctx.seed, key=lambda u: u["gen_frames"],
                            want=ctx.workload["judge_steps"])
    items = [dict(x=u["req"]["x"], y=u["req"]["y"], span=u["req"]["span"],
                  stream=judge_lm.served_stream(u["stream"], u["gen_frames"], K))
             for u in picked]
    gap, compared, built = judge_lm.judge(ctx, items, lm_dtype)
    mismatch = sum(judge_lm.codes_mismatch(u, it, kept, K)[0]
                   for u, it, (_, kept) in zip(picked, items, built))
    checks = [harness.check("logit_gap_mean", gap, limits["logit_gap_mean"]),
              harness.check("codes_mismatch", mismatch, limits["codes_mismatch"]),
              harness.check("tokens_compared", float(compared),
                            float(limits["min_tokens_compared"]), least=True)]
    return checks
