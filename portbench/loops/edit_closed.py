"""One client editing recordings, closed loop: each request is sent when the
last one's audio is back. A request goes the way ``inference/cli.py``
ships it: ``decode.generate`` (the prefill, then the replayed decode loop
with classifier-free guidance), ``pipeline.splice_waveform``, and the
codec's ``wmdecode`` of the whole utterance, its waveform back on the host.

End to end: ``rtf``, the generated audio seconds of the requests of the
window over its wall seconds (the window closes when the request that is
running at its end is done). Checked after the window: the served tokens
of a seeded sample of the greedy requests (the longest among them) against
the plain reference's logits (``logit_gap_mean``), the spliced codes and labels
rebuilt from those tokens (``codes_mismatch``), and the waveform against
the reference's watermark decode (``wav_rel_err``). A control run judges
the control's tokens (``lib/judge_lm``) and the reference's watermark
decode under TF32 in place of the program's; the codes stay the
program's.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.lib import harness, judge_lm, port, profile, traffic, weights
from portbench.reference import codec as codec_ref
from portbench.reference import patterns

TRACE_COUNT = 2  # requests profiled after the window of a --trace 1 run


class Server:
    """The program's set-up and the path of one request."""

    def __init__(self, ctx: harness.Context):
        from ssr_speech_tpu_torch.data.tokenizer import AudioTokenizer
        from ssr_speech_tpu_torch.device import set_precision_policy

        set_precision_policy()
        cfg, mix = ctx.cfg, ctx.mix
        self.ctx = ctx
        self.mcfg = port.lm_config(cfg)
        self.lm = port.lm(cfg, ctx.seed, ctx.device)
        params, self.ccfg = port.codec(cfg["codec"], ctx.seed, ctx.device)
        self.codec = AudioTokenizer(params, self.ccfg)
        common = dict(length_cap_mult=mix["length_cap_mult"],
                      max_gen_per_span=mix["max_gen_per_span"])
        self.dec = {False: port.decode_config(cfg, **common),
                    True: port.decode_config(cfg, top_k=1, **common)}

    def serve(self, req: dict, seed: int) -> dict:
        from ssr_speech_tpu_torch.inference import decode, pipeline

        dev = self.ctx.device
        t0 = time.perf_counter()
        gen = weights.generator(seed, 100 + req["index"], dev)
        stats: dict = {}
        with profile.span("generate"):
            codes, marks, out_iv, nm = decode.generate(
                self.lm, self.mcfg, self.dec[req["greedy"]], req["x"], req["y"],
                [req["span"]], gen, stats=stats)
        with profile.span("splice"):
            spliced = pipeline.splice_waveform(req["wav"], codes.shape[2],
                                               self.ccfg.hop_length, nm, out_iv)
        t1 = time.perf_counter()
        with profile.span("wmdecode"):
            wav = self.codec.wmdecode(codes, marks, spliced)
        t2 = time.perf_counter()
        return dict(
            index=req["index"], greedy=req["greedy"], frames=req["frames"],
            span=req["span"], gen_frames=int(np.asarray(marks).sum()),
            prefill_s=stats["prefill_s"], decode_s=stats["decode_s"],
            steps=int(stats["decode_steps"]), codec_s=t2 - t1, wall_s=t2 - t0,
            stream=stats["out_tokens"], codes=codes, marks=marks, wav=wav,
            x_len=len(req["x"]))


def _captures() -> int:
    from ssr_speech_tpu_torch.inference import graphs

    n = 0
    for ws in graphs.kept():
        n += ws.loop.captures + sum(p.captures for _, p in ws.prefills.values())
    return n


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    srv = Server(ctx)
    n_pre = int(math.ceil(ctx.seconds * mix["max_requests_per_s"])) + len(mix["block"])
    sizes = traffic.edit_sizes(mix, ctx.seed, n_pre)
    reqs = [traffic.edit_request(mix, cfg, ctx.seed, i, s)
            for i, s in enumerate(sizes)]
    # warm-up: one request of every size the mix draws, from another stream
    warm_seed = ctx.seed + 7_919
    for j, size in enumerate(traffic.warm_sizes(mix)):
        srv.serve(traffic.edit_request(mix, cfg, warm_seed, j, size), warm_seed)
    harness.sync(dev)
    captured = _captures()
    setup_s = time.perf_counter() - ctx.t_start

    done, failed = [], 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    i = 0

    def request(i):
        if i < len(reqs):
            return reqs[i]
        size = traffic.edit_sizes(mix, ctx.seed, i + 1)[i]
        return traffic.edit_request(mix, cfg, ctx.seed, i, size)

    while time.perf_counter() < deadline:
        req = request(i)
        try:
            rec = srv.serve(req, ctx.seed)
            rec["req"] = req
            done.append(rec)
        except Exception as e:  # counted against the attempted requests
            ctx.log(f"request {i} failed: {type(e).__name__}: {e}")
            failed += 1
        i += 1
    t_end = time.perf_counter()
    window_s = t_end - t0
    in_window = _captures() - captured
    traced, summary = [], None
    if ctx.trace:
        traced, summary = profile.traced(lambda: [
            srv.serve(request(j), ctx.seed) for j in range(i, i + TRACE_COUNT)])
    rtf = sum(r["gen_frames"] for r in done) / cfg["codec"]["frame_rate"] / window_s
    peak = harness.peak_bytes(dev)

    for rec in done + traced:  # the prompt's audio positions, for the rooflines
        rec["p_len"] = (rec["frames"] - (rec["span"][1] - rec["span"][0])
                        + traffic.prefix_overhead(cfg))
    del srv
    from ssr_speech_tpu_torch.inference import graphs

    graphs.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = judge(ctx, done)
    ctx.log(f"judged in {time.perf_counter() - t_judge:.1f} s")
    checks.append(harness.check("failed_requests", float(failed), 0.0))
    checks.append(harness.check("captures_in_window", float(in_window), 0.0))
    return harness.Outcome(
        e2e=dict(rtf=rtf, setup_s=setup_s), units=done,
        attempted=len(done) + failed, failed=failed,
        checks=checks, memory_peak_bytes=peak, profile=summary, traced=traced)


def judge(ctx: harness.Context, done):
    """The reference's comparison on a seeded sample of the greedy
    requests of the window (the longest of them first): their tokens
    (``lib/judge_lm``), then the codes, labels and waveform the codec was
    given and gave, rebuilt from those tokens."""
    from ssr_speech_tpu_torch.device import compute_dtype

    cfg, dev = ctx.cfg, ctx.device
    limits = ctx.workload["limits"]
    K = cfg["n_codebooks"]
    hop = math.prod(cfg["codec"]["seanet"]["ratios"])
    picked = harness.sample([r for r in done if r["greedy"]], ctx.seed,
                            key=lambda r: r["steps"],
                            want=ctx.workload["judge_steps"])
    items = [dict(x=r["req"]["x"], y=r["req"]["y"], span=r["req"]["span"],
                  stream=judge_lm.served_stream(r["stream"], r["gen_frames"], K))
             for r in picked]
    gap, compared, built = judge_lm.judge(ctx, items, compute_dtype(dev))
    C = weights.codec_weights(cfg["codec"], ctx.seed, dev)
    mismatch = wav_err = 0.0
    for rec, it, (_, kept) in zip(picked, items, built):
        bad, codes, marks, out_iv = judge_lm.codes_mismatch(rec, it, kept, K)
        mismatch += bad
        if bad:
            continue
        wave = patterns.splice_wave(rec["req"]["wav"], codes.shape[1], hop, kept,
                                    out_iv)
        args = (C["wmdecoder"],
                codec_ref.dequantize(C["quantizer"]["embed"],
                                     torch.as_tensor(codes[None], device=dev)),
                torch.as_tensor(marks[None], device=dev),
                torch.as_tensor(wave, device=dev), cfg["codec"]["seanet"])
        with codec_ref.precision(tf32=False):
            want, _ = codec_ref.wm_decode(*args)
        if ctx.control:
            with codec_ref.precision(tf32=True):
                out, _ = codec_ref.wm_decode(*args)
        else:
            out = torch.as_tensor(np.asarray(rec["wav"]), device=dev)
        wav_err = max(wav_err, float((out - want).norm() / want.norm()))
    checks = [harness.check("logit_gap_mean", gap, limits["logit_gap_mean"]),
              harness.check("codes_mismatch", mismatch, limits["codes_mismatch"]),
              harness.check("wav_rel_err", wav_err, limits["wav_rel_err"]),
              harness.check("tokens_compared", float(compared),
                            float(limits["min_tokens_compared"]), least=True)]
    return checks
