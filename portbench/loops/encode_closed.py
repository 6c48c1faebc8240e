"""Data preparation's encoding, closed loop: batches of waveforms padded to
a length bucket as ``data/prep.py encode`` pads them, through the codec's
``wmencodec.encode`` (SEANet encoder, its LSTM, the RVQ), the codes back on
the host; no file I/O. The pool is drawn once at set-up and cycled.

The host pads each batch into one of ``AHEAD`` pinned buffers, copies it in
and launches the encoder and the copy of its codes out without waiting,
and waits only for the batch ``AHEAD`` places behind: so a stall of the
host's padding or launches does not leave the card idle while queued work
remains. (CUDA's launch queue, about a thousand kernels, may bind
sooner: the LSTM launches kernels for every frame.) When the window's time
is up no more is sent; it closes once every batch sent has its codes on
the host.

End to end: ``encode_audio_s_per_s``, the input audio seconds (unpadded)
of every batch sent in the window over the seconds from its start to the
last batch's codes. Checked after the window, on a seeded reservoir sample
of the window's batches plus the last of the largest: the encoder's
latents against the plain reference's (``latent_rel_err``, the widest of
any row) and the codes against the reference's latents and codebooks
(``code_gap``: how far the chosen codewords lie beyond the nearest, summed
over every valid frame and stage of the sample, over the residuals'
squared norms). A control run judges the reference's encoder and RVQ
under TF32 in their place.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterable

import numpy as np
import torch

from portbench.lib import harness, port, profile, traffic, weights
from portbench.reference import codec as codec_ref

TRACE_COUNT = 16  # batches profiled after the window of a --trace 1 run
KEEP = 4  # batches of the reservoir sample whose latents are kept
AHEAD = 8  # batches in flight at most: about 0.35 s of the card's work


def run(ctx: harness.Context) -> harness.Outcome:
    from ssr_speech_tpu_torch.device import set_precision_policy
    from ssr_speech_tpu_torch.models.codec import wmencodec as wm

    set_precision_policy()
    codec, mix, dev = ctx.cfg, ctx.mix, ctx.device
    cuda = dev.type == "cuda"
    params, ccfg = port.codec(codec, ctx.seed, dev)
    hop, rate = ccfg.hop_length, ccfg.sample_rate
    pool = traffic.wave_pool(mix, ctx.seed, hop, rate, dev)
    batches = traffic.wave_batches(mix, pool, hop, ctx.seed)
    most = max(len(b["idx"]) * b["pad"] * hop for b in batches)
    slots = [torch.empty(most, dtype=torch.float32, pin_memory=cuda)
             for _ in range(AHEAD)]
    copied = [None] * AHEAD  # each slot's copy in, once it is launched

    def dispatch(b: dict, k: int) -> dict:
        """One batch as prep encodes it: padded on the host into pinned
        slot ``k``, copied in, encoded, the codes' copy out launched."""
        if copied[k] is not None:
            copied[k].synchronize()
        n = len(b["idx"]) * b["pad"] * hop
        buf = slots[k][:n]
        traffic.padded(pool, b, hop, out=buf.numpy())
        with profile.span("encode"):
            wav = buf.view(len(b["idx"]), -1, 1).to(dev, non_blocking=True)
            copied[k] = _event(cuda)
            codes, _, emb = wm.encode(params, wav, ccfg)
            codes = codes.to("cpu", non_blocking=True)
        return dict(batch=b, codes=codes, emb=emb, done=_event(cuda),
                    samples=sum(f * hop for f in b["frames"]))

    def pump(todo: Iterable[dict], on_done: Callable[[dict], None]) -> int:
        """Dispatch every batch of ``todo``, ``AHEAD`` in flight at most;
        ``on_done`` each in order once its codes are on the host. Returns
        the batches that failed."""
        flight, failed = deque(), 0

        def retire() -> int:
            u = flight.popleft()
            try:
                if u["done"] is not None:
                    u["done"].synchronize()
            except Exception as e:  # counted against the attempted batches
                ctx.log(f"batch failed: {type(e).__name__}: {e}")
                return 1
            u["codes"] = u["codes"].numpy().astype(np.int16)
            u["done"] = None
            on_done(u)
            return 0

        for j, b in enumerate(todo):
            try:
                flight.append(dispatch(b, j % AHEAD))
            except Exception as e:  # counted against the attempted batches
                ctx.log(f"batch {j} failed: {type(e).__name__}: {e}")
                failed += 1
            while len(flight) >= AHEAD:
                failed += retire()
        while flight:
            failed += retire()
        return failed

    pump(batches, lambda u: None)  # warm-up: every batch shape of the pool
    harness.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    done = []
    rng = np.random.default_rng([ctx.seed % (2 ** 63), 5])
    largest_frames = max(sum(b["frames"]) for b in batches)
    held = dict(largest=None, reservoir=[], seen=0)

    def keep(u: dict) -> None:
        # the latents of a seeded reservoir sample of the window's batches,
        # and of the last of the largest, are kept for the comparison
        done.append(u)
        reservoir = held["reservoir"]
        if sum(u["batch"]["frames"]) == largest_frames:
            if held["largest"] is not None:
                held["largest"]["emb"] = None
            held["largest"] = u
            return
        held["seen"] += 1
        if len(reservoir) < KEEP:
            reservoir.append(u)
            return
        j = int(rng.integers(0, held["seen"]))
        if j < KEEP:
            reservoir[j]["emb"] = None
            reservoir[j] = u
        else:
            u["emb"] = None

    sent = [0]

    def window(deadline: float):
        while time.perf_counter() < deadline:
            yield batches[sent[0] % len(batches)]
            sent[0] += 1

    t0 = time.perf_counter()
    failed = pump(window(t0 + ctx.seconds), keep)
    t_end = time.perf_counter()
    window_s = t_end - t0
    traced, summary = [], None
    if ctx.trace:
        def units():
            out = []
            pump((batches[j % len(batches)]
                  for j in range(sent[0], sent[0] + TRACE_COUNT)), out.append)
            return out
        traced, summary = profile.traced(units)
        for u in traced:
            u["emb"] = None
    audio_s = sum(u["samples"] for u in done) / rate
    peak = harness.peak_bytes(dev)
    del params
    picked = ([held["largest"]] if held["largest"] is not None else []) \
        + held["reservoir"]
    t_judge = time.perf_counter()
    checks = judge(ctx, pool, picked, hop)
    ctx.log(f"judged in {time.perf_counter() - t_judge:.1f} s")
    checks.append(harness.check("failed_batches", float(failed), 0.0))
    return harness.Outcome(
        e2e=dict(encode_audio_s_per_s=audio_s / window_s, setup_s=setup_s),
        units=done, attempted=len(done) + failed, failed=failed, checks=checks,
        memory_peak_bytes=peak, profile=summary, traced=traced,
        extra=dict(window_s=window_s))


def _event(cuda: bool):
    """A CUDA event recorded on the current stream (None on the CPU, where
    every call has finished when it returns)."""
    if not cuda:
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def judge(ctx: harness.Context, pool, picked, hop):
    """A control run judges the reference's encoder and RVQ under TF32 in
    place of the program's latents and codes."""
    codec, dev = ctx.cfg, ctx.device
    limits = ctx.workload["limits"]
    C = weights.codec_weights(codec, ctx.seed, dev)
    embed = C["quantizer"]["embed"]
    n_q = codec["rvq"]["n_q"]
    lat, excess, frames = 0.0, [], 0
    for u in picked:
        b = u["batch"]
        wav = torch.as_tensor(traffic.padded(pool, b, hop), device=dev)
        with codec_ref.precision(tf32=False):
            z = codec_ref.encode(C["encoder"], wav, codec["seanet"])
        if ctx.control:
            with codec_ref.precision(tf32=True):
                emb = codec_ref.encode(C["encoder"], wav, codec["seanet"])
                got = codec_ref.quantize(embed, emb, n_q)
        else:
            emb = u["emb"]
            got = torch.as_tensor(u["codes"].astype(np.int64), device=dev)
        with codec_ref.precision(tf32=False):
            for r, f in enumerate(b["frames"]):
                want = z[r, :f]
                lat = max(lat, float((emb[r, :f] - want).norm() / want.norm()))
                excess.append(codec_ref.code_gap(embed, want[None],
                                                 got[r:r + 1, :, :f]))
                frames += f
    gap = float(np.mean(excess)) if excess else float("inf")
    return [harness.check("latent_rel_err", lat, limits["latent_rel_err"]),
            harness.check("code_gap", gap, limits["code_gap"]),
            harness.check("frames_compared", float(frames),
                          float(limits["min_frames_compared"]), least=True)]
