#!/usr/bin/env python3
"""Where the PyTorch port's decode spends its time, on one CUDA GPU.

    python3 tools/torch_profile_generate.py [--n_samples 1 8]
        [--continuous 4 8] [--out chiprun_out/torch_profile]

Runs the smoke's edit request without the codec: the 830M LM (e830M
geometry) with random weights in bf16 (JAX's draw from ``PRNGKey(0)``), 68
text tokens, 300 frames of seeded random source codes, one masked span
(54, 108), greedy with CFG (cfg_pretrained, stride 5), through
``decode.generate`` for S = 1 and ``decode.generate_batch`` (S chains, 2S
rows over a shared prompt cache) for each other S of ``--n_samples``. For
each S it reports:

- wall, prefill and decode ms/step, twice, unprofiled (every S before any
  profiling: a profiler session slows the host calls that follow it);
- the same call under ``torch.profiler``, tracing the device only. Device
  time comes from the kernel-level events, never from the aten ops that
  launched them, which would count each kernel twice. The decode loop is every device
  event after the prefill's last flash-attention launch. Reported: launches
  and device time per step by category, and the device busy share (union of
  the device intervals over the unprofiled decode wall).

With ``--continuous S1 S2 ...`` (then ``--n_samples`` defaults to none):
the continuous server's chunk loop (``serve.ContinuousBatcher``, S lanes of
the same request, 2S rows, paged decode step, replayed as CUDA graphs of 8
steps) for one chunk of at most ``--chunk_steps`` steps, unprofiled twice
and then profiled, with the same report a step (the profiler runs around
the chunk alone: the lanes' prefills come before it and are synchronised).

Under graph replay a graph's kernels are traced one by one, as eager
launches are. For ``generate`` the loop is still every device event after
the prefill's last flash launch, so it also holds the tail of the prefill's
last layer (its projections and FFN: ≈60 launches once a request, well
under one a step).

Then, once: the transformer step plus heads alone, without the sampling
bookkeeping, and the flash kernel against its plain version at prefill
shapes [2, 16, S, 128], S = 384, 640, 1000, 1300 (CUDA events).

Writes ``<out>.json`` and ``<out>.txt`` (the profiler's tables by kernel).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# kernel-name fragments -> category, first match wins. The decode step's
# attention is two batched GEMMs (under "gemm") and a softmax; K1 runs only
# in the prefills. Casts are copy kernels.
FLASH = "flash_fwd_kernel"
CATEGORIES = (("attention", (FLASH, "softmax")),
              ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
              ("copy/cast", ("copy", "memcpy")),
              ("reduce", ("reduce",)),
              ("elementwise", ("elementwise", "functor_add")))


def category(name: str) -> str:
    low = name.lower()
    for cat, frags in CATEGORIES:
        if any(f in low for f in frags):
            return cat
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def decode_runner(torch, decode, lm, cfg, dec, x, y, n_samples, device):
    """One call of the edit request at ``n_samples`` chains (``generate``
    for 1, ``generate_batch`` above), returning its statistics."""
    def run():
        stats = {}
        gen = torch.Generator(device=device).manual_seed(1)
        t0 = time.perf_counter()
        if n_samples == 1:
            decode.generate(lm, cfg, dec, x, y, [(54, 108)], gen, stats=stats)
        else:
            decode.generate_batch(lm, cfg, dec, x, y, [(54, 108)], gen,
                                  n_samples, stats=stats)
        stats["wall_s"] = time.perf_counter() - t0
        stats["decode_ms_per_step"] = (stats["decode_s"] * 1e3
                                       / stats["decode_steps"])
        del stats["out_tokens"]
        return stats
    return run


def loop_profile(events, n_flash, steps, rows, unprofiled_ms):
    """The decode loop's share of a profile's events: with ``n_flash`` > 0
    every device event after the prefills' last flash-attention launch
    (``n_flash`` of them), with 0 every device event (a profile that holds
    only the loop). Returns launches and device time a step, by category,
    and the busy share."""
    from torch.autograd import DeviceType

    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    flash = [e for e in dev_events if FLASH in e.name]
    if len(flash) != n_flash:
        raise RuntimeError(f"{len(flash)} flash launches in the profile "
                           f"(expected {n_flash}); is CUPTI tracing?")
    if not dev_events:
        raise RuntimeError("no device event in the profile; is CUPTI tracing?")
    prefill_end = max((e.time_range.end for e in flash), default=float("-inf"))
    loop = [e for e in dev_events if e.time_range.start >= prefill_end]
    counts, dev_us = Counter(), Counter()
    for e in loop:
        counts[category(e.name)] += 1
        dev_us[category(e.name)] += e.time_range.end - e.time_range.start
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in loop)
    span_us = (max(e.time_range.end for e in loop)
               - min(e.time_range.start for e in loop))
    launches = len(loop) / steps
    return {
        "steps": steps,
        "rows": rows,
        "launches_per_step": launches,
        "launches_per_step_by_category": {k: v / steps for k, v in
                                          counts.most_common()},
        "device_ms_per_step_by_category": {k: dev_us[k] / steps / 1e3 for k, _
                                           in counts.most_common()},
        "device_ms_per_step": sum(dev_us.values()) / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "busy_share_of_profiled_span": busy_us / span_us,
        "unprofiled_decode_ms_per_step": unprofiled_ms,
        "busy_share_of_unprofiled_wall": busy_us / steps / 1e3 / unprofiled_ms,
        "unprofiled_host_us_per_launch": unprofiled_ms * 1e3 / launches,
        "prefill_flash_device_ms": [(e.time_range.end - e.time_range.start)
                                    / 1e3 for e in flash],
    }


def profile_decode(torch, run, n_samples, n_layers, unprofiled_ms):
    """``run`` under ``torch.profiler`` (device activity only). Returns
    (report, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep = {"profiled_generate": run()}
    rep["decode_loop_profile"] = loop_profile(
        prof.events(), n_layers, rep["profiled_generate"]["decode_steps"],
        n_samples * 2, unprofiled_ms)
    return rep, prof


def chunk_runner(torch, serve, lm, cfg, dec, x, y, n_slots, steps,
                 sync=None):
    """The continuous server's chunk loop at ``n_slots`` lanes: every lane
    filled with the edit request (one prefill each), then one chunk of at
    most ``steps`` steps; the lanes are parked after it. ``run(chunk=None)``
    wraps the chunk alone in ``chunk`` (a context manager: the profiler), so
    a profile holds the loop and none of the prefills. ``sync`` waits for
    the device (``torch.cuda.synchronize`` by default)."""
    srv = serve.ContinuousBatcher(lm, cfg, dec, n_slots, sx_pad=128,
                                  p_pad=256, num_task=1)
    sync = sync or torch.cuda.synchronize

    def run(chunk=None):
        for slot in range(n_slots):
            srv._fill_slot(slot, slot, x, y, [(54, 108)])
        sync()
        with chunk or contextlib.nullcontext():
            t0 = time.perf_counter()
            n = srv._run_chunk(steps)
            sync()
            wall = time.perf_counter() - t0
        for slot in range(n_slots):
            srv._slot_req[slot] = None
            srv._park(slot)
        return {"steps": n, "chunk_ms_per_step": wall * 1e3 / n}
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_samples", type=int, nargs="*", default=None,
                    help="chains of the request: 1 runs generate, more "
                         "generate_batch (default 1 8 without --continuous)")
    ap.add_argument("--continuous", type=int, nargs="*", default=[],
                    help="lane counts of the continuous server's chunk loop "
                         "to profile (S lanes, 2S rows)")
    ap.add_argument("--chunk_steps", type=int, default=64,
                    help="steps of the profiled chunk")
    ap.add_argument("--out", default="chiprun_out/torch_profile")
    args = ap.parse_args()
    if args.n_samples is None:
        args.n_samples = [] if args.continuous else [1, 8]

    import numpy as np
    import torch

    from chip_smoke import card_line, cuda_time_ms, init_key, prefill_segments
    from ssr_speech_tpu_torch.config import DecodeConfig, SSRModelConfig
    from ssr_speech_tpu_torch.device import resolve_device, set_precision_policy
    from ssr_speech_tpu_torch.inference import decode, serve
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models import transformer as trf
    from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
    from ssr_speech_tpu_torch.ops import flash_attention as fa
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device("cuda")
    set_precision_policy()
    card = card_line()
    rep = {"card": card, "by_n_samples": {}, "continuous": {}}
    cfg = SSRModelConfig(d_model=2048, nhead=16, num_layers=16, n_codebooks=4,
                         text_vocab_size=120)
    gen = torch.Generator(device=device).manual_seed(0)
    lm = lm_from_jax(tssr.init_ssr(init_key(0), cfg, device), cfg,
                     device=device, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.text_vocab_size - 1, size=68)
    y = rng.integers(0, 2048, size=(cfg.n_codebooks, 300))
    dec = DecodeConfig(top_k=1, top_p=0.8, stop_repetition=2,
                       silence_tokens=(1388, 1898, 131), cfg_coef=1.5,
                       cfg_stride=5, aug_text=True, cfg_pretrained=True)
    # every count's unprofiled runs first: a profiler session slows the
    # host calls that follow it
    runs = {n: decode_runner(torch, decode, lm, cfg, dec, x, y, n, device)
            for n in args.n_samples}
    plain = {}
    for n, run in runs.items():
        run()  # cuBLAS handles, kernel build
        plain[n] = [run(), run()]
    chunks = {n: chunk_runner(torch, serve, lm, cfg, dec, x, y, n,
                              args.chunk_steps) for n in args.continuous}
    chunk_plain = {}
    for n, run in chunks.items():
        run()
        chunk_plain[n] = [run(), run()]
    tables = []
    for n, run in runs.items():
        unprofiled_ms = min(g["decode_ms_per_step"] for g in plain[n])
        r, prof = profile_decode(torch, run, n, cfg.num_layers, unprofiled_ms)
        rep["by_n_samples"][n] = {"generate": plain[n], **r}
        tables.append(f"=== n_samples {n} ===\n" + prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60,
            max_name_column_width=90))
        p = r["decode_loop_profile"]
        print(f"[profile] S = {n} ({p['rows']} rows): {p['steps']} steps, "
              f"{p['launches_per_step']:.0f} launches and "
              f"{p['device_ms_per_step']:.3f} ms of device time a step, "
              f"{p['unprofiled_decode_ms_per_step']:.2f} ms a step unprofiled, "
              f"busy {p['busy_share_of_unprofiled_wall']:.1%} [{card}]")

    # the continuous server's chunk loop, one profiled chunk a lane count
    for n, run in chunks.items():
        unprofiled_ms = min(c["chunk_ms_per_step"] for c in chunk_plain[n])
        prof = profile(activities=[ProfilerActivity.CUDA])
        got = run(chunk=prof)
        p = loop_profile(prof.events(), 0, got["steps"], 2 * n, unprofiled_ms)
        rep["continuous"][n] = {"chunks": chunk_plain[n], "profiled_chunk": got,
                                "chunk_loop_profile": p}
        tables.append(f"=== continuous, {n} lanes ===\n"
                      + prof.key_averages().table(
                          sort_by="self_cuda_time_total", row_limit=60,
                          max_name_column_width=90))
        print(f"[profile] continuous, {n} lanes ({p['rows']} rows): "
              f"{p['steps']} steps, {p['launches_per_step']:.0f} launches and "
              f"{p['device_ms_per_step']:.3f} ms of device time a step, "
              f"{p['unprofiled_decode_ms_per_step']:.2f} ms a step "
              f"unprofiled, busy {p['busy_share_of_unprofiled_wall']:.1%} "
              f"[{card}]")

    # the transformer step and heads alone, on a cache filled to the edit's
    # prefill length (the sampling state machine left out)
    cache = trf.init_kv_cache(cfg, 2, 1024, dtype=torch.bfloat16,
                              device=device)
    cache = trf.KVCache(cache.k, cache.v, 384)
    banned = torch.tensor([[68, 128], [1, 128]], device=device)
    h = torch.randn((2, cfg.d_model), generator=gen, device=device)
    layers = trf.layer_params(lm["decoder"])
    n = 200
    for _ in range(2):  # the first round warms up
        c = cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out, c = trf.transformer_decode_step(lm["decoder"], h, c, banned,
                                                 cfg, layers=layers)
            tssr.predict_logits(lm, out)
        torch.cuda.synchronize()
        rep["step_plus_heads_ms"] = (time.perf_counter() - t0) * 1e3 / n

    rep["flash_vs_plain"] = {}
    for s in (384, 640, 1000, 1300):
        q, k, v = (torch.randn((2, 16, s, 128), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        seg = prefill_segments(torch, 2, s, 128, 68, device)
        ms = cuda_time_ms(torch, lambda: fa.flash_attend_xy(q, k, v, seg))
        plain = cuda_time_ms(torch, lambda: fa.reference_attend(
            q, k, v, seg, 128 ** -0.5))
        flops = 2 * 2 * 16 * s * s * 128  # QK^T and PV, causal half
        rep["flash_vs_plain"][s] = {"kernel_ms": ms, "plain_ms": plain,
                                    "kernel_tflops": flops / ms / 1e9}

    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.with_suffix(".json").write_text(json.dumps(rep, indent=1))
    out.with_suffix(".txt").write_text("\n".join(tables))
    print(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
