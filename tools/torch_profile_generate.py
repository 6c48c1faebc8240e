#!/usr/bin/env python3
"""Where the PyTorch port's decode spends its time, on one CUDA GPU.

    python3 tools/torch_profile_generate.py [--out chiprun_out/torch_profile]

Runs ``ssr_speech_tpu_torch.inference.decode.generate`` on the smoke's edit
request without the codec: the 830M LM (e830M geometry) with seeded random
weights in bf16, 68 text tokens, 300 frames of seeded random source codes,
one masked span (54, 108), greedy with CFG (cfg_pretrained, stride 5). It
reports:

- wall, prefill and decode ms/step of ``generate``, twice, unprofiled;
- the same call under ``torch.profiler``. Device time comes from the
  kernel-level (device) events only, never from the aten ops that launched
  them, which would count each kernel twice. The decode loop is every device
  event after the prefill's last flash-attention launch. Reported: launches
  and device time per step by category, and the device busy share (union of
  the device intervals over the unprofiled decode wall);
- the transformer step plus heads alone, without the sampling bookkeeping;
- the flash kernel against its plain version at prefill shapes
  [2, 16, S, 128], S = 384, 640, 1000, 1300 (CUDA events).

Writes ``<out>.json`` and ``<out>.txt`` (the profiler's table by kernel).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# kernel-name fragments -> category, first match wins
CATEGORIES = (("flash", ("flash_fwd_kernel",)),
              ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
              ("copy/cast", ("copy", "memcpy")),
              ("add", ("functor_add",)),
              ("reduce", ("reduce",)),
              ("softmax", ("softmax",)),
              ("memset", ("memset",)))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/torch_profile")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, cuda_time_ms, prefill_segments
    from ssr_speech_tpu_torch.config import DecodeConfig, SSRModelConfig
    from ssr_speech_tpu_torch.device import resolve_device, set_precision_policy
    from ssr_speech_tpu_torch.inference import decode
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models import transformer as trf
    from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    device = resolve_device("cuda")
    set_precision_policy()
    card = card_line()
    rep = {"card": card}
    cfg = SSRModelConfig(d_model=2048, nhead=16, num_layers=16, n_codebooks=4,
                         text_vocab_size=120)
    gen = torch.Generator(device=device).manual_seed(0)
    lm = lm_from_jax(tssr.init_ssr(gen, cfg, device), cfg, device=device,
                     dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.text_vocab_size - 1, size=68)
    y = rng.integers(0, 2048, size=(cfg.n_codebooks, 300))
    dec = DecodeConfig(top_k=1, top_p=0.8, stop_repetition=2,
                       silence_tokens=(1388, 1898, 131), cfg_coef=1.5,
                       cfg_stride=5, aug_text=True, cfg_pretrained=True)

    def run():
        stats = {}
        t0 = time.perf_counter()
        decode.generate(lm, cfg, dec, x, y, [(54, 108)],
                        torch.Generator(device=device).manual_seed(1),
                        stats=stats)
        stats["wall_s"] = time.perf_counter() - t0
        stats["decode_ms_per_step"] = (stats["decode_s"] * 1e3
                                       / stats["decode_steps"])
        return stats

    run()  # cuBLAS handles, kernel build
    rep["generate"] = [run(), run()]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep["profiled_generate"] = run()

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    flash = [e for e in dev_events if category(e.name) == "flash"]
    if len(flash) != cfg.num_layers:
        raise RuntimeError(f"{len(flash)} flash launches in the profile "
                           f"(expected {cfg.num_layers}); is CUPTI tracing?")
    prefill_end = max(e.time_range.end for e in flash)
    loop = [e for e in dev_events if e.time_range.start >= prefill_end]
    steps = rep["profiled_generate"]["decode_steps"]
    counts, dev_us = Counter(), Counter()
    for e in loop:
        counts[category(e.name)] += 1
        dev_us[category(e.name)] += e.time_range.end - e.time_range.start
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in loop)
    span_us = (max(e.time_range.end for e in loop)
               - min(e.time_range.start for e in loop))
    unprofiled_ms = min(g["decode_ms_per_step"] for g in rep["generate"])
    launches = len(loop) / steps
    rep["decode_loop_profile"] = {
        "steps": steps,
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
    out.with_suffix(".txt").write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=60, max_name_column_width=90))
    print(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
