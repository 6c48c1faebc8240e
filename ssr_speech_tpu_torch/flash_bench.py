"""Time the attention kernels alone, at the shapes of the port's two paths.

    python3 -m ssr_speech_tpu_torch.flash_bench     # from the root of a checkout

For the training batch's shape [18, 16, 1152, 128] (416 text + 736 audio slots,
a padded batch's segments from ``--seed``, and the same shape with one segment
everywhere, where only causality skips tiles) and the serving prefill's
[2, 16, 384, 128] (the two CFG rows) and [1, 16, 384, 128], it prints one line
with:

- the forward (``ops/flash_attention.py::flash_forward``, with the
  log-sum-exp) and the backward (``flash_backward``, both of its kernels):
  ``ms`` as a caller sees it (eager Python launches) and ``device_ms`` with the
  launches queued behind a long matmul, so that the host's pace drops out;
- one PyTorch call for the same function, as a yardstick only:
  ``F.scaled_dot_product_attention`` with the same mask, and its autograd
  backward;
- the share of the causal 64 x 64 tiles that the kernels visit
  (``tile_visits``), and the share of the card's bf16 tensor-core peak that
  ``device_ms`` comes to, counting the products the kernels run on the visited
  tiles (2 a tile forward; 7 backward: 3 in the dq kernel, 4 in the dk/dv
  kernel);
- the device time of each kernel by name, from ``torch.profiler`` (the
  backward's dq and dk/dv kernels apart), or "not measured" where the
  profiler sees no device time;
- the host time of encoding a launch's TMA tensor maps.

Before the lines come ptxas's register and spill counts of both libraries.
The default device is the card, and the script raises without one.
``--device cpu`` runs the plain versions (dense and tiled) at whatever small
``--shape`` is asked for (the tests) and reports host milliseconds and the
tile shares, no rate. ``main`` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from typing import Dict, List, Optional

import torch

from .device import resolve_device
from .int8_probe import _time_ms, queued_ms
from .ops import flash_attention as fa

PEAK_BF16_OPS_PER_S = 989e12  # one H100 SXM, dense, at its full 700 W limit
TRAIN_SHAPE = (18, 16, 1152, 128)
TRAIN_TEXT_SLOTS = 416
FWD_PRODUCTS = 2  # a visited tile: Q.K^T, P.V
BWD_PRODUCTS = 7  # dq kernel: Q.K^T, dO.V^T, dS.K; dk/dv: K.Q^T, V.dO^T, P^T.dO, dS^T.Q
PREFILL_S, PREFILL_TEXT_SLOTS, PREFILL_TEXT_LEN = 384, 128, 68


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--shape", default=None,
                   help="B,H,S,Dh: time this one shape (a padded batch's "
                        "segments, a third of S text slots) instead of the "
                        "two paths' shapes")
    return p


def padded_batch_segments(b: int, s: int, sx: int, gen) -> torch.Tensor:
    """[text valid | text pad | audio valid | audio pad]: the text fills
    5-36% of its sx slots, the audio half to all of its own; row 0's audio is
    full, as in a batch bucketed by its longest row."""
    seg = torch.zeros((b, s), dtype=torch.int32)
    x_len = torch.randint(max(sx // 20, 1), max(sx * 36 // 100, 1) + 1, (b,),
                          generator=gen)
    y_len = torch.randint((s - sx) // 2, s - sx + 1, (b,), generator=gen)
    y_len[0] = s - sx
    for r in range(b):
        seg[r, :x_len[r]] = 1
        seg[r, sx:sx + y_len[r]] = 1
    return seg


def prefill_segments(b: int) -> torch.Tensor:
    """Row 0 conditional (text padding banned), further rows the
    unconditional CFG row ([1, sx) banned)."""
    seg = torch.ones((b, PREFILL_S), dtype=torch.int32)
    seg[:, PREFILL_TEXT_LEN:PREFILL_TEXT_SLOTS] = 0
    seg[1:, 1:PREFILL_TEXT_SLOTS] = 0
    return seg


def cases(args, gen) -> List[tuple]:
    if args.shape:
        shape = tuple(int(x) for x in args.shape.split(","))
        b, _, s, _ = shape
        return [("padded batch", shape,
                 padded_batch_segments(b, s, max(s // 3, 1), gen))]
    b, _, s, _ = TRAIN_SHAPE
    prefill = (2, 16, PREFILL_S, 128)
    return [
        ("train, padded batch", TRAIN_SHAPE,
         padded_batch_segments(b, s, TRAIN_TEXT_SLOTS, gen)),
        ("train, one segment", TRAIN_SHAPE, torch.ones((b, s), dtype=torch.int32)),
        ("prefill, CFG rows", prefill, prefill_segments(2)),
        ("prefill, one row", (1,) + prefill[1:], prefill_segments(1)),
    ]


def tile_shares(seg) -> Dict[str, float]:
    """Of the causal tiles, the share visited; of the causal pairs, the share
    that attends."""
    b, s = seg.shape
    vis = fa.tile_visits(seg)
    causal = torch.ones(vis.shape[1:], dtype=torch.bool, device=seg.device).tril()
    same = (seg[:, None, :] == seg[:, :, None]) & torch.ones(
        (s, s), dtype=torch.bool, device=seg.device).tril()
    return {"visited_tiles": int((vis & causal).sum()),
            "visited_share_of_causal_tiles":
                (vis & causal).sum().item() / (b * causal.sum().item()),
            "attending_share_of_causal_pairs":
                same.sum().item() / (b * s * (s + 1) / 2)}


def kernel_device_ms(fn, iters: int) -> Optional[Dict[str, float]]:
    """Device milliseconds per call of each kernel that ``fn`` launches, by
    name, from the profiler; None where it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0:
            times[ev.key] = us / 1e3 / iters
    return times or None


def measure(label, shape, seg, args, device, gen) -> dict:
    b, h, s, dh = shape
    scale = 1.0 / math.sqrt(dh)
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    q, k, v, dout = (torch.randn(shape, generator=gen).to(device, dtype)
                     for _ in range(4))
    seg = seg.to(device)
    rec = {"label": label, "shape": list(shape), **tile_shares(seg)}
    if not on_card:
        rec["plain_ms"] = _time_ms(lambda: fa.flash_attend_xy(q, k, v, seg),
                                   args.iters, device)
        rec["tiled_plain_ms"] = _time_ms(
            lambda: fa.tiled_forward(q, k, v, seg, scale), args.iters, device)
        print(f"[flash_bench] {label} {list(shape)}: plain {rec['plain_ms']:.3f} "
              f"ms, tiled plain {rec['tiled_plain_ms']:.3f} ms on the host; "
              f"visits {rec['visited_share_of_causal_tiles']:.3f} of the "
              f"causal tiles", flush=True)
        return rec

    out, lse = fa.flash_forward(q, k, v, seg, scale, with_lse=True)
    mask = ((seg[:, None, :] == seg[:, :, None]) & torch.ones(
        (s, s), dtype=torch.bool, device=device).tril())[:, None]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, attn_mask=mask)

    def fwd():
        return fa.flash_forward(q, k, v, seg, scale, with_lse=True)

    def bwd():
        return fa.flash_backward(q, k, v, seg, out, lse, dout, scale)

    for _ in range(3):  # past the allocator's first requests at this shape
        fwd(), bwd()
    for name, fn, products, lib in (
            ("fwd", fwd, FWD_PRODUCTS,
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 q, k, v, attn_mask=mask)),
            ("bwd", bwd, BWD_PRODUCTS,
             lambda: torch.autograd.grad(lib_out, leaves, dout,
                                         retain_graph=True))):
        ms = _time_ms(fn, args.iters, device)
        dev_ms = queued_ms(fn, ms, device, calls=args.iters)
        flops = rec["visited_tiles"] * h * products * 2 * fa.TILE * fa.TILE * dh
        rec[name] = {"ms": ms, "device_ms": dev_ms,
                     "library_ms": _time_ms(lib, args.iters, device),
                     "share_of_bf16_peak": flops / PEAK_BF16_OPS_PER_S / (dev_ms / 1e3),
                     "kernels_device_ms": kernel_device_ms(fn, args.iters)}
    rec["encode_us"] = fa.last_encode_us()

    def by_kernel(d):
        if d is None:
            return "by kernel not measured"
        return ", ".join(
            f"{n.replace('(anonymous namespace)::', '').split('(')[0]} {t:.4f}"
            for n, t in sorted(d.items()))

    f, w = rec["fwd"], rec["bwd"]
    print(f"[flash_bench] {label} {list(shape)}: visits "
          f"{rec['visited_share_of_causal_tiles']:.3f} of the causal tiles "
          f"({rec['attending_share_of_causal_pairs']:.3f} of the pairs attend); "
          f"fwd {f['ms']:.4f} ms as called, {f['device_ms']:.4f} queued "
          f"({f['share_of_bf16_peak']:.2f} of the bf16 peak; "
          f"{by_kernel(f['kernels_device_ms'])}), library {f['library_ms']:.4f}; "
          f"bwd {w['ms']:.4f} as called, {w['device_ms']:.4f} queued "
          f"({w['share_of_bf16_peak']:.2f} of the peak; "
          f"{by_kernel(w['kernels_device_ms'])}), library {w['library_ms']:.4f}; "
          f"encoding the forward's tensor maps {rec['encode_us']:.2f} us",
          flush=True)
    return rec


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    res = {"cases": []}
    if device.type == "cuda":
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        for built in (fa.load_kernel(), fa.load_bwd_kernel()):
            for line in built.ptxas_log.splitlines():
                if any(w in line for w in ("Used", "spill", "C75")):
                    print(f"[flash_bench] {line.strip()[:150]}"
                          + (f" ...{line.strip()[-70:]}" if len(line) > 230 else ""))
    for label, shape, seg in cases(args, gen):
        res["cases"].append(measure(label, shape, seg, args, device, gen))
    if "card" in res:
        print(f"[flash_bench] {res['card']}")
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
