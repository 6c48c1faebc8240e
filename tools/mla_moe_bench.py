"""K11 and K12 alone at the ``moonlight-serve-open-16lane`` cell's shapes,
on the card: each replayed from a CUDA graph of ``--reps`` calls, timed
with CUDA events, against its bound (the bytes it must read and write over
the H100's 3.35 TB/s; both are bound by bytes) and beside its plain
version's time.

    python3 tools/mla_moe_bench.py [--rows 32] [--keys 950]

K11: one MoE layer's routed experts for ``--rows`` rows under uniform
random routing (6 of 64 a row): the touched experts' gate, up and down
weights plus the rows in and the weighted outputs out. K12: one layer's
latent attention for ``--rows`` rows of ``--keys`` live keys each (prompt
and generated): the live latents plus q in and the output out. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM = 3.35e12


def _time_graph(torch, fn, reps: int) -> float:
    """Seconds a call, from a graph of ``reps`` calls."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(3):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 1e3 / (3 * reps)


def main(argv=None) -> int:
    import torch

    from ssr_speech_tpu_torch.ops import mla_attention as mla
    from ssr_speech_tpu_torch.ops import moe_experts as moe

    p = argparse.ArgumentParser("mla_moe_bench")
    p.add_argument("--rows", type=int, default=32)
    p.add_argument("--keys", type=int, default=950)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    n, D, F, E, K = args.rows, 2048, 1408, 64, 6
    g = torch.Generator(device=dev).manual_seed(0)
    gu = torch.empty((E, 2 * F, D), device=dev, dtype=torch.bfloat16).uniform_(
        -D ** -0.5, D ** -0.5, generator=g)
    dn = torch.empty((E, D, F), device=dev, dtype=torch.bfloat16).uniform_(
        -F ** -0.5, F ** -0.5, generator=g)
    idx = torch.stack([torch.randperm(E, generator=g, device=dev)[:K] for _ in range(n)])
    w = torch.rand((n, K), generator=g, device=dev)
    x = torch.randn((n, D), generator=g, device=dev).bfloat16()
    touched = int(torch.unique(idx).numel())
    k11_bytes = touched * 3 * F * D * 2 + n * D * 2 + n * K * D * 4
    out = dict(device=torch.cuda.get_device_name(dev), rows=n,
               k11=dict(experts_touched=touched, bytes=k11_bytes,
                        bound_ms=1e3 * k11_bytes / HBM))
    out["k11"]["kernel_ms"] = 1e3 * _time_graph(
        torch, lambda: moe.kernel_moe_experts(x, idx, w, gu, dn), args.reps)
    out["k11"]["plain_ms"] = 1e3 * _time_graph(
        torch, lambda: moe.plain_moe_experts(x, idx, w, gu, dn), 2)
    out["k11"]["share"] = out["k11"]["bound_ms"] / out["k11"]["kernel_ms"]

    tp = 192 + 1152
    gen_keys = max(args.keys - 700, 1)
    q = torch.randn((n, 16, 576), generator=g, device=dev).bfloat16()
    cur = torch.randn((n, 576), generator=g, device=dev).bfloat16()
    pfx = torch.randn((n, tp, 576), generator=g, device=dev).bfloat16()
    gen = torch.randn((n, 640, 576), generator=g, device=dev).bfloat16()
    banned = torch.zeros((n, tp), dtype=torch.bool, device=dev)
    banned[:, args.keys - gen_keys:] = True
    gen_len = torch.full((n,), gen_keys, dtype=torch.int64, device=dev)
    live = int((~banned).sum()) + n * (gen_keys + 1)
    k12_bytes = live * 576 * 2 + n * 16 * (576 + 512) * 2
    out["k12"] = dict(live_keys=live, bytes=k12_bytes,
                      bound_ms=1e3 * k12_bytes / HBM)

    def k12(fn):
        return lambda: fn(q, cur, pfx, gen, banned, gen_len, tp, 640,
                          192 ** -0.5, 512)

    out["k12"]["kernel_ms"] = 1e3 * _time_graph(
        torch, k12(mla.kernel_paged_mla_attention), args.reps)
    out["k12"]["plain_ms"] = 1e3 * _time_graph(
        torch, k12(mla.plain_paged_mla_attention), 2)
    out["k12"]["share"] = out["k12"]["bound_ms"] / out["k12"]["kernel_ms"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
