"""Find the knee of the ``moonlight-serve-open-16lane`` cell once, on the
card (``sweep_rate.py`` for the MLA + MoE block's loop): one server, the
mix served at each rate for ``--seconds``; per rate the latency median and
95th percentile, the served audio seconds a second, how far the last
completion trailed the last arrival (a backlog that grows with the window
is past the knee), and the milliseconds a decode step. The cell's rate
(``traffic/serve-open-16lane.json``) is set from it by hand, at four
fifths of the highest rate without a growing backlog; the benchmark's runs
never search.

    python3 portbench/sweep_rate_mla_moe.py --seed <n> --seconds 30 --rates 2 3 4 5
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.lib import common  # noqa: E402

common.cache_dirs()


def main(argv=None) -> int:
    import numpy as np
    import torch

    from portbench.lib import harness, traffic
    from portbench.loops import serve_open_mla_moe

    p = argparse.ArgumentParser("portbench/sweep_rate_mla_moe.py")
    p.add_argument("--cell", default="moonlight-serve-open-16lane")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = common.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == args.cell)
    mix = common.traffic_params(entry["traffic"])
    cfg = common.config(entry["config"])
    ctx = harness.Context(cell=args.cell, workload=common.workload(args.cell),
                          cfg=cfg, mix=dict(mix, rate_per_s=args.rates[0]),
                          device=torch.device("cuda", 0), seed=args.seed,
                          seconds=args.seconds)
    svc = serve_open_mla_moe.Service(ctx)
    for rate in args.rates:
        n = int(round(rate * args.seconds))
        reqs = traffic.serve_requests(mix, cfg, args.seed, n)
        times = traffic.arrivals(rate, n, args.seed)
        results, done_at, wall, st = svc.serve(reqs, times, {})
        lat = np.array([d - t for d, t in zip(done_at, times)])
        frames = sum(int(np.asarray(r[1]).sum()) for r in results)
        print(json.dumps(dict(
            rate=rate, requests=n, p50_s=float(np.median(lat)),
            p95_s=float(np.quantile(lat, 0.95)),
            served_audio_s_per_s=frames / cfg["codec"]["frame_rate"] / wall,
            trail_s=float(max(done_at) - times[-1]),
            ms_per_step=1e3 * st["decode_s"] / max(st["decode_steps"], 1),
            lanes_busy=st["lane_steps"] / max(st["decode_steps"], 1),
            experts_touched=float(st["expert_steps"].sum(1).mean())
            / max(st["decode_steps"], 1))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
