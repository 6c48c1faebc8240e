"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names its configuration and its
traffic mix; ``portbench/workloads/<cell>.json`` names the loop that drives
the port (``portbench/loops/<loop>.py``). The run draws the weights and the
inputs from ``--seed`` on the device, warms every shape the mix can draw,
measures for ``--seconds``, then judges what the timed path produced against
the plain reference (``portbench/reference``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read by ``portbench/metrics/<name>.py`` from a profiled
sub-window and the program's counters), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2. It exits with 3, printing no result, if JAX, flax
or the JAX package was loaded in the process.

``--control 1`` (the control runs of ``PERF.md``, not a measurement) puts
the control, the reference in the next precision below the configured
one, in the program's place in the comparison: its outputs are judged by
the same checks and limits, and ``correct`` has to come out false.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import common  # noqa: E402

common.cache_dirs()


def parse(argv=None):
    p = argparse.ArgumentParser("portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(bench, ctx):
    """Run the cell's loop; returns (outcome, metrics, breakdown)."""
    from portbench.lib import profile

    out = common.loop(ctx.workload["loop"]).run(ctx)
    wanted = common.metrics_for(ctx.cell, bench, ctx.trace)
    metrics, breakdown = {}, None
    if not ctx.trace:
        for name, m in wanted.items():
            if name in out.e2e:
                metrics[name] = dict(value=out.e2e[name], unit=m["unit"])
    else:
        for name, m in wanted.items():
            value = common.metric_reader(name).read(out, ctx)
            if value is not None:
                metrics[name] = dict(value=value, unit=m["unit"])
        if out.profile is not None:
            breakdown = profile.breakdown(out.profile)
    return out, metrics, breakdown


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = common.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}: not measured",
              file=sys.stderr)
        return 2
    from portbench.lib.harness import Context, device_info

    device = torch.device("cuda", 0)
    torch.cuda.init()
    ctx = Context(cell=args.workload, workload=common.workload(args.workload),
                  cfg=common.config(entry["config"]),
                  mix=common.traffic_params(entry["traffic"]), device=device,
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  control=bool(args.control), t_start=T_START)
    out, metrics, breakdown = measure(bench, ctx)
    found = common.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in the measured process: {found}",
              file=sys.stderr)
        return 3
    dev = device_info(device, entry["chips"])
    dev["memory_peak_bytes"] = out.memory_peak_bytes
    if ctx.trace and out.profile is not None:
        dev["busy_s"] = out.profile["busy_s"]
        dev["window_s"] = out.profile["window_s"]
        print(f"traced window {out.profile['window_s']!r} s, busy "
              f"{out.profile['busy_s']!r} s; the same units unprofiled "
              f"{out.profile['plain_s']!r} s; device s by kernel group "
              + json.dumps(out.profile["groups"]), file=sys.stderr)
    correct = all(c["ok"] for c in out.checks)
    if ctx.control:
        print("control run: the checks judge the reference in a lower "
              "precision in the program's place", file=sys.stderr)
    print(common.checks_text(out.checks), file=sys.stderr, flush=True)
    print(common.result_line(
        correct=correct, attempted=out.attempted, failed=out.failed,
        metrics=metrics, device=dev, checks=out.checks, breakdown=breakdown),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
