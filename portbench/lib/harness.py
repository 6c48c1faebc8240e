"""What a loop is handed and what it hands back."""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class Context:
    """A run's settings: the cell (its workload file), the configuration
    and traffic files, the device, the seed, the window's seconds, tracing,
    whether the control (the reference in a lower precision) stands in
    the program's place in the comparison (PERF.md's control runs, never a
    measurement), and when the process started."""

    cell: str
    workload: dict
    cfg: dict
    mix: dict
    device: torch.device
    seed: int
    seconds: float
    trace: bool = False
    control: bool = False
    t_start: float = field(default_factory=time.perf_counter)
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """A loop's result: end-to-end values by metric name, the records the
    per-layer readers read (``units``: one a request or batch of the window;
    ``traced`` and ``profile``: the records of the sub-window profiled
    right after the window, and its reduction, or None), and the checks
    (name, value, limit, ok)."""

    e2e: Dict[str, float]
    units: List[dict]
    attempted: int
    failed: int
    checks: List[dict]
    memory_peak_bytes: int
    profile: Optional[dict] = None
    traced: List[dict] = field(default_factory=list)
    extra: Dict[str, object] = field(default_factory=dict)


def check(name: str, value: float, limit: float, least: bool = False) -> dict:
    """A number compared with its limit: ok when value <= limit (with
    ``least``: value >= limit)."""
    ok = limit is not None and (value >= limit if least else value <= limit)
    return dict(name=name, value=value, limit=limit,
                ok=bool(np.isfinite(value) and ok))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=count)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        info["power_limit"] = out.stdout.strip().splitlines()[0]
    except Exception:  # the limit is a note beside the numbers, not a result
        pass
    return info


def sample(records: List[dict], seed: int, key: Callable[[dict], int],
           want: int) -> List[dict]:
    """Records drawn from the seed, the one of largest ``key`` first, then
    more until their ``key`` sums to ``want``."""
    if not records:
        return []
    first = max(records, key=key)
    rest = [r for r in records if r is not first]
    order = np.random.default_rng([int(seed) % (2 ** 63), 9]).permutation(len(rest))
    out, total = [first], key(first)
    for j in order:
        if total >= want:
            break
        out.append(rest[j])
        total += key(rest[j])
    return out
