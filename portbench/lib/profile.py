"""The traced sub-window: ``torch.profiler`` over a few whole requests or
batches run right after the measured window (so the profiler's cost and
its reduction stay out of the window), reduced in memory to device time by
kernel group, the union of device intervals (busy seconds), the longest
idle gaps labelled by the harness's span that was open on the host, and
the kernels that took most time. No trace file is written.

The kernel groups are the port's ``utils/profiler.py::KERNEL_GROUPS``,
copied, with a copy/cast group (``tools/torch_profile_generate.py``'s) and
the matrix-vector kernels cuBLAS picks for small-batch recurrences apart
from the GEMMs.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch

# name fragments (lower case) -> group; the first group that matches takes
# a kernel, so cuDNN's convolutions come before the GEMMs
KERNEL_GROUPS = (
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("fused_ce", ("ce_fwd_kernel", "ce_dhidden_kernel", "ce_dw2_kernel")),
    ("rnn", ("rnn", "lstm")),
    ("convolution", ("fprop", "dgrad", "wgrad", "implicit_gemm", "cudnn",
                     "conv1d", "conv2d", "convolve", "winograd")),
    ("fft", ("fft",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("gemv", ("gemv", "gemmsn")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copy", ("copy", "memcpy", "memset", "cast", "catarray", "index_put",
              "indexing_backward", "scatter", "gather", "index_kernel")),
    ("elementwise", ("elementwise",)),
    ("reduction", ("reduce_kernel", "softmax", "argmax", "topk", "sort",
                   "cumsum", "scan")),
)

SPAN_PREFIX = "pb:"


def group_of(name: str) -> str:
    low = name.lower()
    for group, frags in KERNEL_GROUPS:
        if any(f in low for f in frags):
            return group
    return "other"


@contextmanager
def span(name: str):
    """A harness span: a host range the profiler records, which labels the
    device's idle gaps under it."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _ns(ev, what: str) -> Optional[int]:
    for attr, mult in ((what + "_ns", 1), (what + "_us", 1000)):
        fn = getattr(ev, attr, None)
        if fn is not None:
            return int(fn() * mult)
    return None


def _events(prof) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """(device events, harness spans) as (name, start ns, end ns)."""
    dev, spans = [], []
    raw = prof.profiler.kineto_results.events()
    for ev in raw:
        name = ev.name()
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if start is None or dur is None:
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kind = getattr(ev, "activity_type", lambda: "")() or ""
            if "annotation" not in kind and not name.startswith(SPAN_PREFIX):
                dev.append((name, start, start + dur))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], start, start + dur))
    return dev, spans


def reduce(prof, window_s: float) -> Dict:
    """Reduce a closed profile: device seconds by group and by kernel name,
    busy seconds (the union of device intervals), the idle gaps summed by
    the innermost harness span open at each gap's middle."""
    dev, spans = _events(prof)
    groups: Dict[str, float] = {}
    names: Dict[str, List] = {}
    for name, s, e in dev:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + (e - s) / 1e9
        ent = names.setdefault(name[:120], [0, 0.0])
        ent[0] += 1
        ent[1] += (e - s) / 1e9
    busy = 0
    gaps = []
    end = None
    for _, s, e in sorted(dev, key=lambda t: t[1]):
        if end is None:
            busy += e - s
            end = e
        elif s > end:
            gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    spans.sort(key=lambda t: t[1])
    idle: Dict[str, float] = {}
    for lo, hi in gaps:
        mid = (lo + hi) // 2
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        label = (min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner
                 else "outside any span")
        idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e9
    if dev:
        first = min(s for _, s, _ in dev)
        last = max(e for _, _, e in dev)
        idle["before the first kernel and after the last"] = max(
            window_s - (last - first) / 1e9, 0.0)
    return dict(window_s=window_s, busy_s=busy / 1e9, groups=groups,
                kernels=names, idle=idle, n_device_events=len(dev))


def breakdown(summary: Dict) -> Dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[n, v[1]] for n, v in ops],
                idle_gaps=[[n, v] for n, v in gaps])


def traced(units: Callable[[], list]) -> Tuple[list, Dict]:
    """Run ``units()`` (a few whole requests or batches) twice: once plain,
    timed, then again under the profiler; both synchronised at both ends.
    Returns (the profiled run's records, the reduction of its profile, with
    ``plain_s``: the wall seconds of the plain run, printed beside the
    idle share: the profiler slows the host, the graph replays most, and
    its window is longer by that)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    units()
    sync()
    plain = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    t0 = time.perf_counter()
    records = units()
    sync()
    window = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    summary = reduce(prof, window)
    summary["plain_s"] = plain
    return records, summary
