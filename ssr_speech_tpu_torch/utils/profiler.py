"""Profiling hooks of the trainer (``ssr_speech_tpu/utils/profiler.py`` with
``torch.profiler`` in place of ``jax.profiler``): trace N steps of a loop,
CPU and CUDA activity, to a Chrome trace under ``logdir``, and summarise the
device kernels of the window in ``summary.json`` (:func:`summarize_trace`)."""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Dict

import torch

logger = logging.getLogger(__name__)

# kernel name fragments (lower case) -> the group a device-time summary
# reports them under; the first group with a matching fragment takes a
# kernel, so cuDNN's convolutions (xmma, implicit-GEMM) come before gemm
KERNEL_GROUPS = (
    ("flash_attention_fwd", ("flash_fwd_kernel",)),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("fused_ce", ("ce_fwd_kernel", "ce_dhidden_kernel", "ce_dw2_kernel")),
    ("rnn", ("rnn", "lstm")),
    ("convolution", ("fprop", "dgrad", "wgrad", "implicit_gemm", "cudnn",
                     "conv1d", "conv2d", "convolve", "winograd")),
    ("fft", ("fft",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
    ("elementwise", ("elementwise",)),
    ("reduction", ("reduce_kernel",)),
)


class Profiler:
    """Call :meth:`step` after each training step: the first call opens the
    trace, which then covers the next ``num_steps`` steps and is written
    when it closes (or at :meth:`close`)."""

    def __init__(self, logdir: str, enabled: bool = False, num_steps: int = 20):
        self.logdir = logdir
        self.enabled = enabled
        self.num_steps = num_steps
        self._step = 0
        self._prof = None

    def step(self):
        if not self.enabled:
            return
        if self._step == 0:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            logger.info("profiler: tracing %d steps to %s", self.num_steps,
                        self.logdir)
        self._step += 1
        if self._prof is not None and self._step > self.num_steps:
            self.close()

    def close(self):
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        summary = summarize_trace(path, steps=max(self._step - 1, 1))
        with open(os.path.join(self.logdir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        logger.info("profiler: trace and summary written to %s", self.logdir)


def summarize_trace(path: str, steps: int = 1, top: int = 25
                    ) -> Dict[str, object]:
    """Device kernels of a Chrome trace: per step, the kernel count, the
    device time by group (:data:`KERNEL_GROUPS`, the rest ``other``), the
    busy time (union of kernel intervals) and the span from the first kernel
    to the last; ``idle_share`` = 1 - busy / span; and the ``top`` kernel
    names by device time. Times in ms."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    by_name: Dict[str, list] = {}
    for e in kernels:
        name = e.get("name", "")
        group = next((g for g, frags in KERNEL_GROUPS
                      if any(f in name.lower() for f in frags)), "other")
        groups[group] += e["dur"] / 1e3
        entry = by_name.setdefault(name[:120], [0, 0.0])
        entry[0] += 1
        entry[1] += e["dur"] / 1e3
    busy, end = 0.0, None
    for e in sorted(kernels, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    span = ((max(e["ts"] + e["dur"] for e in kernels)
             - min(e["ts"] for e in kernels)) if kernels else 0.0)
    return {"steps": steps, "kernels_per_step": len(kernels) / steps,
            "device_ms_per_step": {k: v / steps for k, v in groups.items()},
            "busy_ms_per_step": busy / 1e3 / steps,
            "span_ms_per_step": span / 1e3 / steps,
            "idle_share": 1.0 - busy / span if span else None,
            "top": [{"name": n, "launches_per_step": c / steps,
                     "ms_per_step": ms / steps}
                    for n, (c, ms) in sorted(by_name.items(),
                                             key=lambda kv: -kv[1][1])[:top]]}


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield
