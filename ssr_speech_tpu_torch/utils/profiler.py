"""The port's spans and counters, and the trainer's profiling hooks
(``ssr_speech_tpu/utils/profiler.py`` with ``torch.profiler`` in place of
``jax.profiler``).

- :class:`annotate` is the one span API. A span records its name, its host
  start and end (``time.perf_counter_ns``), its parent, the identifier of
  the request it serves (a root takes a new one; a child shares its
  parent's unless given its own) and attributes (:func:`note`). A span
  given a CUDA ``device`` also records a CUDA event at entry and at exit
  on the current stream (events from a pool, read only when a reader asks:
  the recording path neither synchronises nor reads an event), and with
  them its device interval on the host clock: an anchor (an event recorded while the stream is idle
  and the host time beside it, renewed at most once a second) maps device
  times onto ``perf_counter_ns``. Spans record on a thread that is inside
  a span opened with ``record=True`` (what a call given ``stats=`` does) or
  inside :func:`recording`; elsewhere a span costs a flag test and records
  nothing. While a ``torch.profiler`` profile is active every span also
  opens a profiler range of its name (as ``torch.profiler.record_function``
  does, but without a range on the device's timeline), so profiler traces
  show the same names. A finished root span goes into a process-wide ring
  of the last :data:`RING` roots (:func:`roots`); nothing is written to a
  file.
- :class:`Profiler` traces N steps of a loop, CPU and CUDA activity, to a
  Chrome trace under ``logdir`` and summarises the device kernels of the
  window in ``summary.json`` (:func:`summarize_trace`).
- :class:`StepTimer`: the wall-clock data/train meters of the LM trainer.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

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


RING = 1024  # finished root spans kept, the oldest dropped first
ANCHOR_NS = 1_000_000_000  # an anchor is renewed at most once a second


class _Thread(threading.local):
    """Per thread: the open recorded spans, innermost last, and the depth
    of :func:`recording` contexts."""

    def __init__(self):
        self.stack: List[Span] = []
        self.forced = 0


_ring: deque = deque()
_local = _Thread()
_requests = itertools.count(1)
_events: List = []  # the pool of timing events
_lock = threading.Lock()  # the pool and the ring
_made = [0]  # timing events ever made (anchors included)
_anchors: Dict[int, "_Anchor"] = {}  # device index -> latest anchor
_streams: Dict[int, tuple] = {}  # device index -> (stream key, Stream)


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def _stream(idx: int):
    """The current stream of device ``idx`` (``torch.cuda.current_stream``
    without a new Python object when it has not changed)."""
    key = torch._C._cuda_getCurrentStream(idx)
    hit = _streams.get(idx)
    if hit is None or hit[0] != key:
        hit = _streams[idx] = (key, torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2]))
    return hit[1]


def _event():
    with _lock:
        if _events:
            return _events.pop()
        _made[0] += 1
    return torch.cuda.Event(enable_timing=True)


def _release(*events) -> None:
    with _lock:
        _events.extend(events)


def _keep(root: "Span") -> None:
    """Put a finished root into the ring; the oldest root past
    :data:`RING` leaves it, and its events, long completed, go back to the
    pool unread (its spans then have no device times)."""
    with _lock:
        _ring.append(root)
        old = _ring.popleft() if len(_ring) > RING else None
    if old is not None:
        for s in old.walk():
            if s._ev is not None:
                _release(*(e for e in s._ev[:2] if e is not None))
                s._ev = None


class _Anchor:
    """An event recorded while its stream had no work queued, and the host
    time at its record: ``host_ns + anchor.elapsed_time(e)`` is the host
    time at which the device reached ``e``."""

    __slots__ = ("event", "host_ns")

    def __init__(self, stream):
        _made[0] += 1
        self.event = torch.cuda.Event(enable_timing=True)
        self.host_ns = time.perf_counter_ns()
        self.event.record(stream)


def _anchor(idx: int, stream, now: int) -> Optional[_Anchor]:
    """The latest anchor of device ``idx``, renewed when it is missing or a
    second old and the stream is idle (``query``: no synchronise)."""
    a = _anchors.get(idx)
    if (a is None or now - a.host_ns > ANCHOR_NS) and stream.query():
        a = _anchors[idx] = _Anchor(stream)
    return a


class Span:
    """One recorded span: ``name``, ``parent``, ``request``, ``attrs``,
    ``children``, host ``t0``/``t1`` in ns (``t1`` None while open) and,
    for a device span, its events until they are resolved
    (:meth:`device`, :meth:`device_s`)."""

    __slots__ = ("name", "parent", "request", "attrs", "children", "t0", "t1",
                 "_ev", "_anchor", "_dev")

    def __init__(self, name: str, parent: Optional["Span"], request,
                 attrs: Dict, t0: int):
        self.name = name
        self.parent = parent
        self.request = request
        self.attrs = attrs
        self.children: List[Span] = []
        self.t0 = t0
        self.t1: Optional[int] = None
        self._ev = None  # (entry event, exit event, device index)
        self._anchor: Optional[_Anchor] = None
        self._dev: Optional[Tuple[Optional[int], int]] = None  # (start, dur)

    @property
    def host_s(self) -> Optional[float]:
        return None if self.t1 is None else (self.t1 - self.t0) / 1e9

    def _resolve(self) -> bool:
        """Read the events, once, into (device start on the host clock or
        None, device duration) in ns, and give them back to the pool. A
        read waits for pending events; the recording path never reads."""
        if self._ev is None:
            return self._dev is not None
        e0, e1, idx = self._ev
        if e1 is None:
            return False  # still open
        e1.synchronize()
        dur = int(e0.elapsed_time(e1) * 1e6)
        a = self._anchor or _anchors.get(idx)
        start = (None if a is None
                 else a.host_ns + int(a.event.elapsed_time(e0) * 1e6))
        self._dev = (start, dur)
        self._ev = self._anchor = None
        _release(e0, e1)
        return True

    def device(self) -> Optional[Tuple[int, int]]:
        """(start, end) of the span's device work on the host clock, ns;
        None for a host span, without an anchor, or once its root has left
        the ring unread."""
        if not self._resolve() or self._dev[0] is None:
            return None
        return self._dev[0], self._dev[0] + self._dev[1]

    def device_s(self) -> Optional[float]:
        """Seconds from the entry event to the exit event on the device;
        None for a host span (or as :meth:`device`)."""
        if not self._resolve():
            return None
        return self._dev[1] / 1e9

    def walk(self) -> Iterator["Span"]:
        """This span and every span under it, in the order they opened."""
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]


class annotate:
    """``with annotate(name, device=None, record=False, request=None,
    **attrs) as span``: a named span (see the module's text); ``span`` is
    the :class:`Span`, or None where nothing records. ``device``: a CUDA
    device on which the span's work runs (a device span; a host span on
    other devices and inside a CUDA graph capture); ``record=True`` records
    this span and every span opened inside it on this thread; ``request``
    overrides the inherited request identifier."""

    __slots__ = ("name", "device", "record", "request", "attrs", "_span",
                 "_rf")

    def __init__(self, name: str, device=None, record: bool = False,
                 request=None, **attrs):
        self.name = name
        self.device = device
        self.record = record
        self.request = request
        self.attrs = attrs
        self._span = self._rf = None

    def __enter__(self) -> Optional[Span]:
        if _profiling():
            # a range of the profiler's own kind (``record_function``
            # makes a user annotation, which the trace also draws as a
            # range on the device's timeline, where it reads as device work)
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        tls = _local
        if not (self.record or tls.stack or tls.forced):
            return None
        st = tls.stack
        parent = st[-1] if st else None
        request = (self.request if self.request is not None
                   else parent.request if parent is not None
                   else next(_requests))
        now = time.perf_counter_ns()
        sp = Span(self.name, parent, request, self.attrs, now)
        dev = self.device
        if (dev is not None and torch.device(dev).type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            idx = torch.device(dev).index
            idx = torch.cuda.current_device() if idx is None else idx
            stream = _stream(idx)
            sp._anchor = _anchor(idx, stream, now)
            e0 = _event()
            e0.record(stream)
            sp._ev = (e0, None, idx)
        if parent is not None:
            parent.children.append(sp)
        st.append(sp)
        self._span = sp
        return sp

    def __exit__(self, *exc) -> None:
        sp = self._span
        if sp is not None:
            self._span = None
            if sp._ev is not None:
                e1 = _event()
                e1.record(_stream(sp._ev[2]))
                sp._ev = (sp._ev[0], e1, sp._ev[2])
            sp.t1 = time.perf_counter_ns()
            st = _local.stack
            if st and st[-1] is sp:
                st.pop()
            if sp.parent is None:
                _keep(sp)
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None


@contextlib.contextmanager
def recording():
    """Record every span opened inside on this thread (roots included)."""
    _local.forced += 1
    try:
        yield
    finally:
        _local.forced -= 1


def note(**attrs) -> None:
    """Set attributes on the innermost recorded span of this thread; a
    no-op where nothing records."""
    st = _local.stack
    if st:
        st[-1].attrs.update(attrs)


def new_request() -> int:
    """A fresh request identifier (a server gives one to each request)."""
    return next(_requests)


def roots() -> List[Span]:
    """The finished root spans of the ring, oldest first."""
    with _lock:
        return list(_ring)




def events_made() -> int:
    """Timing events made so far in the process (pooled and anchors)."""
    return _made[0]


class StepTimer:
    """data_time / train_time meters (reference steps/trainer.py:164-168)."""

    def __init__(self):
        self.data_time = 0.0
        self.train_time = 0.0
        self._mark = time.time()

    def data_done(self):
        now = time.time()
        self.data_time = now - self._mark
        self._mark = now

    def step_done(self):
        now = time.time()
        self.train_time = now - self._mark
        self._mark = now
