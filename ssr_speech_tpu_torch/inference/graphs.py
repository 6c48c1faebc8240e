"""The decode loops' CUDA graphs: the port's counterpart of ``jax.jit`` over
JAX's ``_staged_while`` decode (``ssr_speech_tpu/inference/decode.py``).

JAX compiles each decode loop once per shape bucket and runs it on the
device. The port keeps the loop on the host but moves its work into graphs:
the loop body is a plain function of ``UNROLL`` decode steps over static
buffers (the KV caches, the chain state, a step counter, the loop's flag),
and on a CUDA device it is captured once per stage window
(``models.transformer.cache_stage_sizes``) and replayed. A replay costs one
graph launch; the host then reads one flag, the loop condition the body
evaluated on the device, and moves to the next window's graph when the
steps it has replayed may cross the current one. Steps the body takes after
the condition turned false change nothing but RNG offsets and cache columns
nothing reads, so the loop ends where JAX's ends.

- :class:`GraphLoop` holds one workspace's graphs. Each is captured lazily,
  the first time the loop enters its window: the body runs once on a side
  stream (the warm-up, which is the replay it stands for: the same steps on
  the same buffers), then is captured. All graphs of a loop share one memory
  pool. A failed capture or replay raises; nothing falls back to the eager
  loop.
- The request's generator: the loop's own generator is registered with each
  graph (``CUDAGraph.register_generator_state``), takes the request
  generator's state before the first replay and hands it back after the
  last, so Gumbel sampling draws the Philox stream the eager body draws.
- :class:`GraphProgram` is the same for a program without a loop, JAX's
  other compiled programs of the serving path: the prefills
  (``decode._prefill_impl``, ``_prefill_multi_impl``) and the server's
  splice (``serve._refill_impl``). Its function reads its inputs from static
  buffers, which a request fills by host-to-device copies before the call,
  and writes its results into static buffers; the lengths and the slot are
  device scalars there, as JAX traces them, so one capture serves every
  request of its shapes. The first call is the warm-up and the capture,
  every later call one replay. Each program has a memory pool of its own:
  nothing it allocates outlives its call, and no other graph's capture can
  take its blocks.
- A replay launches the kernels its capture recorded without a Python
  call, so both classes record every hand-written kernel's launches at
  capture (``ops.cuda_build.recording``) and add them to the kernels'
  counters at each replay.
- :func:`workspace` keeps workspaces per process and per parameter object
  (weakly: a workspace dies with its parameters), keyed by the shapes and
  settings the body is built for, so later requests of the same bucket
  replay the graphs captured by the first.

Graphs run where the device is CUDA and the parameters are not split over
tensor-parallel ranks (gloo's collectives go through host memory and
cannot be captured); elsewhere, the CPU included, the same body runs
eagerly in the same loop, which is what the CPU tests hold against JAX.
A graph holds the addresses of the tensors it read at capture: a parameter
tensor rebound after that (not updated in place) needs :func:`clear`.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Dict, Hashable, Optional

import torch

from ..ops.cuda_build import Recorded, recording
from ..parallel import collectives as col
from ..utils.profiler import annotate

UNROLL = 8  # decode steps a graph replays, and between two host reads
MAX_WORKSPACES = 6  # kept per parameter object, least recently used dropped

_workspaces: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_workspaces_lock = threading.Lock()


def graphs_wanted(device: torch.device, params, cuda_graphs: bool) -> bool:
    """Graphs on a CUDA device with one tensor-parallel rank, unless the
    caller asks for the eager loop."""
    par = getattr(params, "parallel", None)
    return (cuda_graphs and torch.device(device).type == "cuda"
            and col.tp_of(par) == 1)


class GraphLoop:
    """The captured bodies of one decode workspace, one graph per stage
    window. ``run(window, body, generator)`` takes ``UNROLL`` steps: by a
    graph replay when ``use_graphs``, else by calling ``body(window,
    generator)``. ``captures``, ``capture_s`` and ``replays`` count for the
    smoke and the tests, as does :meth:`pool_bytes`, and ``recorded``: the
    kernel launches each window's graph replays."""

    def __init__(self, device: torch.device, use_graphs: bool):
        self.device = torch.device(device)
        self.use_graphs = use_graphs
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.recorded: Dict[int, Recorded] = {}
        self.pool = None
        self.generator = (torch.Generator(device=self.device) if use_graphs
                          else None)
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    @contextmanager
    def request_rng(self, generator: torch.Generator):
        """The generator the body draws from during one request: the
        request's own on the eager path; on the graph path the loop's
        registered generator, which takes ``generator``'s state on entry and
        gives it back on exit."""
        if not self.use_graphs:
            yield generator
            return
        self.generator.set_state(generator.get_state())
        try:
            yield self.generator
        finally:
            generator.set_state(self.generator.get_state())

    def run(self, window: int, body: Callable, generator) -> None:
        if not self.use_graphs:
            body(window, generator)
            return
        graph = self.graphs.get(window)
        if graph is not None:
            graph.replay()
            self.replays += 1
            self.recorded[window].replay()
            return
        with annotate("graph.capture", window=window):
            self._capture(window, body, generator)

    def _capture(self, window: int, body: Callable, generator) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(window, generator)  # the warm-up is this run's real steps
        torch.cuda.current_stream(dev).wait_stream(side)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with recording() as rec, torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            body(window, generator)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.recorded[window] = rec
        self.graphs[window] = graph

    def pool_bytes(self) -> int:
        """Device memory of the graphs' shared pool."""
        return pool_bytes(self.pool)


def pool_bytes(pool) -> int:
    """Device memory of a graph pool (its segments in the allocator's
    snapshot); 0 for none."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


class GraphProgram:
    """One captured program without a loop. ``run(fn)`` calls ``fn()``, a
    plain function of static buffers: eagerly unless ``use_graphs``; with
    graphs the first call runs ``fn`` on a side stream (the warm-up, which
    is this call's real work) and then captures it into a pool of the
    program's own, and every later call replays the capture. A failed
    capture or replay raises. ``captures``, ``capture_s``, ``replays`` and
    ``recorded`` (the kernel launches one replay makes) count for the smoke
    and the tests, as does :meth:`pool_bytes`."""

    def __init__(self, device: torch.device, use_graphs: bool):
        self.device = torch.device(device)
        self.use_graphs = use_graphs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.pool = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.recorded = Recorded()

    def run(self, fn: Callable[[], None]) -> None:
        if not self.use_graphs:
            fn()
        elif self.graph is None:
            with annotate("graph.capture"):
                self._capture(fn)
        else:
            self.graph.replay()
            self.replays += 1
            self.recorded.replay()

    def _capture(self, fn: Callable[[], None]) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()  # the warm-up is this call's real work
        torch.cuda.current_stream(dev).wait_stream(side)
        self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with recording() as rec, torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            fn()
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.recorded = rec
        self.graph = graph

    def pool_bytes(self) -> int:
        return pool_bytes(self.pool)


def workspace(params, key: Hashable, make: Callable):
    """The workspace ``make()`` builds for ``params`` and ``key``, kept for
    the next call with the same parameter object and key (at most
    ``MAX_WORKSPACES`` a parameter object; a plain dict of parameters,
    which cannot be weakly referenced, gets a fresh one each call)."""
    with _workspaces_lock:
        try:
            table = _workspaces.get(params)
        except TypeError:
            return make()
        if table is None:
            table = _workspaces[params] = OrderedDict()
        ws = table.get(key)
        if ws is not None:
            table.move_to_end(key)
            return ws
    ws = make()
    with _workspaces_lock:
        table[key] = ws
        while len(table) > MAX_WORKSPACES:
            table.popitem(last=False)
    return ws


def clear() -> None:
    """Drop every kept workspace (its buffers and graphs)."""
    with _workspaces_lock:
        _workspaces.clear()


def kept() -> list:
    """The kept workspaces (for counters and tests)."""
    with _workspaces_lock:
        return [ws for table in _workspaces.values() for ws in table.values()]


def loop_steps(loop: GraphLoop, body: Callable, flag: torch.Tensor, *,
               max_steps: int, window_for: Callable[[int], int],
               generator: Optional[torch.Generator]) -> int:
    """Run ``body`` ``UNROLL`` steps at a time until its ``flag`` reads
    false or ``max_steps`` steps (a host bound the device condition also
    holds) have been replayed. ``window_for(n)`` gives the stage window for
    the replay after ``n`` steps. Spans: ``decode.replay`` (device) a
    replay, ``decode.poll`` a flag read. Returns the steps replayed (the
    device counter holds the steps taken)."""
    n = 0
    with loop.request_rng(generator) as gen:
        while n < max_steps:
            with annotate("decode.replay", loop.device):
                loop.run(window_for(n), body, gen)
            n += UNROLL
            if n >= max_steps:
                break
            with annotate("decode.poll"):
                go = bool(flag.item())  # the one read
            if not go:
                break
    return n
