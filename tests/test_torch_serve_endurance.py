"""Serving endurance of the port's ``StreamingServer.serve_loop`` on the CPU:
the two cases of tests/test_serve_endurance.py at its tiny geometry (the
tiny LM, the causal two-filter codec, two lanes, greedy).

- No leaks over a stream: after a warm-up, further requests leave no lane,
  slot or queue behind, and neither the Python heap (tracemalloc) nor the
  process RSS grows past the JAX test's bounds (4 MB and 64 MB). The counts
  are cut from JAX's 40 warm-up + 100 measured requests to 8 + 24, so that
  the case fits the CPU suite's budget (a few seconds); the card's
  ``[endurance]`` phase of chip_smoke.py runs the full-width server.
- Refilled lanes are stable: requests that arrive after the loop went idle
  give the same codes (and waveforms within 2e-5 / 1e-4) as the same
  requests served before.
"""

import gc
import os
import tracemalloc
from collections import deque

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import DecodeConfig
from ssr_speech_tpu_torch.inference import stream as tstream
from tests.test_torch_batched_decode import CFG, TCFG, models, one_torch_thread
from tests.test_torch_hostcopies import port_config
from tests.test_torch_stream_tts import TCODEC, codecs

__all__ = ["codecs", "models", "one_torch_thread"]  # shared fixtures

N_WARM, N_MEASURED = 8, 24
DEC = DecodeConfig(top_k=1, top_p=1.0, stop_repetition=-1, cfg_coef=1.5,
                   cfg_stride=2, aug_text=True, cfg_pretrained=True,
                   max_gen_per_span=60, length_cap_mult=10)


def _rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def _requests(n, rng):
    """A few recycled shapes (tests/test_serve_endurance.py)."""
    ts = CFG.tokens
    shapes = [(24, 40), (17, 28), (30, 36)]
    reqs = []
    for i in range(n):
        T, sx = shapes[i % len(shapes)]
        y = rng.integers(0, ts.audio_vocab_size, size=(CFG.n_codebooks, T))
        x = rng.integers(0, CFG.text_vocab_size - 1, size=(sx,))
        reqs.append((x, y))
    return reqs


def _server(models, codecs):
    return tstream.StreamingServer(models[1], TCFG, port_config(DEC),
                                   codecs[1], TCODEC, 2, chunk_frames=10,
                                   sx_pad=64, p_pad=64, warm_chunk=8)


def test_serve_loop_endurance_no_leaks(models, codecs):
    server = _server(models, codecs)
    n_total = N_WARM + N_MEASURED
    reqs = _requests(n_total, np.random.default_rng(5))
    pending = deque((i, server.prepare_request(x, y))
                    for i, (x, y) in enumerate(reqs))
    done, marks = {}, {}

    def poll():
        return pending.popleft() if pending else None

    def on_done(req_id, codes, wav, first_at, t):
        done[req_id] = (codes.shape, wav.shape)
        if len(done) == N_WARM:
            gc.collect()
            tracemalloc.start()
            marks["snap0"] = tracemalloc.take_snapshot()
            marks["rss0"] = _rss_mb()

    server.serve_loop(poll, on_done=on_done,
                      generator=torch.Generator().manual_seed(0),
                      should_stop=lambda: len(done) >= n_total)

    assert len(done) == n_total
    assert all(cs[1] > 0 and ws[0] > 0 for cs, ws in done.values())
    gc.collect()
    snap1 = tracemalloc.take_snapshot()
    growth = sum(st.size_diff for st in
                 snap1.compare_to(marks["snap0"], "lineno"))
    tracemalloc.stop()
    rss1 = _rss_mb()
    assert growth < 4 * 2**20, f"python heap grew {growth / 2**20:.2f} MB"
    assert rss1 - marks["rss0"] < 64, (
        f"RSS grew {rss1 - marks['rss0']:.1f} MB over {N_MEASURED} requests")
    srv = server._server
    assert all(r is None for r in srv._slot_req)
    assert not srv.state.active.any()


def test_serve_loop_interleaved_refill_results_stable(models, codecs):
    server = _server(models, codecs)
    base = _requests(3, np.random.default_rng(9))
    # phase 1: ids 0..2; an idle gap; phase 2: the same requests as 10..12
    schedule = deque([(i, server.prepare_request(x, y))
                      for i, (x, y) in enumerate(base)])
    late = [(10 + i, server.prepare_request(x, y))
            for i, (x, y) in enumerate(base)]
    done, state = {}, {"idled": 0}

    def poll():
        return schedule.popleft() if schedule else None

    def on_idle(now):
        state["idled"] += 1
        if len(done) >= 3 and late:
            schedule.extend(late)
            late.clear()

    def on_done(req_id, codes, wav, first_at, t):
        done[req_id] = (codes, wav)

    server.serve_loop(poll, on_done=on_done,
                      generator=torch.Generator().manual_seed(0),
                      should_stop=lambda: len(done) >= 6, on_idle=on_idle)
    assert sorted(done) == [0, 1, 2, 10, 11, 12] and state["idled"] >= 1
    for i in range(3):
        c0, w0 = done[i]
        c1, w1 = done[10 + i]
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_allclose(w0, w1, atol=2e-5, rtol=1e-4)
