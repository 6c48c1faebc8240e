"""The readers of the program's spans and counters on synthetic outcomes,
against hand computations: ``queue_wait_ms_p90.serve``,
``lanes_busy.serve``, ``host_idle_share.edit1`` and
``replay_gap_us.edit1``; each edit reader gives None where a root and a
unit disagree, and every reader gives None where the program keeps no such
span or counter (as a program before the recorder)."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench.lib import common, harness, traffic
from ssr_speech_tpu_torch.utils import profiler

SEED = 2 ** 31 + 4242


def _reader(name):
    return common.metric_reader(name).read


def _outcome(units=(), traced=(), stats=None):
    return harness.Outcome(e2e={}, units=list(units), attempted=len(units),
                           failed=0, checks=[], memory_peak_bytes=0,
                           traced=list(traced),
                           extra={} if stats is None else dict(stats=stats))


def _ctx(rate=3.4):
    return SimpleNamespace(mix=dict(rate_per_s=rate), seed=SEED)


def _span(name, parent=None, dev=None, **attrs):
    """A finished span; ``dev`` its device (start, end) in ns on the host
    clock, as the recorder resolves a device span's events."""
    sp = profiler.Span(name, parent, 1, attrs, 0)
    sp.t1 = 1
    if dev is not None:
        sp._dev = (dev[0], dev[1] - dev[0])
    if parent is not None:
        parent.children.append(sp)
    return sp


def _request(offset, steps, text_len):
    """A ``generate`` tree: device interval [0, 10000] from ``offset``,
    the prefill [2000, 3000], replays [3100, 5000], [5050, 7000],
    [7100, 9000], the copy-out [9200, 9500]; idle 2000 + 100 + 50 + 100 +
    200 + 500 = 2950 ns; replay gaps 50 and 100 ns."""
    o = offset
    root = _span("generate", dev=(o, o + 10000), decode_steps=steps,
                 text_len=text_len)
    _span("generate.prompt", root)
    _span("prefill", root, dev=(o + 2000, o + 3000))
    loop = _span("decode", root)
    for i, (lo, hi) in enumerate([(3100, 5000), (5050, 7000), (7100, 9000)]):
        _span("decode.replay", loop, dev=(o + lo, o + hi))
        if i < 2:
            _span("decode.poll", loop)
    _span("decode.copy_out", root, dev=(o + 9200, o + 9500))
    _span("generate.assemble", root)
    return root


def _edit_case(monkeypatch, units_steps=(17, 23), traced=1):
    """Roots: one warm-up, the window's two, then a plain and a profiled
    run of ``traced`` requests each, and a codec root after each."""
    roots = [_request(0, 5, 9)]
    window = [_request(10 ** 6, 17, 30), _request(2 * 10 ** 6, 23, 40)]
    for r in window:
        roots += [r, _span("codec.wmdecode", dev=(0, 1))]
    roots += [_request(3 * 10 ** 6 + i, 8, 12) for i in range(2 * traced)]
    monkeypatch.setattr(profiler, "roots", lambda: roots)
    units = [dict(steps=s, x_len=x, wall_s=w)
             for s, x, w in zip(units_steps, (30, 40), (2e-5, 3e-5))]
    return _outcome(units, traced=[{}] * traced)


def test_host_idle_share_by_hand(monkeypatch):
    out = _edit_case(monkeypatch)
    got = _reader("host_idle_share.edit1")(out, _ctx())
    assert got == pytest.approx(100.0 * 2 * 2950e-9 / 5e-5)


def test_replay_gap_by_hand(monkeypatch):
    out = _edit_case(monkeypatch)
    assert _reader("replay_gap_us.edit1")(out, _ctx()) == pytest.approx(0.075)


@pytest.mark.parametrize("name", ["host_idle_share.edit1",
                                  "replay_gap_us.edit1"])
@pytest.mark.parametrize("fault", ["steps", "text_len", "too_few"])
def test_edit_readers_refuse_a_disagreement(monkeypatch, name, fault):
    if fault == "steps":
        out = _edit_case(monkeypatch, units_steps=(17, 24))
    elif fault == "text_len":
        out = _edit_case(monkeypatch)
        out.units[0]["x_len"] = 31
    else:  # one more traced request than the roots hold
        out = _edit_case(monkeypatch)
        out.traced.append({})
    assert _reader(name)(out, _ctx()) is None


@pytest.mark.parametrize("name", ["host_idle_share.edit1",
                                  "replay_gap_us.edit1"])
def test_edit_readers_without_the_recorder(monkeypatch, name):
    out = _edit_case(monkeypatch)
    monkeypatch.delattr(profiler, "roots")
    assert _reader(name)(out, _ctx()) is None


def test_edit_readers_without_device_times(monkeypatch):
    """On the CPU the spans are host spans: no share, no gap."""
    out = _edit_case(monkeypatch)
    for root in profiler.roots():
        for s in root.walk():
            s._dev = None
    assert _reader("host_idle_share.edit1")(out, _ctx()) is None
    assert _reader("replay_gap_us.edit1")(out, _ctx()) is None


def test_queue_wait_p90_by_hand():
    n = 11  # p90 is the tenth smallest of eleven waits
    due = traffic.arrivals(3.4, n, SEED)
    waits = np.arange(n)[::-1] * 0.01 + 0.003
    admit = list(due + waits)
    got = _reader("queue_wait_ms_p90.serve")(
        _outcome(stats=dict(admit_at=admit)), _ctx())
    assert got == pytest.approx(1e3 * sorted(waits)[9])


def test_lanes_busy_by_hand():
    st = dict(lane_steps=2 * 17 + 1 * 6, decode_steps=23)
    got = _reader("lanes_busy.serve")(_outcome(stats=st), _ctx())
    assert got == pytest.approx(40 / 23)


@pytest.mark.parametrize("stats", [None, {}, dict(decode_steps=5),
                                   dict(admit_at=[0.1, None])])
def test_serve_readers_without_the_counters(stats):
    for name in ("queue_wait_ms_p90.serve", "lanes_busy.serve"):
        assert _reader(name)(_outcome(stats=stats), _ctx()) is None
