"""Microseconds the device waits between two decode replays of one edit
request: the mean, over consecutive ``decode.replay`` spans within each of
the window's ``generate`` roots, of the next replay's start minus the
last one's end on the device (the flag read on the host and the next
graph launch). Read from the program's span recorder, the window's roots
found as ``host_idle_share.edit1`` finds them; None where the program has
none, on the CPU, or where they disagree with the window's requests."""

from portbench.lib import common


def read(out, ctx):
    roots = common.metric_reader("host_idle_share.edit1").window_roots(out, ctx)
    if roots is None:
        return None
    gaps = []
    for root in roots:
        times = [s.device() for s in root.find("decode.replay")]
        if any(t is None for t in times):
            return None
        gaps += [b[0] - a[1] for a, b in zip(times, times[1:])]
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
