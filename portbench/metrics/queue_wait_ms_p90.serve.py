"""Milliseconds a request of the continuous server waits before its
admission begins: the 90th percentile over every request of the window of
``admit_at`` (``ContinuousBatcher.stats``: the server's reading of its
clock that found the request arrived) minus the time it was due
(``lib/traffic.arrivals``, the loop's schedule), both on the server's
clock of the arrivals. None where the server keeps no ``admit_at``."""

import numpy as np

from portbench.lib import traffic


def read(out, ctx):
    admit = (out.extra.get("stats") or {}).get("admit_at")
    if not admit or any(a is None for a in admit):
        return None
    due = traffic.arrivals(ctx.mix["rate_per_s"], len(admit), ctx.seed)
    return 1e3 * float(np.quantile(np.asarray(admit) - due, 0.9))
