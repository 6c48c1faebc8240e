"""The device's idle share in the continuous server, in %: 1 - the union of
device intervals (taken from the profiler's trace of the burst of requests
run right after the window) over the wall seconds of the same units run
unprofiled just before. The profiled window itself is longer by the
profiler's own cost on the host, so it is not the denominator. Where the
device is saturated this reads about 0, and a little below where the
profiler lengthens the kernels themselves."""


def read(out, ctx):
    prof = out.profile
    if not prof or prof["plain_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["plain_s"])
