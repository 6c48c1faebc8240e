"""The device's idle share that the host causes in the edit cell, in %:
over the window's requests, the device time between consecutive device
spans of each request's ``generate`` span tree (from the root's entry
event, through the prefill, each decode replay and the copy-out, to the
root's exit event: the prompt build, the flag reads and relaunches, the
chain state's small fills, the copy-out's wait, the assembly), over the
window's wall (the requests' own walls summed). Gaps inside a replay are
not counted; nor is the splice and watermark decode between requests,
which the loop calls without ``stats``. Read from the program's span
recorder (``utils/profiler.roots``); None where the program has none, on
the CPU (no device times), or where the roots and the window's requests
disagree.

The recorder's roots run: warm-up, the window's requests, then
``lib/profile.traced``'s plain and profiled runs of ``len(out.traced)``
requests each; they are paired with the window's units from the end and
must agree on the decode steps and the text length."""


def window_roots(out, ctx):
    """The ``generate`` roots of the window's requests, in order, or None."""
    try:
        from ssr_speech_tpu_torch.utils import profiler

        roots = [r for r in profiler.roots() if r.name == "generate"]
    except (ImportError, AttributeError):
        return None
    units = out.units
    tail = 2 * len(out.traced)
    if not units or len(roots) < len(units) + tail:
        return None
    picked = roots[len(roots) - tail - len(units):len(roots) - tail]
    for root, u in zip(picked, units):
        if (root.attrs.get("decode_steps") != u["steps"]
                or root.attrs.get("text_len") != u["x_len"]):
            return None
    return picked


def device_spans(root):
    """(start, end) ns on the host clock of the root's device spans below
    it, by start; None if a span has none."""
    spans = []
    for s in root.walk():
        if s is root or s.device_s() is None:
            continue
        t = s.device()
        if t is None:
            return None
        spans.append(t)
    return sorted(spans)


def idle_ns(root):
    """Device time in the root's device interval that none of its device
    spans covers; None without device times."""
    whole = root.device()
    spans = device_spans(root)
    if whole is None or spans is None:
        return None
    idle, end = 0, whole[0]
    for lo, hi in spans:
        idle += max(lo - end, 0)
        end = max(end, hi)
    return idle + max(whole[1] - end, 0)


def read(out, ctx):
    roots = window_roots(out, ctx)
    if roots is None:
        return None
    idle = [idle_ns(r) for r in roots]
    wall = sum(u["wall_s"] for u in out.units)
    if any(i is None for i in idle) or wall <= 0:
        return None
    return 100.0 * sum(idle) / 1e9 / wall
