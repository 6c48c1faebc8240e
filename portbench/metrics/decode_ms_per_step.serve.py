"""Milliseconds a decode step of the continuous server: the program's own
chunk spans over the steps they took (``ContinuousBatcher.stats``:
``decode_s``, ``decode_steps``), over the whole window."""


def read(out, ctx):
    st = out.extra.get("stats") or {}
    steps = st.get("decode_steps", 0)
    return 1e3 * st["decode_s"] / steps if steps else None
