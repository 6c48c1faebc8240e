"""Lanes of the continuous server holding an unfinished request, the mean
over the window's decode steps: the server's counter ``lane_steps`` (each
chunk's busy lanes at its start times the steps it took) over its
``decode_steps``. At a fixed arrival rate this is the rate times the time
a request spends in a lane (Little's law); near the lane count the queue
grows. None where the server keeps no ``lane_steps``."""


def read(out, ctx):
    st = out.extra.get("stats") or {}
    if "lane_steps" not in st or not st.get("decode_steps"):
        return None
    return st["lane_steps"] / st["decode_steps"]
