"""Milliseconds a decode step of the edit cell: the program's own decode
span over its step count (``decode.generate(stats=)``: ``decode_s``,
``decode_steps``), summed over the window's requests."""


def read(out, ctx):
    units = out.units
    steps = sum(u["steps"] for u in units)
    return 1e3 * sum(u["decode_s"] for u in units) / steps if steps else None
