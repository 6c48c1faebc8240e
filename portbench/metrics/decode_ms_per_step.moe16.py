"""Milliseconds a decode step of the continuous server with the MLA + MoE
block: the program's chunk spans over the steps they took, over the whole
window (``decode_ms_per_step.serve``'s reading)."""

from portbench.lib.common import metric_reader


def read(out, ctx):
    return metric_reader("decode_ms_per_step.serve").read(out, ctx)
