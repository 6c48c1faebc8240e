"""``lanes_busy.serve``'s reading in the continuous server with the MLA + MoE
block (the same server, lanes and admission queue, and the same traced
burst after the window)."""

from portbench.lib.common import metric_reader


def read(out, ctx):
    return metric_reader("lanes_busy.serve").read(out, ctx)
