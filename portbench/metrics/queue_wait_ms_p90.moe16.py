"""``queue_wait_ms_p90.serve``'s reading in the continuous server with the MLA + MoE
block (the same server, lanes and admission queue, and the same traced
burst after the window)."""

from portbench.lib.common import metric_reader


def read(out, ctx):
    return metric_reader("queue_wait_ms_p90.serve").read(out, ctx)
