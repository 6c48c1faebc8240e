"""Milliseconds of an admission of the continuous server with the MLA +
MoE block: the ``prefill`` spans under ``serve.admit`` (the staging area's
replayed prefill: expanded latent attention, the grouped expert products),
the mean over the window (``admit_ms.serve``'s reading)."""

from portbench.lib.common import metric_reader


def read(out, ctx):
    return metric_reader("admit_ms.serve").read(out, ctx)
