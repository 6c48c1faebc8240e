"""The allocator's peak of the process serving the MLA + MoE block up to
the end of the window, GiB (``peak_gib.serve``'s reading): the weights,
the latent caches, the staging areas and the graphs' pools."""

from portbench.lib.common import metric_reader


def read(out, ctx):
    return metric_reader("peak_gib.serve").read(out, ctx)
