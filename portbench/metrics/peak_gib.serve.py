"""The allocator's peak of the continuous server's process up to the end
of the window (``torch.cuda.max_memory_allocated``), GiB."""


def read(out, ctx):
    return out.memory_peak_bytes / 2 ** 30 if out.memory_peak_bytes else None
