"""Milliseconds a prefill of the edit cell: the program's synchronised
prefill span (``decode.generate(stats=)["prefill_s"]``), the mean over the
window's requests."""


def read(out, ctx):
    units = out.units
    return 1e3 * sum(u["prefill_s"] for u in units) / len(units) if units else None
