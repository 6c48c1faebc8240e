"""Milliseconds of the codec's watermark decode a request of the edit cell:
the harness's span around ``wmdecode`` up to its waveform on the host, the
mean over the window's requests."""


def read(out, ctx):
    units = out.units
    return 1e3 * sum(u["codec_s"] for u in units) / len(units) if units else None
