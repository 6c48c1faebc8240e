"""Milliseconds of an admission of the continuous server: the program's
synchronised prefill span of each request (``ContinuousBatcher.stats``
``prefill_s``: the staging area's replayed prefill), the mean over the
window."""


def read(out, ctx):
    spans = (out.extra.get("stats") or {}).get("prefill_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
