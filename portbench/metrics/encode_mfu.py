"""The whole encode step's share of the card's fp32 peak: the operations
the window's batches need (``rooflines/codec_encoder`` over each
waveform's own length, padding not counted) over the window's wall seconds
(padding on the host, the copies in, the encoder, the codes out, the
batches in flight overlapping) at 67 TFLOP/s, in %."""

from portbench.lib.common import PEAK_FP32_FLOPS, roofline


def read(out, ctx):
    enc = roofline("codec_encoder")
    units = out.units
    spent = out.extra.get("window_s", 0.0)
    if not spent or not units:
        return None
    hop = 1
    for r in ctx.cfg["seanet"]["ratios"]:
        hop *= r
    need = sum(enc.flops(ctx.cfg, f * hop) for u in units
               for f in u["batch"]["frames"])
    return 100.0 * need / (spent * PEAK_FP32_FLOPS)
