"""The whole decode step's share of the card's peak in the edit cell: the
least time every step of the window's requests needs
(``rooflines/decode_step``: the larger of its operations at the bf16 peak
and its bytes at the HBM rate; the bytes bound it) over the program's
decode span of those requests, in %."""

from portbench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, roofline


def read(out, ctx):
    cfg = ctx.cfg
    step = roofline("decode_step")
    units = out.units
    spent = sum(u["decode_s"] for u in units)
    if not spent:
        return None
    cfg_rows = cfg["decode"]["aug_text"]
    need = 0.0
    for u in units:
        for t in range(u["steps"]):
            ctx_rows = [u["x_len"] + u["p_len"] + t + 1]
            if cfg_rows:
                ctx_rows.append(1 + u["p_len"] + t + 1)
            need += step.bound_s(cfg, ctx_rows, peak_flops=PEAK_BF16_FLOPS,
                                 peak_bytes=PEAK_HBM_BYTES)
    return 100.0 * need / spent
