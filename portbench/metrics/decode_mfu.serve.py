"""The whole paged decode step's share of the card's peak in the
continuous server: the least time the window's steps need
(``rooflines/decode_step``: the weights read once a step, and each live
row's keys, products and logits; the larger of the window's operations at
the bf16 peak and its bytes at the HBM rate) over the program's chunk
spans, in %."""

from portbench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, roofline


def read(out, ctx):
    st = out.extra.get("stats") or {}
    if not st.get("decode_steps") or not st.get("decode_s"):
        return None
    cfg = ctx.cfg
    step = roofline("decode_step")
    fixed_f, fixed_b = step.ops_bytes(cfg, [])
    flops, nbytes = fixed_f * st["decode_steps"], fixed_b * st["decode_steps"]
    K = cfg["n_codebooks"]
    for u in out.units:
        for t in range(u["gen_frames"] + K):
            rows = [u["x_len"] + u["p_len"] + t + 1]
            if cfg["decode"]["aug_text"]:
                rows.append(1 + u["p_len"] + t + 1)
            f, b = step.ops_bytes(cfg, rows)
            flops += f - fixed_f
            nbytes += b - fixed_b
    need = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * need / st["decode_s"]
