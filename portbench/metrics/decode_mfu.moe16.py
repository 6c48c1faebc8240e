"""The whole paged decode step's share of the card's peak in the server
with the MLA + MoE block: the least time the window's steps need
(``rooflines/mla_moe_decode_step``: the weights read once a step, the
routed experts the steps touched from the server's routing counter, each
live row's latents, products and logits; the larger of the window's
operations at the bf16 peak and its bytes at the HBM rate) over the
program's chunk spans, in %."""

from portbench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, roofline


def read(out, ctx):
    st = out.extra.get("stats") or {}
    if (not st.get("decode_steps") or not st.get("decode_s")
            or "expert_steps" not in st):
        return None
    cfg = ctx.cfg
    step = roofline("mla_moe_decode_step")
    n = st["decode_steps"]
    fixed_f, fixed_b = step.ops_bytes(cfg, [], 0.0)
    flops, nbytes = fixed_f * n, fixed_b * n
    nbytes += step.ops_bytes(cfg, [], float(st["expert_steps"].sum()))[1] - fixed_b
    K = cfg["n_codebooks"]
    for u in out.units:
        for t in range(u["gen_frames"] + K):
            rows = [u["x_len"] + u["p_len"] + t + 1]
            if cfg["decode"]["aug_text"]:
                rows.append(1 + u["p_len"] + t + 1)
            f, b = step.ops_bytes(cfg, rows, 0.0)
            flops += f - fixed_f
            nbytes += b - fixed_b
    need = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * need / st["decode_s"]
