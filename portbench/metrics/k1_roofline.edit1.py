"""K1's share of its roofline in the edit cell: the least time the prompts
of the requests profiled right after the window need (``rooflines/k1``:
one launch a layer over the attendable positions of each row; under CFG
the unconditional row sees one text token) over the device time of the
kernels named ``flash_fwd_kernel`` in their profile, in %."""

from portbench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, roofline


def rows(u, cfg):
    dec = cfg["decode"]
    out = [u["x_len"] + u["p_len"]]
    if dec["aug_text"]:
        out.append(1 + u["p_len"])
    return out


def read(out, ctx):
    prof = out.profile
    if not prof or prof["groups"].get("flash_attention_fwd", 0.0) <= 0.0:
        return None
    cfg = ctx.cfg
    k1 = roofline("k1")
    traced = out.traced
    need = sum(cfg["num_layers"] * k1.bound_s(
        rows(u, cfg), heads=cfg["nhead"], head_dim=cfg["d_model"] // cfg["nhead"],
        peak_flops=PEAK_BF16_FLOPS, peak_bytes=PEAK_HBM_BYTES) for u in traced)
    return 100.0 * need / prof["groups"]["flash_attention_fwd"]
