"""K12's share of its roofline in the server with the MLA + MoE block: the
least time the latent attention of the burst profiled right after the
window needs (``rooflines/k12``: each served row's live latents, its query
and output, one launch a layer a step; under CFG the unconditional row
sees one text token) over the device time of the kernel
``mla_decode_attn_kernel`` in its profile, in %. Only the requests' rows
are counted (a parked lane's reads are not), scaled by the steps K12 ran
(``k12_steps``) over the steps taken."""

from portbench.lib import weights_mla_moe
from portbench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, roofline


def read(out, ctx):
    prof = out.profile
    if not prof or not out.traced:
        return None
    st = out.traced[0]
    busy = sum(v[1] for k, v in prof["kernels"].items()
               if "mla_decode_attn_kernel" in k)
    if busy <= 0 or not st.get("decode_steps") or "units" not in st:
        return None
    cfg = ctx.cfg
    L = weights_mla_moe.sizes(cfg)["L"]
    K = cfg["n_codebooks"]
    keys, rows = 0, 0
    for u in st["units"]:
        for t in range(u["gen_frames"] + K):
            keys += u["x_len"] + u["p_len"] + t + 1
            rows += 1
            if cfg["decode"]["aug_text"]:
                keys += 1 + u["p_len"] + t + 1
                rows += 1
    flops, nbytes = roofline("k12").ops_bytes(L * keys, L * rows)
    need = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * need * st["k12_steps"] / st["decode_steps"] / busy
