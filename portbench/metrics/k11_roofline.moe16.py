"""K11's share of its roofline in the server with the MLA + MoE block: the
least time the routed experts of the burst profiled right after the window
need (``rooflines/k11``: the experts the live rows touched, their weights
read once, the live rows in, the intermediates and weighted outputs) over
the device time of K11's kernels (``moe_gate_up_kernel``,
``moe_act_kernel``, ``moe_down_kernel``) in its profile, in %. The routing
counters count the live rows of the steps the chunks took; the kernels
that a replay runs past a chunk's end have no live row and read no expert,
and their time is K11's too."""

from portbench.lib import weights_mla_moe
from portbench.lib.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, roofline

NAMES = ("moe_gate_up_kernel", "moe_act_kernel", "moe_down_kernel")


def read(out, ctx):
    prof = out.profile
    if not prof or not out.traced:
        return None
    st = out.traced[0]
    busy = sum(v[1] for k, v in prof["kernels"].items()
               if any(n in k for n in NAMES))
    if busy <= 0 or "expert_steps" not in st:
        return None
    s = weights_mla_moe.sizes(ctx.cfg)
    pairs = float(st["expert_tokens"].sum())
    flops, nbytes = roofline("k11").ops_bytes(
        touched=float(st["expert_steps"].sum()), pairs=pairs,
        rows=pairs / s["k"], d=s["d"], f=s["F"])
    need = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * need / busy
