"""Distinct routed experts a MoE layer reads a step, the mean over the
window's steps and the layers: the server's device-side routing counter
(``stats["expert_steps"]`` [layers, experts]: the steps in which each
expert took a token) over its ``decode_steps``. None where the server keeps
no such counter."""


def read(out, ctx):
    st = out.extra.get("stats") or {}
    if "expert_steps" not in st or not st.get("decode_steps"):
        return None
    return float(st["expert_steps"].sum(1).mean()) / st["decode_steps"]
