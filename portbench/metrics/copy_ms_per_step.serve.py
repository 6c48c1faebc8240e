"""Device milliseconds of the copy and cast kernels a decode step of the
continuous server (the paged step's K/V windows widened to fp32, the
casts, gathers and scatters), from the profile of a burst served right
after the window over the steps it took."""


def read(out, ctx):
    prof = out.profile
    steps = sum(st.get("decode_steps", 0) for st in out.traced)
    if not prof or not steps or prof["groups"].get("copy", 0.0) <= 0.0:
        return None
    return 1e3 * prof["groups"]["copy"] / steps
