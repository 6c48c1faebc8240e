"""Device milliseconds of the convolution kernels (cuDNN) a batch of the
encode cell, from the profile of the batches traced after the window."""


def read(out, ctx):
    prof = out.profile
    n = len(out.traced)
    if not prof or not n or prof["groups"].get("convolution", 0.0) <= 0.0:
        return None
    return 1e3 * prof["groups"]["convolution"] / n
