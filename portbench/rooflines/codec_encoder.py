"""The codec's encoder (``models/codec/seanet.py::encode`` and the RVQ of
``quantize.py``) over one waveform of ``samples`` samples: the operations it
needs (multiply-adds counted as 2).

Convolutions: 2 * k * Cin * Cout per output sample of each conv at its
rate; the LSTM: 2 * 4H * (In + H) a frame a layer (the gates' two
products; the activations are not counted); the RVQ: 2 * bins * dim a
frame a stage for the distances."""

from __future__ import annotations

import math


def flops(codec: dict, samples: int) -> int:
    c, q = codec["seanet"], codec["rvq"]
    nf = c["n_filters"]
    t = samples
    total = 2 * c["kernel_size"] * c["channels"] * nf * t
    mult = 1
    for ratio in reversed(c["ratios"]):
        dim = mult * nf
        hidden = dim // c["compress"]
        total += c["n_residual_layers"] * 2 * t * (
            c["residual_kernel_size"] * dim * hidden + hidden * dim)
        t = math.ceil(t / ratio)
        total += 2 * t * (2 * ratio) * dim * (2 * dim)
        mult *= 2
    dim = mult * nf
    total += c["lstm"] * 2 * t * 4 * dim * (dim + dim)
    total += 2 * t * c["last_kernel_size"] * dim * c["dimension"]
    total += q["n_q"] * 2 * t * q["bins"] * q["dimension"]
    return total
