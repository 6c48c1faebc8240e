"""1-D conv primitives of the SEANet codec with the streamable padding rules
(port of ``ssr_speech_tpu/models/codec/conv.py``).

Public layouts are the JAX package's: activations [B, T, C], conv weights
[K, Cin, Cout]. Each call transposes to torch's [B, C, T] / [Cout, Cin, K]
around ``torch.nn.functional`` (cuDNN on the card;
``device.set_precision_policy`` turns its TF32 off, so fp32 convs stay fp32).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ...utils import prng


def _uniform(key, shape, bound):
    return prng.uniform(key, shape, -bound, bound)


def init_conv(key, kernel: int, cin: int, cout: int, weight_norm: bool = True
              ) -> Dict[str, torch.Tensor]:
    """torch Conv1d default init on [K, Cin, Cout], JAX's draw from the
    threefry ``key`` (on its device); with weight norm the gain is per
    output channel, stored as [1, 1, Cout]."""
    kw, kb = prng.split(key)
    bound = 1.0 / math.sqrt(cin * kernel)
    w = _uniform(kw, (kernel, cin, cout), bound)
    b = _uniform(kb, (cout,), bound)
    if weight_norm:
        return dict(v=w, g=w.square().sum(dim=(0, 1), keepdim=True).sqrt(), b=b)
    return dict(w=w, b=b)


def init_conv_transpose(key, kernel: int, cin: int, cout: int,
                        weight_norm: bool = True) -> Dict[str, torch.Tensor]:
    """Transposed-conv weights in the JAX [K, Cin, Cout] pre-flipped layout,
    JAX's draw from ``key``; with weight norm the gain is per input channel,
    stored as [1, Cin, 1]."""
    kw, kb = prng.split(key)
    bound = 1.0 / math.sqrt(cin * kernel)
    w = _uniform(kw, (kernel, cin, cout), bound)
    b = _uniform(kb, (cout,), bound)
    if weight_norm:
        return dict(v=w, g=w.square().sum(dim=(0, 2), keepdim=True).sqrt(), b=b)
    return dict(w=w, b=b)


def conv_weight(p) -> torch.Tensor:
    """w = g * v / ||v||, the norm taken over every axis where g has extent 1
    (both torch weight_norm conventions), with 1e-12 inside the sqrt."""
    if "v" in p:
        v, g = p["v"], p["g"]
        axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
        norm = torch.sqrt(v.square().sum(dim=axes, keepdim=True) + 1e-12)
        return g * v / norm
    return p["w"]


def extra_padding_for_conv(length: int, eff_kernel: int, stride: int,
                           padding_total: int) -> int:
    """Right padding so the final window is full."""
    n_frames = (length - eff_kernel + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (eff_kernel - padding_total)
    return ideal - length


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad along time (axis 1 of [B, T, C]). Reflect on inputs shorter than
    the pad zero-extends first, then drops the extension."""
    if left == 0 and right == 0:
        return x
    xt = x.transpose(1, 2)  # [B, C, T]
    if mode == "reflect":
        length = xt.shape[-1]
        max_pad = max(left, right)
        extra = 0
        if length <= max_pad:
            extra = max_pad - length + 1
            xt = F.pad(xt, (0, extra))
        out = F.pad(xt, (left, right), mode="reflect")
        out = out[..., :out.shape[-1] - extra]
    else:
        out = F.pad(xt, (left, right))
    return out.transpose(1, 2)


def conv1d(p, x: torch.Tensor, stride: int = 1, dilation: int = 1,
           causal: bool = False, pad_mode: str = "constant") -> torch.Tensor:
    """StreamableConv1d forward. x: [B, T, C] -> [B, T', Cout]."""
    w = conv_weight(p).to(x.dtype)
    k = w.shape[0]
    eff_k = (k - 1) * dilation + 1
    padding_total = eff_k - stride
    extra = extra_padding_for_conv(x.shape[1], eff_k, stride, padding_total)
    if causal:
        x = _pad1d(x, padding_total, extra, pad_mode)
    else:
        right = padding_total // 2
        x = _pad1d(x, padding_total - right, right + extra, pad_mode)
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), p["b"].to(x.dtype),
                 stride=stride, dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(p, x: torch.Tensor, stride: int, causal: bool = False,
                     trim_right_ratio: float = 1.0) -> torch.Tensor:
    """StreamableConvTranspose1d forward. JAX runs an lhs-dilated conv with
    the time-flipped [K, Cin, Cout] kernel; ``F.conv_transpose1d`` takes the
    same kernel unflipped as [Cin, Cout, K]. Then the fixed-padding trim."""
    w = conv_weight(p).to(x.dtype)
    k = w.shape[0]
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0),
                           p["b"].to(x.dtype), stride=stride).transpose(1, 2)
    padding_total = k - stride
    if causal:
        right = math.ceil(padding_total * trim_right_ratio)
    else:
        right = padding_total // 2
    left = padding_total - right
    return y[:, left:y.shape[1] - right]


def init_lstm(key, dim: int, num_layers: int):
    """torch nn.LSTM default init: U(-1/sqrt(H), 1/sqrt(H)) on all tensors,
    JAX's draw from ``key`` (five keys a layer, the last carried on)."""
    bound = 1.0 / math.sqrt(dim)
    layers = []
    for _ in range(num_layers):
        k1, k2, k3, k4, key = prng.split(key, 5)
        layers.append(dict(
            wih=_uniform(k1, (4 * dim, dim), bound),
            whh=_uniform(k2, (4 * dim, dim), bound),
            bih=_uniform(k3, (4 * dim,), bound),
            bhh=_uniform(k4, (4 * dim,), bound)))
    return dict(layers=layers)


def lstm_skip(p, x: torch.Tensor) -> torch.Tensor:
    """StreamableLSTM with residual skip: y = LSTM(x) + x on [B, T, C].
    The JAX weights are torch's own layout and gate order (i, f, g, o), so
    they feed ``torch.lstm`` (cuDNN on the card) as they are, cast to the
    activations' dtype as JAX casts them. Under autograd the call runs in
    train mode (the dropout is 0, so the numbers are the same), which
    cuDNN's backward requires."""
    layers = list(p["layers"])
    weights = []
    for lp in layers:
        weights += [lp[k].to(x.dtype) for k in ("wih", "whh", "bih", "bhh")]
    hidden = layers[0]["whh"].shape[1]
    h0 = x.new_zeros((len(layers), x.shape[0], hidden))
    y, _, _ = torch.lstm(x, (h0, h0), weights, True, len(layers), 0.0,
                         torch.is_grad_enabled(), False, True)
    return y + x
