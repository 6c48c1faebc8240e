"""The codec GAN's discriminators (port of
``ssr_speech_tpu/training/discriminators.py``): the multi-scale STFT
discriminator (MS-STFT), the multi-scale waveform discriminator (MSD) and
the multi-period discriminator (MPD).

Layouts are torch's: activations NCHW (NCW for MSD), weight-normed conv
weights ``v`` OIHW (OIW) with the gain ``g`` per output channel as
[Cout, 1, 1, 1] ([Cout, 1, 1]). JAX stores HWIO / WIO with ``g`` as
[1, 1, 1, Cout]; :func:`conv_from_jax` and :func:`conv_to_jax` carry a tree
across either way. The feature maps come out in the port's layout
(:func:`msstftd_forward` gives [B, C, frames, freq], where JAX gives
[B, frames, freq, C]).

The STFT runs in fp32; the conv stack follows the activation dtype, with
the weight-norm arithmetic in fp32 and the weights cast at use.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stft as stft_ops
from ..utils import prng

Params = Dict[str, Any]

N_FFTS = (1024, 2048, 512, 256, 128)
HOPS = (256, 512, 128, 64, 32)
LEAKY_SLOPE = 0.3
MPD_PERIODS = (2, 3, 5, 7, 11)


def _init_wn(key, jax_shape, fan_in: int) -> Params:
    """Weight-normed conv of torch's default init, JAX's draw from the
    threefry ``key``: v (in JAX's HWIO / WIO layout, moved to OIHW / OIW)
    and b uniform in +-1/sqrt(fan_in), g = ||v|| per output channel."""
    kkey, bkey = prng.split(key)
    bound = 1.0 / math.sqrt(fan_in)
    w = prng.uniform(kkey, jax_shape, -bound, bound)
    n = w.dim()
    v = w.permute((n - 1, n - 2) + tuple(range(n - 2))).contiguous()
    g = v.square().sum(dim=tuple(range(1, n)), keepdim=True).sqrt()
    return dict(v=v, g=g, b=prng.uniform(bkey, (jax_shape[-1],), -bound, bound))


def _init_conv2d(key, cin, cout, kh, kw) -> Params:
    return _init_wn(key, (kh, kw, cin, cout), cin * kh * kw)


def _init_conv1d(key, cin, cout, k, groups=1) -> Params:
    return _init_wn(key, (k, cin // groups, cout), (cin // groups) * k)


def _wn_weight(p: Params, dtype: torch.dtype) -> torch.Tensor:
    v, g = p["v"], p["g"]
    dims = tuple(range(1, v.dim()))
    norm = torch.sqrt(v.square().sum(dim=dims, keepdim=True) + 1e-12)
    return (g * v / norm).to(dtype)


def _conv2d(p: Params, x: torch.Tensor, stride=(1, 1),
            dilation=(1, 1)) -> torch.Tensor:
    """x [B, C, H, W]; 'same'-style padding of the reference's
    get_2d_padding."""
    w = _wn_weight(p, x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    pad = (((kh - 1) * dilation[0]) // 2, ((kw - 1) * dilation[1]) // 2)
    return F.conv2d(x, w, p["b"].to(x.dtype), stride=stride, padding=pad,
                    dilation=dilation)


def _conv1d_wn(p: Params, x: torch.Tensor, stride=1, padding=0,
               groups: int = 1) -> torch.Tensor:
    """x [B, C, T], weight-normed grouped conv1d."""
    return F.conv1d(x, _wn_weight(p, x.dtype), p["b"].to(x.dtype),
                    stride=stride, padding=padding, groups=groups)


def conv_from_jax(tree, device="cpu"):
    """A JAX discriminator tree (numpy or torch leaves) in the port's
    layout: every ``{v, g, b}`` conv's HWIO / WIO ``v`` and trailing ``g``
    moved to OIHW / OIW and a leading ``g``. Also maps optimizer moments,
    which have the parameters' shapes."""
    if isinstance(tree, dict):
        if set(tree) == {"v", "g", "b"}:
            t = lambda a: torch.as_tensor(np.array(a)).to(device)
            v, g = t(tree["v"]), t(tree["g"])
            n = v.dim()  # HWIO -> OIHW, WIO -> OIW
            perm = (n - 1, n - 2) + tuple(range(n - 2))
            return dict(v=v.permute(perm).contiguous(),
                        g=g.permute(perm).contiguous(), b=t(tree["b"]))
        return {k: conv_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(conv_from_jax(x, device) for x in tree)
    return tree


def conv_to_jax(tree):
    """Inverse of :func:`conv_from_jax`, as numpy arrays (copies)."""
    if isinstance(tree, dict):
        if set(tree) == {"v", "g", "b"}:
            n = tree["v"].dim()
            perm = tuple(range(2, n)) + (1, 0)  # OIHW -> HWIO
            a = lambda t: t.detach().cpu().numpy().copy()
            return dict(v=a(tree["v"].permute(perm)),
                        g=a(tree["g"].permute(perm)), b=a(tree["b"]))
        return {k: conv_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(conv_to_jax(x) for x in tree)
    return tree


# -------------------------------------------------------------------- MS-STFT

def init_msstftd(key, filters: int = 32, in_channels: int = 1,
                 max_filters: int = 1024, dilations=(1, 2, 4),
                 n_scales: int = len(N_FFTS), device="cpu") -> Params:
    """``n_scales`` < 5 keeps the first N scales of the shipped n_fft list;
    the forward follows the number of sub-discriminators. JAX's draw from
    the threefry ``key``, on ``device``."""
    subs = []
    for sk in prng.split(key.to(device), n_scales):
        ks = prng.split(sk, len(dilations) + 3)
        convs = [_init_conv2d(ks[0], 2 * in_channels, filters, 3, 9)]
        in_chs = min(filters, max_filters)
        for i, _ in enumerate(dilations):
            out_chs = min(filters, max_filters)
            convs.append(_init_conv2d(ks[1 + i], in_chs, out_chs, 3, 9))
            in_chs = out_chs
        convs.append(_init_conv2d(ks[-2], in_chs, in_chs, 3, 3))
        subs.append(dict(convs=convs,
                         post=_init_conv2d(ks[-1], in_chs, 1, 3, 3)))
    return dict(subs=subs)


def _sub_forward(sub: Params, x: torch.Tensor, n_fft: int, hop: int,
                 dilations=(1, 2, 4)) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x [B, T] -> (logits [B, 1, frames, freq'], fmaps)."""
    spec = stft_ops.stft(x.float(), n_fft, hop, normalized=True)
    z = torch.stack([spec.real, spec.imag], dim=1)  # [B, 2, freq, frames]
    h = z.transpose(2, 3).to(x.dtype)  # [B, 2, frames, freq]
    fmaps = []
    h = F.leaky_relu(_conv2d(sub["convs"][0], h), LEAKY_SLOPE)
    fmaps.append(h)
    for i, d in enumerate(dilations):
        h = F.leaky_relu(_conv2d(sub["convs"][1 + i], h, stride=(1, 2),
                                 dilation=(d, 1)), LEAKY_SLOPE)
        fmaps.append(h)
    h = F.leaky_relu(_conv2d(sub["convs"][-1], h), LEAKY_SLOPE)
    fmaps.append(h)
    return _conv2d(sub["post"], h), fmaps


def msstftd_forward(params: Params, wav: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
    """wav [B, T, C] or [B, T] -> (per-scale logits, per-scale fmaps)."""
    x = wav[..., 0] if wav.dim() == 3 else wav
    logits, fmaps = [], []
    for sub, n_fft, hop in zip(params["subs"], N_FFTS, HOPS):
        lg, fm = _sub_forward(sub, x, n_fft, hop)
        logits.append(lg)
        fmaps.append(fm)
    return logits, fmaps


# ------------------------------------------------------------------ MSD / MPD

def _msd_layout(filters=16, max_filters=1024, downsample_scales=(4, 4, 4, 4),
                kernel_sizes=(5, 3)):
    """Static (cin, cout, k, stride, pad, groups) per layer of one scale."""
    k0 = int(np.prod(kernel_sizes))
    layers = [(1, filters, k0, 1, (k0 - 1) // 2, 1)]
    in_chs = filters
    for scale in downsample_scales:
        out_chs = min(in_chs * scale, max_filters)
        k = scale * 10 + 1
        layers.append((in_chs, out_chs, k, scale, (k - 1) // 2, in_chs // 4))
        in_chs = out_chs
    out_chs = min(in_chs * 2, max_filters)
    layers.append((in_chs, out_chs, kernel_sizes[0], 1,
                   (kernel_sizes[0] - 1) // 2, 1))
    post = (out_chs, 1, kernel_sizes[1], 1, (kernel_sizes[1] - 1) // 2, 1)
    return layers, post


def init_msd(key, n_scales: int = 3, device="cpu") -> Params:
    """Multi-scale waveform discriminator (filters 16, inner groups cin // 4,
    downsample scales 4, 4, 4, 4), JAX's draw from ``key``."""
    layers, post = _msd_layout()
    subs = []
    for sk in prng.split(key.to(device), n_scales):
        ks = prng.split(sk, len(layers) + 1)
        convs = [_init_conv1d(ks[i], cin, cout, k, groups=gr)
                 for i, (cin, cout, k, _, _, gr) in enumerate(layers)]
        subs.append(dict(convs=convs, post=_init_conv1d(
            ks[-1], post[0], post[1], post[2])))
    return dict(subs=subs)


def msd_forward(params: Params, wav: torch.Tensor):
    """wav [B, T, C]; scale i sees the waveform average-pooled i times
    (window 4, stride 2, zero padding 2). Feature maps are [B, C, T']."""
    layers, post = _msd_layout()
    x = (wav if wav.dim() == 3 else wav[..., None]).transpose(1, 2)
    logits, fmaps = [], []
    for i, sub in enumerate(params["subs"]):
        if i > 0:
            x = F.avg_pool1d(x, 4, 2, padding=2)
        h = x
        fm = []
        for p, (_, _, _, stride, pad, gr) in zip(sub["convs"], layers):
            h = F.leaky_relu(_conv1d_wn(p, h, stride, pad, gr), 0.2)
            fm.append(h)
        lg = _conv1d_wn(sub["post"], h, post[3], post[4])
        fm.append(lg)
        logits.append(lg)
        fmaps.append(fm)
    return logits, fmaps


def init_mpd(key, periods=MPD_PERIODS, n_layers: int = 5, kernel_sizes=(5, 3),
             filters: int = 8, filters_scale: int = 4, max_filters: int = 1024,
             device="cpu") -> Params:
    """Multi-period discriminator (filters 8, scale 4, 5 layers), JAX's
    draw from ``key``."""
    subs = []
    for sk in prng.split(key.to(device), len(periods)):
        ks = prng.split(sk, n_layers + 1)
        convs = []
        in_chs = 1
        for i in range(n_layers):
            out_chs = min(filters * (filters_scale ** (i + 1)), max_filters)
            convs.append(_init_conv2d(ks[i], in_chs, out_chs, kernel_sizes[0], 1))
            in_chs = out_chs
        subs.append(dict(convs=convs, post=_init_conv2d(
            ks[-1], in_chs, 1, kernel_sizes[1], 1)))
    return dict(subs=subs)


def mpd_forward(params: Params, wav: torch.Tensor, periods=MPD_PERIODS,
                stride: int = 3):
    """wav [B, T, C] -> per-period logits and fmaps: the signal folded to
    [B, 1, T/period, period]; the last conv layer has stride 1."""
    x0 = wav[..., 0] if wav.dim() == 3 else wav
    logits, fmaps = [], []
    for period, sub in zip(periods, params["subs"]):
        b, t = x0.shape
        n_pad = (period - t % period) % period
        x = F.pad(x0, (0, n_pad), mode="reflect") if n_pad else x0
        h = x.reshape(b, 1, -1, period)
        fm = []
        n = len(sub["convs"])
        for i, p in enumerate(sub["convs"]):
            eff_stride = 1 if i == n - 1 else stride
            h = F.leaky_relu(_conv2d(p, h, stride=(eff_stride, 1)), 0.2)
            fm.append(h)
        lg = _conv2d(sub["post"], h)
        fm.append(lg)
        logits.append(lg)
        fmaps.append(fm)
    return logits, fmaps


def get_adversary(name: str, key, device="cpu", **kwargs):
    """(params, forward) of the named adversary, drawn from ``key``."""
    if name == "msstftd":
        return init_msstftd(key, device=device, **kwargs), msstftd_forward
    if name == "msd":
        return init_msd(key, device=device, **kwargs), msd_forward
    if name == "mpd":
        return init_mpd(key, device=device, **kwargs), mpd_forward
    raise ValueError(name)
