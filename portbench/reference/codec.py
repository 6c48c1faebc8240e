"""The watermarked EnCodec in plain PyTorch: SEANet encoder and decoder
(weight-normed 1-D convolutions with EnCodec's non-causal padding, ELU
residual blocks, a two-layer LSTM with a skip, written out step by step),
the residual vector quantizer, and the watermark decoder of SSR-Speech
(the skip encoder's taps fused with a label embedding into each decoder
stage, then the watermark encoder and its predictor).

Layouts are those of ``lib/weights.py``: activations [B, T, C], conv
weights [K, Cin, Cout]. ``tf32=True`` is the control: every product of the
codec in TF32 where the configuration states fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import List

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32: bool):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def weight(p) -> torch.Tensor:
    """w = g * v / ||v|| (the norm over the axes the gain does not span)."""
    if "w" in p:
        return p["w"]
    v, g = p["v"], p["g"]
    axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
    return g * v / torch.sqrt(v.square().sum(dim=axes, keepdim=True) + 1e-12)


def conv(p, x, stride=1, dilation=1):
    """EnCodec's streamable conv, non-causal: the padding split around the
    input, plus the right padding that makes the last window whole."""
    w = weight(p)
    k = w.shape[0]
    eff = (k - 1) * dilation + 1
    total = eff - stride
    n = x.shape[1]
    frames = (n - eff + total) / stride + 1
    extra = (math.ceil(frames) - 1) * stride + (eff - total) - n
    right = total // 2
    xt = F.pad(x.transpose(1, 2), (total - right, right + extra))
    y = F.conv1d(xt, w.permute(2, 1, 0), p["b"], stride=stride,
                 dilation=dilation)
    return y.transpose(1, 2)


def conv_up(p, x, stride):
    """Transposed conv of the [K, Cin, Cout] time-flipped kernel, then the
    fixed trim of k - stride samples, split as the padding is."""
    w = weight(p)
    k = w.shape[0]
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0),
                           p["b"], stride=stride).transpose(1, 2)
    total = k - stride
    right = total // 2
    return y[:, total - right:y.shape[1] - right]


def lstm(p, x):
    """Stacked LSTM, gates (i, f, g, o), zero initial state, plus the
    input: y = LSTM(x) + x."""
    h_in = x
    for lp in p["layers"]:
        B, T, _ = h_in.shape
        H = lp["whh"].shape[1]
        gx = h_in @ lp["wih"].T + lp["bih"] + lp["bhh"]  # [B, T, 4H]
        h = h_in.new_zeros(B, H)
        c = h_in.new_zeros(B, H)
        outs = []
        for t in range(T):
            g = gx[:, t] + h @ lp["whh"].T
            i, f, gg, o = g.split(H, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        h_in = torch.stack(outs, 1)
    return h_in + x


def resblock(p, x, dilation):
    h = conv(p["conv1"], F.elu(x), dilation=dilation)
    return x + conv(p["conv2"], F.elu(h))


def encode(p, x, c, taps: bool = False):
    """[B, T, 1] -> latents [B, T / hop, dim] (and the taps after each
    group's residual blocks, then the latent)."""
    h = conv(p["conv_in"], x)
    out: List[torch.Tensor] = []
    for g, ratio in zip(p["groups"], reversed(c["ratios"])):
        for j, rp in enumerate(g["res"]):
            h = resblock(rp, h, c["dilation_base"] ** j)
        out.append(h)
        h = conv(g["down"], F.elu(h), stride=ratio)
    if "lstm" in p:
        h = lstm(p["lstm"], h)
    h = conv(p["conv_out"], F.elu(h))
    return (h, out + [h]) if taps else h


def _res(p, h, c):
    for j, rp in enumerate(p["res"]):
        h = resblock(rp, h, c["dilation_base"] ** j)
    return h


def quantize(embed, z, n_q):
    """Residual VQ: at each stage the nearest codeword by squared distance
    (first on ties). Returns codes [B, n_q, F]."""
    residual, codes = z, []
    for k in range(n_q):
        d = (residual.square().sum(-1, keepdim=True)
             - 2 * residual @ embed[k].T + embed[k].square().sum(-1))
        idx = d.argmin(-1)
        codes.append(idx)
        residual = residual - embed[k][idx]
    return torch.stack(codes, 1)


def code_gap(embed, z, codes):
    """How far the chosen codewords lie beyond the nearest, the residual
    taken after the chosen codewords of the earlier stages: the sum over
    frames and stages of d(chosen) - d(nearest), squared distances, over
    the sum of the residuals' squared norms. ``z`` [B, F, D] the reference's
    latents, ``codes`` [B, n_q, F] the codes judged. 0 where every code is
    the nearest."""
    residual, excess, norm = z, 0.0, 0.0
    for k in range(codes.shape[1]):
        d = (residual.square().sum(-1, keepdim=True)
             - 2 * residual @ embed[k].T + embed[k].square().sum(-1))
        chosen = d.gather(-1, codes[:, k][..., None])[..., 0]
        excess += float((chosen - d.min(-1).values).sum())
        norm += float(residual.square().sum())
        residual = residual - embed[k][codes[:, k]]
    return excess / max(norm, 1e-30)


def dequantize(embed, codes):
    idx = codes.clamp(0, embed.shape[1] - 1)
    return sum(embed[k][idx[:, k]] for k in range(codes.shape[1]))


def wm_decode(p, latents, labels, wave, c):
    """The watermark decode: returns (audio [B, T, 1], detector logits)."""
    ratios = c["ratios"]
    _, taps = encode(p["skip_encoder"], wave, c, taps=True)
    used = taps[1:]
    emb_w = p["wm_embed"]
    emb_w = emb_w * torch.clamp(
        1.0 / torch.sqrt(emb_w.square().sum(-1, keepdim=True) + 1e-12), max=1.0)
    dp = p["decoder"]
    x = latents
    for stage in range(len(ratios)):
        tap = used[len(ratios) - 1 - stage]
        rep = math.prod(ratios[:stage])
        lab = torch.repeat_interleave(labels, rep, dim=1) if rep > 1 else labels
        fused = conv(p["projs"][stage]["conv"],
                     F.elu(torch.cat([tap, emb_w[lab]], -1))) + x
        if stage == 0:
            h = conv(dp["conv_in"], fused)
            if "lstm" in dp:
                h = lstm(dp["lstm"], h)
        else:
            h = _res(dp["groups"][stage - 1], fused, c)
        x = conv_up(dp["groups"][stage]["up"], F.elu(h), ratios[stage])
    x = _res(dp["groups"][-1], x, c)
    audio = conv(dp["conv_out"], F.elu(x))
    m = encode(p["wm_encoder"], audio, c)
    return audio, conv(p["predictor"]["conv"], F.elu(m))
