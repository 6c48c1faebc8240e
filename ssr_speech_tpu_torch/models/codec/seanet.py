"""SEANet encoder/decoder and the watermark decoder/detector (port of
``ssr_speech_tpu/models/codec/seanet.py``). Layout [B, T, C]; stages are
explicit, and the encoder can return the taps the watermark decoder fuses.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ...config import SEANetConfig
from ...utils import prng

from . import conv as cv


def act(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)  # alpha = 1.0


def init_resblock(key, dim: int, cfg: SEANetConfig, norm: bool):
    hidden = dim // cfg.compress
    k1, k2 = prng.split(key)
    return dict(
        conv1=cv.init_conv(k1, cfg.residual_kernel_size, dim, hidden,
                           weight_norm=norm),
        conv2=cv.init_conv(k2, 1, hidden, dim, weight_norm=norm))


def resblock(p, x: torch.Tensor, cfg: SEANetConfig, dilation: int) -> torch.Tensor:
    """[ELU, dilated conv k3, ELU, conv k1] + identity skip."""
    h = cv.conv1d(p["conv1"], act(x), dilation=dilation, causal=cfg.causal,
                  pad_mode=cfg.pad_mode)
    h = cv.conv1d(p["conv2"], act(h), causal=cfg.causal, pad_mode=cfg.pad_mode)
    return x + h


def _key_iter(key, n_ratios: int, cfg: SEANetConfig):
    """JAX's key list of an encoder or decoder: one a conv, res-block and
    LSTM in draw order."""
    return iter(prng.split(key, 3 + n_ratios * (cfg.n_residual_layers + 1)))


def init_encoder(key, cfg: SEANetConfig):
    ratios = list(reversed(cfg.ratios))
    n_blocks = len(ratios) + 2
    wn = cfg.norm == "weight_norm"

    def blk_norm(i):  # block index, 1 = conv-in
        return wn and not (cfg.disable_norm_outer_blocks >= i)

    ki = _key_iter(key, len(ratios), cfg)
    mult = 1
    params = dict(conv_in=cv.init_conv(next(ki), cfg.kernel_size, cfg.channels,
                                       cfg.n_filters, weight_norm=blk_norm(1)),
                  groups=[])
    for i, ratio in enumerate(ratios):
        norm = blk_norm(i + 2)
        res = [init_resblock(next(ki), mult * cfg.n_filters, cfg, norm)
               for _ in range(cfg.n_residual_layers)]
        down = cv.init_conv(next(ki), ratio * 2, mult * cfg.n_filters,
                            mult * cfg.n_filters * 2, weight_norm=norm)
        params["groups"].append(dict(res=res, down=down))
        mult *= 2
    if cfg.lstm:
        params["lstm"] = cv.init_lstm(next(ki), mult * cfg.n_filters, cfg.lstm)
    params["conv_out"] = cv.init_conv(
        next(ki), cfg.last_kernel_size, mult * cfg.n_filters, cfg.dimension,
        weight_norm=wn and cfg.disable_norm_outer_blocks != n_blocks)
    return params


def encode(p, x: torch.Tensor, cfg: SEANetConfig, return_taps: bool = False):
    """x [B, T, 1] -> latents [B, T/hop, dimension]; with ``return_taps``
    also the activations after each group's res-blocks (before its down-conv)
    and, last, the latent."""
    h = cv.conv1d(p["conv_in"], x, causal=cfg.causal, pad_mode=cfg.pad_mode)
    taps: List[torch.Tensor] = []
    enc_ratios = list(reversed(cfg.ratios))
    for i, g in enumerate(p["groups"]):
        for j, rp in enumerate(g["res"]):
            h = resblock(rp, h, cfg, cfg.dilation_base ** j)
        if return_taps:
            taps.append(h)
        h = cv.conv1d(g["down"], act(h), stride=enc_ratios[i],
                      causal=cfg.causal, pad_mode=cfg.pad_mode)
    if "lstm" in p:
        h = cv.lstm_skip(p["lstm"], h)
    h = cv.conv1d(p["conv_out"], act(h), causal=cfg.causal, pad_mode=cfg.pad_mode)
    if return_taps:
        taps.append(h)
        return h, taps
    return h


def init_decoder(key, cfg: SEANetConfig):
    n_blocks = len(cfg.ratios) + 2
    wn = cfg.norm == "weight_norm"

    def blk_norm_up(i):  # i-th up-stage; norm off for the last N blocks
        return wn and not (cfg.disable_norm_outer_blocks >= n_blocks - (i + 1))

    ki = _key_iter(key, len(cfg.ratios), cfg)
    mult = int(2 ** len(cfg.ratios))
    params = dict(conv_in=cv.init_conv(
        next(ki), cfg.kernel_size, cfg.dimension, mult * cfg.n_filters,
        weight_norm=wn and cfg.disable_norm_outer_blocks != n_blocks),
        groups=[])
    if cfg.lstm:
        params["lstm"] = cv.init_lstm(next(ki), mult * cfg.n_filters, cfg.lstm)
    for i, ratio in enumerate(cfg.ratios):
        norm = blk_norm_up(i)
        up = cv.init_conv_transpose(next(ki), ratio * 2, mult * cfg.n_filters,
                                    mult * cfg.n_filters // 2, weight_norm=norm)
        res = [init_resblock(next(ki), mult * cfg.n_filters // 2, cfg, norm)
               for _ in range(cfg.n_residual_layers)]
        params["groups"].append(dict(up=up, res=res))
        mult //= 2
    params["conv_out"] = cv.init_conv(
        next(ki), cfg.last_kernel_size, cfg.n_filters, cfg.channels,
        weight_norm=wn and cfg.disable_norm_outer_blocks < 1)
    return params


def _up(g, h, cfg: SEANetConfig, i: int) -> torch.Tensor:
    return cv.conv_transpose1d(g["up"], act(h), stride=cfg.ratios[i],
                               causal=cfg.causal,
                               trim_right_ratio=cfg.trim_right_ratio)


def _decoder_stage0(p, z: torch.Tensor, cfg: SEANetConfig) -> torch.Tensor:
    """conv-in [+ LSTM] + first up-conv."""
    h = cv.conv1d(p["conv_in"], z, causal=cfg.causal, pad_mode=cfg.pad_mode)
    if "lstm" in p:
        h = cv.lstm_skip(p["lstm"], h)
    return _up(p["groups"][0], h, cfg, 0)


def _decoder_stage(p, h: torch.Tensor, i: int, cfg: SEANetConfig) -> torch.Tensor:
    """res-blocks of group i-1, then up-conv of group i."""
    for j, rp in enumerate(p["groups"][i - 1]["res"]):
        h = resblock(rp, h, cfg, cfg.dilation_base ** j)
    return _up(p["groups"][i], h, cfg, i)


def _decoder_tail(p, h: torch.Tensor, cfg: SEANetConfig) -> torch.Tensor:
    """last group's res-blocks + ELU + conv-out (+ tanh)."""
    for j, rp in enumerate(p["groups"][len(cfg.ratios) - 1]["res"]):
        h = resblock(rp, h, cfg, cfg.dilation_base ** j)
    h = cv.conv1d(p["conv_out"], act(h), causal=cfg.causal, pad_mode=cfg.pad_mode)
    if cfg.final_activation == "Tanh":
        h = torch.tanh(h)
    return h


def decode(p, z: torch.Tensor, cfg: SEANetConfig) -> torch.Tensor:
    """z [B, T/hop, dimension] -> waveform [B, T, channels]."""
    h = _decoder_stage0(p, z, cfg)
    for i in range(1, len(cfg.ratios)):
        h = _decoder_stage(p, h, i, cfg)
    return _decoder_tail(p, h, cfg)


def init_wm_decoder(key, cfg: SEANetConfig):
    """Decoder + skip/wm encoders + label embedding + fusion projections,
    JAX's draw from ``key`` (ten keys, as JAX splits them)."""
    dim, nf = cfg.dimension, cfg.n_filters
    emb_dim = dim // 16
    n_up = len(cfg.ratios)
    ks = prng.split(key, 10)
    params = dict(
        decoder=init_decoder(ks[0], cfg),
        skip_encoder=init_encoder(ks[1], cfg),
        wm_encoder=init_encoder(ks[2], cfg),
        wm_embed=prng.normal(ks[3], (2, emb_dim)))
    mult = int(2 ** n_up)
    params["projs"] = [dict(conv=cv.init_conv(ks[4], 1, dim + emb_dim, dim,
                                              weight_norm=False))]
    for i in range(1, n_up):
        mult //= 2
        params["projs"].append(dict(conv=cv.init_conv(
            ks[4 + i], 1, mult * nf + emb_dim, mult * nf, weight_norm=False)))
    params["predictor"] = dict(conv=cv.init_conv(ks[8], 1, dim, 2,
                                                 weight_norm=False))
    return params


def _wm_embed(p, labels: torch.Tensor) -> torch.Tensor:
    """Label embedding with torch ``max_norm=True`` semantics: rows
    renormalised to unit max-norm at lookup."""
    w = p["wm_embed"]
    norm = torch.sqrt(w.square().sum(dim=-1, keepdim=True) + 1e-12)
    w = w * torch.clamp(1.0 / norm, max=1.0)
    return w[labels]


def _proj(pp, x: torch.Tensor, cfg: SEANetConfig) -> torch.Tensor:
    return cv.conv1d(pp["conv"], act(x), causal=cfg.causal, pad_mode=cfg.pad_mode)


def wm_decode(p, latents: torch.Tensor, labels: torch.Tensor,
              waveform: torch.Tensor, cfg: SEANetConfig):
    """Watermark decode: tap the skip encoder on the masked original
    ``waveform`` [B, T, C] at each decoder resolution, fuse each tap with the
    per-frame labels [B, F] (repeated to that resolution) through a 1x1 conv,
    add it into the decoder stage, then run the detector on the audio.
    Returns (audio [B, T, C], logits [B, F, 2])."""
    n_up = len(cfg.ratios)
    _, taps = encode(p["skip_encoder"], waveform, cfg, return_taps=True)
    used = taps[1:]  # the full-rate tap is not fused
    x = latents
    dp = p["decoder"]
    for stage in range(n_up):
        tap = used[n_up - 1 - stage]  # deepest tap first
        rep = 1
        for r in cfg.ratios[:stage]:
            rep *= r
        lab = torch.repeat_interleave(labels, rep, dim=1) if rep > 1 else labels
        emb = _wm_embed(p, lab)
        fused = torch.cat([tap, emb.to(tap.dtype)], dim=-1)
        fused = _proj(p["projs"][stage], fused, cfg) + x
        if stage == 0:
            x = _decoder_stage0(dp, fused, cfg)
        else:
            x = _decoder_stage(dp, fused, stage, cfg)
            if stage == n_up - 1:
                x = _decoder_tail(dp, x, cfg)
    audio = x
    m = encode(p["wm_encoder"], audio, cfg)
    return audio, _proj(p["predictor"], m, cfg)


def detect_watermark_logits(p, audio: torch.Tensor, cfg: SEANetConfig) -> torch.Tensor:
    """Detector head on arbitrary audio [B, T, C] -> logits [B, F, 2]."""
    return _proj(p["predictor"], encode(p["wm_encoder"], audio, cfg), cfg)
