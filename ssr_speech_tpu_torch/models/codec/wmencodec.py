"""Watermarked EnCodec: encode / decode / wmdecode / detect_watermark (port of
``ssr_speech_tpu/models/codec/wmencodec.py``). Waveforms are [B, T, C]; the
codec runs in fp32, as in JAX. ``params`` is a :class:`from_jax.WMEncodec`
(or any tree indexed like the JAX params). The four entry points run without
autograd; the codec trainer calls the ``seanet`` functions beneath them."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...config import CodecConfig

from . import quantize as q
from . import seanet


def init_wmencodec(gen: torch.Generator, cfg: CodecConfig, device="cpu"):
    """Random codec parameters with the JAX init's structure and
    distributions (a bundle-ready pytree of fp32 tensors on ``device``)."""
    return dict(
        encoder=seanet.init_encoder(gen, cfg.seanet, device),
        decoder=seanet.init_decoder(gen, cfg.seanet, device),
        wmdecoder=seanet.init_wm_decoder(gen, cfg.seanet, device),
        quantizer=q.init_rvq(gen, cfg.rvq, device))


def preprocess(wav: torch.Tensor, cfg: CodecConfig
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Optional volume renormalisation before the encoder: scale = 1e-8 +
    rms of the mono mix. Returns (wav, scale [B, 1] or None)."""
    if not cfg.renormalize:
        return wav, None
    if cfg.seanet.causal:
        raise ValueError("Causal model does not support renormalize")
    mono = wav.mean(dim=2, keepdim=True)
    volume = mono.square().mean(dim=1, keepdim=True).sqrt()
    scale = 1e-8 + volume  # [B, 1, 1]
    return wav / scale, scale[:, 0]


def postprocess(wav: torch.Tensor, scale: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Undo :func:`preprocess` on a decoded waveform [B, T, C]."""
    return wav if scale is None else wav * scale[:, :, None]


@torch.no_grad()
def encode(params, wav: torch.Tensor, cfg: CodecConfig):
    """wav [B, T, C] -> (codes [B, K, F], scale [B, 1] or None,
    latents [B, F, D])."""
    wav, scale = preprocess(wav, cfg)
    emb = seanet.encode(params["encoder"], wav, cfg.seanet)
    return q.rvq_encode(params["quantizer"], emb, cfg.rvq.n_q), scale, emb


@torch.no_grad()
def decode(params, codes: torch.Tensor, cfg: CodecConfig,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes [B, K, F] -> wav [B, F*hop, C]."""
    emb = q.rvq_decode(params["quantizer"], codes)
    return postprocess(seanet.decode(params["decoder"], emb, cfg.seanet), scale)


@torch.no_grad()
def wmdecode(params, codes: torch.Tensor, labels: torch.Tensor,
             waveform: torch.Tensor, cfg: CodecConfig,
             scale: Optional[torch.Tensor] = None):
    """Watermark decode of codes [B, K, F] with labels [B, F] (1 = generated)
    and the original waveform [B, F*hop, C] zeroed in the masked regions.
    Returns (wav [B, F*hop, C], detector logits [B, F, 2])."""
    emb = q.rvq_decode(params["quantizer"], codes)
    out, mark = seanet.wm_decode(params["wmdecoder"], emb, labels, waveform,
                                 cfg.seanet)
    return postprocess(out, scale), mark


@torch.no_grad()
def detect_watermark(params, wav: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """wav [B, T, C] -> per-frame watermark decision [B, F]."""
    logits = seanet.detect_watermark_logits(params["wmdecoder"], wav, cfg.seanet)
    return torch.argmax(logits, dim=-1)


def sample_watermark_mask(
    rng: np.random.Generator,
    batch: int,
    n_frames: int,
    hop: int,
    min_regions: int = 0,
    max_regions: int = 2,
    max_fraction: float = 0.8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side random watermark spans for codec training (a copy of the
    JAX package's numpy function): returns (labels [B, F] 0/1, audio keep
    [B, F*hop], 1 outside the masked regions and 0 inside)."""
    labels = np.zeros((batch, n_frames), np.int32)
    keep = np.ones((batch, n_frames * hop), np.float32)
    for b in range(batch):
        n_regions = int(rng.integers(min_regions, max_regions + 1))
        total = 0
        for _ in range(n_regions):
            if total >= int(max_fraction * n_frames):
                break
            mask_len = int(rng.integers(1, int(n_frames * max_fraction) + 1))
            if total + mask_len > max_fraction * n_frames:
                mask_len = int(max_fraction * n_frames) - total
            if mask_len <= 0:
                break
            start = int(rng.integers(0, n_frames - mask_len + 1))
            labels[b, start:start + mask_len] = 1
            keep[b, start * hop:(start + mask_len) * hop] = 0.0
            total += mask_len
    return labels, keep
