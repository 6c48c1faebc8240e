"""Residual vector quantization of the codec (port of
``ssr_speech_tpu/models/codec/quantize.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ...config import RVQConfig


def init_rvq(gen, cfg: RVQConfig, device="cpu"):
    """Codebooks [n_q, bins, dim], standard normal (random weights)."""
    return dict(embed=torch.randn((cfg.n_q, cfg.bins, cfg.dimension),
                                  generator=gen, device=device))


def nearest_code(codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """codebook [bins, D], x [..., D] -> indices [...]: argmax of the
    expanded distance -(||x||^2 - 2 x.e + ||e||^2), first index on ties
    (the JAX formula, not ``cdist``, so the codes match bit for bit)."""
    x2 = x.square().sum(dim=-1, keepdim=True)
    e2 = codebook.square().sum(dim=-1)
    dots = torch.matmul(x, codebook.T)
    dist = -(x2 - 2.0 * dots + e2)
    return torch.argmax(dist, dim=-1)


def rvq_encode(p, emb: torch.Tensor, n_q: Optional[int] = None) -> torch.Tensor:
    """emb [B, F, D] -> codes [B, K, F]."""
    embed = p["embed"]
    n_q = n_q if n_q is not None else embed.shape[0]
    residual = emb
    codes = []
    for k in range(n_q):
        idx = nearest_code(embed[k], residual)
        codes.append(idx)
        residual = residual - embed[k][idx]
    return torch.stack(codes, dim=1)


def rvq_decode(p, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, K, F] -> latents [B, F, D], the sum of codebook vectors.
    Indices are clipped to the codebook first: an LM with untrained weights
    can emit special tokens >= bins, which JAX's gather clamps and an
    unclipped CUDA gather would turn into a device assert."""
    embed = p["embed"]
    idx = codes.clamp(0, embed.shape[1] - 1)
    out = embed[0][idx[:, 0]]
    for k in range(1, codes.shape[1]):
        out = out + embed[k][idx[:, k]]
    return out
