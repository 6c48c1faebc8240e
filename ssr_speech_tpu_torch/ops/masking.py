"""Attention/padding masks for the [text ; codec] joint sequence (port of
``ssr_speech_tpu/ops/masking.py``).

Text queries attend causally within the text block and never to audio; audio
queries attend to all text and causally within audio; padded keys are masked
everywhere. The bias constant is -1e9 (not -inf), as in JAX.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True at padding positions."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


def xy_attn_bias(x_lens: torch.Tensor, y_lens: torch.Tensor, sx: int,
                 sy: int) -> torch.Tensor:
    """Additive attention bias [B, 1, Sx+Sy, Sx+Sy] (float32)."""
    s = sx + sy
    idx = torch.arange(s, device=x_lens.device)
    is_y_row = idx >= sx
    is_y_col = idx[None, :] >= sx
    tri = idx[None, :] > idx[:, None]  # strictly-future ban (causal)
    banned = tri | ((~is_y_row)[:, None] & is_y_col)
    key_pad = torch.cat([make_pad_mask(x_lens, sx), make_pad_mask(y_lens, sy)],
                        dim=1)
    full = banned[None, :, :] | key_pad[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=x_lens.device)
    return torch.where(full, NEG_INF, zero)[:, None, :, :]
