"""Running meters and SI-SNR (``AverageMeter`` and :func:`si_snr` are the
ones of ``ssr_speech_tpu/utils/metrics.py``, whose module imports
``jax.numpy``). ``MetricsWriter`` lives in :mod:`.logging_utils`, as in JAX,
and is re-exported here.
"""

from __future__ import annotations

import torch

from .logging_utils import MetricsWriter  # noqa: F401


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def si_snr(est, ref, eps: float = 1e-8):
    """Scale-invariant SNR in dB over the last axis ([B, T] or [B, T, C]:
    the first channel), per row."""
    if est.dim() == 3:
        est = est[..., 0]
        ref = ref[..., 0]
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    dot = (est * ref).sum(dim=-1, keepdim=True)
    energy = (ref * ref).sum(dim=-1, keepdim=True) + eps
    target = dot / energy * ref
    noise = est - target
    ratio = ((target ** 2).sum(dim=-1) + eps) / ((noise ** 2).sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio)
