"""Running meters, the metrics log of the trainer, and SI-SNR.

``AverageMeter`` and :func:`si_snr` are the ones of
``ssr_speech_tpu/utils/metrics.py`` (whose module imports ``jax.numpy``).
``MetricsWriter`` writes the same ``metrics.jsonl`` rows as ``ssr_speech_tpu/utils/logging_utils.py`` without
its TensorBoard mirror: ``torch.utils.tensorboard`` imports TensorFlow where
it is installed, and TensorFlow imports JAX.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import torch


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


class MetricsWriter:
    """Append one JSON row per call to ``<logdir>/metrics.jsonl``."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a", buffering=1)

    def add_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        row = {"step": int(step), "time": time.time()}
        row.update({f"{prefix}{k}": float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(row) + "\n")

    def close(self):
        self._f.close()


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
