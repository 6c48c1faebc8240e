"""Running meters and the metrics log of the trainer.

``AverageMeter`` is the one of ``ssr_speech_tpu/utils/metrics.py`` (whose
module imports ``jax.numpy``). ``MetricsWriter`` writes the same
``metrics.jsonl`` rows as ``ssr_speech_tpu/utils/logging_utils.py`` without
its TensorBoard mirror: ``torch.utils.tensorboard`` imports TensorFlow where
it is installed, and TensorFlow imports JAX.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


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
