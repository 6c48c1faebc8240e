"""Metrics logging of the port (``ssr_speech_tpu/utils/logging_utils.py``):
one JSON row of scalars per call to ``<logdir>/metrics.jsonl``.

The JAX writer also mirrors the scalars to TensorBoard when it can import
``torch.utils.tensorboard``; the port writes the same rows without that
mirror, because ``torch.utils.tensorboard`` imports TensorFlow where it is
installed, and TensorFlow imports JAX.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


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
