"""Generated-sample bookkeeping (the port's own copy of
``ssr_speech_tpu/utils/sample_manager.py``; nothing in it is JAX-specific).

Capability parity with the reference ``audiocraft/audiocraft/utils/samples/
manager.py:41+`` (SampleManager): generated audio is stored per epoch with
content-hash deduplication and a JSON sidecar recording the prompt/conditioning
provenance, so eval stages can pair samples across experiments.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from . import audio as audio_io


class SampleManager:
    def __init__(self, root: str, map_reference_to_sample_id: bool = False):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.map_reference = map_reference_to_sample_id

    def _hash(self, wav: np.ndarray) -> str:
        return hashlib.sha1(np.ascontiguousarray(wav).tobytes()).hexdigest()[:16]

    def add_sample(
        self,
        wav: np.ndarray,
        sample_rate: int,
        epoch: int = 0,
        conditioning: Optional[Dict[str, Any]] = None,
        prompt_wav: Optional[np.ndarray] = None,
    ) -> str:
        """Store one sample; returns its id (content hash — duplicate audio
        maps to the same file, the dedup of reference manager.py)."""
        wav = np.asarray(wav)
        if wav.ndim == 3:
            wav = wav[0, :, 0][None]
        elif wav.ndim == 1:
            wav = wav[None]
        sid = self._hash(wav)
        epoch_dir = os.path.join(self.root, f"epoch_{epoch}")
        os.makedirs(epoch_dir, exist_ok=True)
        path = os.path.join(epoch_dir, f"{sid}.wav")
        if not os.path.exists(path):
            audio_io.write_wav(path, wav, sample_rate)
        meta = dict(
            id=sid, epoch=epoch, time=time.time(),
            duration=wav.shape[-1] / sample_rate,
            conditioning=conditioning or {},
        )
        if prompt_wav is not None:
            pid = self._hash(np.asarray(prompt_wav))
            ppath = os.path.join(epoch_dir, f"{pid}_prompt.wav")
            if not os.path.exists(ppath):
                audio_io.write_wav(ppath, np.asarray(prompt_wav).reshape(1, -1),
                                   sample_rate)
            meta["prompt_id"] = pid
        with open(os.path.join(epoch_dir, f"{sid}.json"), "w") as f:
            json.dump(meta, f)
        return sid

    def get_samples(self, epoch: Optional[int] = None) -> List[Dict[str, Any]]:
        out = []
        dirs = (
            [f"epoch_{epoch}"] if epoch is not None
            else sorted(d for d in os.listdir(self.root) if d.startswith("epoch_"))
        )
        for d in dirs:
            full = os.path.join(self.root, d)
            if not os.path.isdir(full):
                continue
            for fn in sorted(os.listdir(full)):
                if fn.endswith(".json"):
                    with open(os.path.join(full, fn)) as f:
                        out.append(json.load(f))
        return out
