"""Raw-audio segment dataset for codec training (the port's own copy of
``ssr_speech_tpu/data/audio_dataset.py``; nothing in it is JAX-specific).

Capability parity with ``audiocraft/audiocraft/data/audio_dataset.py``
(AudioDataset): a jsonl manifest of AudioMeta lines ``{"path", "duration",
"sample_rate"[, "weight"]}`` (the reference's ``makefile.py:8-41`` writes
``egs/train/data.jsonl``), random fixed-duration segment sampling (config
``dataset.segment_duration: 2``) with the reference's sampling options
(``audio_dataset.py:272-303,356-369,434-454``):

  - ``sample_on_duration`` / ``sample_on_weight``: file pick probability
    proportional to duration x manifest weight (both default True, as the
    reference) — an unbalanced corpus is sampled per-second, not per-file;
  - ``min_segment_ratio``: seek time uniform over
    ``[0, max(0, duration - segment * ratio)]`` — segments may overhang the
    file end and get zero-padded (reference default 0.5);
  - ``max_read_retry``: a failed read re-samples a different file, raising
    only after the final retry;
  - ``pad``: when False, short reads raise instead of padding (the batched
    iterator requires pad=True for static shapes);
  - ``min_audio_duration`` / ``max_audio_duration`` manifest filters;
  - zip-archive corpora: manifest paths of the form
    ``archive.zip:inside/file.wav`` (reference ``data/zip.py:22`` PathInZip)
    and gzipped ``.jsonl.gz`` manifests (``audio_dataset.py:215,236``).

Mono conversion + resample via ``utils.audio``. Batches come out at one
static shape.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import CodecConfig
from ..utils import audio as audio_io

logger = logging.getLogger(__name__)


class AudioSegmentDataset:
    def __init__(
        self,
        manifest: str,
        cfg: CodecConfig,
        segment_duration: float = 2.0,
        seed: int = 0,
        min_audio_duration: float = 0.1,
        max_audio_duration: Optional[float] = None,
        loader_threads: int = 0,
        sample_on_duration: bool = True,
        sample_on_weight: bool = True,
        min_segment_ratio: float = 0.5,
        max_read_retry: int = 10,
        pad: bool = True,
    ):
        """loader_threads > 0 routes batch loading through the C++ threaded
        WAV loader (``native.load_wav_batch``: parallel parse + mono-mix +
        crop; rows needing resample or exotic encodings fall back to the
        python path per-row). The weighted FILE pick applies on the native
        path too; its seek is clamped to the last full segment (no
        tail-padding), a documented deviation from the python path."""
        self.cfg = cfg
        self.loader_threads = loader_threads
        self.segment_duration = segment_duration
        self.segment_samples = int(segment_duration * cfg.sample_rate)
        # round to a hop multiple so codec frames line up
        hop = cfg.hop_length
        self.segment_samples = (self.segment_samples // hop) * hop
        self.sample_on_duration = sample_on_duration
        self.sample_on_weight = sample_on_weight
        self.min_segment_ratio = min_segment_ratio
        self.max_read_retry = max_read_retry
        self.pad = pad
        self.metas: List[Dict] = []
        # .jsonl.gz manifests (reference audio_dataset.py:215,236) and
        # zip-member "archive.zip:inside.wav" paths (reference data/zip.py:22
        # PathInZip) are both accepted; zip rows route through the python
        # reader's cached handle pool (utils.audio.split_zip_path) — the
        # native threaded loader flags them unparseable and the per-row
        # fallback picks them up.
        open_fn = gzip.open if manifest.lower().endswith(".gz") else open
        with open_fn(manifest, "rt") as f:
            for line in f:
                if not line.strip():
                    continue
                m = json.loads(line)
                dur = m.get("duration", segment_duration)
                if dur < min_audio_duration:
                    continue
                if max_audio_duration is not None and dur > max_audio_duration:
                    continue
                self.metas.append(m)
        assert self.metas, f"no usable files in {manifest}"
        logger.info("audio dataset: %d files", len(self.metas))
        self.total_duration = sum(
            m.get("duration", segment_duration) for m in self.metas)
        self.sampling_probabilities = self._get_sampling_probabilities()
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.metas)

    def _get_sampling_probabilities(self) -> np.ndarray:
        """Per-file pick probability (reference ``audio_dataset.py:356-369``):
        weight x duration products, normalized."""
        scores = np.ones(len(self.metas), np.float64)
        for i, m in enumerate(self.metas):
            if self.sample_on_weight and m.get("weight") is not None:
                scores[i] *= float(m["weight"])
            if self.sample_on_duration:
                scores[i] *= float(m.get("duration", self.segment_duration))
        return scores / scores.sum()

    def _sample_file_idx(self) -> int:
        if not self.sample_on_weight and not self.sample_on_duration:
            return int(self.rng.integers(0, len(self.metas)))
        return int(self.rng.choice(len(self.metas),
                                   p=self.sampling_probabilities))

    def _read_segment(self, meta: Dict, frac: float) -> np.ndarray:
        """Read one segment at the reference's seek distribution
        (``audio_dataset.py:436-448``): seek uniform over
        ``[0, max(0, duration - segment * min_segment_ratio)]``, then pad the
        (possibly overhanging) read to the target length."""
        wav, sr = audio_io.read_wav(meta["path"])
        wav = audio_io.convert_audio(wav, sr, self.cfg.sample_rate, 1)[0]
        t = wav.shape[-1]
        dur = t / self.cfg.sample_rate
        max_seek = max(
            0.0, dur - self.segment_duration * self.min_segment_ratio)
        start = int(frac * max_seek * self.cfg.sample_rate)
        seg = wav[start:start + self.segment_samples]
        if seg.shape[-1] < self.segment_samples:
            if not self.pad:
                raise ValueError(
                    f"segment from {meta['path']} is {seg.shape[-1]} samples "
                    f"< {self.segment_samples} and pad=False")
            out = np.zeros(self.segment_samples, np.float32)
            out[: seg.shape[-1]] = seg
            return out
        return np.asarray(seg, np.float32)

    def sample_segment(self, idx: Optional[int] = None) -> np.ndarray:
        """Random segment [T] float32. A read failure re-samples a different
        file up to ``max_read_retry`` times (reference
        ``audio_dataset.py:434-454``) and raises on the final retry."""
        for retry in range(self.max_read_retry):
            i = self._sample_file_idx() if idx is None else idx
            frac = float(self.rng.random())
            try:
                return self._read_segment(self.metas[i], frac)
            except Exception as e:
                logger.warning("error reading %s: %r", self.metas[i]["path"], e)
                if idx is not None or retry == self.max_read_retry - 1:
                    raise
        raise AssertionError("unreachable")

    def batches(self, batch_size: int, num_batches: int) -> Iterator[np.ndarray]:
        """Yields [B, T, 1] float32 batches."""
        for _ in range(num_batches):
            if self.loader_threads:
                batch = self._native_batch(batch_size)
                if batch is not None:
                    yield batch
                    continue
            seg = np.stack([self.sample_segment() for _ in range(batch_size)])
            yield seg[..., None]

    def _native_batch(self, batch_size: int) -> Optional[np.ndarray]:
        from ..native import load_wav_batch

        idxs = np.asarray([self._sample_file_idx()
                           for _ in range(batch_size)])
        fracs = self.rng.random(batch_size)
        paths = [self.metas[int(i)]["path"] for i in idxs]
        res = load_wav_batch(paths, self.cfg.sample_rate,
                             self.segment_samples, fracs,
                             n_threads=self.loader_threads)
        if res is None:  # no native lib: caller uses the python path
            return None
        out, errs = res
        for j in np.nonzero(errs)[0]:
            # python-load the SAME file (the native loader can't parse it —
            # resample/exotic encoding): a fresh weighted re-sample here would
            # systematically underrepresent native-unparseable files
            try:
                out[j] = self.sample_segment(int(idxs[j]))
            except Exception:
                # unreadable by python too: re-sample, like the retry path
                out[j] = self.sample_segment()
        return out[..., None]
