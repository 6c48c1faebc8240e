"""Host tokenizers (port of ``ssr_speech_tpu/data/tokenizer.py``): the
phonemizer text tokenizer with its character fallback, and the codec facade
with the numpy-in / numpy-out contract of the JAX ``AudioTokenizer``.

The JAX module imports the JAX codec at import time, so the text tokenizer is
restated here rather than imported.
"""

from __future__ import annotations

import logging
import re
from typing import List, Optional

import numpy as np
import torch

from ..config import CodecConfig
from ..utils import audio as audio_io

from ..models.codec import wmencodec as wm

logger = logging.getLogger(__name__)


def _espeak_backend(language: str, preserve_punctuation: bool,
                    with_stress: bool):
    """(backend, separator) from the phonemizer package, or None without it."""
    try:
        from phonemizer.backend import EspeakBackend
        from phonemizer.punctuation import Punctuation
        from phonemizer.separator import Separator
    except ImportError:
        return None
    backend = EspeakBackend(
        language, punctuation_marks=Punctuation.default_marks(),
        preserve_punctuation=preserve_punctuation, with_stress=with_stress,
        tie=False, language_switch="keep-flags", words_mismatch="ignore")
    return backend, Separator(word="_", syllable="-", phone="|")


class TextTokenizer:
    """Text -> phone list: espeak when the phonemizer package is installed,
    else a deterministic character fallback (one field per character, "_"
    between words)."""

    def __init__(self, language: str = "en-us", backend: str = "espeak",
                 preserve_punctuation: bool = True, with_stress: bool = False):
        self.language = language
        self.word_sep = "_"
        self.phone_sep = "|"
        found = (_espeak_backend(language, preserve_punctuation, with_stress)
                 if backend == "espeak" else None)
        if found is None:
            self.backend = None
            logger.warning(
                "phonemizer/espeak unavailable; using character fallback "
                "tokenizer (install espeak-ng for reference-equivalent "
                "phonemization)")
        else:
            self.backend, self.separator = found

    def _to_list(self, phonemized: str) -> List[str]:
        fields: List[str] = []
        for word in phonemized.split(self.word_sep):
            parts = re.findall(r"\w+|[^\w\s]", word, re.UNICODE)
            fields.extend([p for p in parts if p != self.phone_sep])
            fields.append(self.word_sep)
        return fields[:-1]

    def __call__(self, text: str) -> List[str]:
        text = text.strip()
        if self.backend is not None:
            out = self.backend.phonemize([text], separator=self.separator,
                                         strip=True, njobs=1)[0]
            return self._to_list(out)
        fields: List[str] = []
        for word in text.split():
            fields.extend(list(word))
            fields.append(self.word_sep)
        return fields[:-1] if fields else []


def tokenize_text(tokenizer: TextTokenizer, text: str) -> List[str]:
    return tokenizer(text.strip())


class AudioTokenizer:
    """Codec facade: numpy in, numpy out; the codec runs on ``device``."""

    def __init__(self, params, cfg: Optional[CodecConfig] = None):
        self.params = params
        self.cfg = cfg or CodecConfig()
        self.device = next(iter(params.buffers())).device

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    def encode(self, wav: np.ndarray):
        """wav [B, T, C] -> (codes [B, K, F], scale [B, 1] or None,
        latents [B, F, D]) as numpy."""
        codes, scale, emb = wm.encode(self.params, self._t(wav), self.cfg)
        return (codes.cpu().numpy(),
                None if scale is None else scale.cpu().numpy(),
                emb.cpu().numpy())

    def decode(self, codes: np.ndarray,
               scale: Optional[np.ndarray] = None) -> np.ndarray:
        out = wm.decode(self.params, self._t(codes, torch.int64), self.cfg,
                        None if scale is None else self._t(scale))
        return out.cpu().numpy()

    def wmdecode(self, codes: np.ndarray, marks: np.ndarray, wav: np.ndarray,
                 scale: Optional[np.ndarray] = None) -> np.ndarray:
        out, _ = wm.wmdecode(self.params, self._t(codes, torch.int64),
                             self._t(marks, torch.int64), self._t(wav),
                             self.cfg, None if scale is None else self._t(scale))
        return out.cpu().numpy()

    def detect_watermark(self, wav: np.ndarray) -> np.ndarray:
        return wm.detect_watermark(self.params, self._t(wav), self.cfg
                                   ).cpu().numpy()


def tokenize_audio(tokenizer: AudioTokenizer, path: str):
    """Load, pad to a hop multiple, resample, encode. Returns (codes, scale,
    latents, wav [1, T, 1])."""
    wav = audio_io.load_for_codec(path, tokenizer.sample_rate,
                                  tokenizer.cfg.hop_length)
    codes, scale, emb = tokenizer.encode(wav)
    return codes, scale, emb, wav
