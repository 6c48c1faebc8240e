"""Host-side ASR and word-level alignment of the port (host copy of
``ssr_speech_tpu/utils/asr.py``) via transformers Whisper.

The reference uses whisper / whisperx (ctranslate2) for transcription and
forced alignment (``inference_v2.py:56-94``). This wrapper produces the same
``[(word, start, end)]`` contract with HuggingFace transformers' Whisper word
timestamps, on the caller's device; ``transformers`` is imported when the
aligner is built. Anything that produces that contract (whisperx offline,
MFA, a CSV) plugs into the CLI via ``--alignment_file``.

Option parity with the reference ASR setup:
  - numeral suppression (``inference_v2.py:73-78``: every token decoding to
    pure digits is suppressed so numbers come out as words) —
    :func:`numeral_suppress_ids` + generate-time ``suppress_tokens``.
    Downstream, ``text_norm.replace_numbers_with_words`` normalizes any
    digits that still slip through (``inference_v2.py:90-94``).
  - ``hallucination_silence_threshold`` / ``max_new_tokens`` /
    ``clip_timestamps`` are ``None`` (disabled) in the reference
    (``inference_v2.py:87``), so there is nothing to implement.
  - beam options: the reference calls whisper with its defaults (greedy,
    ``beam_size=None``); so does this wrapper.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

WordTime = Tuple[str, float, float]


def numeral_suppress_ids(tokenizer, upto: Optional[int] = None) -> List[int]:
    """Token ids that decode to pure digit strings (reference
    ``inference_v2.py:73-78`` builds the same list from the openai-whisper
    tokenizer; ``-1`` there means "the default non-speech set", which
    transformers applies separately via the generation config)."""
    n = upto
    if n is None:
        n = getattr(tokenizer, "eos_token_id", None) or len(tokenizer)
    ids = []
    for i in range(n):
        s = tokenizer.decode([i])
        if s.startswith(" "):
            s = s[1:]
        if s and all(c in "0123456789" for c in s):
            ids.append(i)
    return ids


class WhisperAligner:
    """Whisper ASR with word timestamps on ``device``, the caller's."""

    def __init__(self, model_id: str, device, language: str = "en",
                 suppress_numerals: bool = True):
        from transformers import pipeline

        self.pipe = pipeline(
            "automatic-speech-recognition",
            model=model_id,
            device=device,
            return_timestamps="word",
        )
        self.language = language
        self.suppress_ids: Optional[Sequence[int]] = None
        if suppress_numerals:
            base = getattr(
                self.pipe.model.generation_config, "suppress_tokens", None)
            self.suppress_ids = sorted(
                set(base or []) | set(numeral_suppress_ids(self.pipe.tokenizer)))

    def transcribe(self, audio_path: str) -> List[WordTime]:
        from . import audio as audio_io

        wav, sr = audio_io.read_wav(audio_path)
        mono = wav.mean(axis=0)
        kwargs = {}
        if self.suppress_ids is not None:
            kwargs["generate_kwargs"] = {
                "suppress_tokens": list(self.suppress_ids)}
        out = self.pipe({"raw": mono, "sampling_rate": sr}, **kwargs)
        words: List[WordTime] = []
        for chunk in out.get("chunks", []):
            s, e = chunk["timestamp"]
            words.append((chunk["text"].strip(), float(s), float(e if e is not None else s)))
        return words
