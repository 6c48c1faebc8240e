"""Forced alignment of the port (host copy of
``ssr_speech_tpu/utils/forced_align.py``): wav2vec2-CTC word timing for a
KNOWN transcript.

The reference aligns with whisperx's wav2vec2 forced-alignment pass
(``inference_v2.py:56-94``: whisper transcribes, wav2vec2 CTC aligns the
segment text to frames). This module gives the same ``[(word, start, end)]``
contract:

  - :func:`ctc_forced_align` — the CTC Viterbi trellis over an emission
    matrix (numpy, on the host; interleaved-blank state graph with the
    standard stay / advance / skip transitions),
  - :class:`Wav2Vec2Aligner` — a wav2vec2-CTC model of ``transformers``
    (imported when the aligner is built, so the module imports without it)
    on the caller's device, producing the emissions, and the mapping of
    aligned character tokens to word intervals via the tokenizer's word
    delimiter.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

WordTime = Tuple[str, float, float]
NEG = -1e30


def ctc_forced_align(
    log_probs: np.ndarray,  # [T, V] log-softmax emissions
    tokens: Sequence[int],  # target token ids (no blanks)
    blank: int = 0,
) -> List[Tuple[int, int]]:
    """Viterbi-align ``tokens`` to ``T`` frames under CTC.

    Returns per-token frame intervals [start, end) (end exclusive), i.e.
    the frames Viterbi assigns to each (non-blank) token occurrence.
    """
    T, V = log_probs.shape
    L = len(tokens)
    # adjacent equal tokens need a separating blank frame, so the minimal
    # path length is L + #adjacent-duplicate-pairs (standard CTC topology)
    dups = sum(1 for a, b in zip(tokens, tokens[1:]) if a == b)
    if L == 0 or T < L + dups:
        raise ValueError(
            f"CTC alignment infeasible: {T} frames for {L} tokens with "
            f"{dups} adjacent duplicates (audio too short for transcript)")
    S = 2 * L + 1  # interleaved blanks: b t0 b t1 b ... b tL-1 b

    def state_token(s: int) -> int:
        return tokens[(s - 1) // 2] if s % 2 else blank

    emit = np.empty((T, S), np.float64)
    for s in range(S):
        emit[:, s] = log_probs[:, state_token(s)]

    alpha = np.full((T, S), NEG)
    back = np.zeros((T, S), np.int8)  # 0=stay, 1=from s-1, 2=from s-2
    alpha[0, 0] = emit[0, 0]
    alpha[0, 1] = emit[0, 1]
    for t in range(1, T):
        stay = alpha[t - 1]
        prev1 = np.concatenate([[NEG], alpha[t - 1, :-1]])
        prev2 = np.concatenate([[NEG, NEG], alpha[t - 1, :-2]])
        # skip (s-2 -> s) allowed only into a token state whose token differs
        # from the previous token state's (standard CTC topology)
        for s in range(S):
            if not (s % 2) or s < 2 or state_token(s) == state_token(s - 2):
                prev2[s] = NEG
        choices = np.stack([stay, prev1, prev2])
        best = np.argmax(choices, axis=0)
        alpha[t] = choices[best, np.arange(S)] + emit[t]
        back[t] = best

    # terminal: last blank or last token state
    s = int(np.argmax(alpha[T - 1, [S - 2, S - 1]])) + S - 2
    path = np.empty(T, np.int32)
    for t in range(T - 1, -1, -1):
        path[t] = s
        s -= int(back[t, s])

    spans: List[Tuple[int, int]] = []
    for j in range(L):
        frames = np.nonzero(path == 2 * j + 1)[0]
        if frames.size == 0:  # should be unreachable given the check above
            raise ValueError(
                f"CTC backtrace assigned no frames to token {j}/{L}")
        spans.append((int(frames[0]), int(frames[-1]) + 1))
    return spans


def tokens_to_word_times(
    token_spans: Sequence[Tuple[int, int]],
    token_strings: Sequence[str],
    sec_per_frame: float,
    word_delimiter: str = "|",
) -> List[WordTime]:
    """Group aligned character tokens into word intervals."""
    words: List[WordTime] = []
    cur: List[str] = []
    start = end = 0
    for (s, e), tok in zip(token_spans, token_strings):
        if tok == word_delimiter:
            if cur:
                words.append(("".join(cur), start * sec_per_frame,
                              end * sec_per_frame))
            cur = []
            continue
        if not cur:
            start = s
        end = e
        cur.append(tok)
    if cur:
        words.append(("".join(cur), start * sec_per_frame,
                      end * sec_per_frame))
    return words


class Wav2Vec2Aligner:
    """Gated transformers wav2vec2-CTC forced aligner.

    ``align(audio_path, transcript)`` -> ``[(word, start_sec, end_sec)]`` —
    the drop-in upgrade over Whisper word timestamps for the CLI
    (``--align_model`` + a known transcript), matching whisperx's
    load_align_model/align flow (reference inference_v2.py:57-63). The model
    runs on ``device``, the caller's."""

    def __init__(self, model_id: str, device):
        from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

        self.processor = Wav2Vec2Processor.from_pretrained(model_id)
        self.model = Wav2Vec2ForCTC.from_pretrained(model_id).to(device).eval()
        self.device = device

    def align(self, audio_path: str, transcript: str) -> List[WordTime]:
        import torch

        from . import audio as audio_io

        wav, sr = audio_io.read_wav(audio_path)
        mono = wav.mean(axis=0)
        if sr != 16000:
            from .visqol import _resample

            mono = _resample(mono, sr, 16000)
            sr = 16000
        inputs = self.processor(mono, sampling_rate=sr, return_tensors="pt")
        with torch.no_grad():
            logits = self.model(inputs.input_values.to(self.device)).logits[0]
        log_probs = torch.log_softmax(logits, dim=-1).cpu().numpy()

        tokenizer = self.processor.tokenizer
        delim = tokenizer.word_delimiter_token
        vocab = tokenizer.get_vocab()

        def to_vocab(ch):
            # CTC vocabs come in upper- OR lower-case variants; match either
            for c in (ch, ch.upper(), ch.lower()):
                if c in vocab:
                    return c
            return None

        norm = delim.join(
            "".join(c for c in (to_vocab(ch) for ch in w) if c is not None)
            for w in transcript.split())
        ids = tokenizer.convert_tokens_to_ids(list(norm))
        toks = [t for t, i in zip(list(norm), ids)
                if i != tokenizer.unk_token_id]
        ids = [i for i in ids if i != tokenizer.unk_token_id]
        if not ids:
            raise ValueError(
                "forced alignment: no transcript character maps into the "
                f"CTC vocab of {type(tokenizer).__name__} (checked both "
                "cases) — wrong --align_model for this language?")
        spans = ctc_forced_align(log_probs, ids,
                                 blank=tokenizer.pad_token_id)
        sec_per_frame = (mono.shape[0] / sr) / log_probs.shape[0]
        return tokens_to_word_times(spans, toks, sec_per_frame, delim)
