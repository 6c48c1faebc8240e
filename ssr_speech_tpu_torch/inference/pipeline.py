"""End-to-end inference: text + audio -> edited or synthesized waveform (port of
``ssr_speech_tpu/inference/pipeline.py``).

Phonemize the target text, codec-encode the source audio, run the LM's span
infilling (``decode.generate``; ``generate_batch`` for several seeds of one
request, ``generate_multi`` for several requests, or the continuous-batching
server of ``serve``), then either the watermark
decode (original samples copied into the un-edited regions, the watermark
embedded in the generated ones) or a plain codec decode, and crop the prompt
for TTS. The host helpers are restated from the JAX module, which imports
JAX.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DecodeConfig, SSRModelConfig

from ..data.tokenizer import (AudioTokenizer, TextTokenizer, tokenize_audio,
                              tokenize_text)
from ..utils.profiler import annotate
from . import decode as decode_mod
from . import serve

logger = logging.getLogger(__name__)

Span = Tuple[int, int]
WordTime = Tuple[str, float, float]  # word, start sec, end sec


def text_to_ids(tokenizer: TextTokenizer, phn2num: Dict[str, int],
                text: str) -> np.ndarray:
    """Phonemize and map to ids, dropping OOV phones; fail when most phones
    are OOV (tokenizer and bundle disagree on the phone alphabet)."""
    phones = tokenize_text(tokenizer, text)
    toks = [phn2num[p] for p in phones if p in phn2num]
    if phones and len(toks) < 0.5 * len(phones):
        hint = (" The espeak phonemizer is unavailable and the char fallback "
                "is active — install espeak-ng/phonemizer to match this "
                "bundle." if getattr(tokenizer, "backend", None) is None
                else "")
        raise RuntimeError(
            f"{len(phones) - len(toks)}/{len(phones)} phones missing from the "
            f"bundle's phn2num — tokenizer/bundle mismatch.{hint}")
    return np.asarray(toks, np.int32)


def word_span_to_time(words: Sequence[WordTime], span: Span) -> Tuple[float, float]:
    """Word-index span -> (start_sec, end_sec) from the alignment."""
    s, e = span
    n = len(words)
    if not 0 <= s <= e <= n:
        raise ValueError(f"word span {span} outside 0..{n}")
    if e == 0:  # insert at the very beginning
        return 0.0, float(words[0][1])
    if s == n:  # append at the end
        t = float(words[-1][2])
        return t, t
    if s == e:  # pure insertion between words
        return float(words[s - 1][2]), float(words[s][1])
    start = float(words[s - 1][2]) if s > 0 else float(words[s][1])
    end = float(words[e][1]) if e < n else float(words[-1][2])
    return start, end


def spans_to_mask_intervals(words: Sequence[WordTime], spans: Sequence[Span],
                            audio_dur: float, codec_sr: int = 50,
                            sub_amount: float = 0.12) -> List[Span]:
    """Widen each span by +-sub_amount, clamp, merge overlaps, convert to
    codec frames."""
    intervals = []
    for sp in spans:
        s, e = word_span_to_time(words, sp)
        intervals.append((max(s - sub_amount, 0.0), min(e + sub_amount, audio_dur)))
    combined: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if combined and s <= combined[-1][1]:
            combined[-1] = (combined[-1][0], max(combined[-1][1], e))
        else:
            combined.append((s, e))
    return [(int(round(s * codec_sr)), int(round(e * codec_sr)))
            for s, e in combined]


def cut_prompt_for_tts(words: Sequence[WordTime], prompt_length: float
                       ) -> Tuple[int, float]:
    """The word boundary closest under ``prompt_length`` seconds. Returns
    (n_prompt_words, cut_sec)."""
    n = 0
    cut = 0.0
    for i, (_, s, e) in enumerate(words):
        if e > prompt_length:
            break
        n = i + 1
        cut = float(e)
    if n == 0 and words:
        n, cut = 1, float(words[0][2])
    return n, cut


def tts_trim_offset(gen_words: Sequence[WordTime], first_target_word: str,
                    language: str = "en") -> float:
    """Where to cut the leading prompt out of a TTS result, from a
    re-transcription of the generated audio."""
    if not gen_words:
        return 0.0
    w0 = gen_words[0][0]
    tgt = first_target_word
    if language == "en":
        w0, tgt = w0.lower(), tgt.lower()
    if w0.strip(".,!?'\" ") == tgt.strip(".,!?'\" "):
        return float(gen_words[0][1])
    if len(gen_words) > 1:
        return float(gen_words[1][1])
    return float(gen_words[0][1])


def splice_waveform(wav: np.ndarray, n_frames: int, hop: int, nm, out_iv
                    ) -> np.ndarray:
    """The watermark decoder's input: original samples copied into the
    un-edited regions of the output timeline, zeros elsewhere. Span
    ``splice``."""
    with annotate("splice"):
        new_wav = np.zeros((1, n_frames * hop, 1), np.float32)
        for (os_, oe), (ns, _) in zip(nm, out_iv):
            os_, ns = max(os_, 0), max(ns, 0)
            seg = wav[0, os_ * hop:oe * hop]
            new_wav[0, ns * hop:ns * hop + seg.shape[0]] = seg
    return new_wav


def _render_waveform(audio_tokenizer: AudioTokenizer, result, wav: np.ndarray,
                    scale, use_watermark: bool, tts: bool) -> np.ndarray:
    """One decoded result (codes, marks, out_intervals, nm_intervals) ->
    waveform [1, T, 1]: the watermark decode over the source samples spliced
    into the un-edited regions, or a plain decode; TTS drops the prompt."""
    out_codes, marks, out_intervals, nm = result
    hop = audio_tokenizer.cfg.hop_length
    if use_watermark:
        new_wav = splice_waveform(wav, out_codes.shape[2], hop, nm, out_intervals)
        out = audio_tokenizer.wmdecode(out_codes, marks, new_wav, scale)
    else:
        out = audio_tokenizer.decode(out_codes, scale)
    if tts:
        out = out[:, out_intervals[0][1] * hop:]
    return out


def _generator(lm, seed: int) -> torch.Generator:
    return torch.Generator(device=lm["text_emb"].device).manual_seed(seed)


def inference_one_sample(lm, cfg: SSRModelConfig, dec: DecodeConfig,
                         phn2num: Dict[str, int], text_tokenizer: TextTokenizer,
                         audio_tokenizer: AudioTokenizer, audio_path: str,
                         prompt_text: str, target_text: str,
                         mask_interval: Sequence[Span],
                         use_watermark: bool = True, tts: bool = False,
                         seed: int = 1, stats: Optional[Dict] = None
                         ) -> np.ndarray:
    """Returns the generated waveform [1, T, 1] float32. ``stats``, when
    given, receives ``decode.generate``'s timings and the frame counts."""
    x = text_to_ids(text_tokenizer, phn2num, target_text)
    prompt_x = (text_to_ids(text_tokenizer, phn2num, prompt_text) if prompt_text
                else np.zeros(0, np.int32))
    codes, scale, _, wav = tokenize_audio(audio_tokenizer, audio_path)
    y = codes[0]  # [K, F]
    logger.info("source audio: %d codec frames (%.2f s)", y.shape[1],
                y.shape[1] / dec.codec_sr)
    # aug_context feeds the original codes as the context audio too
    result = decode_mod.generate(
        lm, cfg, dec, x, y, list(mask_interval), _generator(lm, seed),
        prompt_x=prompt_x, prompt_y=y, stats=stats)
    out_codes, _, out_intervals, _ = result
    logger.info("generated %d codec frames (%.2f s)", out_codes.shape[2],
                out_codes.shape[2] / dec.codec_sr)
    if stats is not None:
        stats["source_frames"] = int(y.shape[1])
        stats["output_frames"] = int(out_codes.shape[2])
        stats["out_intervals"] = out_intervals
    return _render_waveform(audio_tokenizer, result, wav, scale, use_watermark,
                           tts)


def inference_batch(lm, cfg: SSRModelConfig, dec: DecodeConfig,
                    phn2num: Dict[str, int], text_tokenizer: TextTokenizer,
                    audio_tokenizer: AudioTokenizer, audio_path: str,
                    target_text: str, mask_interval: Sequence[Span],
                    n_samples: int, use_watermark: bool = True,
                    tts: bool = False, seed: int = 1,
                    stats: Optional[Dict] = None) -> List[np.ndarray]:
    """``n_samples`` seeds of one request decoded in one loop
    (``decode.generate_batch``). Returns a list of waveforms [1, T, 1];
    ``stats`` as in :func:`inference_one_sample`, with the frame counts and
    intervals per chain."""
    x = text_to_ids(text_tokenizer, phn2num, target_text)
    codes, scale, _, wav = tokenize_audio(audio_tokenizer, audio_path)
    y = codes[0]
    results = decode_mod.generate_batch(
        lm, cfg, dec, x, y, list(mask_interval), _generator(lm, seed),
        n_samples, stats=stats)
    if stats is not None:
        stats["source_frames"] = int(y.shape[1])
        stats["output_frames"] = [int(r[0].shape[2]) for r in results]
        stats["out_intervals"] = [r[2] for r in results]
    return [_render_waveform(audio_tokenizer, r, wav, scale, use_watermark, tts)
            for r in results]


def inference_multi(lm, cfg: SSRModelConfig, dec: DecodeConfig,
                    phn2num: Dict[str, int], text_tokenizer: TextTokenizer,
                    audio_tokenizer: AudioTokenizer, jobs: Sequence[Dict],
                    use_watermark: bool = True, seed: int = 1,
                    continuous: bool = False, n_slots: int = 8,
                    stats: Optional[Dict] = None) -> List[np.ndarray]:
    """Several different requests decoded in one loop
    (``decode.generate_multi``). Each job: {audio_path, target_text,
    mask_interval, tts?}. Up to ``n_slots`` jobs go in one batch; more go
    in static batches of neighbours by text length
    (``serve.sorted_static_batches``), each from a generator seeded with
    ``seed``. ``continuous=True`` streams the jobs through the
    slot-recycling server instead (``serve.serve_requests``): a finished
    lane takes the next job at once. Returns waveforms in job order;
    ``stats`` receives the last batch's decode statistics (the server's,
    continuous) and each job's output frames and intervals."""
    prompts, metas = [], []
    for job in jobs:
        x = text_to_ids(text_tokenizer, phn2num, job["target_text"])
        codes, scale, _, wav = tokenize_audio(audio_tokenizer, job["audio_path"])
        prompts.append((x, codes[0], list(job["mask_interval"])))
        metas.append((wav, bool(job.get("tts", False)), scale))
    if continuous:
        results = serve.serve_requests(lm, cfg, dec, prompts,
                                       _generator(lm, seed), n_slots=n_slots,
                                       stats=stats)
    else:
        batches = (serve.sorted_static_batches(prompts, n_slots)
                   if len(prompts) > n_slots else [list(range(len(prompts)))])
        results = [None] * len(prompts)
        for batch in batches:
            outs = decode_mod.generate_multi(lm, cfg, dec,
                                             [prompts[i] for i in batch],
                                             _generator(lm, seed), stats=stats)
            for i, r in zip(batch, outs):
                results[i] = r
    if stats is not None:
        stats["output_frames"] = [int(r[0].shape[2]) for r in results]
        stats["out_intervals"] = [r[2] for r in results]
    return [_render_waveform(audio_tokenizer, r, wav, scale, use_watermark, tts)
            for (wav, tts, scale), r in zip(metas, results)]
