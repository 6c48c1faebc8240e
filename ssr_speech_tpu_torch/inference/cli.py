"""Inference CLI of the PyTorch port: zero-shot speech editing and TTS.

    python -m ssr_speech_tpu_torch.inference.cli --model_path lm.pkl \\
        --codec_path codec.pkl --orig_audio in.wav --orig_transcript "..." \\
        --target_transcript "..." --alignment_file align.csv --device cuda

The flags are those of ``ssr_speech_tpu.inference.cli`` plus ``--device``
(default ``cuda``; asking for it without a card is an error, never a silent
CPU run). The word alignment comes, as in JAX, from ``--alignment_file``
(CSV rows ``word,start,end``), from a wav2vec2 forced aligner over the known
transcript (``--align_model`` with ``--orig_transcript``), or from Whisper
ASR (``--whisper_model``, optionally re-aligned by ``--align_model``); the
aligners run on ``--device`` and need ``transformers``. With ``--tts
--whisper_model`` the output is trimmed by re-transcribing it.
``--sample_batch_size N`` > 1 decodes N seeds of the request in one loop and
writes ``{savename}_seed{seed + i}.wav`` for i < N.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SSR-Speech inference (PyTorch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cpu, cuda or cuda:N")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--sub_amount", type=float, default=0.12,
                   help="seconds to add around each edit span")
    p.add_argument("--codec_sr", type=int, default=50)
    p.add_argument("--codec_audio_sr", type=int, default=None,
                   help="output wav header rate; default: the codec's rate")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--stop_repetition", type=int, default=2)
    p.add_argument("--kvcache", type=int, default=1)
    p.add_argument("--silence_tokens", type=int, nargs="*",
                   default=[1388, 1898, 131])
    p.add_argument("--cfg_coef", type=float, default=1.5)
    p.add_argument("--cfg_stride", type=int, default=5)
    p.add_argument("--aug_text", action="store_true")
    p.add_argument("--aug_context", action="store_true")
    p.add_argument("--cfg_pretrained", action="store_true")
    p.add_argument("--use_watermark", action="store_true")
    p.add_argument("--tts", action="store_true")
    p.add_argument("--language", type=str, default="en", choices=["en", "zh"])
    p.add_argument("--model_path", type=str, required=True,
                   help="LM bundle (.pkl ours or .pth reference bundle)")
    p.add_argument("--codec_path", type=str, required=True,
                   help="wmencodec checkpoint (.pkl ours or .th reference)")
    p.add_argument("--orig_audio", type=str, required=True)
    p.add_argument("--orig_transcript", type=str, default=None)
    p.add_argument("--target_transcript", type=str, required=True)
    p.add_argument("--alignment_file", type=str, default=None,
                   help="CSV word,start,end (skips ASR)")
    p.add_argument("--temp_folder", type=str, default="./temp",
                   help="accepted for reference-CLI compatibility")
    p.add_argument("--output_dir", type=str, default="./out")
    p.add_argument("--savename", type=str, default="output")
    p.add_argument("--whisper_model", type=str, default=None,
                   help="HF whisper id for on-host ASR+alignment")
    p.add_argument("--whisper_model_name", type=str, default=None,
                   choices=["base.en", "base"],
                   help="reference-CLI spelling (inference_v2.py:186): "
                        "short OpenAI model name, mapped to the HF id "
                        "openai/whisper-<name>")
    p.add_argument("--align_model", type=str, default=None,
                   help="HF wav2vec2-CTC id for forced alignment of the "
                        "transcript (the whisperx-style pass, reference "
                        "inference_v2.py:56-94)")
    p.add_argument("--prompt_length", type=float, default=3.0)
    p.add_argument("--sample_batch_size", type=int, default=1)
    return p


def read_alignment(path: str) -> List[Tuple[str, float, float]]:
    words = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0] in ("word", "BEGIN"):
                continue
            words.append((row[0], float(row[1]), float(row[2])))
    return words


def resolve_alignment(orig_audio, orig_transcript, *, device,
                      alignment_file=None, align_model=None,
                      whisper_model=None):
    """Word alignment [(word, start, end)] from one of: a precomputed CSV, a
    wav2vec2 forced aligner over the known transcript (whisperx-equivalent),
    or transformers-Whisper ASR (optionally re-aligned). The models run on
    ``device``."""
    if alignment_file:
        return read_alignment(alignment_file)
    if align_model and orig_transcript:
        from ..utils import forced_align

        return forced_align.Wav2Vec2Aligner(align_model, device).align(
            orig_audio, orig_transcript)
    if whisper_model:
        from ..utils import asr, forced_align

        words = asr.WhisperAligner(whisper_model, device).transcribe(
            orig_audio)
        if align_model:  # re-align the ASR transcript with wav2vec2
            words = forced_align.Wav2Vec2Aligner(align_model, device).align(
                orig_audio, " ".join(w for w, _, _ in words))
        return words
    raise SystemExit("need --alignment_file, --align_model with "
                     "--orig_transcript, or --whisper_model")


def prepare_job(words, orig_transcript, target_transcript, audio_dur, *,
                language="en", tts=False, codec_sr=50, sub_amount=0.12,
                prompt_length=3.0):
    """Text normalisation, edit-span diff and codec-frame mask intervals.
    Returns (orig_transcript, target_transcript, target_text,
    mask_intervals); ``target_text`` is what the LM reads (for TTS the
    prompt transcript is prepended)."""
    from ..inference import edit as edit_mod
    from ..utils.text_norm import (normalize_aligned_words,
                                                replace_numbers_with_words)

    from . import pipeline

    words = normalize_aligned_words(words)
    target_transcript = replace_numbers_with_words(target_transcript)
    if orig_transcript:
        orig_transcript = replace_numbers_with_words(orig_transcript)
    orig_transcript = orig_transcript or " ".join(w for w, _, _ in words)
    if language == "zh":
        try:  # traditional -> simplified
            from opencc import OpenCC

            cc = OpenCC("t2s")
            orig_transcript = cc.convert(orig_transcript)
            target_transcript = cc.convert(target_transcript)
        except ImportError:
            logging.warning("opencc unavailable; skipping t2s conversion")

    if language == "zh":
        parse = edit_mod.parse_tts_zh if tts else edit_mod.parse_edit_zh
    else:
        parse = edit_mod.parse_tts_en if tts else edit_mod.parse_edit_en
    spans = parse(orig_transcript, target_transcript)
    if tts:
        target_text = (orig_transcript + " " + target_transcript
                       if language == "en" else orig_transcript + target_transcript)
        _, cut = pipeline.cut_prompt_for_tts(words, prompt_length)
        # TTS masks from the prompt boundary to the end of the audio
        mask_intervals = [(int(cut * codec_sr), int(audio_dur * codec_sr))]
    else:
        target_text = target_transcript
        mask_intervals = pipeline.spans_to_mask_intervals(
            words, spans, audio_dur, codec_sr, sub_amount)
    return orig_transcript, target_transcript, target_text, mask_intervals


def main(argv=None) -> Optional[Dict]:
    """Run one request. Returns a summary dict (output path or, with
    ``--sample_batch_size`` > 1, paths; frame counts, timings, peak device
    memory) for callers that drive the CLI in-process."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    t0 = time.perf_counter()

    import torch

    from ..config import DecodeConfig
    from ..utils import audio as audio_io

    from ..data.tokenizer import TextTokenizer
    from ..device import resolve_device, set_precision_policy
    from ..models import pretrained
    from . import pipeline

    device = resolve_device(args.device)
    set_precision_policy()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    lm, cfg, phn2num = pretrained.load_lm(args.model_path, device)
    audio_tok = pretrained.load_codec(args.codec_path, device)
    text_tok = TextTokenizer(language="cmn" if args.language == "zh" else "en-us")
    if not os.path.isfile(args.orig_audio):
        raise SystemExit(f"--orig_audio not found: {args.orig_audio}")
    t_loaded = time.perf_counter()

    words = resolve_alignment(
        args.orig_audio, args.orig_transcript, device=device,
        alignment_file=args.alignment_file, align_model=args.align_model,
        whisper_model=args.whisper_model)
    wav, sr = audio_io.read_wav(args.orig_audio)
    audio_dur = wav.shape[-1] / sr
    orig_transcript, args.target_transcript, target_text, mask_intervals = \
        prepare_job(words, args.orig_transcript, args.target_transcript,
                    audio_dur, language=args.language, tts=args.tts,
                    codec_sr=args.codec_sr, sub_amount=args.sub_amount,
                    prompt_length=args.prompt_length)
    logging.info("mask intervals (codec frames): %s", mask_intervals)

    dec = DecodeConfig(
        top_k=args.top_k, top_p=args.top_p, temperature=args.temperature,
        stop_repetition=args.stop_repetition, kvcache=bool(args.kvcache),
        silence_tokens=tuple(args.silence_tokens), cfg_coef=args.cfg_coef,
        cfg_stride=args.cfg_stride, aug_text=args.aug_text,
        aug_context=args.aug_context, cfg_pretrained=args.cfg_pretrained,
        codec_sr=args.codec_sr, seed=args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    # the reference CLI's alias, applied where JAX applies it: after the
    # alignment, so it names the model of the TTS trim below
    if args.whisper_model_name and not args.whisper_model:
        args.whisper_model = f"openai/whisper-{args.whisper_model_name}"
    out_sr = args.codec_audio_sr or audio_tok.sample_rate
    if out_sr != audio_tok.sample_rate:
        logging.warning("--codec_audio_sr %d != codec sample rate %d: the "
                        "wav header is labeled %d (no resample)", out_sr,
                        audio_tok.sample_rate, out_sr)
    stats: Dict = {}
    if args.sample_batch_size > 1:
        # all seeds decoded in one loop
        outs = pipeline.inference_batch(
            lm, cfg, dec, phn2num, text_tok, audio_tok, args.orig_audio,
            target_text, mask_intervals, n_samples=args.sample_batch_size,
            use_watermark=args.use_watermark, tts=args.tts, seed=args.seed,
            stats=stats)
        paths = [os.path.join(args.output_dir,
                              f"{args.savename}_seed{args.seed + i}.wav")
                 for i in range(len(outs))]
    else:
        outs = [pipeline.inference_one_sample(
            lm, cfg, dec, phn2num, text_tok, audio_tok, args.orig_audio,
            orig_transcript, target_text, mask_intervals,
            use_watermark=args.use_watermark, tts=args.tts, seed=args.seed,
            stats=stats)]
        paths = [os.path.join(args.output_dir, f"{args.savename}.wav")]
    for path, out in zip(paths, outs):
        audio_io.write_wav(path, out[0, :, 0], out_sr)
    if args.sample_batch_size == 1 and args.tts and args.whisper_model:
        # trim residual prompt audio via re-transcription
        # (reference inference_v2.py:338-354)
        from ..utils import asr

        gen_words = asr.WhisperAligner(args.whisper_model, device).transcribe(
            paths[0])
        first_target = ((args.target_transcript.split() or [""])[0]
                        if args.language == "en" else args.target_transcript[:1])
        offset = pipeline.tts_trim_offset(gen_words, first_target,
                                          args.language)
        if offset > 0:
            cut = int(offset * audio_tok.sample_rate)
            audio_io.write_wav(paths[0], outs[0][0, cut:, 0], out_sr)
            stats["trimmed_samples"] = cut
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    logging.info("Running time: %.2f s", t_end - t0)
    stats.update(out_finite=all(bool(np.isfinite(o).all()) for o in outs),
                 sample_rate=out_sr, load_s=t_loaded - t0,
                 request_s=t_end - t_loaded, mask_intervals=mask_intervals,
                 peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                               if cuda else None))
    if args.sample_batch_size > 1:
        stats.update(n_samples=len(outs), out_paths=paths,
                     out_samples=[int(o.shape[1]) for o in outs])
    else:
        stats.update(out_path=paths[0], out_samples=int(outs[0].shape[1]))
    return stats

if __name__ == "__main__":
    main()
