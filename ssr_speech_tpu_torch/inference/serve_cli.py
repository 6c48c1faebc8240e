"""Batch serving CLI of the PyTorch port: many editing/TTS jobs through one
model load (port of ``ssr_speech_tpu/inference/serve_cli.py``).

    python -m ssr_speech_tpu_torch.inference.serve_cli --model_path lm.pkl \\
        --codec_path codec.pkl --jobs jobs.jsonl --output_dir out \\
        [--continuous --n_slots 8 | --stream] --device cuda

Reads a JSONL jobs file and runs every job through the multi-prompt decoder:
in static batches by text length (offline throughput), through the
continuous-batching server (``--continuous``: slot recycling), or, for TTS
jobs, through the multi-client streaming server (``--stream``: waveform
chunks while the LM decodes; needs a causal codec bundle). Each line is one
job:

    {"orig_audio": "a.wav", "orig_transcript": "...",
     "target_transcript": "...", "alignment_file": "a.csv",
     "tts": false, "savename": "job0"}

The flags are the JAX CLI's plus ``--device`` (default ``cuda``; asking for
it without a card is an error). Each job's word alignment comes from its
``alignment_file`` (CSV ``word,start,end``); the whisper / wav2vec2 aligners
are not ported and their flags raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SSR-Speech batch serving "
                                            "(PyTorch)")
    p.add_argument("--device", default="cuda", help="cpu, cuda or cuda:N")
    p.add_argument("--model_path", required=True)
    p.add_argument("--codec_path", required=True)
    p.add_argument("--jobs", required=True,
                   help="JSONL of jobs (see module docstring)")
    p.add_argument("--output_dir", default="./out")
    p.add_argument("--language", default="en", choices=["en", "zh"])
    p.add_argument("--continuous", action="store_true",
                   help="slot-recycling continuous batching instead of "
                        "static sorted batches")
    p.add_argument("--stream", action="store_true",
                   help="stream TTS jobs through n_slots concurrent lanes: "
                        "waveform chunks are emitted while the LM decodes "
                        "(all jobs must be tts; needs a causal codec bundle; "
                        "use_watermark does not apply). Writes "
                        "<savename>.wav plus a <savename>.stream.jsonl "
                        "emission manifest (chunk sizes and times)")
    p.add_argument("--chunk_frames", type=int, default=25,
                   help="stream mode: LM chunk cadence in codec frames "
                        "(emission steps are half this)")
    p.add_argument("--save_chunks", action="store_true",
                   help="stream mode: also write each emitted chunk under "
                        "<output_dir>/<savename>.chunks/")
    p.add_argument("--n_slots", type=int, default=8)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--sub_amount", type=float, default=0.12)
    p.add_argument("--codec_sr", type=int, default=50)
    p.add_argument("--prompt_length", type=float, default=3.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--stop_repetition", type=int, default=2)
    p.add_argument("--silence_tokens", type=int, nargs="*",
                   default=[1388, 1898, 131])
    p.add_argument("--cfg_coef", type=float, default=1.5)
    p.add_argument("--cfg_stride", type=int, default=5)
    p.add_argument("--aug_text", action="store_true")
    p.add_argument("--cfg_pretrained", action="store_true")
    p.add_argument("--use_watermark", action="store_true")
    p.add_argument("--whisper_model", default=None,
                   help="not ported: give each job an alignment_file")
    p.add_argument("--align_model", default=None,
                   help="not ported: give each job an alignment_file")
    return p


def _serve_stream(args, lm, cfg, dec, phn2num, text_tok, audio_tok, prepared,
                  device) -> Dict:
    """TTS jobs through the multi-client :class:`stream.StreamingServer`:
    each job's waveform chunks are emitted while the LM decodes. The request
    prompt is the job's audio codes cut at the TTS prompt boundary
    (``mask_interval[0][0]`` frames, where the offline TTS path's mask
    starts). Returns per job the prompt codes, the streamed codes and wav,
    the first-audio and completion times (s from the start of serving), the
    text ids and the wav's path."""
    import torch

    from ..data.tokenizer import tokenize_audio
    from ..ops import patterns
    from ..utils import audio as audio_io
    from . import decode as decode_mod
    from . import pipeline
    from . import stream as stream_mod

    bad = [j["savename"] for j in prepared if not j["tts"]]
    if bad:
        raise SystemExit(f"--stream serves TTS jobs only; non-tts jobs: {bad}")

    requests = []
    for job in prepared:
        x = pipeline.text_to_ids(text_tok, phn2num, job["target_text"])
        codes, _, _, _ = tokenize_audio(audio_tok, job["audio_path"])
        # cut == 0 (the target replaces everything) streams from an empty
        # prompt, as the offline path does
        cut = int(job["mask_interval"][0][0])
        requests.append((x, codes[0][:, :cut]))

    ts = cfg.tokens
    sx_max = max(len(x) for x, _ in requests)
    p_max = 1
    for _, y in requests:
        prefix, _, _, _ = patterns.build_inference_prefix(
            y, [(y.shape[1], y.shape[1])], ts)
        p_max = max(p_max, prefix.shape[1])
    server = stream_mod.StreamingServer(
        lm, cfg, dec, audio_tok.params, audio_tok.cfg,
        min(args.n_slots, len(requests)), chunk_frames=args.chunk_frames,
        sx_pad=decode_mod._bucket(sx_max, 64),
        p_pad=decode_mod._bucket(p_max, 128))

    manifests = [[] for _ in prepared]

    def on_chunk(i, c, w, t):
        manifests[i].append((c.shape[1], w, t))

    results, first_at, done_at = server.run_online(
        requests, [0.0] * len(requests), on_chunk=on_chunk,
        generator=torch.Generator(device=device).manual_seed(args.seed))

    os.makedirs(args.output_dir, exist_ok=True)
    sr = audio_tok.sample_rate
    out = []
    for i, (job, (codes_out, wav)) in enumerate(zip(prepared, results)):
        path = os.path.join(args.output_dir, job["savename"] + ".wav")
        audio_io.write_wav(path, wav[:, 0], sr)
        man = os.path.join(args.output_dir, job["savename"] + ".stream.jsonl")
        with open(man, "w") as f:
            for k, (frames, w, t) in enumerate(manifests[i]):
                f.write(json.dumps(dict(chunk=k, frames=frames,
                                        samples=int(w.shape[0]),
                                        t=round(float(t), 4))) + "\n")
        if args.save_chunks:
            cdir = os.path.join(args.output_dir, job["savename"] + ".chunks")
            os.makedirs(cdir, exist_ok=True)
            for k, (_, w, _) in enumerate(manifests[i]):
                audio_io.write_wav(os.path.join(cdir, f"{k:04d}.wav"),
                                   w[:, 0], sr)
        # first_at is None when a job emitted no audio (an immediate EOG)
        ttfa = ("n/a" if first_at[i] is None
                else f"{1e3 * first_at[i]:.0f} ms")
        logging.info("streamed %s: %.2f s audio, TTFA %s, done %.2f s",
                     job["savename"], wav.shape[0] / sr, ttfa, done_at[i])
        out.append(dict(x=requests[i][0], prompt_codes=requests[i][1],
                        codes=codes_out, wav=wav,
                        first_at=first_at[i], done_at=done_at[i], path=path,
                        chunks=len(manifests[i])))
    return dict(streams=out)


def main(argv=None) -> Optional[Dict]:
    """Serve the jobs file. Returns a summary dict (paths, output samples
    and, without ``--stream``, the decode statistics; with it, each
    stream's codes, wav and times) for callers that drive the CLI
    in-process."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    t0 = time.perf_counter()

    import numpy as np
    import torch

    from ..config import DecodeConfig
    from ..data.tokenizer import TextTokenizer
    from ..device import resolve_device, set_precision_policy
    from ..models import pretrained
    from ..utils import audio as audio_io
    from . import pipeline
    from .cli import prepare_job, read_alignment

    device = resolve_device(args.device)
    set_precision_policy()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if args.whisper_model or args.align_model:
        raise NotImplementedError("the whisper / wav2vec2 aligners are not "
                                  "yet ported: give each job an "
                                  "alignment_file")

    jobs = []
    with open(args.jobs) as f:
        for line in f:
            if line.strip():
                jobs.append(json.loads(line))
    if not jobs:
        raise SystemExit("no jobs in " + args.jobs)

    lm, cfg, phn2num = pretrained.load_lm(args.model_path, device)
    audio_tok = pretrained.load_codec(args.codec_path, device)
    text_tok = TextTokenizer(language="cmn" if args.language == "zh"
                             else "en-us")
    t_loaded = time.perf_counter()

    prepared = []
    for i, job in enumerate(jobs):
        if not job.get("alignment_file"):
            raise SystemExit(f"job {i}: needs an alignment_file (the whisper "
                             "/ wav2vec2 aligners are not yet ported)")
        words = read_alignment(job["alignment_file"])
        wav, sr = audio_io.read_wav(job["orig_audio"])
        dur = wav.shape[-1] / sr
        tts = bool(job.get("tts", False))
        _, _, target_text, mask_intervals = prepare_job(
            words, job.get("orig_transcript"), job["target_transcript"], dur,
            language=args.language, tts=tts, codec_sr=args.codec_sr,
            sub_amount=args.sub_amount, prompt_length=args.prompt_length)
        prepared.append(dict(
            audio_path=job["orig_audio"], target_text=target_text,
            mask_interval=mask_intervals, tts=tts,
            savename=job.get("savename", f"job{i}")))
        logging.info("job %d (%s): mask intervals %s",
                     i, prepared[-1]["savename"], mask_intervals)

    dec = DecodeConfig(
        top_k=args.top_k, top_p=args.top_p, temperature=args.temperature,
        stop_repetition=args.stop_repetition,
        silence_tokens=tuple(args.silence_tokens), cfg_coef=args.cfg_coef,
        cfg_stride=args.cfg_stride, aug_text=args.aug_text,
        cfg_pretrained=args.cfg_pretrained, codec_sr=args.codec_sr,
        seed=args.seed)
    if args.stream:
        stats = _serve_stream(args, lm, cfg, dec, phn2num, text_tok,
                              audio_tok, prepared, device)
        logging.info("streamed %d jobs in %.2f s", len(jobs),
                     time.perf_counter() - t0)
    else:
        stats: Dict = {}
        outs = pipeline.inference_multi(
            lm, cfg, dec, phn2num, text_tok, audio_tok, prepared,
            use_watermark=args.use_watermark, seed=args.seed,
            continuous=args.continuous, n_slots=args.n_slots, stats=stats)
        os.makedirs(args.output_dir, exist_ok=True)
        paths = []
        for job, out in zip(prepared, outs):
            path = os.path.join(args.output_dir, job["savename"] + ".wav")
            audio_io.write_wav(path, out[0, :, 0], audio_tok.sample_rate)
            paths.append(path)
            logging.info("wrote %s (%.2f s)", path,
                         out.shape[1] / audio_tok.sample_rate)
        stats.update(out_paths=paths,
                     out_samples=[int(o.shape[1]) for o in outs],
                     out_finite=all(bool(np.isfinite(o).all()) for o in outs))
        logging.info("served %d jobs in %.2f s", len(jobs),
                     time.perf_counter() - t0)
    if cuda:
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    stats.update(sample_rate=audio_tok.sample_rate, load_s=t_loaded - t0,
                 request_s=t_end - t_loaded,
                 mask_intervals=[j["mask_interval"] for j in prepared],
                 peak_mem_gib=(torch.cuda.max_memory_allocated(device)
                               / 2 ** 30 if cuda else None))
    return stats


if __name__ == "__main__":
    main()
