"""Data-prep rehearsal of the port: a synthetic corpus through the whole prep
pipeline into ``train_lm``, with the encode throughput measured.

    python -m ssr_speech_tpu_torch.prep_rehearsal --out /tmp/r --n_utts 1000
    python -m ssr_speech_tpu_torch.prep_rehearsal --out /tmp/r --n_utts 12 \\
        --tiny --device cpu

The stages of ``tools/prep_rehearsal.py`` through the port's entry points:
wav synthesis (tone + noise, lognormal 2-12 s, transcripts with GigaSpeech
tags) -> ``data.prep encode`` (a random-init codec bundle from the port's
seeded init: the default geometry, or a tiny one with ``--tiny``, which
also caps the wavs at 3 s) -> ``phonemize`` -> ``filemaker`` -> ``vocab`` ->
a few ``train_lm`` steps of a tiny LM on the artifacts. ``--device`` (default
cuda; raises without a card) is where the encode and the training run.
Prints one JSON report with each stage's wall seconds and the encode's
audio-hours per device-hour (under the JAX tool's key,
``encode_audio_hours_per_chip_hour``), and writes it to ``report.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np

WORDS = ("the tpu rebuild speaks for itself today and tomorrow with spans "
         "masked tokens codecs watermark decode speech synthesis model "
         "training data pipeline phoneme vocab manifest bucket").split()
GARBAGE_TAGS = ["<MUSIC>", "<SIL>"]
PUNCT_TAGS = ["<COMMA>", "<PERIOD>"]


def synth_corpus(out: str, n_utts: int, sr: int = 16000, seed: int = 0,
                 tiny: bool = False) -> float:
    """Random tone+noise wavs (lognormal 2-12 s, at most 3 s with ``tiny``)
    and synthetic transcripts, some carrying GigaSpeech tags; writes
    ``wav_manifest.tsv`` and ``text_manifest.tsv`` and returns the corpus's
    seconds."""
    from .utils import audio as audio_io

    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    manifest, tsv, total_sec = [], [], 0.0
    for i in range(n_utts):
        dur = float(np.clip(rng.lognormal(1.2, 0.4), 2.0, 12.0))
        if tiny:
            dur = min(dur, 3.0)
        n = int(dur * sr)
        t = np.arange(n) / sr
        f0 = float(rng.uniform(80, 400))
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.05 * rng.normal(size=n)).astype(np.float32)
        seg = f"utt{i:05d}"
        path = os.path.join(wav_dir, seg + ".wav")
        audio_io.write_wav(path, wav[None], sr)
        nw = int(rng.integers(8, 28))
        words = list(rng.choice(WORDS, size=nw))
        if i % 7 == 0:  # garbage tags, as GigaSpeech transcripts carry
            words.insert(int(rng.integers(1, nw)),
                         GARBAGE_TAGS[(i // 7) % len(GARBAGE_TAGS)])
        if i % 5 == 1:  # and punctuation tags
            words.insert(int(rng.integers(1, nw)),
                         PUNCT_TAGS[(i // 5) % len(PUNCT_TAGS)])
        manifest.append(f"{path}\t{seg}")
        tsv.append(f"{seg}\t{' '.join(words)}")
        total_sec += dur
    with open(os.path.join(out, "wav_manifest.tsv"), "w") as f:
        f.write("\n".join(manifest))
    with open(os.path.join(out, "text_manifest.tsv"), "w") as f:
        f.write("\n".join(tsv))
    return total_sec


def make_codec_bundle(out: str, tiny: bool = False) -> str:
    """A random-init codec bundle from the port's init (seed 1): the
    default geometry, or a tiny one with the default's 4 codebooks of
    2048."""
    import torch

    from .config import CodecConfig, RVQConfig, SEANetConfig
    from .models.codec import wmencodec as wm
    from .models.pretrained import save_bundle

    cfg = (CodecConfig(seanet=SEANetConfig(dimension=16, n_filters=2,
                                           n_residual_layers=1,
                                           ratios=(8, 5, 4, 2), lstm=1),
                       rvq=RVQConfig(dimension=16, n_q=4, bins=2048))
           if tiny else CodecConfig())
    params = wm.init_wmencodec(torch.Generator().manual_seed(1), cfg)
    path = os.path.join(out, "codec.pkl")
    save_bundle(path, params=params, config=cfg)
    return path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.prep_rehearsal")
    p.add_argument("--out", required=True)
    p.add_argument("--n_utts", type=int, default=1000)
    p.add_argument("--tiny", action="store_true",
                   help="tiny codec and wavs of at most 3 s (smoke test)")
    p.add_argument("--train_steps", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from . import train_lm
    from .data import prep
    from .device import resolve_device

    device = str(resolve_device(args.device))
    os.makedirs(args.out, exist_ok=True)
    report = {"n_utts": args.n_utts, "tiny": bool(args.tiny)}

    t0 = time.monotonic()
    total_sec = synth_corpus(args.out, args.n_utts, tiny=args.tiny)
    report["corpus_audio_sec"] = round(total_sec, 1)
    report["synth_s"] = round(time.monotonic() - t0, 1)

    codec_path = make_codec_bundle(args.out, tiny=args.tiny)
    ds = os.path.join(args.out, "dataset")
    codes_dir = os.path.join(ds, "codes")
    phn_dir = os.path.join(ds, "phonemes")
    os.makedirs(ds, exist_ok=True)

    t0 = time.monotonic()
    prep.main(["encode", "--manifest", os.path.join(args.out, "wav_manifest.tsv"),
               "--codec_path", codec_path, "--save_dir", codes_dir,
               "--batch_size", str(args.batch_size), "--device", device])
    enc_s = time.monotonic() - t0
    report["encode_s"] = round(enc_s, 1)
    report["encode_audio_hours_per_chip_hour"] = round(
        (total_sec / 3600.0) / (enc_s / 3600.0), 1)

    t0 = time.monotonic()
    prep.main(["phonemize", "--manifest",
               os.path.join(args.out, "text_manifest.tsv"),
               "--save_dir", phn_dir, "--num_workers", "2"])
    report["phonemize_s"] = round(time.monotonic() - t0, 1)

    t0 = time.monotonic()
    prep.main(["filemaker", "--manifest",
               os.path.join(args.out, "text_manifest.tsv"),
               "--phn_dir", phn_dir, "--codes_dir", codes_dir,
               "--output", os.path.join(ds, "manifest", "train.txt"),
               "--min_frames", "50"])
    # the same list serves as validation for the smoke run
    shutil.copy(os.path.join(ds, "manifest", "train.txt"),
                os.path.join(ds, "manifest", "validation.txt"))
    prep.main(["vocab", "--phn_dir", phn_dir,
               "--output", os.path.join(ds, "vocab.txt")])
    report["filemaker_vocab_s"] = round(time.monotonic() - t0, 1)
    with open(os.path.join(ds, "manifest", "train.txt")) as f:
        report["kept_utts"] = sum(1 for line in f if line.strip())

    # consume the artifacts: a few train_lm steps of a tiny LM
    t0 = time.monotonic()
    train_lm.main([
        "--device", device,
        "--exp_dir", os.path.join(args.out, "exp"), "--dataset_dir", ds,
        "--encodec_folder_name", "codes", "--manifest_name", "manifest",
        "--d_model", "64", "--nhead", "4", "--num_decoder_layers", "2",
        "--audio_vocab_size", "2048", "--text_vocab_size", "100",
        "--n_codebooks", "4", "--num_epochs", "1",
        "--num_steps", str(args.train_steps),
        "--val_every_n_steps", "1000", "--print_every_n_steps", "1",
        "--max_num_tokens", "2500", "--num_buckets", "2",
        "--audio_min_length", "1.0", "--audio_max_length", "15.0",
        "--text_min_length", "2", "--optimizer_name", "scaledadam",
        "--lr", "0.01",
    ])
    report["train_smoke_s"] = round(time.monotonic() - t0, 1)
    report["ok"] = True
    print(json.dumps(report))
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
