"""Train->serve lifecycle rehearsal of the port, with artifacts it trains
itself.

    python -m ssr_speech_tpu_torch.lifecycle_rehearsal --out /tmp/lifecycle
    python -m ssr_speech_tpu_torch.lifecycle_rehearsal --out /tmp/l --device cpu

A tiny watermark codec GAN-trained from random init (``train_codec``) and a
tiny LM overfit on data prepped through that codec (``train_lm``) drive the
inference CLI's TTS and edit; ``detect_cli`` must flag exactly the generated
spans, and the overfit LM must reproduce its training utterance token for
token through the same loaded bundle. The stages of
``tools/lifecycle_rehearsal.py``, through the port's entry points:

1. a tone corpus (one f0 an utterance, 2.56 s each) and transcripts;
2. ``train_codec`` at the tiny geometry of :data:`TINY_CODEC` (2 MS-STFT
   scales, watermark CE) -> ``codec_bundle.pkl``;
3. ``data.prep encode/phonemize/filemaker/vocab`` through that codec;
4. ``train_lm`` (d_model 64, 4 heads: head width 16, so its attention and the
   prefill's are the einsum route) overfit on the prepped dataset;
5. ``inference.cli`` TTS and edit, both watermarked, from the two bundles;
6. ``detect_cli --frames`` on the TTS output, the edit output and the
   original wav;
7. a greedy TTS decode of utterance 0's second half through the loaded
   bundle against its prepped codes.

``--device`` (default cuda; raises without a card) is where every stage
runs; the LM trains in fp32 on the CPU and bf16 on the card, as JAX's does by
backend, and the codec in fp32 (the port's default). Every stage runs under
``device.deterministic_algorithms``: the thresholds are read from one run,
and on the card the GAN's trajectory otherwise depends on which convolution
algorithms cuDNN picks. Prints one JSON report with the JAX tool's keys
(``tests/test_lifecycle.py``'s thresholds read it) and writes it to
``report.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import os
import shutil
import time

import numpy as np

WORDS = ("the tpu rebuild speaks for itself today and tomorrow with spans "
         "masked tokens codec watermark decode speech synthesis model "
         "training data pipeline phoneme vocab manifest bucket").split()

TINY_CODEC = dict(
    sample_rate=16000,
    seanet=dict(dimension=16, n_filters=2, n_residual_layers=1,
                ratios=[8, 5, 4, 2], lstm=1, norm="weight_norm",
                pad_mode="constant"),
    rvq=dict(dimension=16, n_q=2, bins=11),
)


def synth_corpus(out: str, n_utts: int, sr: int = 16000, seed: int = 0):
    """Tone+noise wavs (2.56 s: 128 codec frames at hop 320) with word
    transcripts; each utterance has its own f0 so that its codes differ.
    Writes the wav, text and codec manifests; returns the utterances."""
    from .utils import audio as audio_io

    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    wav_manifest, text_manifest, codec_manifest = [], [], []
    utts = []
    for i in range(n_utts):
        dur = 2.56
        n = int(dur * sr)
        t = np.arange(n) / sr
        f0 = 120.0 + 60.0 * i
        wav = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.1 * np.sin(2 * np.pi * 3.1 * f0 * t)
               + 0.03 * rng.normal(size=n)).astype(np.float32)
        seg = f"utt{i:05d}"
        path = os.path.join(wav_dir, seg + ".wav")
        audio_io.write_wav(path, wav[None], sr)
        words = [WORDS[(3 * i + j) % len(WORDS)] for j in range(10)]
        wav_manifest.append(f"{path}\t{seg}")
        text_manifest.append(f"{seg}\t{' '.join(words)}")
        codec_manifest.append(json.dumps(dict(path=path, duration=dur)))
        utts.append(dict(seg=seg, path=path, words=words, dur=dur))
    with open(os.path.join(out, "wav_manifest.tsv"), "w") as f:
        f.write("\n".join(wav_manifest))
    with open(os.path.join(out, "text_manifest.tsv"), "w") as f:
        f.write("\n".join(text_manifest))
    with open(os.path.join(out, "codec_manifest.jsonl"), "w") as f:
        f.write("\n".join(codec_manifest))
    return utts


def write_alignment(path: str, words, dur: float) -> None:
    """An evenly spaced word alignment CSV (the CLI's ``--alignment_file``)."""
    step = dur / (len(words) + 1)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["word", "start", "end"])
        for i, word in enumerate(words):
            w.writerow([word, round(i * step + 0.02, 3),
                        round((i + 1) * step, 3)])


def run_detect(codec_path: str, audio_paths, device: str):
    """``detect_cli --frames`` over the files -> its JSON rows."""
    from .inference import detect_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        detect_cli.main(["--codec_path", codec_path, "--frames",
                         "--device", device, "--audio", *audio_paths])
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.strip()]


def main(argv=None) -> dict:
    from .device import deterministic_algorithms

    with deterministic_algorithms():
        return rehearse(argv)


def rehearse(argv=None) -> dict:
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.lifecycle_rehearsal")
    p.add_argument("--out", required=True)
    p.add_argument("--n_utts", type=int, default=3)
    p.add_argument("--codec_steps", type=int, default=400)
    p.add_argument("--lm_steps", type=int, default=220)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from . import train_codec, train_lm
    from .data import prep
    from .device import resolve_device

    dev = resolve_device(args.device)
    device = str(dev)
    os.makedirs(args.out, exist_ok=True)
    report = {"n_utts": args.n_utts, "codec_steps": args.codec_steps,
              "lm_steps": args.lm_steps}
    t00 = time.monotonic()

    # ---- 1. corpus
    utts = synth_corpus(args.out, args.n_utts)

    # ---- 2. the watermark codec from random init (GAN + watermark CE; tiny
    # SEANet, 2-scale MS-STFT)
    t0 = time.monotonic()
    cfg_json = os.path.join(args.out, "codec_config.json")
    with open(cfg_json, "w") as f:
        json.dump(TINY_CODEC, f)
    codec_exp = os.path.join(args.out, "codec_exp")
    train_codec.main([
        "--device", device,
        "--manifest", os.path.join(args.out, "codec_manifest.jsonl"),
        "--exp_dir", codec_exp, "--config_json", cfg_json,
        "--batch_size", "2", "--segment_duration", "0.16",
        "--updates", str(args.codec_steps), "--epochs", "1",
        "--lr", "3e-3", "--ema_decay", "0.9", "--disc_scales", "2",
        "--loss_weights", "adv=4,feat=4,l1=0.1", "--wm_min_regions", "1",
        "--wm_ce_weight", "10",
        "--save_every", str(args.codec_steps),
        "--eval_every", str(10 * args.codec_steps),
        "--loader_threads", "0", "--seed", "0",
    ])
    codec_path = os.path.join(codec_exp, "codec_bundle.pkl")
    report["codec_train_s"] = round(time.monotonic() - t0, 1)

    # ---- 3. data prep through the trained codec
    t0 = time.monotonic()
    ds = os.path.join(args.out, "dataset")
    codes_dir = os.path.join(ds, "codes")
    phn_dir = os.path.join(ds, "phonemes")
    prep.main(["encode", "--manifest", os.path.join(args.out, "wav_manifest.tsv"),
               "--codec_path", codec_path, "--save_dir", codes_dir,
               "--batch_size", "4", "--device", device])
    prep.main(["phonemize", "--manifest",
               os.path.join(args.out, "text_manifest.tsv"),
               "--save_dir", phn_dir, "--num_workers", "1"])
    prep.main(["filemaker", "--manifest",
               os.path.join(args.out, "text_manifest.tsv"),
               "--phn_dir", phn_dir, "--codes_dir", codes_dir,
               "--output", os.path.join(ds, "manifest", "train.txt"),
               "--min_frames", "10"])
    shutil.copy(os.path.join(ds, "manifest", "train.txt"),
                os.path.join(ds, "manifest", "validation.txt"))
    prep.main(["vocab", "--phn_dir", phn_dir,
               "--output", os.path.join(ds, "vocab.txt")])
    report["prep_s"] = round(time.monotonic() - t0, 1)

    # ---- 4. overfit the LM on the prepped dataset
    t0 = time.monotonic()
    lm_exp = os.path.join(args.out, "lm_exp")
    train_lm.main([
        "--device", device,
        "--exp_dir", lm_exp, "--dataset_dir", ds,
        "--encodec_folder_name", "codes", "--manifest_name", "manifest",
        "--d_model", "64", "--nhead", "4", "--num_decoder_layers", "2",
        "--audio_vocab_size", str(TINY_CODEC["rvq"]["bins"]),
        "--text_vocab_size", "100",
        "--n_codebooks", str(TINY_CODEC["rvq"]["n_q"]),
        "--num_epochs", "1000000", "--num_steps", str(args.lm_steps),
        "--val_every_n_steps", "1000000", "--print_every_n_steps", "100",
        "--early_stop_step", "100000000",
        "--max_num_tokens", "2500", "--num_buckets", "1",
        "--audio_min_length", "1.0", "--audio_max_length", "15.0",
        "--text_min_length", "2", "--optimizer_name", "scaledadam",
        "--lr", "0.03", "--trm_dropout", "0", "--text_embedding_dropout", "0",
        "--text_positional_embedding_dropout", "0",
        "--audio_positional_embedding_dropout", "0",
        "--precision", "float32" if dev.type == "cpu" else "bfloat16",
    ])
    lm_path = os.path.join(lm_exp, "bundle.pkl")
    report["lm_train_s"] = round(time.monotonic() - t0, 1)

    # ---- 5. inference through the CLI with the two trained bundles
    from .inference import cli

    t0 = time.monotonic()
    u0 = utts[0]
    align_path = os.path.join(args.out, "align0.csv")
    write_alignment(align_path, u0["words"], u0["dur"])
    out_dir = os.path.join(args.out, "cli_out")
    common = [
        "--device", device,
        "--model_path", lm_path, "--codec_path", codec_path,
        "--orig_audio", u0["path"], "--alignment_file", align_path,
        "--output_dir", out_dir, "--top_k", "1", "--top_p", "1.0",
        "--temperature", "1.0", "--stop_repetition", "-1",
        "--silence_tokens", "--cfg_coef", "1.0", "--cfg_pretrained",
        "--use_watermark", "--seed", "7",
    ]
    # TTS: the prompt is the first half of utt0's audio and the target the
    # rest of its transcript, so the overfit LM regenerates the memorised
    # tail (every TTS output frame is generated, so every frame is marked)
    n_prompt = len(u0["words"]) // 2
    cli.main(common + [
        "--tts", "--prompt_length", str(u0["dur"] * 0.5),
        "--orig_transcript", " ".join(u0["words"][:n_prompt]),
        "--target_transcript", " ".join(u0["words"][n_prompt:]),
        "--savename", "tts",
    ])
    tts_wav = os.path.join(out_dir, "tts.wav")

    # edit: two middle words replaced -> one masked span in the middle
    edited = list(u0["words"])
    edited[4:6] = ["bucket", "vocab"]
    cli.main(common + [
        "--orig_transcript", " ".join(u0["words"]),
        "--target_transcript", " ".join(edited),
        "--savename", "edit", "--sub_amount", "0.12",
    ])
    edit_wav = os.path.join(out_dir, "edit.wav")
    report["inference_s"] = round(time.monotonic() - t0, 1)

    # ---- 6. watermark detection over TTS / edit / original
    t0 = time.monotonic()
    rows = run_detect(codec_path, [tts_wav, edit_wav, u0["path"]], device)
    tts_row, edit_row, clean_row = rows
    report["tts_wm_fraction"] = tts_row["watermarked_fraction"]
    report["clean_wm_fraction"] = clean_row["watermarked_fraction"]
    report["tts_flagged"] = tts_row["flagged"]
    report["clean_flagged"] = clean_row["flagged"]

    # the edit splice: the CLI's mask interval recomputed, the generated
    # length solved from the frame counts (out = orig - mask + generated)
    words = cli.read_alignment(align_path)
    _, _, _, mask_intervals = cli.prepare_job(
        words, " ".join(u0["words"]), " ".join(edited), u0["dur"],
        language="en", tts=False, codec_sr=50, sub_amount=0.12)
    if len(mask_intervals) != 1:
        raise RuntimeError(f"expected one edit span, got {mask_intervals}")
    ms, me = mask_intervals[0]
    orig_frames = clean_row["frames"]
    out_frames = edit_row["frames"]
    gen_len = out_frames - orig_frames + (me - ms)
    marks = np.asarray(edit_row["per_frame"])
    tol = 2  # the detector's look-back blurs +-2 frames at a splice
    report["edit_mask"] = [int(ms), int(me)]
    report["edit_gen_len"] = int(gen_len)
    report["edit_prefix_fp"] = float(marks[: max(ms - tol, 0)].mean())
    report["edit_gen_coverage"] = float(
        marks[ms + tol: ms + gen_len - tol].mean()) if gen_len > 2 * tol \
        else float(marks[ms:ms + gen_len].mean())
    report["edit_suffix_fp"] = float(marks[ms + gen_len + tol:].mean()) \
        if ms + gen_len + tol < out_frames else 0.0
    report["detect_s"] = round(time.monotonic() - t0, 1)

    # ---- 7. the memorised utterance token for token through the same
    # loaded bundle (greedy TTS decode of its second half)
    t0 = time.monotonic()
    import torch

    from .config import DecodeConfig
    from .data.tokenizer import TextTokenizer
    from .inference import decode as decode_mod
    from .inference import pipeline
    from .models.pretrained import load_lm

    params, cfg, phn2num = load_lm(lm_path, dev)
    text_tok = TextTokenizer(language="en-us")
    codes = np.loadtxt(os.path.join(codes_dir, u0["seg"] + ".txt"),
                       dtype=np.int32)
    if codes.ndim == 1:
        codes = codes[None]
    F = codes.shape[1]
    x = pipeline.text_to_ids(text_tok, phn2num, " ".join(u0["words"]))
    cut = F // 2
    dec = DecodeConfig(top_k=1, top_p=1.0, temperature=1.0,
                       stop_repetition=-1, kvcache=True, cfg_coef=1.0,
                       cfg_stride=5, cfg_pretrained=True, codec_sr=50, seed=7,
                       silence_tokens=())
    out_codes, _, out_iv, _ = decode_mod.generate(
        params, cfg, dec, x, codes, [(cut, F)],
        torch.Generator(device=dev).manual_seed(7))
    gen = np.asarray(out_codes[0])
    gs, ge = out_iv[0]
    gen_region = gen[:, gs:ge]
    want = codes[:, cut:cut + gen_region.shape[1]]
    n = min(gen_region.shape[1], want.shape[1])
    report["token_match"] = float(
        (gen_region[:, :n] == want[:, :n]).mean()) if n else 0.0
    report["token_truth_frames"] = int(F - cut)
    report["token_gen_frames"] = int(gen_region.shape[1])
    report["token_check_s"] = round(time.monotonic() - t0, 1)

    report["total_s"] = round(time.monotonic() - t00, 1)
    report["ok"] = True
    print(json.dumps(report))
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
