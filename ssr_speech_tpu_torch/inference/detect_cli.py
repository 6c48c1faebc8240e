"""Watermark detection CLI (port of ``ssr_speech_tpu/inference/detect_cli.py``).

Given wavs, prints one JSON line per file with the per-frame watermark
decisions of the codec's detector head and the watermarked fraction: the
user-facing way to check whether audio was produced by this system.

    python -m ssr_speech_tpu_torch.inference.detect_cli \\
        --codec_path codec.pkl --audio out/edit.wav [--frames] [--device cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.inference.detect_cli")
    p.add_argument("--codec_path", required=True)
    p.add_argument("--audio", required=True, nargs="+")
    p.add_argument("--frames", action="store_true",
                   help="also print the per-frame 0/1 stream")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="watermarked fraction at or above which audio is "
                        "flagged")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from ..device import resolve_device, set_precision_policy
    from ..models.pretrained import load_codec
    from ..utils import audio as audio_io

    device = resolve_device(args.device)
    set_precision_policy()
    tok = load_codec(args.codec_path, device)
    hop = tok.cfg.hop_length
    for path in args.audio:
        wav = audio_io.load_for_codec(path, tok.sample_rate, hop)
        marks = tok.detect_watermark(wav)[0]
        frac = float(np.mean(marks))
        out = {
            "audio": path,
            "frames": int(marks.shape[0]),
            "watermarked_fraction": round(frac, 4),
            "flagged": frac >= args.threshold,
        }
        if args.frames:
            out["per_frame"] = marks.astype(int).tolist()
        print(json.dumps(out))


if __name__ == "__main__":
    main()
