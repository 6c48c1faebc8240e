"""Quality-eval CLI of the port: score generated audio against references.

    python -m ssr_speech_tpu_torch.eval_quality --pairs manifest.jsonl \\
        [--language en] [--whisper_model ID] [--speaker_model ID] \\
        [--visqol_bin PATH] [--out report.json] [--device cuda]

The flags, manifest rows and report of ``tools/eval_quality.py`` plus
``--device`` (where the Whisper and speaker models run; default ``cuda``,
which raises without a card; nothing else here uses it). ``manifest.jsonl``
rows: {"ref": path, "gen": path, "text": optional reference transcript,
"hyp": optional hypothesis transcript}. SI-SNR always; WER/CER when every row
has both transcripts, or from Whisper's transcription of the generated audio
when every row has ``text`` and ``--whisper_model`` is given; speaker
similarity and ViSQOL when their model or binary is given. Whisper and the
speaker model need ``transformers`` (an ``ImportError`` names it when it is
absent), ViSQOL its binary. Prints the JSON report.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np


def read_pairs(path: str) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int,
                                   List[Dict]]:
    """The manifest's rows and their (reference, generated) mono waveforms
    [T] at the common sample rate (channels averaged, never concatenated)."""
    from .utils import audio as audio_io

    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    pairs, sr = [], None
    for row in rows:
        ref, sr_r = audio_io.read_wav(row["ref"])
        gen, sr_g = audio_io.read_wav(row["gen"])
        if sr_r != sr_g:
            raise ValueError(f"{row}: sample rates differ ({sr_r}, {sr_g})")
        sr = sr_r
        pairs.append((ref.mean(axis=0), gen.mean(axis=0)))
    return pairs, sr, rows


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.eval_quality")
    p.add_argument("--pairs", required=True,
                   help="jsonl of {ref, gen, text?, hyp?}")
    p.add_argument("--language", default="en", choices=["en", "zh"])
    p.add_argument("--whisper_model", default=None)
    p.add_argument("--speaker_model", default=None)
    p.add_argument("--visqol_bin", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the Whisper and speaker models run: cuda "
                        "(default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from .device import resolve_device
    from .utils import quality

    device = resolve_device(args.device)
    pairs, sr, rows = read_pairs(args.pairs)
    transcripts = None
    if rows and all("text" in r and "hyp" in r for r in rows):
        transcripts = [(r["text"], r["hyp"]) for r in rows]
    ref_texts: Optional[List[str]] = ([r["text"] for r in rows]
                                      if all("text" in r for r in rows) else None)

    asr = None
    if args.whisper_model and transcripts is None:
        from .utils.asr import WhisperAligner

        aligner = WhisperAligner(args.whisper_model, device)

        def asr(wav, sr):
            return aligner.pipe({"raw": wav, "sampling_rate": sr}).get("text", "")

    speaker = (quality.SpeakerEmbedder(args.speaker_model, device)
               if args.speaker_model else None)
    visqol = None
    if args.visqol_bin:
        from .utils.visqol import ViSQOL

        visqol = ViSQOL(args.visqol_bin, mode="speech")

    report = quality.evaluate_pairs(
        pairs, sr, transcripts=transcripts, language=args.language,
        ref_texts=ref_texts, asr=asr, speaker_model=speaker, visqol=visqol)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()
