"""Data preparation CLIs of the port (``ssr_speech_tpu/data/prep.py``):
encode / phonemize / filemaker / vocab.

  - ``encode``: batched wmencodec encoding of a wav manifest to per-utterance
    code txt files, K rows of ints, with start/end sharding (reference
    ``data/encode.py:17-18,99-117``). The codec runs on ``--device`` (default
    ``cuda``; asking for it without a card is an error) in fp32, over padded
    batches at multiples of ``--bucket_frames`` codec frames, as in JAX; a
    ``.th`` codec goes through ``models.convert`` (``pretrained.
    load_codec_params``).
  - ``phonemize``: multiprocess phonemization with the GigaSpeech tag round
    trip (reference ``data/phonemize.py:36-77``), on the port's own
    ``TextTokenizer``, in spawned workers.
  - ``filemaker``: manifest of utterances that have both phn+code files and
    enough frames (reference ``data/filemaker.py:20-41``).
  - ``vocab``: scan phoneme files -> ``idx phn`` vocab.txt (reference
    ``data/vocab.py``, its append-vs-extend bug fixed as in JAX).

The output files are byte for byte those of the JAX CLI.

Run: ``python -m ssr_speech_tpu_torch.data.prep <subcommand> ...``
"""

from __future__ import annotations

import argparse
import json
import logging
import multiprocessing as mp
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


# -------------------------------------------------------------------- encode

def cmd_encode(args):
    """Returns the run's counts and wall time (files, audio seconds,
    batches, seconds, device peak GiB on a card)."""
    import time

    import torch

    from ..device import resolve_device, set_precision_policy
    from ..models import pretrained
    from ..models.codec import wmencodec as wm
    from ..models.from_jax import codec_from_jax
    from ..utils import audio as audio_io

    device = resolve_device(args.device)
    set_precision_policy()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    # a .th at the default geometry, or a bundle with its stored config
    params, cfg = pretrained.load_codec_params(args.codec_path)
    codec = codec_from_jax(params, cfg, device=device)

    with open(args.manifest) as f:
        if args.manifest.endswith(".jsonl") or args.manifest.endswith(".json"):
            metas = [json.loads(l) for l in f if l.strip()]
            paths = [m["path"] for m in metas]
        else:
            paths = [l.strip().split("\t")[0] for l in f if l.strip()]
    start = args.start if args.start >= 0 else 0
    end = args.end if args.end >= 0 else len(paths)
    paths = paths[start:end]
    os.makedirs(args.save_dir, exist_ok=True)

    hop = cfg.hop_length
    # bucket to multiples of `bucket` codec frames for static XLA shapes
    bucket = args.bucket_frames
    batch_wavs: List[np.ndarray] = []
    batch_names: List[str] = []
    batch_frames: List[int] = []

    done = dict(files=0, audio_s=0.0, batches=0)

    def flush(pad_frames: int):
        if not batch_wavs:
            return
        B = len(batch_wavs)
        wavs = np.zeros((B, pad_frames * hop, 1), np.float32)
        for i, w in enumerate(batch_wavs):
            wavs[i, : w.shape[1]] = w[0]
        codes, _, _ = wm.encode(codec, torch.from_numpy(wavs).to(device), cfg)
        codes = codes.cpu().numpy()
        done["files"] += B
        done["audio_s"] += sum(w.shape[1] for w in batch_wavs) / cfg.sample_rate
        done["batches"] += 1
        for i, (name, f) in enumerate(zip(batch_names, batch_frames)):
            out = codes[i, :, :f]
            with open(os.path.join(args.save_dir, name + ".txt"), "w") as g:
                for row in out:
                    g.write(" ".join(str(int(v)) for v in row) + "\n")
        batch_wavs.clear()
        batch_names.clear()
        batch_frames.clear()

    cur_pad = None
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            wav = audio_io.load_for_codec(path, cfg.sample_rate, hop)
        except Exception as e:
            logger.info("skipping %s: %s", path, e)
            continue
        frames = wav.shape[1] // hop
        pad = ((frames + bucket - 1) // bucket) * bucket
        if cur_pad is not None and (pad != cur_pad or len(batch_wavs) >= args.batch_size):
            flush(cur_pad)
        cur_pad = pad
        batch_wavs.append(wav)
        batch_names.append(name)
        batch_frames.append(frames)
    if cur_pad is not None:
        flush(cur_pad)
    if cuda:
        torch.cuda.synchronize(device)
    done["seconds"] = time.perf_counter() - t0
    done["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                        if cuda else None)
    logger.info("encoded %d files", len(paths))
    return done


# ----------------------------------------------------------------- phonemize

# GigaSpeech tag handling (reference data/phonemize.py:36-41): punctuation
# tags carry a LEADING SPACE so "word <COMMA>" collapses to "word,"; garbage
# tags are swapped for hash/percent sentinel words that espeak renders as
# known phone sequences, which are mapped BACK to the literal tag after
# phonemization — the tags survive into the phoneme files (and the vocab).
_GS_PUNCT = {
    " <COMMA>": ",", " <PERIOD>": ".", " <QUESTIONMARK>": "?",
    " <EXCLAMATIONPOINT>": "!",
}
_GS_GARBAGE = {"<SIL>": "#%#", "<MUSIC>": "##%", "<NOISE>": "%%#",
               "<OTHER>": "%#%"}
# transcripts that already contain a sentinel would alias a tag: skip them
# (reference data/phonemize.py:42 forbidden_words)
_GS_FORBIDDEN = frozenset(_GS_GARBAGE.values())
# espeak-ng en-us renderings of the sentinels (reference phonemize.py:41
# word2sym), keyed by the rendered space-joined phone sequence -> tag
_GS_ESPEAK_WORD2SYM = {
    "h æ ʃ h ɐ ʃ p ɚ s ɛ n t": "<MUSIC>",
    "h æ ʃ p ɚ s ɛ n t h æ ʃ": "<SIL>",
    "p ɚ s ɛ n t h ɐ ʃ p ɚ s ɛ n t": "<OTHER>",
    "p ɚ s ɛ n t p ɚ s ɛ n t h æ ʃ": "<NOISE>",
}

_worker_tok = None


def gs_word2sym(tokenizer) -> dict:
    """Rendered-sentinel -> tag map for the active backend: the recorded
    espeak renderings, or the char fallback's literal characters."""
    if tokenizer.backend is not None:
        return dict(_GS_ESPEAK_WORD2SYM)
    return {" ".join(sent): tag for tag, sent in _GS_GARBAGE.items()}


def gs_phonemize_text(tokenizer, text: str):
    """Full GigaSpeech round trip for one transcript; ``None`` = skip
    (reference data/phonemize.py:59-77 process_one)."""
    if any(word in _GS_FORBIDDEN for word in text.split(" ")):
        return None
    for tag, ch in _GS_PUNCT.items():
        text = text.replace(tag, ch)
    for tag, sentinel in _GS_GARBAGE.items():
        text = text.replace(tag, sentinel)
    phn_seq = " ".join(tokenizer(text.strip()))
    for rendered, tag in gs_word2sym(tokenizer).items():
        phn_seq = phn_seq.replace(rendered, tag)
    return phn_seq


def _phonemize_one(task):
    """GigaSpeech-style punctuation/garbage-tag round trip
    (reference data/phonemize.py:36-41,59-77)."""
    global _worker_tok
    seg_id, text, save_dir = task
    if _worker_tok is None:
        from .tokenizer import TextTokenizer

        _worker_tok = TextTokenizer(language=os.environ.get("PHN_LANG", "en-us"))
    phn_seq = gs_phonemize_text(_worker_tok, text)
    if phn_seq is None:
        logger.info("skip %s: transcript contains a sentinel word", seg_id)
        return seg_id
    with open(os.path.join(save_dir, seg_id + ".txt"), "w") as f:
        f.write(phn_seq)
    return seg_id


def cmd_phonemize(args):
    os.environ["PHN_LANG"] = args.language
    with open(args.manifest) as f:
        rows = [l.strip().split("\t") for l in f if l.strip()]
    tasks = [(r[0], r[1], args.save_dir) for r in rows]
    os.makedirs(args.save_dir, exist_ok=True)
    # spawned workers: a fork of a process that runs threads (torch's, a
    # card's) may deadlock
    with mp.get_context("spawn").Pool(args.num_workers) as pool:
        for i, _ in enumerate(pool.imap_unordered(_phonemize_one, tasks)):
            if i % 1000 == 0:
                logger.info("phonemized %d/%d", i, len(tasks))


# ----------------------------------------------------------------- filemaker

def cmd_filemaker(args):
    """Write ``0\tsegid\tn_frames`` for utts with both phn+code files
    (reference data/filemaker.py:20-41)."""
    kept, lines = 0, []
    with open(args.manifest) as f:
        seg_ids = [l.strip().split("\t")[0] for l in f if l.strip()]
    for seg in seg_ids:
        pf = os.path.join(args.phn_dir, seg + ".txt")
        ef = os.path.join(args.codes_dir, seg + ".txt")
        if not (os.path.isfile(pf) and os.path.isfile(ef)):
            continue
        with open(ef) as e:
            n_frames = len(e.readline().strip().split())
        if n_frames < args.min_frames:
            continue
        lines.append(f"0\t{seg}\t{n_frames}")
        kept += 1
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        f.write("\n".join(lines))
    logger.info("kept %d/%d", kept, len(seg_ids))


# --------------------------------------------------------------------- vocab

def cmd_vocab(args):
    """Scan phoneme files -> vocab.txt ``idx phn``
    (reference data/vocab.py; set-union done correctly)."""
    phones = set()
    for fn in sorted(os.listdir(args.phn_dir)):
        if not fn.endswith(".txt"):
            continue
        with open(os.path.join(args.phn_dir, fn)) as f:
            phones.update(f.read().strip().split(" "))
    phones.discard("")
    with open(args.output, "w") as f:
        for i, p in enumerate(sorted(phones)):
            f.write(f"{i} {p}\n")
    logger.info("vocab size %d", len(phones))


def main(argv=None):
    """Run one subcommand; returns ``encode``'s counts (None otherwise)."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.data.prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode")
    e.add_argument("--manifest", required=True,
                   help="jsonl with {path} or TSV path\\t...")
    e.add_argument("--codec_path", required=True)
    e.add_argument("--save_dir", required=True)
    e.add_argument("--batch_size", type=int, default=16)
    e.add_argument("--bucket_frames", type=int, default=128)
    e.add_argument("--start", type=int, default=-1)
    e.add_argument("--end", type=int, default=-1)
    e.add_argument("--device", default="cuda", help="cpu, cuda or cuda:N")
    e.set_defaults(fn=cmd_encode)

    ph = sub.add_parser("phonemize")
    ph.add_argument("--manifest", required=True, help="TSV segid\\ttext")
    ph.add_argument("--save_dir", required=True)
    ph.add_argument("--language", default="en-us")
    ph.add_argument("--num_workers", type=int, default=os.cpu_count())
    ph.set_defaults(fn=cmd_phonemize)

    fm = sub.add_parser("filemaker")
    fm.add_argument("--manifest", required=True)
    fm.add_argument("--phn_dir", required=True)
    fm.add_argument("--codes_dir", required=True)
    fm.add_argument("--output", required=True)
    fm.add_argument("--min_frames", type=int, default=100)
    fm.set_defaults(fn=cmd_filemaker)

    vb = sub.add_parser("vocab")
    vb.add_argument("--phn_dir", required=True)
    vb.add_argument("--output", required=True)
    vb.set_defaults(fn=cmd_vocab)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
