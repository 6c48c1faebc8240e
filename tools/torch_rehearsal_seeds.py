"""How the lifecycle rehearsal's watermark codec depends on its random draw,
in the JAX package and in the PyTorch port.

For each package and seed, trains the rehearsal's tiny watermark codec
(``lifecycle_rehearsal.TINY_CODEC`` and the rehearsal's ``train_codec``
flags, 500 steps, fp32 on the CPU) over the rehearsal's tone corpus, then,
through the port's codec functions, on each utterance: the codes' distinct
values per codebook, the detector's watermarked fraction of the whole
utterance watermark-decoded with every frame marked (``all``), of its second
half marked (``half_in``) and first half kept (``half_out``), and of the
clean wav. One JSON line per run; the runs go in parallel, one process each.

    JAX_PLATFORMS=cpu python tools/torch_rehearsal_seeds.py --out /tmp/seeds \\
        --seeds 0 1 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def train_args(corpus: str, exp: str, seed: int, steps: int) -> list:
    return ["--manifest", os.path.join(corpus, "codec_manifest.jsonl"),
            "--exp_dir", exp, "--config_json",
            os.path.join(corpus, "codec_config.json"),
            "--batch_size", "2", "--segment_duration", "0.16",
            "--updates", str(steps), "--epochs", "1", "--lr", "3e-3",
            "--ema_decay", "0.9", "--disc_scales", "2",
            "--loss_weights", "adv=4,feat=4,l1=0.1", "--wm_min_regions", "1",
            "--wm_ce_weight", "10", "--save_every", str(steps),
            "--eval_every", str(10 * steps), "--loader_threads", "0",
            "--seed", str(seed), "--precision", "float32"]


def probe(bundle: str, utts) -> list:
    """Watermark detection and code diversity of a trained codec bundle."""
    import numpy as np
    import torch

    from ssr_speech_tpu_torch.models.pretrained import load_codec
    from ssr_speech_tpu_torch.utils import audio as audio_io

    tok = load_codec(bundle, torch.device("cpu"))
    hop = tok.cfg.hop_length
    rows = []
    for u in utts:
        wav = audio_io.load_for_codec(u["path"], tok.sample_rate, hop)
        codes = tok.encode(wav)[0]
        F = codes.shape[-1]
        marked = tok.wmdecode(codes, np.ones((1, F), np.int64),
                              np.zeros_like(wav))
        half = np.zeros((1, F), np.int64)
        half[:, F // 2:] = 1
        kept = wav.copy()
        kept[:, (F // 2) * hop:] = 0
        split = tok.detect_watermark(tok.wmdecode(codes, half, kept))[0]
        rows.append(dict(
            all=float(tok.detect_watermark(marked)[0].mean()),
            half_in=float(split[F // 2 + 2:].mean()),
            half_out=float(split[:F // 2 - 2].mean()),
            clean=float(tok.detect_watermark(wav)[0].mean()),
            distinct_codes=[len(np.unique(c)) for c in codes[0]]))
    return rows


def run_one(pkg: str, seed: int, out: str, steps: int) -> dict:
    corpus = os.path.join(out, "corpus")
    exp = os.path.join(out, f"{pkg}{seed}")
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ssr_speech_tpu import train_codec
        args = train_args(corpus, exp, seed, steps)
    else:
        from ssr_speech_tpu_torch import train_codec
        args = train_args(corpus, exp, seed, steps) + ["--device", "cpu"]
    train_codec.main(args)
    with open(os.path.join(corpus, "utts.json")) as f:
        utts = json.load(f)
    return dict(package=pkg, seed=seed, steps=steps,
                utterances=probe(os.path.join(exp, "codec_bundle.pkl"), utts))


def main(argv=None):
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--one", nargs=2, default=None, metavar=("PKG", "SEED"),
                   help="run one package and seed in this process")
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one[0], int(args.one[1]), args.out,
                                 args.steps)))
        return
    from ssr_speech_tpu_torch import lifecycle_rehearsal

    corpus = os.path.join(args.out, "corpus")
    os.makedirs(corpus, exist_ok=True)
    utts = lifecycle_rehearsal.synth_corpus(corpus, 3)
    with open(os.path.join(corpus, "utts.json"), "w") as f:
        json.dump(utts, f)
    with open(os.path.join(corpus, "codec_config.json"), "w") as f:
        json.dump(lifecycle_rehearsal.TINY_CODEC, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [(pkg, seed, subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--out", args.out,
         "--steps", str(args.steps), "--one", pkg, str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env))
             for pkg in ("jax", "port") for seed in args.seeds]
    for pkg, seed, proc in procs:
        out, _ = proc.communicate()
        lines = [l for l in out.splitlines() if l.startswith("{")]
        print(lines[-1] if proc.returncode == 0 and lines else json.dumps(
            dict(package=pkg, seed=seed, failed=proc.returncode)), flush=True)


if __name__ == "__main__":
    main()
