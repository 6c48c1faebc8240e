"""Profile the port's LM training step on one card and compare its kernels
with the plain paths end to end.

    python3 -m ssr_speech_tpu_torch.profile_train   # from the root of a checkout

Trains the 830M e830M geometry through ``train_lm.main`` with the flags of
``chip_smoke.py``'s training phase (its seeded synthetic corpus, its first
batch repeated by ``--benchmark_no_load``, ScaledAdam, the CLI's dropouts),
once per variant, in one process:

- ``flash+fused``: the attention and CE-head kernels (as the smoke);
- ``flash+unfused``: the plain CE head;
- ``einsum+fused``: the plain attention;
- ``flash+fused`` again, to show the drift between runs;
- ``flash+fused+profile``: ``--profile_steps 3``, whose ``summary.json``
  gives device time by kernel group and the idle share.

Each variant's ms/step (the steps after the first), positions/s, peak device
memory and per-token losses, or the error it stopped on (such as running out
of device memory), go to ``chiprun_out/train_profile.json``.
"""

from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

STEPS = 6  # --num_steps: steps 0..STEPS
VARIANTS = (("flash+fused", "flash", "fused", 0),
            ("flash+unfused", "flash", "unfused", 0),
            ("einsum+fused", "einsum", "fused", 0),
            ("flash+fused", "flash", "fused", 0),
            ("flash+fused+profile", "flash", "fused", 3))


def _set(argv, flag: str, value: str) -> None:
    argv[argv.index(flag) + 1] = value


def run_variant(smoke, device, work: Path, root: str, attn: str, ce: str,
                profile_steps: int) -> dict:
    from . import train_lm

    argv = smoke.train_argv(device, work, root)
    _set(argv, "--attn_impl", attn)
    _set(argv, "--ce_impl", ce)
    _set(argv, "--num_steps", str(STEPS))
    argv += ["--profile_steps", str(profile_steps)]
    shutil.rmtree(work / "train_exp", ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    rec = {"attn_impl": attn, "ce_impl": ce, "profile_steps": profile_steps}
    try:
        trainer = train_lm.main(argv)
    except torch.cuda.OutOfMemoryError as e:
        rec["error"] = f"out of device memory: {str(e).splitlines()[0]}"
        return rec
    finally:
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = trainer.history
    b, sx, sy = hist[0]["batch_shape"]
    ms = [h["seconds"] * 1e3 for h in hist]
    rec.update(batch_shape=[b, sx, sy], real_tokens=hist[0]["real_tokens"],
               first_step_ms=ms[0], step_ms=ms[1:],
               mean_step_ms=sum(ms[1:]) / len(ms[1:]),
               positions_per_s=b * (sx + sy) / (sum(ms[1:]) / len(ms[1:]) / 1e3),
               loss_per_token=[h["loss"] / max(h["ntokens"], 1.0) for h in hist],
               skipped=sum(h["skipped"] for h in hist))
    summary = Path(trainer.exp_dir) / "profile" / "summary.json"
    if profile_steps and summary.is_file():
        rec["profile"] = json.loads(summary.read_text())
    del trainer
    return rec


def main() -> int:
    repo = Path.cwd()
    if not (repo / "chip_smoke.py").is_file() or not torch.cuda.is_available():
        print("run from the root of a checkout, on a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    import chip_smoke as smoke

    from .device import resolve_device

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    work = repo / ".smoke_work" / "profile_train"
    out = {"card": card, "variants": []}
    try:
        root = smoke.write_corpus(work)
        for name, attn, ce, prof in VARIANTS:
            rec = run_variant(smoke, device, work, root, attn, ce, prof)
            rec["name"] = name
            out["variants"].append(rec)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[profile_train] {name}: "
                  + (rec["error"] if "error" in rec else
                     f"{rec['mean_step_ms']:.1f} ms/step "
                     f"({', '.join(f'{x:.1f}' for x in rec['step_ms'])}), "
                     f"{rec['positions_per_s']:.0f} positions/s")
                  + f", peak {rec['peak_gib']:.2f} GiB [{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    base = out["variants"][0].get("loss_per_token")
    for rec in out["variants"]:
        if base and "loss_per_token" in rec:
            rec["max_loss_diff_vs_first"] = max(
                abs(a - b) for a, b in zip(rec["loss_per_token"], base))
    dest = repo / "chiprun_out" / "train_profile.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    print(f"[profile_train] written to {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
