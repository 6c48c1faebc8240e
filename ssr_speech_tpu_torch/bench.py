"""Benchmark of the PyTorch port: the four workloads of the JAX package's
``bench.py`` on one GPU.

    python3 -m ssr_speech_tpu_torch.bench                 # on the card
    python3 -m ssr_speech_tpu_torch.bench --device cpu    # the same on the CPU

The e830M LM (d_model 2048, 16 heads, 16 layers, 4 codebooks, text vocab 120)
from the port's seeded init, its decoder in the compute dtype (bf16 on CUDA),
and the default codec, with the EOG emission bias set to -1e9 so that every
loop runs its full length whatever the random weights draw:

- ``value``: en TTS RTF, 8 s generated after a 3 s prompt (150 frames) from
  120 text ids, CFG stride 5, then the codec decode;
- ``edit_rtf``: a 4 s span (150, 350) of an 8 s utterance, CFG stride 5, the
  original samples spliced into the kept regions and the watermark decode of
  the whole utterance; RTF of the generated frames (``marks.sum()``);
- ``zh_edit_rtf``: the same edit from 64 text ids at CFG stride 1 (the
  Mandarin configuration);
- ``aggregate_rtf_s8``: 8 sampled chains of the TTS request in one loop over
  a shared prompt cache (``generate_batch``).

Sampling is top-p 0.8, CFG 1.5 with ``aug_text`` and ``cfg_pretrained``; each
request runs once to warm up (its CUDA graphs are captured then) and twice
timed, each run from its own seeded ``torch.Generator``. ``codec_mae`` is
null: it compares with the upstream PyTorch tree, which is not part of this
repository. Per run a line gives the prefill ms, decode ms a step, steps,
peak device memory, the attention kernel's launches and the graphs captured;
the last line printed is one JSON object with the JAX benchmark's keys and
``device`` (the card's name and power limit). No file is written.

:func:`run_bench` is what ``main`` calls at the e830M geometry and what the
tests and ``chip_smoke.py`` call (the tests at a tiny geometry).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .config import CodecConfig, DecodeConfig, SSRModelConfig

METRIC = ("en TTS RTF (audio sec generated / wall sec, 830M LM + codec, CFG "
          "stride 5, 1 GPU)")
EDIT_NOTE = "4s span of 8s utt, aug_text cfg_stride=5, wmdecode splice of full utt"
ZH_EDIT_NOTE = "BASELINE config 4: zh chars, cfg_stride=1, same splice+wmdecode"
AGGREGATE_NOTE = "8 seed-batched chains, shared prompt cache, one decode loop"
CODEC_MAE_NOTE = "reference tree not mounted"
REQUESTS = ("tts", "edit", "zh_edit", "batch")


def e830m_config() -> SSRModelConfig:
    """The 830M LM of z_scripts/e830M.sh, as the JAX benchmark builds it."""
    return SSRModelConfig(d_model=2048, nhead=16, num_layers=16,
                          n_codebooks=4, text_vocab_size=120)


@dataclass(frozen=True)
class Sizes:
    """The workloads' sizes; the defaults are the JAX benchmark's."""

    tts_seconds: float = 8.0  # generated by the TTS request
    sx: int = 120  # text ids of the English requests
    prompt_frames: int = 150  # the TTS prompt, 3 s
    utt_frames: int = 400  # the edited utterance, 8 s
    span: Tuple[int, int] = (150, 350)  # the edited span, 4 s
    zh_sx: int = 64  # text ids of the Mandarin edit
    n_samples: int = 8  # chains of the batched TTS request
    tmax: int = 1024  # the batched request's prompt cache
    n_runs: int = 2  # timed runs after the warm-up


def bench_inputs(cfg: SSRModelConfig, codec_cfg: CodecConfig,
                 sizes: Sizes) -> Dict:
    """The requests' inputs, drawn from ``np.random.default_rng(0)`` in the
    JAX benchmark's order: TTS text and prompt, the edited utterance's codes
    and waveform, the Mandarin text."""
    ts, K = cfg.tokens, cfg.n_codebooks
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.text_vocab_size - 1, size=(sizes.sx,))
    y = rng.integers(0, ts.audio_vocab_size, size=(K, sizes.prompt_frames))
    y_edit = rng.integers(0, ts.audio_vocab_size, size=(K, sizes.utt_frames))
    wav_orig = rng.normal(size=(1, sizes.utt_frames * codec_cfg.hop_length, 1)
                          ).astype(np.float32) * 0.1
    x_zh = rng.integers(0, cfg.text_vocab_size - 1, size=(sizes.zh_sx,))
    return dict(x=x, y=y, tts_mask=[(sizes.prompt_frames, sizes.prompt_frames)],
                y_edit=y_edit, wav_orig=wav_orig, x_zh=x_zh,
                frames=int(sizes.tts_seconds * codec_cfg.frame_rate))


def decode_configs(cfg: SSRModelConfig, sizes: Sizes, frames: int,
                   **overrides) -> Dict[str, DecodeConfig]:
    """The JAX benchmark's decode configurations (``overrides`` replace
    fields of all three, e.g. ``top_k=1`` for a greedy comparison)."""
    base = dict(aug_text=True, cfg_stride=5, cfg_coef=1.5, top_k=0, top_p=0.8,
                temperature=1.0, stop_repetition=-1, cfg_pretrained=True,
                length_cap_mult=10_000)
    base.update(overrides)
    span = sizes.span[1] - sizes.span[0]
    edit = DecodeConfig(**base, max_gen_per_span=span + cfg.n_codebooks)
    return dict(tts=DecodeConfig(**base,
                                 max_gen_per_span=frames + cfg.n_codebooks),
                edit=edit, zh_edit=dataclasses.replace(edit, cfg_stride=1))


def bench_models(cfg: SSRModelConfig, codec_cfg: CodecConfig,
                 device: torch.device):
    """(LM, codec): the root ``bench.py``'s parameters, JAX's draws from
    ``PRNGKey(0)`` (LM) and ``PRNGKey(1)`` (codec) made on ``device``, the
    decoder's matrix weights in the device's compute dtype, and the EOG
    logit biased to -1e9 in every codebook, so that each request generates
    its configured budget."""
    from .data.tokenizer import AudioTokenizer
    from .device import compute_dtype
    from .models import ssr
    from .models.codec import wmencodec as wm
    from .models.from_jax import codec_from_jax, lm_from_jax
    from .utils import prng

    lm = lm_from_jax(ssr.init_ssr(prng.PRNGKey(0), cfg, device), cfg,
                     device=device, dtype=compute_dtype(device))
    with torch.no_grad():
        lm["head2_b"][:, cfg.tokens.eog] = -1e9
    codec = codec_from_jax(wm.init_wmencodec(prng.PRNGKey(1), codec_cfg,
                                             device), codec_cfg, device=device)
    return lm, AudioTokenizer(codec, codec_cfg)


@dataclass
class Run:
    """One run of a request: the decode results (one a chain), the output
    waveform (None for the batched request), the generated frames that enter
    its RTF, wall seconds and the measurements of :func:`_run`."""

    results: list
    wav: Optional[np.ndarray]
    frames: int
    wall_s: float
    stats: Dict


def bench_requests(lm, codec, cfg: SSRModelConfig, inputs: Dict,
                   decs: Dict[str, DecodeConfig], sizes: Sizes
                   ) -> Dict[str, Callable[[torch.Generator, Dict], Tuple]]:
    """name -> fn(generator, stats) -> (results, wav or None, generated
    frames), the four requests of :data:`REQUESTS` as the JAX benchmark runs
    them; ``stats`` receives ``decode``'s measurements."""
    from .inference import decode, pipeline

    hop = codec.cfg.hop_length
    pf = sizes.prompt_frames

    def tts(gen, stats):
        result = decode.generate(lm, cfg, decs["tts"], inputs["x"], inputs["y"],
                                 inputs["tts_mask"], gen, stats=stats)
        return [result], codec.decode(result[0]), result[0].shape[2] - pf

    def edit(dec, x):
        def run(gen, stats):
            result = decode.generate(lm, cfg, dec, x, inputs["y_edit"],
                                     [sizes.span], gen, stats=stats)
            codes, marks, out_iv, nm = result
            spliced = pipeline.splice_waveform(inputs["wav_orig"],
                                               codes.shape[2], hop, nm, out_iv)
            return [result], codec.wmdecode(codes, marks, spliced), \
                int(np.asarray(marks).sum())
        return run

    def batch(gen, stats):
        results = decode.generate_batch(
            lm, cfg, decs["tts"], inputs["x"], inputs["y"], inputs["tts_mask"],
            gen, sizes.n_samples, tmax=sizes.tmax, stats=stats)
        return results, None, sum(r[0].shape[2] - pf for r in results)

    return dict(tts=tts, edit=edit(decs["edit"], inputs["x"]),
                zh_edit=edit(decs["zh_edit"], inputs["x_zh"]), batch=batch)


def _captures() -> int:
    from .inference import graphs

    return sum(ws.loop.captures for ws in graphs.kept())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(fn, seed: int, device: torch.device) -> Run:
    """One run of a request from ``torch.Generator(device).manual_seed(seed)``,
    synchronised at both ends; its prefill and decode times (from
    ``decode``'s ``stats``), steps, peak device memory (None on the CPU), the
    attention kernel's launches and the CUDA graphs captured."""
    from .ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    stats: Dict = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches, captures = fa.launches, _captures()
    _sync(device)
    t0 = time.perf_counter()
    results, wav, frames = fn(gen, stats)
    _sync(device)
    wall = time.perf_counter() - t0
    steps = int(stats.get("decode_steps", 0))
    return Run(results, wav, frames, wall, dict(
        prefill_ms=stats["prefill_s"] * 1e3,
        decode_ms_per_step=stats["decode_s"] / max(steps, 1) * 1e3,
        steps=steps,
        peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                  if device.type == "cuda" else None),
        k1_launches=fa.launches - launches,
        captures=_captures() - captures))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_bench(cfg: SSRModelConfig, codec_cfg: CodecConfig,
              device: torch.device, sizes: Sizes = Sizes(), *, models=None,
              log: Callable[[str], None] = print, **dec_overrides):
    """Run the four requests on ``device``: each once to warm up and
    ``sizes.n_runs`` times timed. ``models`` (LM, ``AudioTokenizer``)
    defaults to :func:`bench_models`; ``dec_overrides`` go to
    :func:`decode_configs`. Logs a line a run and returns (the JSON line's
    dict, a report by request: ``frames`` of each run, ``elapsed_s`` (the
    timed runs' mean), ``runs`` (their measurements, warm-up first) and
    ``last`` (the last :class:`Run`))."""
    frame_rate = codec_cfg.frame_rate
    inputs = bench_inputs(cfg, codec_cfg, sizes)
    decs = decode_configs(cfg, sizes, inputs["frames"], **dec_overrides)
    lm, codec = models or bench_models(cfg, codec_cfg, device)
    fns = bench_requests(lm, codec, cfg, inputs, decs, sizes)
    report = {}
    for name in REQUESTS:
        runs = []
        for seed in range(sizes.n_runs + 1):  # seed 0: the warm-up
            run = _run(fns[name], seed, device)
            runs.append(run)
            st = run.stats
            peak = "n/a" if st["peak_gib"] is None else f"{st['peak_gib']:.2f}"
            log(f"[bench] {name} {'warm-up' if seed == 0 else f'run {seed}'}: "
                f"{run.frames} frames in {run.wall_s:.3f} s, prefill "
                f"{st['prefill_ms']:.1f} ms, decode "
                f"{st['decode_ms_per_step']:.2f} ms/step over {st['steps']} "
                f"steps, peak {peak} GiB, K1 launches {st['k1_launches']}, "
                f"graphs captured {st['captures']}")
        timed = runs[1:]
        report[name] = dict(
            frames=[r.frames for r in runs],
            elapsed_s=sum(r.wall_s for r in timed) / len(timed),
            runs=[dict(r.stats, wall_s=r.wall_s, frames=r.frames)
                  for r in runs],
            last=runs[-1])
    gen_frames = report["tts"]["frames"][0]
    audio_sec = gen_frames / frame_rate
    rtf = audio_sec / report["tts"]["elapsed_s"]

    def edit_rtf(name):
        return (report[name]["frames"][0] / frame_rate) / report[name]["elapsed_s"]

    line = {
        "metric": METRIC,
        "value": round(rtf, 3),
        "unit": "x realtime",
        "vs_baseline": round(rtf / 5.0, 3),
        "edit_rtf": round(edit_rtf("edit"), 3),
        "edit_note": EDIT_NOTE,
        "zh_edit_rtf": round(edit_rtf("zh_edit"), 3),
        "zh_edit_note": ZH_EDIT_NOTE,
        "codec_mae": None,
        "aggregate_rtf_s8": round(
            sizes.n_samples * audio_sec / report["batch"]["elapsed_s"], 2),
        "aggregate_note": AGGREGATE_NOTE,
        "codec_mae_note": CODEC_MAE_NOTE,
        "device": card_line() if device.type == "cuda" else "cpu",
    }
    return line, report


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser("ssr_speech_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from .device import resolve_device, set_precision_policy

    device = resolve_device(args.device)
    set_precision_policy()
    try:
        line, _ = run_bench(e830m_config(), CodecConfig(), device, Sizes())
    except Exception as e:  # still emit the one-line contract on failure
        print(json.dumps({
            "metric": f"en TTS RTF — BENCH FAILED: {type(e).__name__}: {e}",
            "value": 0.0, "unit": "x realtime", "vs_baseline": 0.0}))
        raise
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
