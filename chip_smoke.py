#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ssr_speech_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. Check that CUDA is present; print the card's name and power limit.
2. Build the hand-written kernels from ``ssr_speech_tpu_torch/csrc`` with nvcc.
3. Hold each kernel against its plain PyTorch version on the card, in bf16 at
   the prefill shapes of the serving path, and time both. Then hold a small
   LM's prefill (bf16, through the kernel) and the codec against the port's
   fp32 CPU path.
4. Write full-width random-weight bundles (the 830M e830M LM, the default
   encodec_large_nq4_s320 codec) from the port's seeded init, a seeded 16 kHz
   synthetic wav and a word alignment, then drive the port's CLI: a watermarked
   edit (CFG stride 5) and a TTS request, each twice, greedy (--top_k 1).
   Each run must give a finite 16 kHz wav of the expected length, go through
   the prefill kernel once per layer, and repeat bit for bit.
5. Print the kernel report (JSON), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

For kernel work alone, ``pytest -m cuda tests/test_torch_cuda.py`` holds the
kernels against their plain versions without the main path.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ATOL = 2e-2  # bf16 kernel vs plain version, unit-normal inputs, Dh = 128
# [B, H, S, Dh] of the edit request's prefill attention: the JSON report's
# kernel and plain times are taken here
MAIN_PATH_SHAPE = (2, 16, 384, 128)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def prefill_segments(torch, b: int, s: int, sx: int, x_len: int,
                     device) -> "torch.Tensor":
    """Segment ids of a CFG prefill: row 0 conditional (text padding
    [x_len, sx) banned), row 1 cfg_pretrained unconditional ([1, sx)
    banned)."""
    seg = torch.ones((b, s), dtype=torch.int32, device=device)
    seg[:, x_len:sx] = 0
    seg[1:, 1:sx] = 0
    return seg


def cuda_time_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_flash(torch, device) -> dict:
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    built = fa.load_kernel()
    print(f"[build] {built.path.name}: nvcc {built.build_seconds:.2f} s, "
          f"load total {time.perf_counter() - t0:.2f} s")
    for line in built.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")
    gen = torch.Generator(device=device).manual_seed(0)
    worst, times = 0.0, {}
    # (shape, sx, x_len): the prefills of the smoke's own requests first (the
    # edit's two CFG rows, the TTS request's one row; 128 text + 256 prefix
    # slots), then longer prompts, one of them ragged
    cases = [(MAIN_PATH_SHAPE, 128, 68), ((1, 16, 384, 128), 128, 111),
             ((2, 16, 640, 128), 128, 70), ((2, 16, 1000, 128), 192, 150)]
    for shape, sx, x_len in cases:
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32).to(torch.bfloat16)
                   for _ in range(3))
        seg = prefill_segments(torch, b, s, sx, x_len, device)
        fa.reset_launches()
        got = fa.flash_attend_xy(q, k, v, seg)
        torch.cuda.synchronize()
        if fa.launches != 1:
            raise RuntimeError("flash_attend_xy did not launch the kernel")
        want = fa.reference_attend(q, k, v, seg, 1.0 / dh ** 0.5)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"flash kernel: non-finite output at {shape}")
        valid = (seg == 1)[:, None, :, None].expand_as(got)
        err = (got.float() - want.float()).abs()[valid].max().item()
        err_all = (got.float() - want.float()).abs().max().item()
        ms = cuda_time_ms(torch, lambda: fa.flash_attend_xy(q, k, v, seg))
        plain_ms = cuda_time_ms(
            torch, lambda: fa.reference_attend(q, k, v, seg, 1.0 / dh ** 0.5))
        print(f"[flash] {shape} sx={sx} x_len={x_len}: max_abs_err valid "
              f"rows {err:.3e} (all rows {err_all:.3e}, tol {ATOL}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= ATOL:
            raise RuntimeError(f"flash kernel disagrees with the plain "
                               f"version at {shape}: {err} > {ATOL}")
        worst = max(worst, err)
        times[shape] = (ms, plain_ms)
    fa.reset_launches()
    ms, plain_ms = times[MAIN_PATH_SHAPE]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "ssr_speech_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ssr_speech_tpu/ops/flash_attention.py:68",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "shape": list(MAIN_PATH_SHAPE)}


WORDS = ["but", "when", "i", "had", "approached", "so", "near", "to",
         "them", "in", "the", "quiet", "morning", "light"]
EDIT_TARGET = "but when i saw the mirage so near to them in the quiet morning light"
TTS_TARGET = "a brand new sentence for the card to speak"
PHONES = "abcdefghijklmnopqrstuvwxyz_.!?,'"


def write_inputs(torch, device, work: Path, cfg, codec_cfg) -> dict:
    """Full-width random-weight bundles from the port's seeded init, a seeded
    6 s 16 kHz wav and a word alignment spanning it."""
    import csv

    import numpy as np

    from ssr_speech_tpu.utils import audio as audio_io
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models.codec import wmencodec as twm
    from ssr_speech_tpu_torch.models.pretrained import save_bundle

    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = tssr.init_ssr(gen, cfg, device)
    n_params = sum(t.numel() for t in _leaves(params))
    lm = work / "lm.pkl"
    save_bundle(str(lm), params=params, model_config=cfg,
                phn2num={c: i for i, c in enumerate(PHONES)})
    del params
    codec = work / "codec.pkl"
    save_bundle(str(codec), params=twm.init_wmencodec(gen, codec_cfg, device),
                config=codec_cfg)
    rng = np.random.default_rng(0)
    sr, dur = 16000, 6.0
    t = np.arange(int(sr * dur)) / sr
    wav = (0.1 * np.sin(2 * np.pi * 220.0 * t) * np.sin(2 * np.pi * 1.3 * t)
           + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)
    wav_path = work / "in.wav"
    audio_io.write_wav(str(wav_path), wav[None], sr)
    align = work / "align.csv"
    step = dur / (len(WORDS) + 1)
    with open(align, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["word", "start", "end"])
        for i, word in enumerate(WORDS):
            w.writerow([word, round(i * step + 0.05, 3), round((i + 1) * step, 3)])
    print(f"[inputs] LM {n_params / 1e6:.1f}M params ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}), codec n_filters {codec_cfg.seanet.n_filters}"
          f", {dur} s wav: written in "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(lm=str(lm), codec=str(codec), wav=str(wav_path),
                align=str(align), cfg=cfg, codec_cfg=codec_cfg)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def run_request(torch, device, inputs: dict, out_dir: Path, name: str,
                extra) -> dict:
    from ssr_speech_tpu_torch.inference import cli
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    before = fa.launches
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    stats = cli.main([
        "--device", str(device), "--model_path", inputs["lm"],
        "--codec_path", inputs["codec"], "--orig_audio", inputs["wav"],
        "--orig_transcript", " ".join(WORDS), "--alignment_file",
        inputs["align"], "--output_dir", str(out_dir), "--savename", name,
        "--top_k", "1", *extra])
    stats["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                            if cuda else float("nan"))
    stats["prefill_launches"] = fa.launches - before
    stats["wav_bytes"] = Path(stats["out_path"]).read_bytes()
    hop = inputs["codec_cfg"].hop_length
    first = stats["out_intervals"][0][1] if "--tts" in extra else 0
    expect = (stats["output_frames"] - first) * hop
    audio_s = stats["out_samples"] / stats["sample_rate"]
    steps = stats["decode_steps"]
    print(f"[{name}] mask {stats['mask_intervals']}: {steps} decode steps, "
          f"{stats['output_frames']} output frames, {audio_s:.2f} s audio; "
          f"load {stats['load_s']:.2f} s, request {stats['request_s']:.3f} s "
          f"(prefill {stats['prefill_s'] * 1e3:.1f} ms for "
          f"{stats['prefill_tokens']} tokens, decode "
          f"{stats['decode_s'] / max(steps, 1) * 1e3:.2f} ms/step), RTF "
          f"{audio_s / stats['request_s']:.3f}x realtime, peak "
          f"{stats['peak_mem_gb']:.2f} GiB, flash launches "
          f"{stats['prefill_launches']}")
    if stats["sample_rate"] != 16000 or not stats["out_finite"]:
        raise RuntimeError(f"{name}: output not a finite 16 kHz waveform")
    if stats["out_samples"] != expect or expect <= 0:
        raise RuntimeError(f"{name}: {stats['out_samples']} samples, "
                           f"expected {expect}")
    if stats["prefill_launches"] != inputs["cfg"].num_layers:
        raise RuntimeError(f"{name}: {stats['prefill_launches']} flash "
                           f"launches, expected one per layer")
    return stats


def drive_main_path(torch, device, work: Path, card: str, cfg=None,
                    codec_cfg=None) -> int:
    """The port's CLI on full-width bundles (by default the 830M
    configuration of z_scripts/e830M.sh, as __graft_entry__.py builds it, and
    the default encodec_large_nq4_s320 codec): an edit with the watermark
    splice and CFG (stride 5), and a TTS request, each twice. Returns the
    flash kernel's launches in this phase."""
    from ssr_speech_tpu.config import CodecConfig, SSRModelConfig
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    cfg = cfg or SSRModelConfig(d_model=2048, nhead=16, num_layers=16,
                                n_codebooks=4, text_vocab_size=120)
    inputs = write_inputs(torch, device, work, cfg, codec_cfg or CodecConfig())
    requests = {
        "edit": ["--target_transcript", EDIT_TARGET, "--use_watermark",
                 "--aug_text", "--cfg_pretrained", "--cfg_stride", "5"],
        "tts": ["--target_transcript", TTS_TARGET, "--tts",
                "--prompt_length", "3"],
    }
    fa.reset_launches()  # count only the main path's launches
    runs = {}
    for name, extra in requests.items():
        for rep in (1, 2):
            runs[(name, rep)] = run_request(torch, device, inputs,
                                            work / "out", f"{name}_{rep}", extra)
    launches = fa.launches
    if runs[("edit", 1)]["prefill_tokens"] != MAIN_PATH_SHAPE[2]:
        raise RuntimeError(f"edit prefill ran over "
                           f"{runs[('edit', 1)]['prefill_tokens']} tokens; the "
                           f"kernel check took {MAIN_PATH_SHAPE}")
    for name in requests:
        a, b = runs[(name, 1)], runs[(name, 2)]
        if a["wav_bytes"] != b["wav_bytes"] or a["decode_steps"] != b["decode_steps"]:
            raise RuntimeError(f"{name}: greedy output differs between runs")
        print(f"[{name}] greedy output identical over two runs "
              f"({len(a['wav_bytes'])} wav bytes) [{card}]")
    if launches != inputs["cfg"].num_layers * len(runs):
        raise RuntimeError(f"flash kernel launched {launches} times on the "
                           f"main path, expected {inputs['cfg'].num_layers} x "
                           f"{len(runs)} requests")
    return launches


def check_small_reference(torch, device) -> None:
    """What comes out is right: on small inputs, the card's results agree
    with the port's own fp32 CPU results (which the CPU tests hold against
    the JAX package). LM: the prefill through the flash kernel in bf16 vs
    fp32 on the CPU, compared on the KV cache of layers 1.. (layer 0's K/V
    come before any attention) at every position the decode attends. On the
    CPU, bf16 moves this by 6e-3 of the max, while attending one future key
    moves it by 0.33, ignoring the segments by 0.15 and uniform attention by
    0.067. Codec: encode/decode in fp32 on both."""
    import numpy as np

    from ssr_speech_tpu.config import CodecConfig, SSRModelConfig
    from ssr_speech_tpu_torch.inference import decode as tdecode
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models.codec import wmencodec as twm
    from ssr_speech_tpu_torch.models.from_jax import (codec_from_jax,
                                                      lm_from_jax)

    cfg = SSRModelConfig(d_model=256, nhead=2, num_layers=4, n_codebooks=4,
                         audio_embedding_dim=256, text_vocab_size=30,
                         head_hidden=64, max_position=1024)
    params = tssr.init_ssr(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(1)
    sx, P, x_len, p_len = 64, 256, 41, 200
    x = np.full((2, sx), cfg.text_pad_token, np.int64)
    x[0, :x_len] = rng.integers(0, cfg.text_vocab_size - 1, size=x_len)
    x[1, :x_len] = cfg.text_vocab_size - 1  # cfg_pretrained uncond row
    prefix = np.full((4, P), cfg.tokens.empty, np.int64)
    prefix[:, :p_len] = rng.integers(0, 2048, size=(4, p_len))

    def prefill(dev, dtype):
        model = lm_from_jax(params, cfg, device=dev, dtype=dtype)
        return tdecode._prefill_impl(
            model, torch.from_numpy(x).to(dev),
            torch.from_numpy(prefix).to(dev), x_len, p_len, cfg=cfg,
            tmax=512, dtype=dtype, cfg_pretrained=True, aug_text=True)

    c_cpu, ban = prefill(torch.device("cpu"), torch.float32)
    c_card, _ = prefill(device, torch.bfloat16)
    n, rel = sx + p_len, 0.0
    for b, (lo, hi) in enumerate(ban.tolist()):
        keep = torch.ones(n, dtype=torch.bool)
        keep[lo:hi] = False
        for name in ("k", "v"):
            want = getattr(c_cpu, name)[1:, b, :, :n][:, :, keep]
            got = getattr(c_card, name)[1:, b, :, :n][:, :, keep].float().cpu()
            rel = max(rel, ((got - want).abs().max()
                            / want.abs().max()).item())
    print(f"[reference] LM prefill KV cache (layers 1-{cfg.num_layers - 1}, "
          f"attended positions), bf16 card vs fp32 CPU: max abs err / max "
          f"{rel:.2e} (tol 2e-2)")
    if not rel <= 2e-2:
        raise RuntimeError("LM prefill on the card disagrees with the CPU")

    ccfg = CodecConfig()
    cparams = twm.init_wmencodec(torch.Generator().manual_seed(2), ccfg)
    wav = torch.from_numpy((rng.standard_normal((1, 16000, 1)) * 0.1
                            ).astype(np.float32))
    res = {}
    for dev in (torch.device("cpu"), device):
        codec = codec_from_jax(cparams, ccfg, device=dev)
        codes, _, _ = twm.encode(codec, wav.to(dev), ccfg)
        res[dev.type] = (codes.cpu(), twm.decode(codec, codes, ccfg).cpu())
    agree = (res["cuda"][0] == res["cpu"][0]).float().mean().item()
    mae = (twm.decode(codec_from_jax(cparams, ccfg), res["cuda"][0], ccfg)
           - res["cuda"][1]).abs().mean().item()
    print(f"[reference] codec codes card vs CPU: {agree * 100:.2f}% equal; "
          f"decode of the same codes MAE {mae:.2e} (tol 1e-5)")
    if agree < 0.99 or not mae <= 1e-5:
        raise RuntimeError("codec on the card disagrees with the CPU")


def main() -> int:
    if not (REPO / "ssr_speech_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(ssr_speech_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from ssr_speech_tpu_torch.device import resolve_device, set_precision_policy

    device = resolve_device("cuda")
    set_precision_policy()
    card = card_line()
    print(f"[card] {card}")
    kernels = [check_flash(torch, device)]
    check_small_reference(torch, device)
    work = REPO / ".smoke_work"
    try:
        kernels[0]["launches"] = drive_main_path(torch, device, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
