#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ssr_speech_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. Check that CUDA is present; print the card's name and power limit.
2. Build the hand-written kernels from ``ssr_speech_tpu_torch/csrc`` with nvcc,
   one process per source, all at once. Write the training corpus of step 5
   and take the batch ``train_lm.main`` will train on from it.
3. Hold each kernel against its plain PyTorch version on the card in bf16, and
   time both with CUDA events: the attention forward at the prefill shapes of
   the serving path; the attention forward's log-sum-exp and the backward on
   the training batch ([B, 16, Sx + Sy, 128] with its own segments) and at
   [8,16,1280,128] and a ragged S = 1000 (padded-batch segments; every row,
   two runs bit for bit); both also on five layouts that make the kernels
   skip tiles (a text-pad block, an audio-pad block, the banned [1, sx) row,
   ids beyond {0, 1}, rows alone in their segment), against the dense and
   the tiled plain versions; the forward at the multi-prompt prefill's
   exact shape and per-row segments; ``tile_visits`` on the card against the
   dense mask at every case, with the visited share of the causal tiles; the
   forward timed at the training batch's shape too; the fused CE head's forward, dhidden and dw2/db2 on
   the training batch (K = 4, N = B(Sy - 1), Hh = 1024, C = 2056, its
   targets), at N = 8000 and at two small ragged shapes (C no multiple of 8,
   N no multiple of 64), forward and backward twice bit for bit, the
   forward's pre-pass (the target logit) within 1e-4 of the plain one; the int8 weight-streaming matvecs at the
   probe's full width (2, 8 and 64 rows against [2048, 8192] int8: K7 and
   K8, one layer and the 16-layer chain in both modes, each chain with and
   without programmatic dependent launch and as a CUDA graph, all three bit
   for bit; the 16-layer megakernel at 2 and 8 rows, with every column of
   its last layer's fp32 sums (``return_acc``) against the plain last layer,
   and its weight stream alone timed beside it; the int8 mode bit for bit,
   every kernel twice bit for bit). Beside the attention kernels one
   PyTorch call that computes the same function
   (``scaled_dot_product_attention`` and its autograd backward), and beside
   K7, K8's bf16 mode and the megakernel ``torch._weight_int8pack_mm`` (16
   chained calls for a chain), are timed as yardsticks; the port never
   calls them. Then hold a small LM's
   prefill and the codec, and a 4-layer training step (loss and gradients),
   against the port's fp32 CPU path, and train that LM a few steps: the loss
   must fall.
4. Serving: write full-width random-weight bundles (the 830M e830M LM, the
   default encodec_large_nq4_s320 codec) from the port's seeded init, a seeded
   16 kHz synthetic wav and a word alignment, then drive the port's CLI: a
   watermarked edit (CFG stride 5) and a TTS request, each twice, greedy
   (--top_k 1). Each run must give a finite 16 kHz wav of the expected length,
   go through the prefill kernel once per layer, and repeat bit for bit.
   Batched serving on the same bundles: one shared decode step (16 rows over
   a shared prefill) against the single step on the same rows, within the
   bf16 tolerance; the edit with ``--sample_batch_size 8`` (16 rows) twice,
   its 8 greedy wavs identical to each other and over the runs, one prefill
   launch per layer, aggregate RTF printed; and ``inference_multi`` over
   three jobs (the edit, a two-span mask, a shorter text: 6 rows with ragged
   text and prefix lengths) twice, bit for bit, one prefill launch per layer
   per call, at the layout K1 was held at in step 3.
5. Training: over the seeded synthetic corpus (600 utterances of 2-20 s),
   drive ``ssr_speech_tpu_torch.train_lm.main`` on the e830M geometry with
   the flash and fused-CE kernels, ScaledAdam and the CLI's dropouts for 6
   steps: finite losses, no skipped step, moved parameters, a bundle the
   serving loader reads, each kernel launched exactly as often as the steps
   and layers require, and every step on the batch shape the kernels were
   checked at.
6. The int8 probe: ``ssr_speech_tpu_torch.int8_probe.main`` at its full width
   (d_model 2048, FFN 8192, 16 layers, 2 and 8 rows): every chain must launch
   its kernel once per layer and call, the megakernel once per call, with
   finite outputs; each chain's CUDA graph is captured from 16 launches and
   its replay equals the eager chain.
7. Codec training (no hand kernel runs here: convolutions, FFTs and
   matrix products are PyTorch calls, as they are XLA ops in JAX): one TINY
   watermark-codec step on the card against the port's fp32 CPU path
   (metrics within 1e-4 relative, watermark-decoder gradients within 1e-3
   of each leaf's largest) and against a second card run; then
   ``ssr_speech_tpu_torch.train_codec.main`` from step 4's full-width codec
   bundle over a seeded synthetic 16 kHz corpus, batch 16 x 2 s, all five
   MS-STFT scales: 6 fp32 steps (finite metrics each step, the frozen
   encoder, decoder and quantizer bit-identical to the bundle, the
   watermark decoder moved, the balancer's count 6, the saved bundle loaded
   by ``load_codec`` and read by ``detect_cli``, one decision per frame of
   a stored sample), 2 bf16 steps (the first within 5% of fp32's), and a
   profiled run; ms/step, peak GiB, eval SI-SNR and the device time by
   kernel group are printed, and a ``{"codec_train": ...}`` line.
8. Print the kernel report (JSON; each kernel's launches are those of steps
   4 to 6, counted from zero before each path, the flash forward's also by
   path; ``bound_ms`` is the least time the
   card could take for the same work, from the inputs' bytes and operations
   and the published peaks below), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

For kernel work alone, ``pytest -m cuda tests/test_torch_cuda.py`` holds the
kernels against their plain versions without the main paths.
"""

from __future__ import annotations

import gc
import json
import math
import os
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


# Published peaks of one H100 SXM (dense, at its full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def bound(n_bytes: float, ops: float, dtype: str) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once) over
    the memory rate and its operations over the peak rate of their type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attended_pairs(seg) -> int:
    """(query, key) pairs the mask lets through: key <= query, same
    segment."""
    total = 0
    for v in seg.unique().tolist():
        c = (seg == v).sum(dim=1).double()
        total += int((c * (c + 1) / 2).sum().item())
    return total


def attention_mask(torch, seg):
    """The kernels' mask as a boolean [B, 1, S, S] for the library call."""
    s = seg.shape[1]
    return ((seg[:, None, :] == seg[:, :, None]) & torch.ones(
        (s, s), dtype=torch.bool, device=seg.device).tril())[:, None]


SKIP_SHAPE = (5, 4, 640, 128)  # one batch row per layout of skip_segments


def skip_segments(torch, s: int, sx: int, device):
    """Five rows of segment ids that make the kernels skip tiles, one layout
    each: a block of text padding, a block of audio padding, the
    unconditional CFG row's banned [1, sx), runs of ids beyond {0, 1}, and
    rows alone in their segment (the first, a middle and the last)."""
    seg = torch.ones((5, s), dtype=torch.int32)
    seg[0, 40:sx] = 0
    seg[1, s - 170:] = 0
    seg[2, 1:sx] = 0
    ids = torch.tensor([-7, 3, 1 << 20, 0, 5, -(1 << 30)], dtype=torch.int32)
    seg[3] = ids[(torch.arange(s) // 90) % len(ids)]
    seg[4, 0], seg[4, s // 2], seg[4, s - 1] = 9, 7, 3
    return seg.to(device)


def check_tile_visits(torch, fa, seg) -> float:
    """``tile_visits`` on the card against the dense mask: no tile that holds
    an attending pair is skipped, every diagonal tile is visited. Returns the
    visited share of the causal tiles."""
    b, s = seg.shape
    vis = fa.tile_visits(seg)
    t = vis.shape[1]
    pad = t * fa.TILE - s
    ok = torch.nn.functional.pad(attention_mask(torch, seg)[:, 0], (0, pad, 0, pad))
    need = ok.view(b, t, fa.TILE, t, fa.TILE).any(4).any(2)
    if (need & ~vis).any() or not vis.diagonal(dim1=1, dim2=2).all():
        raise RuntimeError(f"tile_visits skips a tile the mask needs at S = {s}")
    causal = torch.ones((t, t), dtype=torch.bool, device=seg.device).tril()
    return (vis & causal).sum().item() / (b * causal.sum().item())


def check_flash(torch, device, multi_seg, server_seg) -> dict:
    """K1 against its plain versions: on the skip layouts, at the serving
    prefills' shapes, at the multi-prompt prefill's exact shape and per-row
    segments ``multi_seg`` (each row its own dead text and prefix tails),
    and at the continuous server's prefill of one request ``server_seg``
    ([cond, uncond] over the server's padded geometry), with the visited
    share of the tiles checked against the dense mask at each."""
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(0)
    worst, times = 0.0, {}
    # the layouts that exercise the skip rule: every row against the dense
    # plain version, the output and LSE against the tiled plain version too
    q, k, v = (torch.randn(SKIP_SHAPE, generator=gen, device=device,
                           dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    seg = skip_segments(torch, SKIP_SHAPE[2], 192, device)
    scale = 1.0 / SKIP_SHAPE[3] ** 0.5
    share = check_tile_visits(torch, fa, seg)
    got, lse = fa.flash_forward(q, k, v, seg, scale, with_lse=True)
    want = fa.reference_attend(q, k, v, seg, scale)
    tiled, tiled_lse = fa.tiled_forward(q, k, v, seg, scale)
    torch.cuda.synchronize()
    errs = {"dense plain": (got.float() - want.float()).abs().max().item(),
            "tiled plain": (got.float() - tiled.float()).abs().max().item()}
    lse_err = (lse - tiled_lse).abs().max().item()
    print(f"[flash] skip layouts {SKIP_SHAPE} (text pad, audio pad, banned "
          f"[1, sx), ids beyond {{0, 1}}, rows alone): max_abs_err on every row "
          + ", ".join(f"vs {k_} {e:.3e}" for k_, e in errs.items())
          + f" (tol {ATOL}); lse vs tiled plain {lse_err:.2e} (tol {LSE_ATOL}); "
          f"tile_visits covers the dense mask, visits {share:.3f} of the "
          f"causal tiles")
    if not (max(errs.values()) <= ATOL and lse_err <= LSE_ATOL
            and torch.isfinite(got).all()):
        raise RuntimeError(f"flash kernel disagrees with its plain versions on "
                           f"the skip layouts: {errs}, lse {lse_err}")
    worst = max(errs.values())
    del q, k, v, got, want, tiled
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
        share = check_tile_visits(torch, fa, seg)
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
        if shape == MAIN_PATH_SHAPE:
            mask = attention_mask(torch, seg)
            library_ms = cuda_time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask))
            lower = bound(nbytes(q, k, v, seg) + nbytes(q),
                          4 * h * dh * attended_pairs(seg), "bf16")
        print(f"[flash] {shape} sx={sx} x_len={x_len}: max_abs_err valid "
              f"rows {err:.3e} (all rows {err_all:.3e}, tol {ATOL}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms; visits {share:.3f} of "
              f"the causal tiles")
        if not err <= ATOL:
            raise RuntimeError(f"flash kernel disagrees with the plain "
                               f"version at {shape}: {err} > {ATOL}")
        worst = max(worst, err)
        times[shape] = (ms, plain_ms)
    multi = check_flash_multi(torch, fa, gen, multi_seg, "multi prefill")
    server = check_flash_multi(torch, fa, gen, server_seg, "server prefill")
    worst = max(worst, multi["max_abs_err"], server["max_abs_err"])
    fa.reset_launches()
    ms, plain_ms = times[MAIN_PATH_SHAPE]
    print(f"[flash] encoding the launch's three TMA tensor maps on the host: "
          f"{fa.last_encode_us():.2f} us (of {ms * 1e3:.1f} us a call at "
          f"{MAIN_PATH_SHAPE})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "ssr_speech_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "ssr_speech_tpu/ops/flash_attention.py:68",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, **lower, "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention(attn_mask=causal & "
                       "same segment)", "shape": list(MAIN_PATH_SHAPE),
            "multi_prefill": multi, "server_prefill": server}


def check_flash_multi(torch, fa, gen, seg, label: str) -> dict:
    """K1 at a prefill's shape [R, 16, sx + P, 128] with its per-row
    segments (the multi-prompt prefill's 2S rows, or the continuous
    server's [cond, uncond] of one request): the valid rows against the
    dense plain version, the skip rule against the dense mask; kernel, plain
    and library timed with CUDA events, the bound from the attending
    pairs."""
    b, s = seg.shape
    shape = (b, 16, s, 128)
    q, k, v = (torch.randn(shape, generator=gen, device=seg.device,
                           dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    share = check_tile_visits(torch, fa, seg)
    fa.reset_launches()
    got = fa.flash_attend_xy(q, k, v, seg)
    torch.cuda.synchronize()
    if fa.launches != 1:
        raise RuntimeError("flash_attend_xy did not launch the kernel")
    want = fa.reference_attend(q, k, v, seg, 1.0 / 128 ** 0.5)
    valid = (seg == 1)[:, None, :, None].expand_as(got)
    err = (got.float() - want.float()).abs()[valid].max().item()
    if not (torch.isfinite(got).all() and err <= ATOL):
        raise RuntimeError(f"flash kernel disagrees with the plain version at "
                           f"the {label} {shape}: {err} > {ATOL}")
    mask = attention_mask(torch, seg)
    res = {"shape": list(shape), "max_abs_err": err,
           "ms": cuda_time_ms(torch, lambda: fa.flash_attend_xy(q, k, v, seg)),
           "plain_ms": cuda_time_ms(torch, lambda: fa.reference_attend(
               q, k, v, seg, 1.0 / 128 ** 0.5)),
           "library_ms": cuda_time_ms(
               torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask)),
           **bound(nbytes(q, k, v, seg) + nbytes(q),
                   4 * 16 * 128 * attended_pairs(seg), "bf16"),
           "visited_share_of_causal_tiles": share,
           "valid_keys_by_row": (seg == 1).sum(dim=1).tolist()}
    print(f"[flash] {label} {shape}, valid keys by row "
          f"{res['valid_keys_by_row']}: max_abs_err valid rows {err:.3e} (tol "
          f"{ATOL}); kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
          f"ms, library {res['library_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']}; tile_visits covers "
          f"the dense mask, visits {share:.3f} of the causal tiles")
    return res


WORDS = ["but", "when", "i", "had", "approached", "so", "near", "to",
         "them", "in", "the", "quiet", "morning", "light"]
EDIT_TARGET = "but when i saw the mirage so near to them in the quiet morning light"
TTS_TARGET = "a brand new sentence for the card to speak"
PHONES = "abcdefghijklmnopqrstuvwxyz_.!?,'"
WAV_SECONDS = 6.0  # the seeded source wav: 300 codec frames
BATCH = 8  # --sample_batch_size of the batched request: 16 rows under CFG
# the multi-prompt request's jobs (target text, mask in codec frames): the
# edit (its own mask, None), the same audio with two spans, a shorter text
MULTI_JOBS = ((EDIT_TARGET, None), (EDIT_TARGET, ((40, 80), (170, 210))),
              ("i saw the mirage", None))


def alignment_words(dur: float = WAV_SECONDS) -> list:
    """(word, start, end) rows of the seeded wav's word alignment."""
    step = dur / (len(WORDS) + 1)
    return [(word, round(i * step + 0.05, 3), round((i + 1) * step, 3))
            for i, word in enumerate(WORDS)]


def multi_jobs(wav_path: str) -> list:
    """``pipeline.inference_multi`` jobs of ``MULTI_JOBS`` over the wav; the
    edit's mask is the CLI's for the edit request."""
    from ssr_speech_tpu_torch.inference import cli

    edit_mask = cli.prepare_job(alignment_words(), " ".join(WORDS),
                                EDIT_TARGET, WAV_SECONDS)[3]
    return [dict(audio_path=wav_path, target_text=text,
                 mask_interval=[tuple(m) for m in (mask or edit_mask)])
            for text, mask in MULTI_JOBS]


def multi_layout(torch, cfg, device):
    """The multi-prompt prefill's layout for ``MULTI_JOBS`` under CFG (2S
    rows), from the host code ``generate_multi`` runs: (the lengths its
    ``stats`` must report, segment ids [2S, sx + P] on ``device``)."""
    import numpy as np

    from ssr_speech_tpu_torch.data.tokenizer import TextTokenizer
    from ssr_speech_tpu_torch.inference import decode, pipeline
    from ssr_speech_tpu_torch.ops import patterns

    tok = TextTokenizer(language="en-us")
    phn2num = {c: i for i, c in enumerate(PHONES)}
    y = np.zeros((cfg.n_codebooks, int(WAV_SECONDS * 50)), np.int32)
    jobs = multi_jobs("")
    x_lens = [len(pipeline.text_to_ids(tok, phn2num, j["target_text"]))
              for j in jobs] * 2
    p_lens = [patterns.build_inference_prefix(y, j["mask_interval"],
                                              cfg.tokens)[0].shape[1]
              for j in jobs]
    sx = decode._bucket(max(x_lens), decode.X_BUCKET)
    P = decode._bucket(max(p_lens), decode.PREFIX_BUCKET)
    dead = decode.multi_dead_keys(torch.tensor(x_lens), torch.tensor(p_lens),
                                  sx, P, aug_text=True, cfg_pretrained=True)
    return (dict(x_lens=x_lens, p_lens=p_lens, sx_pad=sx, p_pad=P),
            (~dead).to(device, torch.int32))


def write_inputs(torch, device, work: Path, cfg, codec_cfg) -> dict:
    """Full-width random-weight bundles from the port's seeded init, a seeded
    6 s 16 kHz wav and a word alignment spanning it."""
    import csv

    import numpy as np

    from ssr_speech_tpu_torch.utils import audio as audio_io
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models.codec import wmencodec as twm
    from ssr_speech_tpu_torch.models.pretrained import save_bundle
    from ssr_speech_tpu_torch.utils.tree import tree_leaves

    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = tssr.init_ssr(gen, cfg, device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    lm = work / "lm.pkl"
    save_bundle(str(lm), params=params, model_config=cfg,
                phn2num={c: i for i, c in enumerate(PHONES)})
    del params
    codec = work / "codec.pkl"
    save_bundle(str(codec), params=twm.init_wmencodec(gen, codec_cfg, device),
                config=codec_cfg)
    rng = np.random.default_rng(0)
    sr, dur = 16000, WAV_SECONDS
    t = np.arange(int(sr * dur)) / sr
    wav = (0.1 * np.sin(2 * np.pi * 220.0 * t) * np.sin(2 * np.pi * 1.3 * t)
           + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)
    wav_path = work / "in.wav"
    audio_io.write_wav(str(wav_path), wav[None], sr)
    align = work / "align.csv"
    with open(align, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["word", "start", "end"])
        w.writerows(alignment_words())
    print(f"[inputs] LM {n_params / 1e6:.1f}M params ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}), codec n_filters {codec_cfg.seanet.n_filters}"
          f", {dur} s wav: written in "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(lm=str(lm), codec=str(codec), wav=str(wav_path),
                align=str(align), cfg=cfg, codec_cfg=codec_cfg)


def run_request(torch, device, inputs: dict, out_dir: Path, name: str,
                extra) -> dict:
    from ssr_speech_tpu_torch.inference import cli
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    before = fa.launches
    stats = cli.main([
        "--device", str(device), "--model_path", inputs["lm"],
        "--codec_path", inputs["codec"], "--orig_audio", inputs["wav"],
        "--orig_transcript", " ".join(WORDS), "--alignment_file",
        inputs["align"], "--output_dir", str(out_dir), "--savename", name,
        "--top_k", "1", *extra])
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
          f"{stats['peak_mem_gib'] or float('nan'):.2f} GiB, flash launches "
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


def serving_config():
    """The 830M LM of z_scripts/e830M.sh, as __graft_entry__.py builds it."""
    from ssr_speech_tpu_torch.config import SSRModelConfig

    return SSRModelConfig(d_model=2048, nhead=16, num_layers=16,
                          n_codebooks=4, text_vocab_size=120)


def drive_main_path(torch, device, work: Path, card: str, cfg=None,
                    codec_cfg=None) -> dict:
    """The port's CLI on full-width bundles (by default the 830M
    configuration of z_scripts/e830M.sh, as __graft_entry__.py builds it, and
    the default encodec_large_nq4_s320 codec): an edit with the watermark
    splice and CFG (stride 5), and a TTS request, each twice. Returns the
    flash kernel's launches in this phase, the inputs and the first edit
    run's statistics."""
    from ssr_speech_tpu_torch.config import CodecConfig
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    cfg = cfg or serving_config()
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
    return dict(launches=launches, inputs=inputs, edit=runs[("edit", 1)])


def cli_argv(device, inputs: dict, out_dir: Path, name: str, extra) -> list:
    return ["--device", str(device), "--model_path", inputs["lm"],
            "--codec_path", inputs["codec"], "--orig_audio", inputs["wav"],
            "--orig_transcript", " ".join(WORDS), "--alignment_file",
            inputs["align"], "--output_dir", str(out_dir), "--savename", name,
            "--top_k", "1", *extra]


def drive_batched_path(torch, device, main: dict, work: Path, card: str) -> dict:
    """The CLI's edit request with ``--sample_batch_size 8`` (16 rows under
    CFG), twice: every seed's wav finite, of the expected length and
    identical to the others bit for bit (greedy), the two runs identical, one
    flash launch per layer per request. Prints the aggregate RTF (8 x audio
    s / request s), decode ms/step, prefill ms and peak GiB, and the first
    decode step at which a chain differs from the single edit's (not a
    gate: another row count may round a near-tie the other way). Returns
    the flash kernel's launches in this phase and the first run's
    statistics."""
    import numpy as np

    from ssr_speech_tpu_torch.inference import cli
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    inputs = main["inputs"]
    cfg = inputs["cfg"]
    hop = inputs["codec_cfg"].hop_length
    extra = ["--target_transcript", EDIT_TARGET, "--use_watermark",
             "--aug_text", "--cfg_pretrained", "--cfg_stride", "5",
             "--sample_batch_size", str(BATCH)]
    fa.reset_launches()  # count only this path's launches
    runs = []
    for rep in (1, 2):
        before = fa.launches
        st = cli.main(cli_argv(device, inputs, work / "out", f"batch_{rep}",
                               extra))
        st["prefill_launches"] = fa.launches - before
        st["wav_bytes"] = [Path(p).read_bytes() for p in st["out_paths"]]
        audio_s = sum(st["out_samples"]) / st["sample_rate"]
        steps = st["decode_steps"]
        st["aggregate_rtf"] = audio_s / st["request_s"]
        print(f"[batch-{BATCH}] run {rep}: {steps} decode steps of "
              f"{2 * BATCH} rows, {len(st['out_paths'])} wavs of "
              f"{st['out_samples'][0] / st['sample_rate']:.2f} s; request "
              f"{st['request_s']:.3f} s (prefill {st['prefill_s'] * 1e3:.1f} "
              f"ms for {st['prefill_tokens']} tokens, decode "
              f"{st['decode_s'] / max(steps, 1) * 1e3:.2f} ms/step), aggregate "
              f"RTF {st['aggregate_rtf']:.3f}x realtime ({BATCH} x audio s / "
              f"request s), peak {st['peak_mem_gib'] or float('nan'):.2f} GiB, "
              f"flash launches {st['prefill_launches']} [{card}]")
        expect = [f * hop for f in st["output_frames"]]
        if (st["n_samples"] != BATCH or not st["out_finite"]
                or st["sample_rate"] != 16000):
            raise RuntimeError(f"batch run {rep}: not {BATCH} finite 16 kHz wavs")
        if st["out_samples"] != expect or min(expect) <= 0:
            raise RuntimeError(f"batch run {rep}: {st['out_samples']} samples, "
                               f"expected {expect}")
        if len(set(st["wav_bytes"])) != 1:
            raise RuntimeError(f"batch run {rep}: the {BATCH} greedy chains "
                               "differ from each other")
        if st["prefill_launches"] != cfg.num_layers:
            raise RuntimeError(f"batch run {rep}: {st['prefill_launches']} "
                               "flash launches, expected one per layer")
        runs.append(st)
    launches = fa.launches
    if runs[0]["wav_bytes"] != runs[1]["wav_bytes"]:
        raise RuntimeError("batched greedy output differs between runs")
    single, batch = main["edit"]["out_tokens"], runs[0]["out_tokens"][0]
    diff = np.nonzero((single != batch).any(axis=0))[0]
    print(f"[batch-{BATCH}] {BATCH} chains bit-identical to each other and over "
          f"two runs; against the single edit request ({main['edit']['decode_steps']} "
          f"steps, {runs[0]['decode_steps']} here): "
          + (f"first differs at decode step {int(diff[0])}" if diff.size
             else "the same tokens at every step"))
    return dict(launches=launches, stats=runs[0])


def drive_multi_path(torch, device, main: dict, layout: dict, card: str) -> dict:
    """``pipeline.inference_multi`` over ``MULTI_JOBS`` (6 rows under CFG,
    stride 5, greedy, watermarked), twice: finite waveforms, bit-identical
    between runs, one flash launch per layer per call, and the prefill's
    layout (text and prefix lengths, pads) the one ``check_flash`` held K1
    at. Returns the flash kernel's launches in this phase and the first
    call's statistics."""
    import numpy as np

    from ssr_speech_tpu_torch.config import DecodeConfig
    from ssr_speech_tpu_torch.data.tokenizer import TextTokenizer
    from ssr_speech_tpu_torch.inference import pipeline
    from ssr_speech_tpu_torch.models import pretrained
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    inputs = main["inputs"]
    lm, cfg, phn2num = pretrained.load_lm(inputs["lm"], device)
    audio_tok = pretrained.load_codec(inputs["codec"], device)
    text_tok = TextTokenizer(language="en-us")
    dec = DecodeConfig(top_k=1, cfg_pretrained=True)  # the CLI's edit flags
    jobs = multi_jobs(inputs["wav"])
    cuda = device.type == "cuda"
    fa.reset_launches()  # count only this path's launches
    runs = []
    for rep in (1, 2):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        stats = {}
        t0 = time.perf_counter()
        outs = pipeline.inference_multi(lm, cfg, dec, phn2num, text_tok,
                                        audio_tok, jobs, use_watermark=True,
                                        stats=stats)
        stats["request_s"] = time.perf_counter() - t0
        stats["peak_mem_gib"] = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                                 if cuda else float("nan"))
        audio_s = sum(o.shape[1] for o in outs) / audio_tok.sample_rate
        steps = stats["decode_steps"]
        stats["aggregate_rtf"] = audio_s / stats["request_s"]
        print(f"[multi-{len(jobs)}] run {rep}: masks "
              f"{[j['mask_interval'] for j in jobs]}, {steps} decode steps of "
              f"{2 * len(jobs)} rows; request {stats['request_s']:.3f} s "
              f"(prefill {stats['prefill_s'] * 1e3:.1f} ms for "
              f"{stats['prefill_tokens']} tokens, decode "
              f"{stats['decode_s'] / max(steps, 1) * 1e3:.2f} ms/step), "
              f"{audio_s:.2f} s of audio, aggregate RTF "
              f"{stats['aggregate_rtf']:.3f}x realtime, peak "
              f"{stats['peak_mem_gib']:.2f} GiB [{card}]")
        if not all(o.shape[1] > 0 and np.isfinite(o).all() for o in outs):
            raise RuntimeError(f"multi run {rep}: empty or non-finite output")
        got = {k: stats[k] for k in layout}
        if got != layout:
            raise RuntimeError(f"multi prefill ran at {got}; the kernel check "
                               f"took {layout}")
        runs.append((outs, stats))
    launches = fa.launches
    if launches != 2 * cfg.num_layers:
        raise RuntimeError(f"multi path: {launches} flash launches, expected "
                           f"one per layer per call")
    if not all(np.array_equal(a, b) for a, b in zip(runs[0][0], runs[1][0])):
        raise RuntimeError("multi-prompt greedy output differs between runs")
    print(f"[multi-{len(jobs)}] outputs bit-identical over two runs; flash "
          f"launches {launches}")
    return dict(launches=launches, stats=runs[0][1])


def check_shared_step(torch, device, main: dict) -> dict:
    """One shared decode step against ``transformer_decode_step`` from the
    same prefill: the edit request's prompt (its text, seeded source codes,
    its mask) prefilled once with ``tmax`` as ``generate_batch`` takes it;
    ``BATCH`` chains a CFG group through the shared step and the [cond,
    uncond] pair through the single step, each fed the first span's
    sentinel. The 16 rows' logits must lie within ``REL`` of the max of the
    single step's (the bf16 tolerance of the prefill check)."""
    import numpy as np

    from ssr_speech_tpu_torch.config import DecodeConfig
    from ssr_speech_tpu_torch.data.tokenizer import TextTokenizer
    from ssr_speech_tpu_torch.inference import decode, pipeline
    from ssr_speech_tpu_torch.models import pretrained
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models import transformer as trf

    inputs = main["inputs"]
    lm, cfg, phn2num = pretrained.load_lm(inputs["lm"], device)
    dtype = lm["decoder"]["layers"]["qkv_w"].dtype
    dec = DecodeConfig(top_k=1, cfg_pretrained=True)
    x = pipeline.text_to_ids(TextTokenizer(language="en-us"), phn2num,
                             EDIT_TARGET)
    y = np.random.default_rng(0).integers(
        0, 2048, size=(cfg.n_codebooks, int(WAV_SECONDS * 50)))
    mask = multi_jobs("")[0]["mask_interval"]
    gen = torch.Generator(device=device).manual_seed(0)
    p = decode._one_prompt(lm, cfg, dec, x, y, mask, gen, None, None, None,
                           "check_shared_step")
    with torch.no_grad():
        pfx, banned = decode._prefill_impl(
            lm, p["xb"], p["prefix"], p["x_len"], p["p_len"], cfg=cfg,
            tmax=decode._bucket(p["sx_pad"] + p["p_pad"] + 8, 256),
            dtype=dtype, cfg_pretrained=True, aug_text=True)
        single = trf.KVCache(pfx.k.clone(), pfx.v.clone(), pfx.length)
        pe = tssr.sine_table(cfg.max_position, cfg.d_model, device=device)
        tokens = p["sentinels"][0].expand(BATCH, cfg.n_codebooks)
        h = decode._embed_step_tokens(lm, cfg, tokens, pe, p["p_len"], True,
                                      dtype)
        gen_cache = trf.init_kv_cache(cfg, 2 * BATCH, 128, dtype=dtype,
                                      device=device)
        out_b, _ = trf.transformer_decode_step_shared(
            lm["decoder"], h, pfx, gen_cache, banned, cfg, n_groups=2,
            dtype=dtype)
        out_s, _ = trf.transformer_decode_step(
            lm["decoder"], h[[0, BATCH]], single, banned, cfg, dtype=dtype)
        got = tssr.predict_logits(lm, out_b)
        want = tssr.predict_logits(lm, out_s)[[0] * BATCH + [1] * BATCH]
    err = rel_err(got, want)
    argmax = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    rows_equal = all(torch.equal(got[i], got[g * BATCH])
                     for g in (0, 1) for i in range(g * BATCH, (g + 1) * BATCH))
    print(f"[shared step] {2 * BATCH} rows over a shared prefill of "
          f"{pfx.length} keys against transformer_decode_step on [cond, "
          f"uncond]: logits max err / max {err:.2e} (tol {REL}); argmax "
          f"agrees on {argmax:.3f} of the codebook rows; the chains of a group "
          + ("bit-identical" if rows_equal else "NOT bit-identical"))
    if not err <= REL or not rows_equal:
        raise RuntimeError(f"the shared decode step disagrees with the single "
                           f"step: {err} (tol {REL}), rows equal {rows_equal}")
    return {"rel_err": err, "argmax_agreement": argmax}


# ---------------------------------------------------- serving and streaming

# the continuous-batching path's jobs (serve_cli --continuous): edits of the
# seeded wav whose masks the CLI derives from the transcript diff (one span
# at the start, middle or end, an insertion, two spans)
SERVE_TARGETS = (
    EDIT_TARGET,
    "but when i saw the mirage so near to them in the quiet evening light",
    "but when i had approached so near to us in the quiet morning light",
    "but when i had approached so very near to them in the quiet morning light",
    "but when i had approached so near to them in the quiet morning sun",
    "but then i had approached so near to them in the quiet morning light")
SERVE_SLOTS = 4  # 6 jobs through 4 lanes: at least two lanes are refilled
SERVE_FLAGS = ["--top_k", "1", "--aug_text", "--cfg_pretrained",
               "--cfg_stride", "5", "--use_watermark"]
# the streaming path's TTS jobs (serve_cli --stream and the HTTP clients)
STREAM_TARGETS = ("a short line to say", "the card speaks now",
                  "streaming from the server")
STREAM_FLAGS = ["--top_k", "1", "--prompt_length", "2"]
STREAM_ATOL = 1e-4  # fp32 codec, TF32 off: streamed vs offline causal decode


def write_jobs(path: Path, inputs: dict, targets, tts: bool) -> str:
    """A serve_cli jobs file over the seeded wav and its alignment."""
    with open(path, "w") as f:
        for i, text in enumerate(targets):
            f.write(json.dumps(dict(
                orig_audio=inputs["wav"], orig_transcript=" ".join(WORDS),
                target_transcript=text, alignment_file=inputs["align"],
                tts=tts, savename=f"{'tts' if tts else 'edit'}{i}")) + "\n")
    return str(path)


def serve_prompts(cfg, targets=SERVE_TARGETS) -> list:
    """(x, y, mask) of the continuous path's jobs as ``serve_cli`` builds
    them (the text ids, zero codes of the wav's 300 frames: the layout
    depends on their count only, the CLI's mask)."""
    import numpy as np

    from ssr_speech_tpu_torch.data.tokenizer import TextTokenizer
    from ssr_speech_tpu_torch.inference import cli, pipeline

    tok = TextTokenizer(language="en-us")
    phn2num = {c: i for i, c in enumerate(PHONES)}
    y = np.zeros((cfg.n_codebooks, int(WAV_SECONDS * 50)), np.int32)
    out = []
    for text in targets:
        _, _, target, mask = cli.prepare_job(alignment_words(), " ".join(WORDS),
                                             text, WAV_SECONDS)
        out.append((pipeline.text_to_ids(tok, phn2num, target), y, mask))
    return out


def server_layout(torch, cfg, device):
    """The continuous server's prefill layout of the first job, from the host
    code ``serve_requests`` runs: its geometry (``serve.serve_geometry``
    over all the jobs) and the job's [cond, uncond] dead keys
    (``decode.multi_dead_keys``). Returns (the layout its stats must
    report, segment ids [2, sx_pad + p_pad] on ``device``)."""
    from ssr_speech_tpu_torch.config import DecodeConfig
    from ssr_speech_tpu_torch.inference import decode, serve
    from ssr_speech_tpu_torch.ops import patterns

    dec = DecodeConfig(top_k=1, cfg_pretrained=True)  # SERVE_FLAGS
    prompts = serve_prompts(cfg)
    sx, P, _ = serve.serve_geometry(cfg, dec, prompts)
    x, y, mask = prompts[0]
    p_len = patterns.build_inference_prefix(y, mask, cfg.tokens)[0].shape[1]
    layout = dict(x_lens=[len(x)] * 2, p_lens=[p_len], sx_pad=sx, p_pad=P)
    dead = decode.multi_dead_keys(torch.tensor(layout["x_lens"]),
                                  torch.tensor([p_len]), sx, P, aug_text=True,
                                  cfg_pretrained=True)
    return layout, (~dead).to(device, torch.int32)


def step_h(lm, cfg, srv):
    """The embedded tokens a ContinuousBatcher feeds its next step."""
    from ssr_speech_tpu_torch.inference import decode
    from ssr_speech_tpu_torch.models import ssr as tssr

    s = srv.state
    pe = tssr.sine_table(cfg.max_position, cfg.d_model, device=s.y_pos.device)
    return decode._embed_step_tokens(lm, cfg, s.next_tokens, pe, s.y_pos,
                                     srv.aug, srv.dtype)


def step_logits(torch, lm, cfg, srv, cache=None):
    """The next step's logits of every row of a ContinuousBatcher through
    the paged step, on a copy of its generated cache (or ``cache``)."""
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models import transformer as trf

    s = srv.state
    cache = cache or trf.KVCache(s.cache.k.clone(), s.cache.v.clone(), 0)
    with torch.no_grad():
        out, _ = trf.transformer_decode_step_paged(
            lm["decoder"], step_h(lm, cfg, srv), srv._pfx, cache, srv._banned,
            s.gen_len, cfg, dtype=srv.dtype)
        return tssr.predict_logits(lm, out)


def argmax_check(got, want):
    """Argmax agreement of two logit tensors [..., V]: (the share of rows
    that agree, the rows whose top two in ``want`` lie within twice that
    row's max abs error, the rows that differ outside such a tie). No
    perturbation within the row's error can flip a row outside a tie."""
    top2 = want.float().topk(2, dim=-1).values
    err = (got.float() - want.float()).abs().amax(-1)
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * err
    differ = got.argmax(-1) != want.argmax(-1)
    return ((~differ).float().mean().item(), int(tie.sum().item()),
            int((differ & ~tie).sum().item()))


def check_paged_step(torch, device, main: dict) -> dict:
    """The paged decode step at full width, from the server's own state.
    (a) ``SERVE_SLOTS`` lanes filled with the edit request and decoded 12
    steps (fewer if the chains finish first), all rows at one column: the
    paged step's logits against ``transformer_decode_step_shared`` on the
    same rows (the [cond, uncond] prompts once, the same generated cache),
    within ``REL`` of the max, and the argmax equal on every codebook row
    outside a tie at that error (``argmax_check``: bf16 rounds the two
    steps' sums apart, which flips rows whose top two lie that close).
    (b) Lane 1 refilled with another
    request beside the lanes mid-flight, its cache row filled with junk
    where the previous occupant's K/V were: its rows' logits against a fresh
    one-lane server's first step on that request, within ``REL``."""
    import numpy as np

    from ssr_speech_tpu_torch.config import DecodeConfig
    from ssr_speech_tpu_torch.inference import serve
    from ssr_speech_tpu_torch.models import pretrained
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models import transformer as trf

    inputs = main["inputs"]
    lm, cfg, _ = pretrained.load_lm(inputs["lm"], device)
    dec = DecodeConfig(top_k=1, cfg_pretrained=True)
    prompts = serve_prompts(cfg)
    codes = np.random.default_rng(0).integers(
        0, 2048, size=(cfg.n_codebooks, int(WAV_SECONDS * 50)))
    (xa, _, ma), (xb, _, mb) = prompts[0], prompts[1]
    sx, P, nt = serve.serve_geometry(cfg, dec, prompts)
    S, g = SERVE_SLOTS, 12
    geom = dict(sx_pad=sx, p_pad=P, num_task=nt)
    srv = serve.ContinuousBatcher(lm, cfg, dec, S, **geom)
    for slot in range(S):
        srv._fill_slot(slot, slot, xa, codes, ma)
    srv._run_chunk(g)  # stops early if the chains finish first
    g = srv.state.steps
    if g < 1 or not bool((srv.state.gen_len == g).all()):
        raise RuntimeError(f"paged-step check: after {g} steps the lanes sit "
                           f"at columns {srv.state.gen_len.tolist()}")
    got = step_logits(torch, lm, cfg, srv)
    s = srv.state
    with torch.no_grad():
        h = step_h(lm, cfg, srv)
        rows = [0, S]
        pfx = trf.KVCache(srv._pfx.k[:, rows], srv._pfx.v[:, rows],
                          srv._pfx.length)
        gen = trf.KVCache(s.cache.k.clone(), s.cache.v.clone(), g)
        out, _ = trf.transformer_decode_step_shared(
            lm["decoder"], h, pfx, gen, srv._banned[rows], cfg, n_groups=2,
            dtype=srv.dtype)
        want = tssr.predict_logits(lm, out)
    err = rel_err(got, want)
    argmax, ties, flips = argmax_check(got, want)
    print(f"[paged step] {2 * S} rows at column {g} over the server's "
          f"prefix rows: logits against the shared step, max err / max "
          f"{err:.2e} (tol {REL}); argmax agrees on {argmax:.3f} of the "
          f"codebook rows, {ties} rows within their error of a tie, "
          f"{flips} rows differ outside a tie")
    if not (err <= REL and flips == 0):
        raise RuntimeError(f"the paged step disagrees with the shared step: "
                           f"{err} (tol {REL}), argmax {argmax}, {flips} "
                           f"rows differ outside a tie")
    # (b) lane 1 refilled mid-flight, junk where the old occupant's K/V were
    srv._splice_slot(1, S, srv._prefill_request(xb, codes, mb))
    cache = trf.KVCache(s.cache.k.clone(), s.cache.v.clone(), 0)
    gen_ = torch.Generator(device=device).manual_seed(3)
    for row in (1, S + 1):
        for buf in (cache.k, cache.v):
            buf[:, row, :, :g] = 30 * torch.randn(
                buf[:, row, :, :g].shape, generator=gen_, device=device,
                dtype=torch.float32).to(buf.dtype)
    mixed = step_logits(torch, lm, cfg, srv, cache)
    one = serve.ContinuousBatcher(lm, cfg, dec, 1, **geom)
    one._fill_slot(0, 0, xb, codes, mb)
    fresh = step_logits(torch, lm, cfg, one)
    err_b = rel_err(mixed[[1, S + 1]], fresh)
    argmax_b, _, flips_b = argmax_check(mixed[[1, S + 1]], fresh)
    print(f"[paged step] lane 1 refilled at column 0 beside {S - 1} lanes at "
          f"column {g} (its old cache columns overwritten with junk): its "
          f"logits against a fresh one-lane step, max err / max {err_b:.2e} "
          f"(tol {REL}); argmax agrees on {argmax_b:.3f} of its codebook rows")
    if not err_b <= REL:
        raise RuntimeError(f"the refilled lane's step differs from a fresh "
                           f"one: {err_b} (tol {REL})")
    del srv, one, cache
    return {"rel_err_vs_shared": err, "argmax_agreement": argmax,
            "refilled_rel_err": err_b}


def drive_continuous_path(torch, device, main: dict, layout: dict, work: Path,
                          card: str) -> dict:
    """``serve_cli --continuous --n_slots 4`` over the 6 greedy edit jobs of
    ``SERVE_TARGETS``, twice: finite 16 kHz wavs of the expected lengths,
    bit-identical over the runs, 16 flash launches (one a layer) per admitted
    request, and every prefill at the server geometry K1 was held at (the
    first request's layout exactly). Prints decode ms/step, prefill ms, each
    request's completion, the aggregate RTF and peak GiB, and (not a gate)
    the first decode step at which each served chain parts from its own
    ``decode.generate`` run. Returns the flash launches of this phase."""
    import numpy as np

    from ssr_speech_tpu_torch.config import DecodeConfig
    from ssr_speech_tpu_torch.data.tokenizer import tokenize_audio
    from ssr_speech_tpu_torch.inference import decode, serve_cli
    from ssr_speech_tpu_torch.models import pretrained
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    inputs = main["inputs"]
    cfg = inputs["cfg"]
    hop = inputs["codec_cfg"].hop_length
    jobs = write_jobs(work / "serve_jobs.jsonl", inputs, SERVE_TARGETS, False)
    argv = ["--device", str(device), "--model_path", inputs["lm"],
            "--codec_path", inputs["codec"], "--jobs", jobs, "--continuous",
            "--n_slots", str(SERVE_SLOTS), *SERVE_FLAGS]
    n = len(SERVE_TARGETS)
    fa.reset_launches()  # count only this path's launches
    runs = []
    for rep in (1, 2):
        before = fa.launches
        st = serve_cli.main(argv + ["--output_dir", str(work / f"serve_{rep}")])
        st["launches"] = fa.launches - before
        st["wav_bytes"] = [Path(p).read_bytes() for p in st["out_paths"]]
        audio_s = sum(st["out_samples"]) / st["sample_rate"]
        steps = st["decode_steps"]
        st["aggregate_rtf"] = audio_s / st["request_s"]
        print(f"[continuous] run {rep}: {n} jobs through {SERVE_SLOTS} lanes "
              f"({2 * SERVE_SLOTS} rows), {steps} decode steps in "
              f"{st['chunks']} chunks, decode {st['decode_s'] / steps * 1e3:.2f}"
              f" ms/step, prefill {np.mean(st['prefill_s']) * 1e3:.1f} ms a "
              f"request ({len(st['prefill_s'])} prefills), completion s by "
              f"request {[round(t, 3) for t in st['done_at']]}, request "
              f"{st['request_s']:.3f} s, {audio_s:.2f} s of audio, aggregate "
              f"RTF {st['aggregate_rtf']:.3f}x realtime, peak "
              f"{st['peak_mem_gib'] or float('nan'):.2f} GiB, flash launches "
              f"{st['launches']} [{card}]")
        expect = [f * hop for f in st["output_frames"]]
        if not st["out_finite"] or st["sample_rate"] != 16000:
            raise RuntimeError(f"continuous run {rep}: not finite 16 kHz wavs")
        if st["out_samples"] != expect or min(expect) <= 0:
            raise RuntimeError(f"continuous run {rep}: {st['out_samples']} "
                               f"samples, expected {expect}")
        if st["launches"] != n * cfg.num_layers:
            raise RuntimeError(f"continuous run {rep}: {st['launches']} flash "
                               f"launches, expected {cfg.num_layers} a request")
        if st["prefill_layouts"][0] != layout or any(
                (lay["sx_pad"], lay["p_pad"]) != (layout["sx_pad"],
                                                  layout["p_pad"])
                for lay in st["prefill_layouts"]):
            raise RuntimeError(f"server prefill ran at "
                               f"{st['prefill_layouts']}; the kernel check "
                               f"took {layout}")
        runs.append(st)
    launches = fa.launches
    if runs[0]["wav_bytes"] != runs[1]["wav_bytes"]:
        raise RuntimeError("continuous greedy output differs between runs")
    # each job alone through decode.generate (not a gate)
    lm, _, phn2num = pretrained.load_lm(inputs["lm"], device)
    audio_tok = pretrained.load_codec(inputs["codec"], device)
    y = tokenize_audio(audio_tok, inputs["wav"])[0][0]
    dec = DecodeConfig(top_k=1, cfg_pretrained=True)
    parts = []
    for i, (x, _, mask) in enumerate(serve_prompts(cfg)):
        st = {}
        decode.generate(lm, cfg, dec, x, y, mask,
                        torch.Generator(device=device).manual_seed(1),
                        stats=st)
        a, b = runs[0]["out_tokens"][i], st["out_tokens"]
        w = min(a.shape[1], b.shape[1])
        diff = np.nonzero((a[:, :w] != b[:, :w]).any(axis=0))[0]
        parts.append(int(diff[0]) if diff.size else None)
    print(f"[continuous] outputs bit-identical over two runs; first decode "
          f"step at which each served chain parts from its own generate run "
          f"(None: never): {parts}")
    return dict(launches=launches, stats=runs[0], parts=parts)


def write_causal_codec(torch, device, work: Path):
    """A causal bundle at the default codec's widths (encodec_large_nq4_s320,
    ``seanet.causal``, constant padding), from the port's seeded init."""
    import dataclasses

    from ssr_speech_tpu_torch.config import CodecConfig
    from ssr_speech_tpu_torch.models.codec import wmencodec as twm
    from ssr_speech_tpu_torch.models.pretrained import save_bundle

    base = CodecConfig()
    cfg = dataclasses.replace(base, seanet=dataclasses.replace(
        base.seanet, causal=True, pad_mode="constant"))
    path = work / "causal_codec.pkl"
    gen = torch.Generator(device=device).manual_seed(4)
    save_bundle(str(path), params=twm.init_wmencodec(gen, cfg, device),
                config=cfg)
    return str(path)


def drive_stream_path(torch, device, main: dict, work: Path, card: str) -> dict:
    """``serve_cli --stream`` over the 3 TTS jobs of ``STREAM_TARGETS`` on
    the causal bundle (3 lanes): each client's concatenated chunks against
    the offline causal decode of its own prompt and streamed codes, cropped
    at the prompt, within ``STREAM_ATOL``; 16 flash launches per request.
    Prints each client's time to first audio. Returns the flash launches of
    this phase and what the HTTP phase reuses."""
    import numpy as np

    from ssr_speech_tpu_torch.inference import serve_cli
    from ssr_speech_tpu_torch.models import pretrained
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    inputs = main["inputs"]
    cfg = inputs["cfg"]
    causal = write_causal_codec(torch, device, work)
    jobs = write_jobs(work / "stream_jobs.jsonl", inputs, STREAM_TARGETS, True)
    fa.reset_launches()  # count only this path's launches
    st = serve_cli.main(["--device", str(device), "--model_path", inputs["lm"],
                         "--codec_path", causal, "--jobs", jobs, "--output_dir",
                         str(work / "stream"), "--stream", *STREAM_FLAGS])
    launches = fa.launches
    audio_tok = pretrained.load_codec(causal, device)
    hop = audio_tok.cfg.hop_length
    worst = 0.0
    for i, s in enumerate(st["streams"]):
        T = s["prompt_codes"].shape[1]
        full = audio_tok.decode(np.concatenate(
            [s["prompt_codes"], s["codes"]], axis=1)[None])[0, T * hop:]
        if s["wav"].shape != full.shape or s["codes"].shape[1] == 0:
            raise RuntimeError(f"stream {i}: {s['wav'].shape} samples, the "
                               f"offline decode {full.shape}")
        err = float(np.abs(s["wav"] - full).max())
        worst = max(worst, err)
        print(f"[stream] client {i}: prompt {T} frames, {s['codes'].shape[1]} "
              f"frames in {s['chunks']} chunks, time to first audio "
              f"{s['first_at'] * 1e3:.1f} ms, done {s['done_at']:.3f} s, max "
              f"abs err against the offline causal decode {err:.2e} (tol "
              f"{STREAM_ATOL}) [{card}]")
    print(f"[stream] request {st['request_s']:.3f} s, peak "
          f"{st['peak_mem_gib'] or float('nan'):.2f} GiB, flash launches "
          f"{launches}")
    if not worst <= STREAM_ATOL:
        raise RuntimeError(f"streamed audio differs from the offline causal "
                           f"decode: {worst} > {STREAM_ATOL}")
    if launches != len(STREAM_TARGETS) * cfg.num_layers:
        raise RuntimeError(f"stream path: {launches} flash launches, expected "
                           f"{cfg.num_layers} a request")
    return dict(launches=launches, causal=causal,
                requests=[(s["x"], s["prompt_codes"]) for s in st["streams"]])


def drive_http_path(torch, device, main: dict, stream: dict, card: str) -> dict:
    """``TTSHttpServer`` on 127.0.0.1:0 over the causal bundle (CFG rows, as
    ``http_server.main`` serves), 3 concurrent clients posting the stream
    path's requests as ``text_ids`` and ``prompt_codes``: each client's PCM
    equal to the engine's own finished waveform, the /health counters
    advanced, and every flash launch of this phase made by the engine
    thread (16 per request). Returns the flash launches of this phase."""
    import http.client
    import threading

    from ssr_speech_tpu_torch.config import DecodeConfig
    from ssr_speech_tpu_torch.inference import decode, http_server
    from ssr_speech_tpu_torch.inference import stream as tstream
    from ssr_speech_tpu_torch.models import pretrained
    from ssr_speech_tpu_torch.ops import flash_attention as fa
    from ssr_speech_tpu_torch.ops import patterns

    inputs = main["inputs"]
    lm, cfg, _ = pretrained.load_lm(inputs["lm"], device)
    audio_tok = pretrained.load_codec(stream["causal"], device)
    reqs = stream["requests"]
    dec = DecodeConfig(top_k=1, aug_text=True, cfg_pretrained=True,
                       stop_repetition=-1)
    p_max = max(patterns.build_inference_prefix(
        y, [(y.shape[1], y.shape[1])], cfg.tokens)[0].shape[1] for _, y in reqs)
    server = tstream.StreamingServer(
        lm, cfg, dec, audio_tok.params, audio_tok.cfg, len(reqs),
        sx_pad=decode._bucket(max(len(x) for x, _ in reqs), 64),
        p_pad=decode._bucket(p_max, 128))
    done = {}

    def on_done(req_id, codes, wav):
        done[req_id] = (wav, threading.current_thread().name)

    def health(addr):
        conn = http.client.HTTPConnection(*addr, timeout=60)
        conn.request("GET", "/health")
        return json.loads(conn.getresponse().read())

    fa.reset_launches()  # count only this path's launches
    srv = http_server.TTSHttpServer(
        server, host="127.0.0.1", port=0, sample_rate=audio_tok.sample_rate,
        generator=torch.Generator(device=device).manual_seed(1),
        on_done=on_done).start()
    try:
        h0 = health(srv.address)
        outs = [None] * len(reqs)

        def client(i):
            x, y = reqs[i]
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection(*srv.address, timeout=600)
            conn.request("POST", "/tts", json.dumps(
                {"text_ids": x.tolist(), "prompt_codes": y.tolist()}))
            resp = conn.getresponse()
            first, body = None, []
            while True:
                b = resp.read1(65536)
                if not b:
                    break
                first = first or time.perf_counter() - t0
                body.append(b)
            outs[i] = (resp.status, int(resp.getheader("X-Request-Id")),
                       b"".join(body), first, time.perf_counter() - t0)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:  # the counters follow the bodies
            h1 = health(srv.address)
            if h1["completed"] >= h0["completed"] + len(reqs):
                break
            time.sleep(0.05)
    finally:
        srv.shutdown()
    launches = fa.launches
    by_thread = dict(fa.launches_by_thread)
    for i, out in enumerate(outs):
        if out is None or out[0] != 200:
            raise RuntimeError(f"http client {i}: {out and out[0]}")
        status, req_id, pcm, first, total = out
        wav, thread = done[req_id]
        same = pcm == http_server.float_to_pcm16(wav)
        print(f"[http] client {i} (request {req_id}): {len(pcm) // 2} samples,"
              f" first bytes after {first * 1e3:.1f} ms, body done after "
              f"{total:.3f} s; PCM " + ("equal to" if same else "DIFFERS from")
              + f" the engine's waveform (finished on thread {thread!r}) "
              f"[{card}]")
        if not same or len(pcm) == 0:
            raise RuntimeError(f"http client {i}: its PCM is not the engine's "
                               "waveform")
    moved = {k: h1[k] - h0[k] for k in ("admitted", "completed", "chunks")}
    print(f"[http] /health counters advanced by {moved}; ttfa p50 "
          f"{h1.get('ttfa_p50_ms')} ms; flash launches by thread {by_thread}")
    if moved["admitted"] != len(reqs) or moved["completed"] != len(reqs) or \
            moved["chunks"] < len(reqs):
        raise RuntimeError(f"/health counters did not advance: {moved}")
    if by_thread != {"tts-engine": len(reqs) * cfg.num_layers}:
        raise RuntimeError(f"http path: flash launches by thread {by_thread}, "
                           f"expected {len(reqs) * cfg.num_layers} from the "
                           "engine thread alone")
    return dict(launches=launches)


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

    from ssr_speech_tpu_torch.config import CodecConfig, SSRModelConfig
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


# ---------------------------------------------------------------- training


KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "fused_ce",
                  "int8_matmul")
REL = 2e-2  # bf16 outputs: max |kernel - plain| / max |plain|
LSE_ATOL = 1e-2  # attention log-sum-exp (fp32, natural log): max abs error
# Besides the training path's own first batch: [B, H, S, Dh] of training
# attention (416 text + 864 audio positions, and a ragged S), and [K, N, Hh, C]
# of the 830M CE head at ~8 rows of 1000 frames
TRAIN_ATTN_SHAPES = ((8, 16, 1280, 128), (8, 16, 1000, 128))
TRAIN_CE_SHAPE = (4, 8000, 1024, 2056)
# C no multiple of 8 (a row pitch of w2 the TMA unit would not take: the
# kernels read the transposed copy) and N no multiple of the kernels' 64 rows
RAGGED_CE_SHAPES = ((2, 203, 256, 131), (4, 65, 1024, 2051))
TLOGIT_ATOL = 1e-4  # the forward's pre-pass: fp32 sums of exact bf16 products
DH_TILED_REL = 1e-2  # dhidden against tiled_ce_dhidden: a bf16 rounding step
CW = (5.0, 1.0, 0.5, 0.1)


def ptxas_summary(log: str) -> list:
    """One line a kernel from ``nvcc -Xptxas -v``: its name, registers, spill
    bytes and stack, and ptxas's notes (C7510-C7515) where it serialised the
    wgmmas; compile errors as they are."""
    import re

    out, name = [], "?"
    serialised = {}
    for m in re.finditer(r"\((C75\d\d)\)[^'\n]*serialized[^'\n]*'(\w+)'", log):
        serialised.setdefault(m.group(2), set()).add(m.group(1))
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            # the mangled name: ..._cu_<8 hex digits><length><name>[ILi<n>E]
            k = re.search(r"_cu_[0-9a-f]{8}(\d{1,2})(\w+)", name)
            short = k.group(2)[:int(k.group(1))] if k else name[:60]
            inst = re.search(r"_kernelIL[ib](\d+)E(?:L[ib](\d+)E)?", name)
            if inst:
                short += f"<{','.join(x for x in inst.groups() if x)}>"
            notes = ", ".join(sorted(serialised.get(name, ())))
            out.append(f"{short}: {line.split(':', 1)[1].strip()}; {spill}"
                       + (f"; {notes}: wgmmas serialised" if notes else ""))
        elif "error" in line:
            out.append(line.strip())
    return out


def build_kernels() -> None:
    """nvcc for every kernel source at once (one process each)."""
    from concurrent.futures import ThreadPoolExecutor

    from ssr_speech_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(cuda_build.load, KERNEL_SOURCES))
    print(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.2f} s")
    for b in built:
        print(f"[build] {b.path.name}: nvcc {b.build_seconds:.2f} s")
        for line in ptxas_summary(b.ptxas_log):
            print(f"[build] {line}")
    from ssr_speech_tpu_torch.ops import int8_matmul as i8

    print("[build] int8 stream_kernel occupancy, blocks an SM: " + ", ".join(
        f"{mode} rows {rows} {i8.occupancy(mode, rows)}"
        for mode in i8.MODES for rows in INT8_ROWS)
        + f"; megakernel: {i8.mega_resident()} blocks resident at once")


def train_segments(torch, b: int, s: int, sx: int, gen, device):
    """Segment ids of a padded training batch: text [0, x_len) and audio
    [sx, sx + y_len) valid, the rest (text and audio padding) segment 0;
    x_len 20-150 phonemes, y_len from half the audio slots to all."""
    seg = torch.zeros((b, s), dtype=torch.int32)
    x_len = torch.randint(20, 151, (b,), generator=gen)
    y_len = torch.randint((s - sx) // 2, s - sx + 1, (b,), generator=gen)
    y_len[0] = s - sx
    for r in range(b):
        seg[r, :x_len[r]] = 1
        seg[r, sx:sx + y_len[r]] = 1
    return seg.to(device)


def first_train_batch(device, argv):
    """The config of ``train_lm.main(argv)`` and the batch it trains on first
    (and, with --benchmark_no_load, on every step): its own dataset and
    batcher at its seed."""
    from ssr_speech_tpu_torch import train_lm

    args = train_lm.build_parser().parse_args(argv)
    cfg, tcfg = train_lm.configs_from_args(args, device)
    _, batcher = train_lm.make_train_batcher(cfg, tcfg, args.seed)
    return cfg, next(iter(batcher(0)))


def train_path_cases(torch, cfg, batch, device):
    """The kernels' inputs on the training path's batch: attention
    [B, H, Sx + Sy, Dh] with the batch's key-valid segments (as
    ``ssr_forward`` derives them), and the CE head [K, B(Sy - 1), Hh, C] with
    the batch's targets (as ``ssr_loss_from_hidden`` lays them out)."""
    b, sx = batch["x"].shape
    sy = batch["y"].shape[1]
    x_lens, y_lens = (torch.from_numpy(batch[k]).long()[:, None]
                      for k in ("x_lens", "y_lens"))
    seg = torch.cat([torch.arange(sx)[None] < x_lens,
                     torch.arange(sy)[None] < y_lens], dim=1).to(torch.int32)
    attn = ((b, cfg.nhead, sx + sy, cfg.d_model // cfg.nhead), seg.to(device))
    k = cfg.n_codebooks
    tgt = torch.from_numpy(batch["y"][:, 1:]).permute(2, 0, 1).reshape(k, -1)
    ce = ((k, b * (sy - 1), cfg.head_hidden_dim, cfg.cardinality),
          tgt.to(device, torch.int32).contiguous())
    return attn, ce


def rel_err(got, want) -> float:
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    return err / scale if scale > 0 else err


def plain_backward_ms(torch, out, inputs, grad) -> float:
    """CUDA-event time of autograd's backward through a built graph, for the
    gradients of ``inputs`` only."""
    return cuda_time_ms(torch, lambda: torch.autograd.grad(
        out, inputs, grad, retain_graph=True), iters=5)


def reference_lse(torch, q, k, seg, scale):
    """Per-row natural log-sum-exp of the masked fp32 scores [B, H, S]."""
    s = q.shape[2]
    ok = (seg[:, None, :] == seg[:, :, None]) & torch.ones(
        (s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.logsumexp(scores.masked_fill(~ok[:, None], float("-inf")), -1)


def check_flash_backward(torch, device, path_case):
    """K1's training forward (output and log-sum-exp) and K3 on the training
    path's batch, at the training shapes and on the layouts that exercise the
    skip rule: dq/dk/dv on every row against autograd through the plain
    version (and, on the skip layouts, against the tiled plain backward), two
    backward runs bit for bit, both timed. The report's times are the
    training path's; the forward is timed there too, beside its bound and
    the library call. Returns (K3's entry, K1's numbers at the training
    shape)."""
    from ssr_speech_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(5)
    cases = [("train path", *path_case)] + [
        ("synthetic", shape, train_segments(torch, shape[0], shape[2], 416, gen,
                                            device))
        for shape in TRAIN_ATTN_SHAPES] + [
        ("skip layouts", SKIP_SHAPE, skip_segments(torch, SKIP_SHAPE[2], 192,
                                                   device))]
    worst, abs_worst, times = 0.0, 0.0, []
    for label, shape, seg in cases:
        b, h, s, dh = shape
        scale = 1.0 / dh ** 0.5
        q, k, v, dout = (torch.randn(shape, generator=gen).to(device, torch.bfloat16)
                         for _ in range(4))
        out, lse = fa.flash_forward(q, k, v, seg, scale, with_lse=True)
        runs = [fa.flash_backward(q, k, v, seg, out, lse, dout, scale)
                for _ in range(2)]
        lse_err = (lse - reference_lse(torch, q, k, seg, scale)).abs().max().item()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fa.reference_attend(*leaves, seg, scale)
        want = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
        torch.cuda.synchronize()
        errs = {}
        for name, got, again, w in zip(("dq", "dk", "dv"), runs[0], runs[1], want):
            if not torch.equal(got, again):
                raise RuntimeError(f"flash backward {name} differs between two "
                                   f"runs at {shape}")
            if not torch.isfinite(got).all():
                raise RuntimeError(f"flash backward: non-finite {name} at {shape}")
            errs[name] = rel_err(got, w)
            abs_worst = max(abs_worst, (got.float() - w.float()).abs().max().item())
        errs["out"] = rel_err(out, ref)
        share = check_tile_visits(torch, fa, seg)
        if label == "skip layouts":
            tiled = fa.tiled_backward(q, k, v, seg, out, lse, dout, scale)
            for name, got, w in zip(("dq", "dk", "dv"), runs[0], tiled):
                errs[f"{name} vs tiled plain"] = rel_err(got, w)
            del tiled
        ms = cuda_time_ms(torch, lambda: fa.flash_backward(
            q, k, v, seg, out, lse, dout, scale), iters=5)
        plain_ms = plain_backward_ms(torch, ref, leaves, dout)
        if label == "train path":
            mask = attention_mask(torch, seg)
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask)
            library_ms = plain_backward_ms(torch, lib_out, leaves, dout)
            del lib_out
            pairs = attended_pairs(seg)
            lower = bound(nbytes(q, k, v, out, dout, lse, seg) + 3 * nbytes(q),
                          10 * h * dh * pairs, "bf16")
            with torch.no_grad():
                fwd_train = {
                    "shape": list(shape), "max_abs_err": (
                        out.float() - ref.float()).abs().max().item(),
                    "ms": cuda_time_ms(torch, lambda: fa.flash_forward(
                        q, k, v, seg, scale, with_lse=True)),
                    "plain_ms": cuda_time_ms(torch, lambda: fa.reference_attend(
                        q, k, v, seg, scale), iters=5),
                    "library_ms": cuda_time_ms(
                        torch, lambda: torch.nn.functional
                        .scaled_dot_product_attention(q, k, v, attn_mask=mask)),
                    **bound(nbytes(q, k, v, seg, out, lse),
                            4 * h * dh * pairs, "bf16"),
                    "visited_share_of_causal_tiles": share}
            del mask
            print(f"[flash] train path {shape} forward with LSE: kernel "
                  f"{fwd_train['ms']:.4f} ms, plain {fwd_train['plain_ms']:.3f} "
                  f"ms, library {fwd_train['library_ms']:.4f} ms, bound "
                  f"{fwd_train['bound_ms']:.4f} ms by {fwd_train['bound_by']}; "
                  f"the batch's segments visit {share:.3f} of the causal tiles "
                  f"({pairs / (b * s * (s + 1) / 2):.3f} of the causal pairs "
                  f"attend)")
        print(f"[flash bwd] {label} {shape}: max err / max "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + f" (tol {REL}), lse max abs err {lse_err:.2e} (tol {LSE_ATOL}), "
              f"two runs bit-identical; kernel {ms:.3f} ms, plain (autograd) "
              f"{plain_ms:.3f} ms; visits {share:.3f} of the causal tiles")
        if max(errs.values()) > REL or not lse_err <= LSE_ATOL:
            raise RuntimeError(f"flash forward/backward disagrees with the "
                               f"plain version at {shape}: {errs}, lse {lse_err}")
        worst = max(worst, max(errs.values()))
        times.append((ms, plain_ms))
        del ref, want, leaves
    ms, plain_ms = times[0]
    print(f"[flash bwd] train path: kernel {ms:.3f} ms, library (autograd of "
          f"scaled_dot_product_attention) {library_ms:.3f} ms, bound "
          f"{lower['bound_ms']:.4f} ms by {lower['bound_by']}")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "ssr_speech_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "ssr_speech_tpu/ops/flash_attention.py:130",
            "launches": 0, "max_abs_err": abs_worst, "max_rel_err": worst,
            "ms": ms, "plain_ms": plain_ms, **lower, "library_ms": library_ms,
            "library": "autograd backward of F.scaled_dot_product_attention",
            "shape": list(path_case[0])}, fwd_train


def check_one_ce(torch, device, shape, tgt, gen, timed: bool = True) -> dict:
    """K4-K6 at one [K, N, Hh, C]: errors against the plain version and its
    autograd (checked), the pre-pass's target logit against the plain one,
    forward and backward twice bit for bit, and (``timed``) times."""
    from ssr_speech_tpu_torch.ops import fused_ce as fce

    k, n, hh, c = shape
    hidden = torch.randn((k, n, hh), generator=gen).to(device, torch.bfloat16)
    w2 = (torch.randn((k, hh, c), generator=gen) / hh ** 0.5).to(device, torch.bfloat16)
    b2 = (torch.randn((k, c), generator=gen) * 0.1).to(device, torch.bfloat16)
    if tgt is None:
        tgt = torch.randint(0, c, (k, n), generator=gen, dtype=torch.int32).to(device)
    g = torch.randn((k, n), generator=gen).to(device)

    w2t = fce.transpose_w2(w2)  # made once a step on the training path
    fwd_runs = [fce.ce_forward_with_target_logits(hidden, w2, b2, tgt)
                for _ in range(2)]
    nll, logz, hits, tlogit = fwd_runs[0]
    runs = [(fce.ce_backward_dhidden(hidden, w2, b2, tgt, logz, g, t),
             *fce.ce_backward_dw2(hidden, w2, b2, tgt, logz, g, w2t))
            for t in (None, w2t)]
    leaves = [t.clone().requires_grad_() for t in (hidden, w2, b2)]
    p_nll, p_hits = fce.reference_ce_head(*leaves, tgt)
    want = torch.autograd.grad(p_nll, leaves, g, retain_graph=True)
    with torch.no_grad():
        logits = torch.matmul(hidden.float(), w2.float()) + b2.float()[:, None]
        p_logz = torch.logsumexp(logits, dim=-1)
        t_logit = torch.gather(logits, -1, tgt.long()[..., None])[..., 0]
        if c >= fce.TOP:
            near_tie = (t_logit - logits.topk(fce.TOP, dim=-1).values[..., -1]
                        ).abs() <= 1e-3
        else:  # every target is a hit: no tie to break
            near_tie = torch.zeros_like(t_logit, dtype=torch.bool)
        del logits
        tiled_dh = fce.tiled_ce_dhidden(hidden, w2, b2, tgt, logz, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("nll", "logz", "hits", "target logit"), *fwd_runs):
        if not torch.equal(a, b):
            raise RuntimeError(f"fused CE {name} differs between two runs at {shape}")
    r = {"errs": {"nll": rel_err(nll, p_nll), "logz": rel_err(logz, p_logz)},
         "abs": {"nll": (nll - p_nll).abs().max().item()},
         "tlogit": (tlogit - t_logit).abs().max().item()}
    for name, i, w in (("dhidden", 0, want[0]), ("dw2", 1, want[1]), ("db2", 2, want[2])):
        if not torch.equal(runs[0][i], runs[1][i]):
            raise RuntimeError(f"fused CE {name} differs between two runs at {shape}")
        r["errs"][name] = rel_err(runs[0][i], w)
        r["abs"][name] = (runs[0][i].float() - w.float()).abs().max().item()
    # the dhidden kernel against its own arithmetic in plain PyTorch: only the
    # fp32 summation order differs, so at most a bf16 rounding step apart
    r["dh_tiled"] = rel_err(runs[0][0], tiled_dh)
    bad = hits != p_hits
    n_bad, n_off = int(bad.sum()), int((bad & ~near_tie).sum())
    line = (f"[fused ce] {shape}: max err / max "
            + ", ".join(f"{k} {e:.2e}" for k, e in r["errs"].items())
            + f" (tol {REL}); the pre-pass's target logit off by {r['tlogit']:.2e} "
            f"(tol {TLOGIT_ATOL}); hits differ on {n_bad} of {k * n} rows, {n_off} of "
            f"them not near-ties; dhidden {r['dh_tiled']:.2e} from tiled_ce_dhidden (tol "
            f"{DH_TILED_REL}); forward and backward bit-identical over two runs "
            f"(dhidden with and without the caller's w2t)")
    if timed:
        r["fwd"] = cuda_time_ms(torch, lambda: fce.ce_forward(hidden, w2, b2, tgt), iters=5)
        with torch.no_grad():
            r["fwd_plain"] = cuda_time_ms(
                torch, lambda: fce.reference_ce_head(hidden, w2, b2, tgt), iters=5)
        r["dh"] = cuda_time_ms(torch, lambda: fce.ce_backward_dhidden(
            hidden, w2, b2, tgt, logz, g, w2t), iters=5)
        r["dw"] = cuda_time_ms(torch, lambda: fce.ce_backward_dw2(
            hidden, w2, b2, tgt, logz, g, w2t), iters=5)
        r["dh_plain"] = plain_backward_ms(torch, p_nll, leaves[:1], g)
        r["dw_plain"] = plain_backward_ms(torch, p_nll, leaves[1:], g)
        r["bwd_plain"] = plain_backward_ms(torch, p_nll, leaves, g)
        one_pass = 2 * k * n * hh * c  # operations of one [N, Hh] x [Hh, C] product
        ins = nbytes(hidden, w2, b2, tgt)
        r["bounds"] = {  # the backward kernels recompute the logits: two products
            "fwd": bound(ins + nbytes(nll, logz, hits), one_pass, "bf16"),
            "dh": bound(ins + nbytes(logz, g, hidden), 2 * one_pass, "bf16"),
            "dw": bound(ins + nbytes(logz, g) + 4 * (w2.numel() + b2.numel()),
                        2 * one_pass, "bf16")}
        line += (f"; forward {r['fwd']:.3f} ms with the transpose of w2 and the "
                 f"pre-pass (plain {r['fwd_plain']:.3f}), dhidden {r['dh']:.3f} ms "
                 f"(plain {r['dh_plain']:.3f}), dw2/db2 {r['dw']:.3f} ms (plain "
                 f"{r['dw_plain']:.3f}); backward {r['dh'] + r['dw']:.3f} ms against "
                 f"{r['bwd_plain']:.3f} ms for the plain backward of all three "
                 f"gradients")
    print(line)
    if (max(r["errs"].values()) > REL or n_off or not r["tlogit"] <= TLOGIT_ATOL
            or not r["dh_tiled"] <= DH_TILED_REL):
        raise RuntimeError(f"fused CE disagrees with the plain version at "
                           f"{shape}: {r['errs']}, target logit off by "
                           f"{r['tlogit']}, {n_off} hit mismatches away from ties, "
                           f"dhidden {r['dh_tiled']} from tiled_ce_dhidden")
    return r


def check_fused_ce(torch, device, path_case) -> list:
    """K4-K6 on the training path's batch (its N and targets), at the 830M
    head with N = 8000 and at two small ragged shapes: nll, logz, hits,
    dhidden, dw2 and db2 against the plain version and its autograd, forward
    and backward twice bit for bit, the first two timed. Hits may differ only where the target logit is within 1e-3 of the
    10th largest (fp32 summation order decides those). The report's times
    are the training path's."""
    gen = torch.Generator().manual_seed(6)
    shape, tgt = path_case
    res = [check_one_ce(torch, device, shape, tgt, gen),
           check_one_ce(torch, device, TRAIN_CE_SHAPE, None, gen)]
    res += [check_one_ce(torch, device, ragged, None, gen, timed=False)
            for ragged in RAGGED_CE_SHAPES]
    worst = {key: max(r["errs"][key] for r in res) for key in res[0]["errs"]}
    worst_abs = {key: max(r["abs"][key] for r in res) for key in res[0]["abs"]}
    t = res[0]
    common = {"route": "cuda", "source": "ssr_speech_tpu_torch/csrc/fused_ce.cu",
              "launches": 0, "library_ms": None, "shape": list(shape)}
    return [
        {"name": "fused_ce_fwd", "replaces": "ssr_speech_tpu/ops/fused_ce.py:80",
         "max_abs_err": worst_abs["nll"],
         "max_rel_err": max(worst["nll"], worst["logz"]),
         "ms": t["fwd"], "plain_ms": t["fwd_plain"], **t["bounds"]["fwd"],
         **common},
        {"name": "fused_ce_bwd_dhidden",
         "replaces": "ssr_speech_tpu/ops/fused_ce.py:100",
         "max_abs_err": worst_abs["dhidden"], "max_rel_err": worst["dhidden"],
         "ms": t["dh"], "plain_ms": t["dh_plain"], **t["bounds"]["dh"],
         **common},
        {"name": "fused_ce_bwd_dw2", "replaces": "ssr_speech_tpu/ops/fused_ce.py:121",
         "max_abs_err": max(worst_abs["dw2"], worst_abs["db2"]),
         "max_rel_err": max(worst["dw2"], worst["db2"]),
         "ms": t["dw"], "plain_ms": t["dw_plain"],
         "plain_bwd_all_ms": t["bwd_plain"], **t["bounds"]["dw"], **common},
    ]


# A 4-layer, head_dim 128 LM with sharpened attention (qkv_w x 3): on the CPU,
# bf16 alone moves the compared gradients by 5.8e-2 (qkv_w, layers 1-3) and
# 1.5e-2 (head2_w) of their max, while attending one future key moves them by
# 0.51 / 0.20 and ignoring the segments by 0.62 / 0.34. At the init's scale
# the attention is near uniform and a mask error hides inside the bf16 noise.
SMALL_TRAIN = dict(d_model=256, nhead=2, num_layers=4, n_codebooks=4,
                   audio_embedding_dim=256, text_vocab_size=30, head_hidden=128,
                   max_position=1024, trm_dropout=0.0, text_embedding_dropout=0.0,
                   text_positional_embedding_dropout=0.0,
                   audio_positional_embedding_dropout=0.0, attn_impl="flash",
                   ce_impl="fused")
QKV_SCALE = 3.0
GRAD_TOL = {"qkv_w": 0.2, "head2_w": 0.07}


def small_train_batch():
    import numpy as np

    from ssr_speech_tpu_torch.config import SSRModelConfig

    cfg = SSRModelConfig(**SMALL_TRAIN)
    ts = cfg.tokens
    rng = np.random.default_rng(3)
    b, sx, sy = 4, 64, 256
    x_lens = np.array([64, 40, 23, 51])
    y_lens = np.array([256, 200, 256, 131])
    x = rng.integers(0, cfg.text_vocab_size - 1, size=(b, sx))
    y = rng.integers(0, ts.audio_vocab_size, size=(b, sy, cfg.n_codebooks))
    y[:, 0] = ts.sos
    y[:, 100] = ts.mts
    for r in range(b):
        x[r, x_lens[r]:] = cfg.text_pad_token
        y[r, y_lens[r]:] = ts.pad
    return cfg, dict(x=x, x_lens=x_lens, y=y, y_lens=y_lens)


def check_small_train_step(torch, device) -> None:
    """One training forward/backward on the card (bf16, flash + fused CE
    kernels) against the port's fp32 CPU path: the loss, and the gradients
    of qkv_w in layers 1-3 and of head2_w relative to their max. Then eight
    ScaledAdam steps on the one batch: the loss must fall."""
    from ssr_speech_tpu_torch.config import OptimConfig, TrainConfig
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models.from_jax import trainable_lm_from_jax
    from ssr_speech_tpu_torch.ops import flash_attention as fa
    from ssr_speech_tpu_torch.ops import fused_ce as fce
    from ssr_speech_tpu_torch.training.optim import build_optimizer
    from ssr_speech_tpu_torch.training.trainer import make_train_step

    cfg, batch = small_train_batch()
    params = tssr.init_ssr(torch.Generator().manual_seed(3), cfg)
    params["decoder"]["layers"]["qkv_w"] *= QKV_SCALE

    def run(dev, dtype):
        model = trainable_lm_from_jax(params, cfg, device=dev)
        out = tssr.ssr_forward(model, cfg, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()},
                               compute_dtype=dtype, codebook_weight=CW)
        out["loss"].backward()
        return (out["loss"].item(),
                model["decoder"]["layers"]["qkv_w"].grad[1:].cpu(),
                model["head2_w"].grad.cpu())

    fa.reset_launches()
    fce.reset_launches()
    card = run(device, torch.bfloat16)
    torch.cuda.synchronize()
    counts = (fa.launches, fa.bwd_launches, fce.fwd_launches,
              fce.dhidden_launches, fce.dw2_launches)
    if counts != (cfg.num_layers, cfg.num_layers, 1, 1, 1):
        raise RuntimeError(f"small train step launched {counts} (flash fwd, "
                           f"bwd, ce fwd, dhidden, dw2)")
    cpu = run(torch.device("cpu"), torch.float32)
    errs = {"loss": abs(card[0] - cpu[0]) / abs(cpu[0]),
            "qkv_w": rel_err(card[1], cpu[1]), "head2_w": rel_err(card[2], cpu[2])}
    print(f"[train-small] 4-layer Dh=128 step, bf16 card vs fp32 CPU: loss "
          f"{card[0]:.4f} vs {cpu[0]:.4f} (rel {errs['loss']:.2e}); grad max "
          f"err / max: qkv_w layers 1-3 {errs['qkv_w']:.2e} (tol "
          f"{GRAD_TOL['qkv_w']}), head2_w {errs['head2_w']:.2e} (tol "
          f"{GRAD_TOL['head2_w']}); launches {counts}")
    if errs["loss"] > 1e-2 or any(errs[k] > t for k, t in GRAD_TOL.items()):
        raise RuntimeError(f"small train step on the card disagrees with the "
                           f"CPU: {errs}")

    tcfg = TrainConfig(precision="bfloat16", codebook_weight=CW,
                       optim=OptimConfig(optimizer_name="scaledadam", lr=0.05))
    opt, _ = build_optimizer(tcfg.optim)
    model = trainable_lm_from_jax(params, cfg, device=device)
    state = opt.init(model.tree())
    step = make_train_step(cfg, tcfg, opt, device)
    gen = torch.Generator(device=device).manual_seed(0)
    ms = [step(model, state, batch, gen) for _ in range(8)]
    losses = [float(m["loss"]) for m in ms]
    print(f"[train-small] 8 ScaledAdam steps on one batch: loss "
          + " ".join(f"{x:.2f}" for x in losses))
    if any(m["skipped"] for m in ms) or not losses[-1] < losses[0]:
        raise RuntimeError(f"small training run did not lower the loss: {losses}")


TRAIN_STEPS = 5  # --num_steps: the loop runs steps 0..TRAIN_STEPS
TRAIN_TOKENS = 20000  # --max_num_tokens, the CLI default
TRAIN_PHONES = 119  # text vocab 120 (the e830M geometry of __graft_entry__.py)


def write_corpus(root: Path, n: int = 600, seed: int = 0) -> str:
    """A seeded synthetic corpus in the training dataset's layout (the
    recipe of tests/test_training.py::make_synth_corpus) at realistic
    lengths: 2-20 s of audio (100-1000 codec frames at 50 Hz) and 20-150
    phonemes per utterance, 4 codebooks of 2048 codes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = root / "corpus"
    for sub in ("manifest", "phonemes", "codes"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    phones = [f"ph{i}" for i in range(TRAIN_PHONES)]
    (d / "vocab.txt").write_text("\n".join(f"{i} {p}" for i, p in enumerate(phones)))
    lines = []
    for i in range(n):
        seg = f"utt{i:04d}"
        frames = int(rng.integers(100, 1001))
        lines.append(f"0\t{seg}\t{frames}")
        toks = rng.choice(phones, size=int(rng.integers(20, 151)))
        (d / "phonemes" / f"{seg}.txt").write_text(" ".join(toks))
        codes = rng.integers(0, 2048, size=(4, frames))
        (d / "codes" / f"{seg}.txt").write_text(
            "\n".join(" ".join(str(c) for c in row) for row in codes))
    (d / "manifest" / "train.txt").write_text("\n".join(lines))
    return str(d)


def train_argv(device, work: Path, root: str, layers: int = 16,
               d_model: int = 2048, nhead: int = 16):
    return ["--device", str(device), "--exp_dir", str(work / "train_exp"),
            "--dataset_dir", root, "--encodec_folder_name", "codes",
            "--d_model", str(d_model), "--nhead", str(nhead),
            "--num_decoder_layers", str(layers), "--n_codebooks", "4",
            "--text_vocab_size", str(TRAIN_PHONES + 1),
            "--attn_impl", "flash", "--ce_impl", "fused",
            "--optimizer_name", "scaledadam", "--lr", "0.05",
            "--codebook_weight", ",".join(str(w) for w in CW),
            "--max_num_tokens", str(TRAIN_TOKENS), "--benchmark_no_load",
            "--num_steps", str(TRAIN_STEPS), "--print_every_n_steps", "1",
            "--val_every_n_steps", "1000000"]


def drive_training_path(torch, device, argv, card: str, checked) -> dict:
    """``train_lm.main(argv)`` (by default the e830M geometry: d_model 2048,
    16 heads, 16 layers, 4 codebooks) over the synthetic corpus, with the
    CLI's dropouts: finite losses, no skipped step, changed parameters, a
    bundle that the serving loader reads, the exact launch counts (flash
    forward and backward once per layer per step, each CE kernel once per
    step), and every step on the batch shape ``checked`` (B, Sx, Sy) at which
    the kernels were held against their plain versions. Returns the launches
    of this path by kernel."""
    from ssr_speech_tpu_torch import train_lm
    from ssr_speech_tpu_torch.models import ssr as tssr
    from ssr_speech_tpu_torch.models.pretrained import load_lm
    from ssr_speech_tpu_torch.ops import flash_attention as fa
    from ssr_speech_tpu_torch.ops import fused_ce as fce

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # count only this path's launches
    fce.reset_launches()
    t0 = time.perf_counter()
    trainer = train_lm.main(argv)
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.launches,
                "flash_attention_bwd": fa.bwd_launches,
                "fused_ce_fwd": fce.fwd_launches,
                "fused_ce_bwd_dhidden": fce.dhidden_launches,
                "fused_ce_bwd_dw2": fce.dw2_launches}
    hist, cfg = trainer.history, trainer.cfg
    steps = len(hist)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    b, sx, sy = hist[0]["batch_shape"]
    step_s = sum(h["seconds"] for h in hist[1:]) / max(steps - 1, 1)
    print(f"[train-830M] {steps} steps of [B={b}, S={sx}+{sy}] ({b * (sx + sy)} "
          f"positions, {hist[0]['real_tokens']} unpadded), "
          f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f}M "
          f"params; first step {hist[0]['seconds']:.2f} s, then "
          f"{step_s * 1e3:.1f} ms/step = {b * (sx + sy) / step_s:.0f} "
          f"positions/s ({hist[0]['real_tokens'] / step_s:.0f} unpadded/s); "
          f"peak {peak:.2f} GiB; main() {wall:.1f} s [{card}]")
    print("[train-830M] loss/ntokens by step: " + " ".join(
        f"{h['loss'] / max(h['ntokens'], 1):.4f}" for h in hist))
    if steps != TRAIN_STEPS + 1:
        raise RuntimeError(f"{steps} training steps, expected {TRAIN_STEPS + 1}")
    if any(tuple(h["batch_shape"]) != tuple(checked) for h in hist):
        raise RuntimeError(f"training ran on batch shapes "
                           f"{sorted({tuple(h['batch_shape']) for h in hist})}; "
                           f"the kernel checks took {tuple(checked)}")
    if not all(math.isfinite(h["loss"]) and h["skipped"] == 0.0 for h in hist):
        raise RuntimeError(f"non-finite or skipped training steps: {hist}")
    want = {"flash_attention_fwd": cfg.num_layers * steps,
            "flash_attention_bwd": cfg.num_layers * steps,
            "fused_ce_fwd": steps, "fused_ce_bwd_dhidden": steps,
            "fused_ce_bwd_dw2": steps}
    if launches != want:
        raise RuntimeError(f"training launches {launches}, expected {want}")
    init = tssr.init_ssr(torch.Generator(device=device).manual_seed(
        trainer.tcfg.seed + 1), cfg, device)
    for key in ("head2_w", "text_emb"):
        if torch.equal(init[key], trainer.model[key].detach()):
            raise RuntimeError(f"training left {key} at its init")
    del init
    served, served_cfg, _ = load_lm(os.path.join(trainer.exp_dir, "bundle.pkl"), device)
    if served_cfg != cfg or not torch.equal(served["head2_w"],
                                            trainer.model["head2_w"].detach()):
        raise RuntimeError("the serving loader does not read the trained bundle")
    print(f"[train-830M] finite losses, no skipped step, parameters moved, "
          f"bundle loads for serving; launches {launches}")
    return launches


# ------------------------------------------------------ int8 weight streaming

INT8_SHAPE = (2048, 8192, 16)  # d_model, FFN width, layers of the 830M LM
INT8_ROWS = (2, 8, 64)  # the TPU probes' own row counts, and a batch of 64
CODEC_STEPS = 6  # --updates of the full-width fp32 run
CODEC_BF16_STEPS = 2
CODEC_PROFILE_STEPS = 2  # traced steps of the profile run (after its first)
CODEC_BATCH = 16  # train_codec's default --batch_size
CODEC_SEGMENT_S = 2.0  # train_codec's default --segment_duration
CODEC_METRIC_REL = 1e-4  # card against the fp32 CPU path, TINY geometry
# watermark-decoder gradients, card against CPU and run against run: 1e-3
# of each leaf's largest, and never below 1e-4 of the step's largest (a leaf
# that is zero in exact arithmetic holds only rounding)
CODEC_GRAD_REL, CODEC_GRAD_FLOOR = 1e-3, 1e-4
CODEC_BF16_REL = 0.05  # bf16 first step against the fp32 first step


def codec_tiny_config():
    """The TINY codec of tests/test_codec_training.py."""
    from ssr_speech_tpu_torch.config import CodecConfig, RVQConfig, SEANetConfig

    return CodecConfig(sample_rate=16000, seanet=SEANetConfig(
        dimension=16, n_filters=2, n_residual_layers=1, ratios=(8, 5, 4, 2),
        lstm=1, norm="weight_norm", pad_mode="constant"),
        rvq=RVQConfig(dimension=16, n_q=2, bins=11))


def write_codec_manifest(root: Path, n: int = 48, seed: int = 0) -> str:
    """A seeded synthetic 16 kHz corpus for codec training: ``n`` wavs of
    2-5 s (a few decaying partials and noise), listed in a jsonl manifest
    of {path, duration, sample_rate}."""
    import numpy as np

    from ssr_speech_tpu_torch.utils import audio as audio_io

    rng = np.random.default_rng(seed)
    d = root / "codec_corpus"
    d.mkdir(parents=True, exist_ok=True)
    sr, lines = 16000, []
    for i in range(n):
        dur = float(rng.uniform(2.0, 5.0))
        t = np.arange(int(sr * dur)) / sr
        wav = 0.02 * rng.standard_normal(t.shape)
        for f0 in rng.uniform(80.0, 2000.0, size=3):
            wav += 0.1 * np.sin(2 * np.pi * f0 * t) * np.exp(-t * rng.uniform(0.1, 1.0))
        path = d / f"w{i:03d}.wav"
        audio_io.write_wav(str(path), wav.astype(np.float32)[None], sr)
        lines.append(json.dumps({"path": str(path), "duration": dur,
                                 "sample_rate": sr}))
    (d / "data.jsonl").write_text("\n".join(lines))
    return str(d / "data.jsonl")


def _wm_grads(state):
    """The gradient a first Adam step was fed, from its mu (b1 = 0.5)."""
    from ssr_speech_tpu_torch.utils.tree import tree_leaves

    return [m.detach().float().cpu() * 2.0 for m in tree_leaves(state.g_opt[1])]


def _grads_close(got, want) -> float:
    """The worst |got - want| over the allowed error, leaf by leaf (<= 1
    passes)."""
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) / max(
        CODEC_GRAD_REL * float(w.abs().max()), CODEC_GRAD_FLOOR * top)
        for g, w in zip(got, want))


def check_small_codec_step(torch, device) -> dict:
    """One TINY codec train step on the card against the port's fp32 CPU
    path from the same state and batch (the state carried across with
    ``codec_train_state_to_numpy`` / ``from_jax``), and two runs on the
    card against each other."""
    import numpy as np

    from ssr_speech_tpu_torch.models.codec import wmencodec as twm
    from ssr_speech_tpu_torch.models.from_jax import (
        codec_train_state_from_jax, codec_train_state_to_numpy)
    from ssr_speech_tpu_torch.training import codec_trainer as tct

    cfg = codec_tiny_config()
    cpu = torch.device("cpu")
    init, _ = tct.init_codec_train_state(torch.Generator().manual_seed(0),
                                         cfg, lr=1e-3, disc_scales=2)
    init = codec_train_state_to_numpy(init)
    rng = np.random.default_rng(0)
    hop, frames = cfg.hop_length, 8
    wav = (rng.standard_normal((2, frames * hop, 1)) * 0.1).astype(np.float32)
    labels, keep = twm.sample_watermark_mask(rng, 2, frames, hop, min_regions=1)

    def run(dev):
        state = codec_train_state_from_jax(init, cfg, device=dev)
        step = tct.make_codec_train_step(cfg, tct.make_optimizers(1e-3))
        state, m = step(state, *(torch.from_numpy(a).to(dev)
                                 for a in (wav, labels, keep)))
        return {k: float(v) for k, v in m.items()}, _wm_grads(state)

    m_cpu, g_cpu = run(cpu)
    runs = [run(device) for _ in range(2)]
    metric_err = max(abs(runs[0][0][k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    grad_err = _grads_close(runs[0][1], g_cpu)
    rerun_err = _grads_close(runs[1][1], runs[0][1])
    rerun_metric = max(abs(runs[1][0][k] - runs[0][0][k]) / abs(runs[0][0][k])
                       for k in m_cpu)
    print(f"[codec-train small] TINY step, card vs fp32 CPU: metrics worst "
          f"rel {metric_err:.2e} (tol {CODEC_METRIC_REL}), watermark-decoder "
          f"grads {grad_err:.3f} of the allowed error; two card runs: "
          f"metrics {rerun_metric:.2e}, grads {rerun_err:.3f}")
    if not (metric_err <= CODEC_METRIC_REL and rerun_metric <= CODEC_METRIC_REL
            and grad_err <= 1.0 and rerun_err <= 1.0):
        raise RuntimeError("codec train step on the card disagrees with the "
                           "CPU path or with itself")
    return dict(metric_rel=metric_err, grad_of_tol=grad_err,
                rerun_grad_of_tol=rerun_err)


def codec_train_argv(device, manifest: str, bundle: str, exp: Path, steps: int,
                     *extra, batch: int = CODEC_BATCH,
                     segment: float = CODEC_SEGMENT_S) -> list:
    return ["--device", str(device), "--manifest", manifest,
            "--codec_path", bundle, "--exp_dir", str(exp),
            "--batch_size", str(batch), "--segment_duration", str(segment),
            "--updates", str(steps), "--epochs", "1", "--wm_min_regions", "1",
            "--seed", "0", *extra]


def _ms_per_step(run) -> list:
    return [row["wall_s"] * 1e3 for row in run["history"]]


def drive_codec_train_path(torch, device, bundle: str, work: Path, card: str,
                           extra=(), batch: int = CODEC_BATCH,
                           segment: float = CODEC_SEGMENT_S) -> dict:
    """``train_codec.main`` from the serving phase's full-width codec bundle
    (the default encodec_large_nq4_s320: n_filters 64, dimension 128, 4 x
    2048 RVQ, 2 LSTM layers; all 5 MS-STFT scales) over a seeded synthetic
    16 kHz corpus: 6 fp32 steps (bundle and eval every 3), then 2 bf16
    steps, then a profiled fp32 run. ``extra`` adds flags (a CPU rehearsal
    passes ``--config_json`` of a tiny codec)."""
    import contextlib
    import io

    import numpy as np

    from ssr_speech_tpu_torch import train_codec
    from ssr_speech_tpu_torch.inference import detect_cli
    from ssr_speech_tpu_torch.models.pretrained import load_bundle, load_codec
    from ssr_speech_tpu_torch.utils.tree import tree_leaves

    manifest = write_codec_manifest(work)
    cuda = device.type == "cuda"

    def peak():
        return (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                else float("nan"))

    runs = {}
    for name, steps, flags in (
            ("fp32", CODEC_STEPS, ["--save_every", "3", "--eval_every", "3"]),
            ("bf16", CODEC_BF16_STEPS, ["--save_every", "100", "--eval_every",
                                        "2", "--precision", "bfloat16"])):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train_codec.main(codec_train_argv(
            device, manifest, bundle, work / f"codec_{name}", steps, *flags,
            *extra, batch=batch, segment=segment))
        run["total_s"] = time.perf_counter() - t0
        run["peak_gib"] = peak()
        runs[name] = run
        ms = _ms_per_step(run)
        print(f"[codec-train] {name}: {steps} steps of [{batch}, "
              f"{int(segment * 16000)}, 1] in {run['total_s']:.1f} s; first "
              f"step {ms[0]:.1f} ms, then {np.mean(ms[1:]):.1f} ms/step (min "
              f"{min(ms[1:]):.1f}, max {max(ms[1:]):.1f}); peak "
              f"{run['peak_gib']:.2f} GiB; eval SI-SNR "
              + ", ".join(f"step {s}: {v:.2f} dB" for s, v in run["eval_sisnr"])
              + f" [{card}]")
        for i, row in enumerate(run["history"]):
            if not all(np.isfinite(v) for v in row.values()):
                raise RuntimeError(f"codec-train {name}: step {i + 1} metrics "
                                   f"not finite: {row}")
    fp32, bf16 = runs["fp32"], runs["bf16"]
    print("[codec-train] fp32 metrics by step: " + "; ".join(
        " ".join(f"{k} {v:.4g}" for k, v in row.items() if k != "wall_s")
        for row in fp32["history"]))

    # gates of the fp32 run
    state = fp32["state"]
    start = load_bundle(bundle)["params"]
    for part in ("encoder", "decoder", "quantizer"):
        for a, b in zip(tree_leaves(state.frozen[part]), tree_leaves(start[part])):
            if not np.array_equal(a.detach().cpu().numpy(), b):
                raise RuntimeError(f"codec-train: frozen {part} changed")
    boot = train_codec.bootstrap_wm_from_codec(load_bundle(bundle)["params"])
    moved = [not np.array_equal(a.detach().cpu().numpy(), b) for a, b in zip(
        tree_leaves(state.wm_params), tree_leaves(boot["wmdecoder"]))]
    if sum(moved) < 0.9 * len(moved):
        raise RuntimeError(f"codec-train: only {sum(moved)} of {len(moved)} "
                           f"watermark leaves moved")
    if float(state.balancer.count) != CODEC_STEPS or int(state.step) != CODEC_STEPS:
        raise RuntimeError(f"codec-train: balancer count "
                           f"{float(state.balancer.count)}, step "
                           f"{int(state.step)}, expected {CODEC_STEPS}")
    tok = load_codec(fp32["bundle"], device)
    sample_dir = Path(fp32["samples_dir"]) / "epoch_0"
    sample = sorted(p for p in sample_dir.glob("*.wav")
                    if not p.name.endswith("_prompt.wav"))[0]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        detect_cli.main(["--codec_path", fp32["bundle"], "--audio", str(sample),
                         "--frames", "--device", str(device)])
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    want_frames = int(segment * tok.sample_rate) // tok.cfg.hop_length
    if not (row["frames"] == len(row["per_frame"]) == want_frames):
        raise RuntimeError(f"detect_cli: {row['frames']} frames, "
                           f"{len(row['per_frame'])} decisions, expected "
                           f"{want_frames}")
    print(f"[codec-train] frozen encoder/decoder/quantizer bit-identical to the "
          f"bundle; {sum(moved)}/{len(moved)} watermark leaves moved; balancer "
          f"count {float(state.balancer.count):.0f}; the saved bundle loads "
          f"(load_codec) and detect_cli gives {row['frames']} decisions on a "
          f"stored sample (watermarked fraction "
          f"{row['watermarked_fraction']})")
    worst = 0.0
    for k, a in fp32["history"][0].items():
        if k == "wall_s":
            continue
        b = bf16["history"][0][k]
        err = abs(a - b) / (CODEC_BF16_REL * abs(a) + 1e-4)
        worst = max(worst, err)
    print(f"[codec-train] bf16 first step against fp32: worst metric at "
          f"{worst:.3f} of the allowed {CODEC_BF16_REL:.0%}")
    if worst > 1.0:
        raise RuntimeError("codec-train: bf16 first step not within 5% of fp32")
    del state, fp32["state"], bf16["state"]
    gc.collect()

    # where the step's time goes: a separate fp32 run, traced after step 1
    prof_run = train_codec.main(codec_train_argv(
        device, manifest, bundle, work / "codec_profile",
        CODEC_PROFILE_STEPS + 1, "--save_every", "100", "--eval_every", "100",
        "--profile_steps", str(CODEC_PROFILE_STEPS), *extra, batch=batch,
        segment=segment))
    del prof_run["state"]
    with open(work / "codec_profile" / "profile" / "summary.json") as f:
        prof = json.load(f)
    groups = prof["device_ms_per_step"]
    busy = prof["busy_ms_per_step"]
    print(f"[codec-train] profile of {prof['steps']} fp32 steps: "
          f"{prof['kernels_per_step']:.0f} kernels and {busy:.1f} ms device "
          f"busy a step, idle share {prof['idle_share'] or float('nan'):.3f}; "
          "by group (ms/step): " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(groups.items(),
                                                key=lambda kv: -kv[1]) if v)
          + f" [{card}]")
    print("[codec-train] top kernels: " + "; ".join(
        f"{t['name'][:60]} {t['ms_per_step']:.2f} ms" for t in prof["top"][:8]))
    summary = {name: dict(
        steps=len(r["history"]), first_step_ms=_ms_per_step(r)[0],
        ms_per_step=float(np.mean(_ms_per_step(r)[1:])),
        peak_gib=r["peak_gib"], eval_sisnr=r["eval_sisnr"]) for name, r in
        runs.items()}
    summary.update(profile=dict(device_ms_per_step=groups, busy_ms_per_step=busy,
                                idle_share=prof["idle_share"],
                                kernels_per_step=prof["kernels_per_step"]),
                   batch=[batch, int(segment * 16000), 1], card=card)
    return summary


MEGA_ROWS = (2, 8)  # the megakernel carries at most 8
CHAIN_REL = 5e-2  # 16 layers: a bf16 rounding flip in h feeds every later layer
INT8_SRC = "ssr_speech_tpu_torch/csrc/int8_matmul.cu"


def check_int8(torch, device) -> list:
    """K7-K9 at the probe's full width against their plain versions on the
    card. One layer at ``REL`` of the max (the int8 mode bit for bit), the
    16-layer chains and the megakernel at ``CHAIN_REL`` (int8 mode bit for
    bit), every kernel twice bit for bit; each chain with programmatic
    dependent launch, without it, and captured in a CUDA graph and replayed,
    all three bit for bit. Times are per wrapper call over 16 distinct
    matrices (268 MB, more than the L2 holds): a chain's 16 launches, the
    megakernel's one; ``int8_matvec`` is timed as that chain and reported
    per launch. ``ms`` is the call as made (eager launches), ``device_ms``
    the same launches queued behind a blocker so that they run back to back
    (``int8_probe.queued_ms``), ``graph_ms`` / ``graph_device_ms`` the graph's
    replay as called and queued. The library call is
    ``torch._weight_int8pack_mm`` on the transposed weight, whose scales are
    bf16 (K7's are fp32): a yardstick of time, not of bits; for the chain,
    16 chained calls, the megakernel's yardstick too. The megakernel's
    ``return_acc`` sums of the last layer are held on every column against
    the plain last layer from the kernel's own h before it (``REL`` of the
    column's largest), and its weight stream alone (``int8_mega_stream``)
    is timed queued for the per-layer line. The report's rows: 2 for the
    launches-per-layer kernels, 8 for the megakernel (the TPU probes' own);
    ``by_rows`` has the rest."""
    import numpy as np

    from ssr_speech_tpu_torch.int8_probe import (QUEUED_CALLS, library_chain,
                                                 matvec_chain, queued_ms)
    from ssr_speech_tpu_torch.ops import int8_matmul as i8

    d, f, n_layers = INT8_SHAPE
    rng = np.random.default_rng(7)
    wq = torch.from_numpy(rng.integers(-127, 127, size=(n_layers, d, f)
                                       ).astype(np.int8)).to(device)
    s = torch.from_numpy((np.abs(rng.normal(size=(n_layers, 1, f))) * 0.01
                          ).astype(np.float32)).to(device)
    w1 = torch.from_numpy(rng.normal(size=(d, f), scale=0.02).astype(np.float32))
    q1, s1 = i8.quantize_weight(w1.to(device))
    lib_w, lib_s = wq.transpose(1, 2).contiguous(), s[:, 0].to(torch.bfloat16)
    res = {}

    def twice(fn, label):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.isfinite(a.float()).all():
            raise RuntimeError(f"{label}: non-finite output")
        if not torch.equal(a, b):
            raise RuntimeError(f"{label}: two runs differ")
        return a

    def hold(label, got, want, tol):
        abs_err = (got.float() - want.float()).abs().max().item()
        rel = rel_err(got, want)
        ok = torch.equal(got, want) if tol == 0 else rel <= tol
        if not ok:
            raise RuntimeError(f"{label} disagrees with its plain version: max "
                               f"err / max {rel:.3e} (tol {tol})")
        return abs_err, rel

    def plain_matvec_chain(x, w, sc):
        h = x
        for layer in range(n_layers):
            h = i8.reference_int8_matvec(h, w[layer], sc[layer, 0])[:, :d]
        return h

    def timed_chain(label, run, eager):
        """ms and queued ms of ``run`` as called and as a graph replay; the
        chain without programmatic dependent launch and the replay must
        equal ``eager``. Returns the times and the capture's launches."""
        i8.PDL = False
        try:
            if not torch.equal(run(), eager):
                raise RuntimeError(f"{label}: the chain without PDL differs")
        finally:
            i8.PDL = True
        ms = cuda_time_ms(torch, run)
        dev = queued_ms(run, ms, device)
        graph = i8.Captured(run)
        if not torch.equal(graph(), eager):
            raise RuntimeError(f"{label}: the CUDA graph's replay differs")
        if graph.programmatic_edges < n_layers - 1:
            raise RuntimeError(f"{label}: the graph has {graph.programmatic_edges} "
                               f"programmatic edges, want {n_layers - 1}")
        gms = cuda_time_ms(torch, graph)
        gdev = queued_ms(graph, gms, device)
        return dict(ms=ms, device_ms=dev, graph_ms=gms, graph_device_ms=gdev,
                    graph_edges=graph.edges, programmatic_edges=graph.programmatic_edges)

    for rows in INT8_ROWS:
        x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)
                             ).to(device, torch.bfloat16)
        out = torch.empty((rows, f), dtype=torch.bfloat16, device=device)
        i8.reset_launches()
        # K7: one layer on quantize_weight's output, then the chain
        one = hold(f"int8_matvec rows {rows}",
                   twice(lambda: i8.int8_matvec(x, q1, s1), "int8_matvec"),
                   i8.reference_int8_matvec(x, q1, s1), REL)
        run = lambda: matvec_chain(x, wq, s, n_layers)  # noqa: E731
        eager = twice(run, "int8_matvec chain")
        chain = hold(f"int8_matvec chain rows {rows}", eager,
                     plain_matvec_chain(x, wq, s), CHAIN_REL)
        t = timed_chain(f"int8_matvec chain rows {rows}", run, eager)
        lib = lambda: library_chain(x, lib_w, lib_s, n_layers)  # noqa: E731
        lib_ms = queued_ms(lib, cuda_time_ms(torch, lib, iters=5), device)
        # 2 + 2 chains + no PDL + warm-up and 20 timed + queued + graph warm-up and capture
        if i8.matvec_launches != 2 + (2 + 1 + 21 + QUEUED_CALLS + 2) * n_layers:
            raise RuntimeError("int8_matvec did not launch its kernel once a layer")
        plain_ms = cuda_time_ms(torch, lambda: plain_matvec_chain(x, wq, s),
                                iters=5) / n_layers
        res[("int8_matvec", rows)] = dict(
            abs=one[0], rel=max(one[1], chain[1]), plain_ms=plain_ms,
            library_ms=lib_ms / n_layers,
            **{k: v / n_layers if k.endswith("ms") else v for k, v in t.items()},
            **bound(nbytes(x, q1, s1, out), 2 * rows * d * f, "bf16"))
        # K8: one layer and the chain, both modes
        for mode in i8.MODES:
            tol = 0 if mode == "int8" else REL
            one = hold(f"int8 layer {mode} rows {rows}",
                       twice(lambda: i8.int8_matvec_layer(x, wq[0], s[0, 0], mode),
                             f"int8 layer {mode}"),
                       i8.reference_int8_layer(x, wq[0], s[0, 0], mode), tol)
            tol = 0 if mode == "int8" else CHAIN_REL
            run = lambda: i8.int8_matvec_chain(x, wq, s, mode, n_layers)  # noqa: E731
            eager = twice(run, f"int8 chain {mode}")
            chain = hold(f"int8 chain {mode} rows {rows}", eager,
                         i8.reference_int8_chain(x, wq, s, mode, n_layers), tol)
            t = timed_chain(f"int8 chain {mode} rows {rows}", run, eager)
            plain_ms = cuda_time_ms(torch, lambda: i8.reference_int8_chain(
                x, wq, s, mode, n_layers), iters=5)
            res[(f"int8_chain_{mode}", rows)] = dict(
                abs=one[0], rel=max(one[1], chain[1]), plain_ms=plain_ms,
                library_ms=lib_ms if mode == "bf16" else None, **t,
                **bound(n_layers * nbytes(x, wq[0], s[0], out),
                        2 * rows * d * f * n_layers, mode))
        if (i8.chain_bf16_launches, i8.chain_int8_launches) != (
                (2 + (2 + 1 + 21 + QUEUED_CALLS + 2) * n_layers,) * 2):
            raise RuntimeError("int8_matvec_chain did not launch once a layer")
        if rows not in MEGA_ROWS:
            continue
        # K9: one layer at the tight tolerance, then all 16 in one launch
        one = hold(f"int8_megakernel 1 layer rows {rows}",
                   twice(lambda: i8.int8_megakernel(x, wq[:1], s[:1]), "megakernel"),
                   i8.reference_int8_mega(x, wq[:1], s[:1]), REL)
        eager = twice(lambda: i8.int8_megakernel(x, wq, s), "megakernel")
        full = hold(f"int8_megakernel rows {rows}", eager,
                    i8.reference_int8_mega(x, wq, s), CHAIN_REL)
        # every column of the last layer, against the plain last layer taken
        # from the kernel's own h before it (a skipped column fails here)
        out_acc, acc = i8.int8_megakernel(x, wq, s, return_acc=True)
        h_before = i8.int8_megakernel(x, wq[:-1], s[:-1])
        want = (h_before.float() @ wq[-1].float()) * s[-1].float()
        col_rel = ((acc - want).abs().amax(dim=0)
                   / want.abs().amax(dim=0).clamp_min(1e-30)).max().item()
        if not torch.equal(out_acc, eager) or col_rel > REL:
            raise RuntimeError(f"int8_megakernel rows {rows}: return_acc differs "
                               f"from the plain last layer (max over columns of "
                               f"err / column max {col_rel:.3e}, tol {REL})")
        if i8.mega_launches != 6:
            raise RuntimeError("int8_megakernel did not launch once a call")
        ms = cuda_time_ms(torch, lambda: i8.int8_megakernel(x, wq, s))
        dev = queued_ms(lambda: i8.int8_megakernel(x, wq, s), ms, device)
        plain_ms = cuda_time_ms(torch, lambda: i8.reference_int8_mega(x, wq, s),
                                iters=5)
        stream = lambda: i8.int8_mega_stream(wq)  # noqa: E731
        stream_dev = queued_ms(stream, cuda_time_ms(torch, stream), device)
        res[("int8_megakernel", rows)] = dict(
            abs=one[0], rel=max(one[1], full[1]), ms=ms, device_ms=dev,
            plain_ms=plain_ms, library_ms=lib_ms,
            stream_device_ms=stream_dev,
            **bound(nbytes(x, wq, s, x), 2 * rows * d * f * n_layers, "bf16"))
        v = res[("int8_megakernel", rows)]
        per = 1e3 / n_layers  # ms a call -> us a layer
        print(f"[int8] megakernel per-layer rows {rows}: {dev * per:.2f} us a layer "
              f"queued, the weight stream alone {stream_dev * per:.2f} us "
              f"({wq.numel() / stream_dev / 1e6:.0f} GB/s), bound "
              f"{v['bound_ms'] * per:.2f} us: the kernel at "
              f"{v['bound_ms'] / dev:.1%} of the bound, the stream alone at "
              f"{v['bound_ms'] / stream_dev:.1%}; last layer's sums on all {f} "
              f"columns within {col_rel:.2e} of each column's max; grid "
              f"{min(2 * f // 128, i8.mega_resident())} blocks")
    for (name, rows), v in res.items():
        graph = (f"; as a CUDA graph {v['graph_ms']:.4f} ms, {v['graph_device_ms']:.4f} "
                 f"queued ({v['programmatic_edges']} of {v['graph_edges']} edges "
                 "programmatic), bit-identical to the eager chain and to it without "
                 "PDL" if "graph_ms" in v else "")
        lib = (f"; torch._weight_int8pack_mm (bf16 scales) {v['library_ms']:.4f} ms "
               "queued" if v["library_ms"] is not None else "")
        print(f"[int8] rows {rows} {name}: max err / max {v['rel']:.2e} "
              f"(one layer max abs {v['abs']:.2e}), two runs "
              f"bit-identical; kernel {v['ms']:.4f} ms as called, "
              f"{v['device_ms']:.4f} ms queued, plain "
              f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms by "
              f"{v['bound_by']}{lib}{graph}")
    i8.reset_launches()
    replaces = {"int8_matvec": "tools/int8_matmul.py:55",
                "int8_chain_bf16": "tools/int8_kernel_probe2.py:25",
                "int8_chain_int8": "tools/int8_kernel_probe2.py:25",
                "int8_megakernel": "tools/int8_kernel_probe3.py:36"}
    keys = ("ms", "device_ms", "graph_ms", "graph_device_ms", "plain_ms",
            "library_ms", "bound_ms", "stream_device_ms")
    entries = []
    for name, where in replaces.items():
        rows = 8 if name == "int8_megakernel" else 2
        v = res[(name, rows)]
        entries.append({
            "name": name, "route": "cuda", "source": INT8_SRC, "replaces": where,
            "launches": 0, "max_abs_err": v["abs"], "max_rel_err": v["rel"],
            "ms": v["ms"], "device_ms": v["device_ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
            **({"library_note": "torch._weight_int8pack_mm, bf16 scales, queued"}
               if v["library_ms"] is not None else {}),
            "shape": [rows, d, f, n_layers],
            "by_rows": {str(r): {k: val[k] for k in keys if k in val}
                        for (nm, r), val in res.items() if nm == name}})
    return entries


def drive_int8_probe(torch, card: str) -> dict:
    """``int8_probe.main`` at its defaults (the 830M widths, 16 layers, 2 and
    8 rows, the card): every measured line finite, each chain's kernel
    launched once per layer per call and the megakernel once per call.
    Returns this path's launches by kernel."""
    from ssr_speech_tpu_torch import int8_probe
    from ssr_speech_tpu_torch.ops import int8_matmul as i8

    i8.reset_launches()  # count only this path's launches
    t0 = time.perf_counter()
    res = int8_probe.main([])
    torch.cuda.synchronize()
    launches = {"int8_matvec": i8.matvec_launches,
                "int8_chain_bf16": i8.chain_bf16_launches,
                "int8_chain_int8": i8.chain_int8_launches,
                "int8_megakernel": i8.mega_launches}
    if (res["d_model"], res["ffn_dim"], res["layers"]) != INT8_SHAPE:
        raise RuntimeError(f"the probe ran at {res['d_model']}, {res['ffn_dim']}, "
                           f"{res['layers']}; the kernel checks took {INT8_SHAPE}")
    want = dict.fromkeys(launches, 0)
    graphs = 0
    for line in res["lines"]:
        if not line["finite"] or line["device"] != "cuda":
            raise RuntimeError(f"int8 probe: bad line {line}")
        if line["kernel"] is None:
            continue
        per_call = 1 if line["kernel"] == "int8_megakernel" else res["layers"]
        if "captured_launches" in line:  # a graph: its replays pass no wrapper
            if (line["launches"], line["captured_launches"]) != (0, 2 * per_call) \
                    or not line["equal_to_eager"] \
                    or line["programmatic_edges"] < per_call - 1:
                raise RuntimeError(f"int8 probe: bad graph line {line}")
            want[line["kernel"]] += 2 * per_call  # warm-up and capture
            graphs += 1
            continue
        if line["launches"] != per_call * line["calls"]:
            raise RuntimeError(f"int8 probe: {line['name']} launched "
                               f"{line['launches']} times in {line['calls']} "
                               f"calls, expected {per_call} a call")
        want[line["kernel"]] += per_call * (line["calls"] + 1)  # + the output's
    if graphs != 12:  # 3 chains x 2 rows x 2 weight variants
        raise RuntimeError(f"int8 probe: {graphs} graph lines, expected 12")
    if launches != want or not all(launches.values()):
        raise RuntimeError(f"int8 probe launches {launches}, expected {want}")
    print(f"[int8-probe] {len(res['lines'])} lines in "
          f"{time.perf_counter() - t0:.1f} s, finite outputs, {graphs} graph "
          "replays equal to their eager chains; launches "
          f"{launches} [{card}]")
    return launches


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
    t0 = time.perf_counter()
    build_kernels()
    work = REPO / ".smoke_work"
    try:
        argv = train_argv(device, work, write_corpus(work))
        cfg, batch = first_train_batch(device, argv)
        attn_case, ce_case = train_path_cases(torch, cfg, batch, device)
        print(f"[train-830M] first batch: x {list(batch['x'].shape)}, y "
              f"{list(batch['y'].shape)}; kernel checks at attention "
              f"{list(attn_case[0])} and CE {list(ce_case[0])}")
        flash_bwd, fwd_train = check_flash_backward(torch, device, attn_case)
        layout, multi_seg = multi_layout(torch, serving_config(), device)
        srv_layout, server_seg = server_layout(torch, serving_config(), device)
        kernels = [check_flash(torch, device, multi_seg, server_seg), flash_bwd,
                   *check_fused_ce(torch, device, ce_case),
                   *check_int8(torch, device)]
        del attn_case, ce_case
        check_small_reference(torch, device)
        check_small_train_step(torch, device)
        serving = drive_main_path(torch, device, work, card)
        check_shared_step(torch, device, serving)
        batched = drive_batched_path(torch, device, serving, work, card)
        multi = drive_multi_path(torch, device, serving, layout, card)
        gc.collect()
        torch.cuda.empty_cache()
        paged = check_paged_step(torch, device, serving)
        continuous = drive_continuous_path(torch, device, serving, srv_layout,
                                           work, card)
        tts_stream = drive_stream_path(torch, device, serving, work, card)
        http_path = drive_http_path(torch, device, serving, tts_stream, card)
        gc.collect()
        torch.cuda.empty_cache()
        training = drive_training_path(
            torch, device, argv, card,
            (batch["x"].shape[0], batch["x"].shape[1], batch["y"].shape[1]))
        gc.collect()
        torch.cuda.empty_cache()
        streaming = drive_int8_probe(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        codec_train = dict(small=check_small_codec_step(torch, device),
                           **drive_codec_train_path(
                               torch, device, serving["inputs"]["codec"], work,
                               card))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for entry in kernels:
        entry["launches"] = {**training, **streaming}[entry["name"]]
    fwd = kernels[0]
    fwd["launches_by_path"] = {"serving": serving["launches"],
                               "batched": batched["launches"],
                               "multi": multi["launches"],
                               "continuous": continuous["launches"],
                               "stream": tts_stream["launches"],
                               "http": http_path["launches"],
                               "training": training[fwd["name"]]}
    fwd["paged_step"] = paged
    fwd["launches"] = sum(fwd["launches_by_path"].values())
    # the top-level numbers are the serving prefill's; every path's shape here
    fwd["by_shape"] = {
        "serving": {key: fwd[key] for key in (
            "shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")},
        "multi": fwd.pop("multi_prefill"),
        "server_prefill": fwd.pop("server_prefill"),
        "training": fwd_train}
    # the TPU package has two forward kernels (library flash and splash); one
    # Hopper kernel replaces both, so the report lists it once for each
    kernels.insert(1, {**fwd, "name": "flash_attention_fwd_splash",
                       "replaces": "ssr_speech_tpu/ops/flash_attention.py:103",
                       "same_kernel_as": fwd["name"]})
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"codec_train": codec_train}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
