"""Autoregressive span-infilling decode for SSR-Speech (port of the
single-sample path of ``ssr_speech_tpu/inference/decode.py``).

``generate`` = ``_prefill_impl`` (the prompt through the LM, every layer's
attention on the hand-written flash kernel) followed by the ``_generate_impl``
loop: one-token decode steps with classifier-free guidance as [cond, uncond]
rows (``_mix_cfg``) and the constrained-sampling state machine of
``_advance_chains`` (eos/sos/mts ban, leading-empty forcing, EOG cascade,
silence-repetition penalty, length caps, multi-span sentinels).

JAX runs the loop as one compiled ``lax.while_loop`` over a telescoping cache;
here it is a host loop over a cache preallocated at its full size (the same
math: keys beyond the fill point are never attended). Frozen chains stay
frozen, so the host tests ``done`` only every ``DONE_CHECK_EVERY`` steps.
JAX clamps out-of-range gathers and drops out-of-range scatters where torch
raises (a device-side assert on CUDA), so every such index is clamped here
explicitly. Batched and multi-prompt decoding are not ported yet.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DecodeConfig, SSRModelConfig
from ..ops import patterns

from ..models import ssr as ssr_model
from ..models import transformer as trf
from ..ops.sampling import categorical, top_k_top_p_filter

NEG = -10000.0
POS = 10000.0
DONE_CHECK_EVERY = 8  # host syncs on `done` once per this many steps
# the prefill's text block, prefix block and cache are padded to these
# multiples, as the JAX package pads them; the padding is banned (text) or
# overwritten by the decode (prefix, cache) and never changes the output
X_BUCKET = 64
PREFIX_BUCKET = 128
TMAX_BUCKET = 512

logger = logging.getLogger(__name__)


def _bucket(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass
class ChainState:
    """Per-chain decode state ([S]-leading tensors; S = 1 here). ``y_pos``,
    the audio position shared by all chains, is a host integer."""

    y_pos: int
    next_tokens: torch.Tensor  # [S, K] token to feed this step
    out: torch.Tensor  # [S, K, CAP] sampled tokens, spans concatenated
    out_len: torch.Tensor  # [S]
    span_idx: torch.Tensor  # [S]
    span_end: torch.Tensor  # [S, num_task] out_len after each span
    num_gen: torch.Tensor
    num_eog: torch.Tensor
    prev_token: torch.Tensor
    consec_silence: torch.Tensor
    num_cfg: torch.Tensor
    done: torch.Tensor  # [S] bool


def _static_ban(ts, device) -> torch.Tensor:
    """eos/sos/all-mask-sentinel column ban [1, 1, card]."""
    cols = torch.arange(ts.cardinality, device=device)[None, None, :]
    return (cols == ts.eos) | (cols == ts.sos) | (
        (cols >= ts.mts) & (cols < ts.mts + ts.max_n_spans))


def _init_chain_state(y_pos0: int, sentinel_ids: torch.Tensor, S: int, K: int,
                      num_task: int, ts, cap_total: int) -> ChainState:
    dev = sentinel_ids.device
    i32 = dict(dtype=torch.int64, device=dev)
    return ChainState(
        y_pos=int(y_pos0),
        next_tokens=sentinel_ids[0].expand(S, K).clone(),
        out=torch.full((S, K, cap_total), ts.empty, **i32),
        out_len=torch.zeros(S, **i32),
        span_idx=torch.zeros(S, **i32),
        span_end=torch.zeros((S, num_task), **i32),
        num_gen=torch.zeros(S, **i32),
        num_eog=torch.zeros(S, **i32),
        prev_token=torch.full((S,), -1, **i32),
        consec_silence=torch.zeros(S, **i32),
        num_cfg=torch.ones(S, **i32),
        done=torch.zeros(S, dtype=torch.bool, device=dev))


def _embed_step_tokens(params, cfg: SSRModelConfig, tokens: torch.Tensor,
                       pe: torch.Tensor, y_pos: int, batch: int,
                       dtype) -> torch.Tensor:
    """[K] token ids -> [B, D] summed codebook embedding + audio position
    (the position clamps to the table, as JAX's dynamic_slice)."""
    embs = params["audio_emb"]
    h = embs[0][tokens[0]]
    for k in range(1, cfg.n_codebooks):
        h = h + embs[k][tokens[k]]
    row = min(max(y_pos, 0), pe.shape[0] - 1)
    h = h + params["audio_pos_alpha"][0] * pe[row]
    return h.expand(batch, cfg.d_model).to(dtype)


def _mix_cfg(logits, s: ChainState, dec: DecodeConfig, S: int, aug_text: bool):
    """CFG stride mix over [cond; uncond] rows. Returns (mixed logits
    [S, K, card], interim per-chain stride counter)."""
    if not aug_text:
        return logits, s.num_cfg
    cond_l, uncond_l = logits[:S], logits[S:]
    do_mix = (s.num_cfg == dec.cfg_stride)[:, None, None]
    lg = torch.where(do_mix, dec.cfg_coef * cond_l
                     + (1.0 - dec.cfg_coef) * uncond_l, cond_l)
    num_cfg = torch.where(s.num_cfg == dec.cfg_stride,
                          torch.ones_like(s.num_cfg), s.num_cfg + 1)
    return lg, num_cfg


def _advance_chains(s: ChainState, lg: torch.Tensor,
                    generator: torch.Generator, num_cfg: torch.Tensor, *, ts,
                    dec: DecodeConfig, num_task: int, length_cap: int,
                    n_tasks: int, sentinel_ids: torch.Tensor,
                    static_ban: torch.Tensor, silence: torch.Tensor) -> ChainState:
    """One step of per-chain constrained-sampling bookkeeping on the
    CFG-mixed logits ``lg`` [S, K, card]. ``s.out`` is updated in place;
    frozen (done) chains keep every field."""
    S, K, card = lg.shape
    dev = lg.device
    rows = torch.arange(K, device=dev)[None, :, None]
    cols = torch.arange(card, device=dev)[None, None, :]
    srow = torch.arange(S, device=dev)

    lg = lg.masked_fill(static_ban, NEG)
    lg = lg.masked_fill((rows > s.num_gen[:, None, None]) & (cols == ts.empty),
                        POS)
    in_cascade = (s.num_eog > 0)[:, None, None]
    casc_ban = in_cascade & (rows > s.num_eog[:, None, None]) & (
        (cols == ts.eog) | (cols == ts.empty))
    noeog_ban = (~in_cascade) & (rows >= 1) & (cols == ts.eog)
    lg = lg.masked_fill(casc_ban | noeog_ban, NEG)
    if dec.stop_repetition > 0:
        is_sil_prev = (silence[None, :] == s.prev_token[:, None]).any(dim=1)
        apply_pen = (s.num_eog == 0) & is_sil_prev & (
            s.consec_silence > dec.stop_repetition)
        factor = (s.consec_silence - (dec.stop_repetition - 1)).float()
        prev_ix = s.prev_token.clamp(0, card - 1)  # prev_token starts at -1
        prev_logit = lg[srow, 0, prev_ix]
        pen = torch.where(prev_logit < 0, prev_logit * factor,
                          prev_logit / factor)
        lg[srow, 0, prev_ix] = torch.where(apply_pen, pen, prev_logit)

    lgt = lg / dec.temperature if dec.temperature != 1.0 else lg
    lgt = top_k_top_p_filter(lgt, top_k=dec.top_k, top_p=dec.top_p)
    samples = categorical(generator, lgt)  # [S, K]

    row_ids = torch.arange(K, device=dev)[None, :]
    empty = torch.full_like(samples, ts.empty)
    eog = torch.full_like(samples, ts.eog)
    casc_samples = torch.where(row_ids < s.num_eog[:, None], empty, samples)
    casc_samples = torch.where(row_ids == s.num_eog[:, None], eog, casc_samples)
    too_long = (s.y_pos + 1) > length_cap
    span_cap = s.num_gen >= (dec.max_gen_per_span - K)
    argmax0 = torch.argmax(lg[:, 0], dim=-1)
    trigger = ((samples[:, 0] == ts.eog) | (argmax0 == ts.eog) | span_cap
               | too_long)
    plain = samples.clone()
    plain[:, 0] = torch.where(trigger, eog[:, 0], samples[:, 0])
    in_c1 = s.num_eog > 0
    new_samples = torch.where(in_c1[:, None], casc_samples, plain)
    num_eog = torch.where(in_c1, s.num_eog + 1,
                          trigger.long())
    s0 = plain[:, 0]
    is_sil = (silence[None, :] == s0[:, None]).any(dim=1) & (s0 == s.prev_token)
    consec = torch.where(in_c1, s.consec_silence,
                         torch.where(is_sil, s.consec_silence + 1,
                                     torch.zeros_like(s.consec_silence)))
    prev = torch.where(in_c1, s.prev_token, s0)

    active = ~s.done
    cap = s.out.shape[2]
    # a frozen chain may sit at out_len == cap: JAX drops that write, here the
    # column is clamped and the (unchanged) current value written back
    col = s.out_len.clamp(max=cap - 1)
    krow = torch.arange(K, device=dev)[None, :]
    cur = s.out[srow[:, None], krow, col[:, None]]
    s.out[srow[:, None], krow, col[:, None]] = torch.where(
        active[:, None], new_samples, cur)
    out_len = torch.where(active, s.out_len + 1, s.out_len)
    num_gen = torch.where(active, s.num_gen + 1, s.num_gen)

    span_done = active & (num_eog == K)
    task_ids = torch.arange(num_task, device=dev)[None, :]
    span_end = torch.where(span_done[:, None] & (task_ids == s.span_idx[:, None]),
                           out_len[:, None], s.span_end)
    span_idx = torch.where(span_done, s.span_idx + 1, s.span_idx)
    done = s.done | (span_done & (span_idx >= n_tasks))
    next_sent = sentinel_ids[span_idx.clamp(max=num_task - 1)]
    next_tokens = torch.where(span_done[:, None],
                              next_sent[:, None].expand(S, K), new_samples)
    zero = torch.zeros_like(num_gen)
    num_gen = torch.where(span_done, zero, num_gen)
    num_eog = torch.where(span_done, zero, num_eog)
    num_eog = torch.where(s.done, s.num_eog, num_eog)
    prev = torch.where(span_done, torch.full_like(prev, -1),
                       torch.where(s.done, s.prev_token, prev))
    consec = torch.where(span_done, zero,
                         torch.where(s.done, s.consec_silence, consec))
    num_cfg = torch.where(span_done, torch.ones_like(num_cfg),
                          torch.where(s.done, s.num_cfg, num_cfg))
    next_tokens = torch.where(s.done[:, None], s.next_tokens, next_tokens)
    return ChainState(
        y_pos=s.y_pos + 1, next_tokens=next_tokens, out=s.out, out_len=out_len,
        span_idx=span_idx, span_end=span_end, num_gen=num_gen,
        num_eog=num_eog, prev_token=prev, consec_silence=consec,
        num_cfg=num_cfg, done=done)


@torch.no_grad()
def _generate_impl(params, cache: trf.KVCache, key_banned: torch.Tensor,
                   generator: torch.Generator, sentinel_ids: torch.Tensor,
                   x_len: int, y_pos0: int, *, cfg: SSRModelConfig,
                   dec: DecodeConfig, num_task: int, cap_total: int,
                   aug_text: bool, dtype, stats: Optional[Dict] = None):
    """The decode loop. Runs until the chain is done, ``cap_total`` tokens
    are out, or the cache is full (JAX's loop conditions). Returns
    (out [K, CAP], span_end [num_task], out_len) as tensors."""
    K = cfg.n_codebooks
    ts = cfg.tokens
    batch = cache.k.shape[1]
    dev = cache.k.device
    pe = ssr_model.sine_table(cfg.max_position, cfg.d_model, device=dev)
    silence = torch.tensor(dec.silence_tokens, dtype=torch.int64, device=dev)
    length_cap = x_len * dec.length_cap_mult
    static_ban = _static_ban(ts, dev)
    layers = trf.layer_params(params["decoder"])

    s = _init_chain_state(y_pos0, sentinel_ids, 1, K, num_task, ts, cap_total)
    # before `done`, one active chain adds one token per step, so JAX's
    # `max(out_len) < cap_total` and `cache.length < size` bound the steps
    max_steps = min(cap_total, cache.max_len - cache.length)
    steps = 0
    while steps < max_steps:
        h = _embed_step_tokens(params, cfg, s.next_tokens[0], pe, s.y_pos,
                               batch, dtype)
        out_h, cache = trf.transformer_decode_step(
            params["decoder"], h, cache, key_banned, cfg, dtype=dtype,
            layers=layers)
        logits = ssr_model.predict_logits(params, out_h)  # [B, K, card] fp32
        lg, num_cfg = _mix_cfg(logits, s, dec, 1, aug_text)
        s = _advance_chains(
            s, lg, generator, num_cfg, ts=ts, dec=dec, num_task=num_task,
            length_cap=length_cap, n_tasks=num_task, sentinel_ids=sentinel_ids,
            static_ban=static_ban, silence=silence)
        steps += 1
        if steps % DONE_CHECK_EVERY == 0 and bool(s.done.all()):
            break
    if stats is not None:
        stats["decode_steps"] = steps
    return s.out[0], s.span_end[0], s.out_len[0]


def _check_positions(cfg: SSRModelConfig, prefill_need: int, gen_max: int,
                     where: str):
    """Positional-table capacity: the prefill must fit the table (hard
    error); generation clips to the last row (warning)."""
    if prefill_need > cfg.max_position:
        raise ValueError(
            f"{where}: prompt needs {prefill_need} positions > "
            f"cfg.max_position={cfg.max_position}; raise max_position or "
            f"shorten the input (aug_context doubles audio+text lengths)")
    if gen_max > cfg.max_position:
        logger.warning(
            "%s: generation may reach position %d > max_position=%d; "
            "positions clip to the last sine row beyond that", where, gen_max,
            cfg.max_position)


def build_text_rows(xs, sx_pad: int, cfg: SSRModelConfig, dec: DecodeConfig,
                    generator: torch.Generator, uncond_xs=None):
    """Pad conditional text rows and, under CFG, append the uncond rows:
    explicit ``uncond_xs``, the reserved token over each row's length
    (cfg_pretrained), or random text from ``generator`` (a different stream
    from JAX's). Returns (xb [R, sx_pad], x_lens [R]) as numpy."""
    S = len(xs)
    x_rows = np.full((S, sx_pad), cfg.text_pad_token, np.int64)
    x_lens = np.zeros(S, np.int64)
    for i, x in enumerate(xs):
        x_rows[i, : len(x)] = x
        x_lens[i] = len(x)
    if not dec.aug_text:
        return x_rows, x_lens
    if uncond_xs is not None:
        uncond = np.full((S, sx_pad), cfg.text_pad_token, np.int64)
        for i, u in enumerate(uncond_xs):
            uncond[i, : len(u)] = u
    elif dec.cfg_pretrained:
        uncond = np.full((S, sx_pad), cfg.text_pad_token, np.int64)
        for i in range(S):
            uncond[i, : x_lens[i]] = cfg.text_vocab_size - 1
    else:
        # range INCLUDES the pad id, as the reference's randint
        uncond = torch.randint(0, cfg.n_text_tokens, (S, sx_pad),
                               generator=generator,
                               device=generator.device).cpu().numpy()
    return (np.concatenate([x_rows, uncond], axis=0),
            np.concatenate([x_lens, x_lens]))


def _apply_aug_context(dec: DecodeConfig, x, y, mask_intervals, prompt_x,
                       prompt_y):
    """aug_context prepend: with the flag set, masked content under 2 s and a
    prompt given, prepend the prompt audio+text. Returns (x, y,
    mask_intervals, trim_frames)."""
    mask_intervals = list(mask_intervals)
    context_len = sum(e - s for s, e in mask_intervals)
    if not (dec.aug_context and context_len < 2 * dec.codec_sr):
        return x, y, mask_intervals, 0
    if prompt_x is None or prompt_y is None or not np.asarray(prompt_x).size:
        return x, y, mask_intervals, 0
    prompt_y = np.asarray(prompt_y, np.int32)
    trim = prompt_y.shape[1]
    y = np.concatenate([prompt_y, y], axis=1)
    x = np.concatenate([np.asarray(prompt_x, np.int32), x])
    mask_intervals = [(s + trim, e + trim) for s, e in mask_intervals]
    return x, y, mask_intervals, trim


def _trim_context(result, trim: int):
    """Drop the prepended aug_context frames from an assembled result."""
    if not trim:
        return result
    codes, marks, out_iv, nm = result
    return (codes[:, :, trim:], marks[:, trim:],
            [(s - trim, e - trim) for s, e in out_iv],
            [(s - trim, e - trim) for s, e in nm])


@torch.no_grad()
def _prefill_impl(params, x: torch.Tensor, y_prefix: torch.Tensor, x_len: int,
                  p_len: int, *, cfg: SSRModelConfig, tmax: int, dtype,
                  cfg_pretrained: bool = False, aug_text: bool = False,
                  uncond_row_start: int = 1):
    """Fill a KV cache of ``tmax`` slots with [x ; y_prefix].

    x: [B, Sx_pad] text ids; y_prefix: [K, P_pad] prefix tokens. Keys banned
    for the whole decode: text padding [x_len, sx) and, for cfg_pretrained
    unconditional rows [uncond_row_start, B), the prompt [1, sx). The
    prefill attention takes them as segment ids (0 = banned), which gives
    the JAX mask on every row whose output is read; only hidden states and
    cache entries at banned positions differ, and nothing reads those.
    Returns (cache with length sx + p_len, key_banned [B, 2])."""
    B, sx = x.shape
    P = y_prefix.shape[1]
    dev = x.device
    pe = ssr_model.sine_table(cfg.max_position, cfg.d_model, device=dev)
    x_h = ssr_model.embed_text(params, cfg, x, pe)
    y_tok = y_prefix.T[None].expand(B, P, cfg.n_codebooks)
    y_h = ssr_model.embed_audio_tokens(params, cfg, y_tok)
    y_h = ssr_model.apply_audio_pos(params, y_h, pe, 0)
    h = torch.cat([x_h, y_h], dim=1).to(dtype)

    seg = torch.ones((B, sx + P), dtype=torch.int32, device=dev)
    seg[:, x_len:sx] = 0
    lo = torch.full((B,), x_len, dtype=torch.int64, device=dev)
    hi = torch.full((B,), sx, dtype=torch.int64, device=dev)
    if aug_text and cfg_pretrained and uncond_row_start >= 0:
        # CFG-pretrained uncond rows see only their first text token
        seg[uncond_row_start:, 1:sx] = 0
        lo[uncond_row_start:] = 1
    key_banned = torch.stack([lo, hi], dim=1)

    cache = trf.init_kv_cache(cfg, B, tmax, dtype=dtype, device=dev)
    _, cache = trf.transformer_prefill(params["decoder"], h, cache, cfg,
                                       key_valid=seg, dtype=dtype)
    # true fill point: the padded text block stays (banned), the prefix is
    # valid up to p_len; decode steps overwrite the padded prefix tail
    return replace(cache, length=sx + p_len), key_banned


def generate(params, cfg: SSRModelConfig, dec: DecodeConfig, x: np.ndarray,
             y: np.ndarray, mask_intervals: Sequence[Tuple[int, int]],
             generator: torch.Generator, *, uncond_x: Optional[np.ndarray] = None,
             prompt_x: Optional[np.ndarray] = None,
             prompt_y: Optional[np.ndarray] = None,
             stats: Optional[Dict] = None
             ) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]],
                        List[Tuple[int, int]]]:
    """Span-infilling generation for one sample on ``params``' device.

    x: [Sx] phoneme ids; y: [K, T] codec tokens of the source audio. Returns
    (codes [1, K, T'], marks [1, T'], out_intervals, nm_intervals), as
    ``ssr_speech_tpu.inference.decode.generate``. Activations take the dtype
    of the decoder's matmul weights (``lm_from_jax`` stores them in the
    device's compute dtype: fp32 on the CPU, bf16 on CUDA). ``stats``, when
    given, receives prefill/decode wall times and the decode step count."""
    ts = cfg.tokens
    K = cfg.n_codebooks
    dev = params["text_emb"].device
    dtype = params["decoder"]["layers"]["qkv_w"].dtype
    x = np.asarray(x, np.int32)
    y = np.asarray(y, np.int32)
    x, y, mask_intervals, trim = _apply_aug_context(
        dec, x, y, mask_intervals, prompt_x, prompt_y)
    prefix, _, num_task, nm = patterns.build_inference_prefix(
        y, mask_intervals, ts)
    sentinels = torch.arange(ts.mts, ts.mts + ts.max_n_spans, device=dev)

    x_len = int(x.shape[0])
    p_len = int(prefix.shape[1])
    cap_total = dec.max_gen_per_span * num_task
    sx_pad = _bucket(max(x_len, 1), X_BUCKET)
    p_pad = _bucket(max(p_len, 1), PREFIX_BUCKET)
    gen_bound = p_len + min(cap_total,
                            max(x_len * dec.length_cap_mult - p_len, 0)
                            + num_task * (K + 2))
    _check_positions(cfg, max(sx_pad, p_pad), gen_bound, "generate")
    xb_padded, _ = build_text_rows(
        [x], sx_pad, cfg, dec, generator,
        uncond_xs=None if uncond_x is None else [uncond_x])
    prefix_padded = np.full((K, p_pad), ts.empty, np.int64)
    prefix_padded[:, :p_len] = prefix
    tmax = _bucket(sx_pad + p_pad + cap_total + num_task + 8, TMAX_BUCKET)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    cache, key_banned = _prefill_impl(
        params, torch.from_numpy(xb_padded).to(dev),
        torch.from_numpy(prefix_padded).to(dev), x_len, p_len, cfg=cfg,
        tmax=tmax, dtype=dtype, cfg_pretrained=dec.cfg_pretrained,
        aug_text=dec.aug_text)
    if stats is not None:
        sync()
        t1 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
        stats["prefill_tokens"] = sx_pad + p_pad
    out, span_end, _ = _generate_impl(
        params, cache, key_banned, generator, sentinels, x_len, p_len,
        cfg=cfg, dec=dec, num_task=num_task, cap_total=cap_total,
        aug_text=dec.aug_text, dtype=dtype, stats=stats)
    out = out.cpu().numpy().astype(np.int32)
    span_end = span_end.cpu().numpy()
    if stats is not None:
        stats["decode_s"] = time.perf_counter() - t1
    return _trim_context(assemble_result(y, nm, out, span_end, num_task, K),
                         trim)


def assemble_result(y, nm, out_row, span_end_row, ntask, K):
    """Host post-processing for one decoded prompt: split the span stream at
    ``span_end_row``, revert the delay pattern, strip EOG and splice into the
    source codes (``ssr_speech_tpu.ops.patterns``)."""
    gen_spans = []
    start = 0
    for t in range(ntask):
        end = max(int(span_end_row[t]), start)
        span = out_row[:, start:end]
        start = end
        if span.shape[1] >= K:
            gen_spans.append(patterns.revert_delay_pattern(span)[:, :-1])
        else:
            gen_spans.append(np.zeros((K, 0), np.int32))
    codes, marks, out_iv = patterns.splice_generated(y, nm, gen_spans,
                                                     y.shape[1])
    return codes, marks, out_iv, nm
