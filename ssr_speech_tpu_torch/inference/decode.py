"""Autoregressive span-infilling decode for SSR-Speech (port of
``ssr_speech_tpu/inference/decode.py``).

``generate`` = ``_prefill_impl`` (the prompt through the LM, every layer's
attention on the hand-written flash kernel) followed by the ``_generate_impl``
loop: one-token decode steps with classifier-free guidance as [cond, uncond]
rows (``_mix_cfg``) and the constrained-sampling state machine of
``_advance_chains`` (eos/sos/mts ban, leading-empty forcing, EOG cascade,
silence-repetition penalty, length caps, multi-span sentinels).

``generate_batch`` decodes S sampling chains of one prompt and
``generate_multi`` S different prompts, each in one loop
(``_generate_shared_impl``) over a prompt cache that each CFG group's
chains share (``transformer_decode_step_shared``); every chain keeps only its
generated positions. The multi-prompt prefill (``_prefill_multi_impl``) runs
the flash kernel over rows with ragged text and prefix lengths, each with its
own segment ids.

JAX runs each loop as one compiled ``lax.while_loop`` over a telescoping
cache; here it is a host loop over a cache preallocated at its full size (the
same math: keys beyond the fill point are never attended). Frozen chains stay
frozen, so the host tests ``done`` only every ``DONE_CHECK_EVERY`` steps.
JAX clamps out-of-range gathers and drops out-of-range scatters where torch
raises (a device-side assert on CUDA), so every such index is clamped here
explicitly.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
    """Per-chain decode state ([S]-leading tensors). ``y_pos``, the audio
    position of the token fed this step, is a host integer on the single
    path and an [S] tensor on the device on the batched and multi-prompt
    paths (each multi-prompt chain has its own)."""

    y_pos: Union[int, torch.Tensor]
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


def _init_chain_state(y_pos0, sentinel_ids: torch.Tensor, S: int, K: int,
                      num_task: int, ts, cap_total: int) -> ChainState:
    dev = sentinel_ids.device
    i32 = dict(dtype=torch.int64, device=dev)
    return ChainState(
        y_pos=y_pos0 if isinstance(y_pos0, torch.Tensor) else int(y_pos0),
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
                       pe: torch.Tensor, y_pos, aug_text: bool,
                       dtype) -> torch.Tensor:
    """[S, K] token ids -> [S, D] summed codebook embedding + audio position
    (``y_pos`` an int or [S]; it clamps to the table, as JAX's gather and
    dynamic_slice do); under CFG the rows repeat for the uncond group:
    [2S, D]."""
    embs = params["audio_emb"]
    h = embs[0][tokens[:, 0]]
    for k in range(1, cfg.n_codebooks):
        h = h + embs[k][tokens[:, k]]
    if isinstance(y_pos, torch.Tensor):
        row = pe[y_pos.clamp(0, pe.shape[0] - 1)]
    else:
        row = pe[min(max(y_pos, 0), pe.shape[0] - 1)]
    h = h + params["audio_pos_alpha"][0] * row
    if aug_text:
        h = torch.cat([h, h], dim=0)
    return h.to(dtype)


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
                    dec: DecodeConfig, num_task: int, length_cap, n_tasks,
                    sentinel_ids: torch.Tensor, static_ban: torch.Tensor,
                    silence: torch.Tensor) -> ChainState:
    """One step of per-chain constrained-sampling bookkeeping on the
    CFG-mixed logits ``lg`` [S, K, card]. ``length_cap`` and ``n_tasks`` are
    ints or [S] tensors (multi-prompt chains each have their own), as
    ``s.y_pos`` is. ``s.out`` is updated in place; frozen (done) chains keep
    every field."""
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
        h = _embed_step_tokens(params, cfg, s.next_tokens, pe, s.y_pos,
                               aug_text, dtype)
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


@torch.no_grad()
def _generate_shared_impl(params, pfx: trf.KVCache, key_banned: torch.Tensor,
                          generator: torch.Generator,
                          sentinel_ids: torch.Tensor, y_pos0: torch.Tensor,
                          length_cap, n_tasks, *, cfg: SSRModelConfig,
                          dec: DecodeConfig, num_task: int, cap_total: int,
                          aug_text: bool, n_chains: int, dtype,
                          stats: Optional[Dict] = None):
    """The decode loop of S = ``n_chains`` chains over a shared prompt cache
    ``pfx`` [L, G, H, Tp, Dh] (the loop of JAX's ``_generate_batched_impl``
    and ``_generate_multi_impl``, which differ only in the arguments below).

    Rows are [cond_0..cond_{S-1} ; uncond_0..uncond_{S-1}] under CFG; the G
    groups of ``pfx`` split them group-major (G = 1 or 2 for S seeds of one
    prompt, G = rows for S prompts). ``y_pos0`` [S] is each chain's first
    audio position; ``length_cap`` and ``n_tasks`` are ints or [S]. Each
    chain's generated K/V go into a cache of ``_bucket(cap_total + 8, 128)``
    positions. Runs until every chain is done or ``cap_total`` tokens are
    out (JAX's loop conditions; the cache never fills first). Returns (out
    [S, K, CAP], span_end [S, num_task], out_len [S]) as tensors."""
    K = cfg.n_codebooks
    ts = cfg.tokens
    dev = pfx.k.device
    rows = n_chains * (2 if aug_text else 1)
    gen = trf.init_kv_cache(cfg, rows, _bucket(cap_total + 8, 128),
                            dtype=pfx.k.dtype, device=dev)
    pe = ssr_model.sine_table(cfg.max_position, cfg.d_model, device=dev)
    silence = torch.tensor(dec.silence_tokens, dtype=torch.int64, device=dev)
    static_ban = _static_ban(ts, dev)
    layers = trf.layer_params(params["decoder"])

    s = _init_chain_state(y_pos0, sentinel_ids, n_chains, K, num_task, ts,
                          cap_total)
    steps = 0
    while steps < cap_total:  # an active chain adds one token a step
        h = _embed_step_tokens(params, cfg, s.next_tokens, pe, s.y_pos,
                               aug_text, dtype)
        out_h, gen = trf.transformer_decode_step_shared(
            params["decoder"], h, pfx, gen, key_banned, cfg,
            n_groups=pfx.k.shape[1], dtype=dtype, layers=layers)
        logits = ssr_model.predict_logits(params, out_h)  # [B, K, card] fp32
        lg, num_cfg = _mix_cfg(logits, s, dec, n_chains, aug_text)
        s = _advance_chains(
            s, lg, generator, num_cfg, ts=ts, dec=dec, num_task=num_task,
            length_cap=length_cap, n_tasks=n_tasks, sentinel_ids=sentinel_ids,
            static_ban=static_ban, silence=silence)
        steps += 1
        if steps % DONE_CHECK_EVERY == 0 and bool(s.done.all()):
            break
    if stats is not None:
        stats["decode_steps"] = steps
    return s.out, s.span_end, s.out_len


def _generate_batched_impl(params, pfx, key_banned, generator, sentinel_ids,
                           x_len: int, y_pos0: int, *, cfg, dec, num_task,
                           cap_total, aug_text, n_samples, dtype, stats=None):
    """S independent sampling chains over one prompt: the chains share the
    audio position and the length cap (JAX ``_generate_batched_impl``)."""
    y_pos = torch.full((n_samples,), y_pos0, dtype=torch.int64,
                       device=pfx.k.device)
    return _generate_shared_impl(
        params, pfx, key_banned, generator, sentinel_ids, y_pos,
        x_len * dec.length_cap_mult, num_task, cfg=cfg, dec=dec,
        num_task=num_task, cap_total=cap_total, aug_text=aug_text,
        n_chains=n_samples, dtype=dtype, stats=stats)


def _generate_multi_impl(params, pfx, key_banned, generator, sentinel_ids,
                         x_lens: torch.Tensor, p_lens: torch.Tensor,
                         n_tasks: torch.Tensor, *, cfg, dec, num_task,
                         cap_total, aug_text, dtype, stats=None):
    """S different prompts, each its own group: per-chain audio positions
    ``p_lens`` [S], length caps ``x_lens * length_cap_mult`` [S] and span
    counts ``n_tasks`` [S] (<= num_task; a chain finishes after its own
    count while the others go on) (JAX ``_generate_multi_impl``)."""
    return _generate_shared_impl(
        params, pfx, key_banned, generator, sentinel_ids, p_lens,
        x_lens * dec.length_cap_mult, n_tasks, cfg=cfg, dec=dec,
        num_task=num_task, cap_total=cap_total, aug_text=aug_text,
        n_chains=p_lens.shape[0], dtype=dtype, stats=stats)


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


def _one_prompt(params, cfg: SSRModelConfig, dec: DecodeConfig, x, y,
                mask_intervals, generator: torch.Generator, uncond_x,
                prompt_x, prompt_y, where: str) -> dict:
    """The host side of a one-prompt request (``generate`` and
    ``generate_batch``): the aug_context prepend, the interleaved prefix,
    the padded text rows ([cond] or [cond; uncond]) and prefix, as device
    tensors."""
    ts = cfg.tokens
    K = cfg.n_codebooks
    dev = params["text_emb"].device
    x = np.asarray(x, np.int32)
    y = np.asarray(y, np.int32)
    x, y, mask_intervals, trim = _apply_aug_context(
        dec, x, y, mask_intervals, prompt_x, prompt_y)
    prefix, _, num_task, nm = patterns.build_inference_prefix(
        y, mask_intervals, ts)
    x_len = int(x.shape[0])
    p_len = int(prefix.shape[1])
    cap_total = dec.max_gen_per_span * num_task
    sx_pad = _bucket(max(x_len, 1), X_BUCKET)
    p_pad = _bucket(max(p_len, 1), PREFIX_BUCKET)
    gen_bound = p_len + min(cap_total,
                            max(x_len * dec.length_cap_mult - p_len, 0)
                            + num_task * (K + 2))
    _check_positions(cfg, max(sx_pad, p_pad), gen_bound, where)
    xb_padded, _ = build_text_rows(
        [x], sx_pad, cfg, dec, generator,
        uncond_xs=None if uncond_x is None else [uncond_x])
    prefix_padded = np.full((K, p_pad), ts.empty, np.int64)
    prefix_padded[:, :p_len] = prefix
    return dict(
        y=y, nm=nm, trim=trim, num_task=num_task, x_len=x_len, p_len=p_len,
        cap_total=cap_total, sx_pad=sx_pad, p_pad=p_pad,
        xb=torch.from_numpy(xb_padded).to(dev),
        prefix=torch.from_numpy(prefix_padded).to(dev),
        sentinels=torch.arange(ts.mts, ts.mts + ts.max_n_spans, device=dev))


def _prefill_then_decode(prefill, decode, dev: torch.device,
                         stats: Optional[Dict], prefill_tokens: int):
    """``decode(*prefill())`` -> (out, span_end) as numpy; ``stats``, when
    given, receives the prefill's and the decode's wall times (the prefill
    synchronised with the device), the prefill's padded length and the
    sampled token stream (``out_tokens``)."""
    t0 = time.perf_counter()
    cache, key_banned = prefill()
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        stats.update(prefill_s=t1 - t0, prefill_tokens=prefill_tokens)
    out, span_end, _ = decode(cache, key_banned)
    out = out.cpu().numpy().astype(np.int32)
    span_end = span_end.cpu().numpy()
    if stats is not None:
        stats.update(decode_s=time.perf_counter() - t1, out_tokens=out)
    return out, span_end


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
    given, receives prefill/decode wall times, the decode step count and the
    sampled token stream (``out_tokens`` [K, CAP])."""
    K = cfg.n_codebooks
    dev = params["text_emb"].device
    dtype = params["decoder"]["layers"]["qkv_w"].dtype
    p = _one_prompt(params, cfg, dec, x, y, mask_intervals, generator,
                    uncond_x, prompt_x, prompt_y, "generate")
    tmax = _bucket(p["sx_pad"] + p["p_pad"] + p["cap_total"] + p["num_task"]
                   + 8, TMAX_BUCKET)
    out, span_end = _prefill_then_decode(
        lambda: _prefill_impl(
            params, p["xb"], p["prefix"], p["x_len"], p["p_len"], cfg=cfg,
            tmax=tmax, dtype=dtype, cfg_pretrained=dec.cfg_pretrained,
            aug_text=dec.aug_text),
        lambda cache, key_banned: _generate_impl(
            params, cache, key_banned, generator, p["sentinels"], p["x_len"],
            p["p_len"], cfg=cfg, dec=dec, num_task=p["num_task"],
            cap_total=p["cap_total"], aug_text=dec.aug_text, dtype=dtype,
            stats=stats),
        dev, stats, p["sx_pad"] + p["p_pad"])
    return _trim_context(assemble_result(p["y"], p["nm"], out, span_end,
                                         p["num_task"], K), p["trim"])


def generate_batch(params, cfg: SSRModelConfig, dec: DecodeConfig,
                   x: np.ndarray, y: np.ndarray,
                   mask_intervals: Sequence[Tuple[int, int]],
                   generator: torch.Generator, n_samples: int, *,
                   uncond_x: Optional[np.ndarray] = None,
                   prompt_x: Optional[np.ndarray] = None,
                   prompt_y: Optional[np.ndarray] = None,
                   tmax: Optional[int] = None, stats: Optional[Dict] = None):
    """``n_samples`` independent sampling chains of one prompt in one loop,
    as ``ssr_speech_tpu.inference.decode.generate_batch``. The prompt cache
    holds only the prompt (``tmax`` slots, by default the prompt's length
    bucketed to 256) and is shared by the chains of each CFG group. Returns a
    list of per-chain (codes, marks, out_intervals, nm_intervals), the
    contract of :func:`generate`, aug_context included; ``stats`` as there
    (``out_tokens`` [S, K, CAP])."""
    K = cfg.n_codebooks
    dev = params["text_emb"].device
    dtype = params["decoder"]["layers"]["qkv_w"].dtype
    p = _one_prompt(params, cfg, dec, x, y, mask_intervals, generator,
                    uncond_x, prompt_x, prompt_y, "generate_batch")
    if tmax is None:
        tmax = _bucket(p["sx_pad"] + p["p_pad"] + 8, 256)
    out, span_end = _prefill_then_decode(
        lambda: _prefill_impl(
            params, p["xb"], p["prefix"], p["x_len"], p["p_len"], cfg=cfg,
            tmax=tmax, dtype=dtype, cfg_pretrained=dec.cfg_pretrained,
            aug_text=dec.aug_text),
        lambda pfx, key_banned: _generate_batched_impl(
            params, pfx, key_banned, generator, p["sentinels"], p["x_len"],
            p["p_len"], cfg=cfg, dec=dec, num_task=p["num_task"],
            cap_total=p["cap_total"], aug_text=dec.aug_text,
            n_samples=n_samples, dtype=dtype, stats=stats),
        dev, stats, p["sx_pad"] + p["p_pad"])
    return [_trim_context(assemble_result(p["y"], p["nm"], out[i],
                                          span_end[i], p["num_task"], K),
                          p["trim"]) for i in range(n_samples)]


def multi_dead_keys(x_lens: torch.Tensor, p_lens: torch.Tensor, sx: int,
                    P: int, *, aug_text: bool,
                    cfg_pretrained: bool) -> torch.Tensor:
    """Keys of the multi-prompt prefill that no query attends, [R, sx + P]
    bool for R = len(x_lens) rows: each row's text padding [x_len_r, sx),
    its prefix tail [sx + p_len_r, sx + P) and, on CFG-pretrained uncond
    rows, the prompt [1, sx). ``p_lens`` [S] is per prompt; under CFG the
    uncond rows [S, 2S) take their prompt's. JAX ``_prefill_multi_impl``'s
    ``dead``."""
    R = x_lens.shape[0]
    S = p_lens.shape[0]
    idx = torch.arange(sx + P, device=x_lens.device)[None, :]
    p_lens_r = torch.cat([p_lens, p_lens]) if aug_text else p_lens
    dead = ((idx >= x_lens[:, None]) & (idx < sx)) | (
        idx >= sx + p_lens_r[:, None])
    if aug_text and cfg_pretrained:
        uncond = torch.arange(R, device=x_lens.device) >= S
        dead = dead | (uncond[:, None] & (idx >= 1) & (idx < sx))
    return dead


@torch.no_grad()
def _prefill_multi_impl(params, x: torch.Tensor, y_prefix: torch.Tensor,
                        x_lens: torch.Tensor, p_lens: torch.Tensor, *,
                        cfg: SSRModelConfig, tmax: int, dtype,
                        cfg_pretrained: bool = False, aug_text: bool = False):
    """Prefill for different prompts in one batch.

    x: [R, Sx_pad] rows [cond_0..cond_{S-1} ; uncond_0..] with true lengths
    ``x_lens`` [R]; y_prefix: [S, K, P_pad] per-prompt prefixes with true
    lengths ``p_lens`` [S]. Every layer's attention is the flash kernel with
    a segment id a row and key: 0 on the row's dead keys
    (:func:`multi_dead_keys`), 1 elsewhere, which is the JAX mask on every
    query the decode reads. Returns (cache with length sx + P, key_banned
    [R, tmax] bool: the dead keys, and every slot from sx + P on)."""
    R, sx = x.shape
    S, K, P = y_prefix.shape
    dev = x.device
    pe = ssr_model.sine_table(cfg.max_position, cfg.d_model, device=dev)
    x_h = ssr_model.embed_text(params, cfg, x, pe)
    y_tok = y_prefix.transpose(1, 2)  # [S, P, K]
    if aug_text:  # uncond rows reuse their prompt's audio prefix
        y_tok = torch.cat([y_tok, y_tok], dim=0)
    y_h = ssr_model.embed_audio_tokens(params, cfg, y_tok)
    y_h = ssr_model.apply_audio_pos(params, y_h, pe, 0)
    h = torch.cat([x_h, y_h], dim=1).to(dtype)

    dead = multi_dead_keys(x_lens, p_lens, sx, P, aug_text=aug_text,
                           cfg_pretrained=cfg_pretrained)
    cache = trf.init_kv_cache(cfg, R, tmax, dtype=dtype, device=dev)
    _, cache = trf.transformer_prefill(params["decoder"], h, cache, cfg,
                                       key_valid=(~dead).to(torch.int32),
                                       dtype=dtype)
    key_banned = torch.ones((R, tmax), dtype=torch.bool, device=dev)
    key_banned[:, :sx + P] = dead
    return cache, key_banned


def generate_multi(params, cfg: SSRModelConfig, dec: DecodeConfig, prompts,
                   generator: torch.Generator, *,
                   stats: Optional[Dict] = None):
    """Decode several different utterances in one loop, as
    ``ssr_speech_tpu.inference.decode.generate_multi``. Each prompt is
    ``(x, y, mask)`` or ``(x, y, mask, prompt_x, prompt_y)`` (the 5-tuple
    turns on the aug_context prepend, as in :func:`generate`); prompts may
    differ in span count, and a chain finishes after its own. Returns a list
    of per-prompt (codes, marks, out_intervals, nm_intervals). ``stats`` as
    in :func:`generate`, plus the prefill's layout (``x_lens`` [R],
    ``p_lens`` [S], ``sx_pad``, ``p_pad``)."""
    ts = cfg.tokens
    K = cfg.n_codebooks
    S = len(prompts)
    dev = params["text_emb"].device
    dtype = params["decoder"]["layers"]["qkv_w"].dtype
    built = []
    for p in prompts:
        (x, y, mask), ctx = p[:3], p[3:]
        x = np.asarray(x, np.int32)
        y = np.asarray(y, np.int32)
        x, y, mask, trim = _apply_aug_context(
            dec, x, y, mask, *(ctx if len(ctx) == 2 else (None, None)))
        prefix, _, num_task, nm = patterns.build_inference_prefix(
            y, list(mask), ts)
        built.append((x, y, prefix, num_task, nm, trim))
    n_tasks = np.asarray([b[3] for b in built], np.int64)
    num_task = int(n_tasks.max())
    sentinels = torch.arange(ts.mts, ts.mts + ts.max_n_spans, device=dev)

    sx_pad = _bucket(max(max(len(b[0]) for b in built), 1), X_BUCKET)
    p_pad = _bucket(max(max(b[2].shape[1] for b in built), 1), PREFIX_BUCKET)
    cap_total = dec.max_gen_per_span * num_task
    gen_bound = max(
        b[2].shape[1] + min(cap_total,
                            max(len(b[0]) * dec.length_cap_mult
                                - b[2].shape[1], 0) + num_task * (K + 2))
        for b in built)
    _check_positions(cfg, max(sx_pad, p_pad), gen_bound, "generate_multi")

    prefixes = np.full((S, K, p_pad), ts.empty, np.int64)
    p_lens = np.zeros(S, np.int64)
    for i, b in enumerate(built):
        prefixes[i, :, : b[2].shape[1]] = b[2]
        p_lens[i] = b[2].shape[1]
    xb, x_lens_r = build_text_rows([b[0] for b in built], sx_pad, cfg, dec,
                                   generator)
    x_lens_r = torch.from_numpy(x_lens_r).to(dev)
    p_lens_t = torch.from_numpy(p_lens).to(dev)

    tmax = _bucket(sx_pad + p_pad + 8, 256)
    if stats is not None:
        stats.update(sx_pad=sx_pad, p_pad=p_pad, x_lens=x_lens_r.tolist(),
                     p_lens=p_lens.tolist())
    out, span_end = _prefill_then_decode(
        lambda: _prefill_multi_impl(
            params, torch.from_numpy(xb).to(dev),
            torch.from_numpy(prefixes).to(dev), x_lens_r, p_lens_t, cfg=cfg,
            tmax=tmax, dtype=dtype, cfg_pretrained=dec.cfg_pretrained,
            aug_text=dec.aug_text),
        lambda pfx, key_banned: _generate_multi_impl(
            params, pfx, key_banned, generator, sentinels, x_lens_r[:S],
            p_lens_t, torch.from_numpy(n_tasks).to(dev), cfg=cfg, dec=dec,
            num_task=num_task, cap_total=cap_total, aug_text=dec.aug_text,
            dtype=dtype, stats=stats),
        dev, stats, sx_pad + p_pad)
    return [_trim_context(assemble_result(y, nm, out[i], span_end[i], ntask, K),
                          trim)
            for i, (_, y, _, ntask, nm, trim) in enumerate(built)]


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
