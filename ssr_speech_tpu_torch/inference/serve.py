"""Request scheduling and continuous-batching serving for the SSR LM (port of
``ssr_speech_tpu/inference/serve.py``).

The static multi-prompt loop (:func:`decode.generate_multi`) holds every slot
until the last chain of the batch finishes. :class:`ContinuousBatcher` keeps
the decode loop full instead:

- a chunk decodes S slots and returns as soon as any live chain finishes
  (or a step budget runs out);
- the host harvests finished slots, prefills the next queued request and
  splices it into the same state (prefix-cache rows, per-slot bookkeeping)
  without touching the other chains;
- the generated-KV cache has a write column per row
  (:func:`models.transformer.transformer_decode_step_paged`): a refilled
  slot restarts at column 0 of its own row, so cache memory is bounded per
  request. Column indices carry no positional meaning (the sine position is
  added at embed time from the chain's own ``y_pos``), which is what makes
  row reuse sound.

JAX runs the chunk as one compiled ``lax.while_loop``; here it is a host
loop over the same body that reads one device flag a step: the loop's stop
test (any harvestable slot, no live chain left), so a chunk stops at the
same step as JAX's and ``steps`` counts what JAX's counter counts. The
splice is a set of in-place index writes on the device. Under greedy
sampling, served outputs equal :func:`decode.generate`'s
(``tests/test_torch_serving.py``).

:func:`sorted_static_batches` is the static scheduler ``pipeline.
inference_multi`` uses to batch more jobs than it has slots.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DecodeConfig, SSRModelConfig
from ..models import ssr as ssr_model
from ..models import transformer as trf
from ..ops import patterns
from . import decode as dec_mod


@dataclass
class ServeState(dec_mod.ChainState):
    """Per-slot chain state ([S] tensors, ``y_pos`` among them) plus the
    paged cache's write columns and the slots' occupancy."""

    cache: trf.KVCache  # generated K/V [L, R, H, G, Dh], a column per row
    gen_len: torch.Tensor  # [R] write column of each row
    active: torch.Tensor  # [S] slot holds a live (unharvested) request
    steps: int  # steps taken in this chunk (the admission budget)


def _chain_fields(s: dec_mod.ChainState) -> Dict:
    return {f.name: getattr(s, f.name)
            for f in dataclasses.fields(dec_mod.ChainState)}


@torch.no_grad()
def _serve_chunk_impl(params, pfx: trf.KVCache, key_banned: torch.Tensor,
                      state: ServeState, x_lens: torch.Tensor,
                      n_tasks: torch.Tensor, sentinel_ids: torch.Tensor,
                      step_budget: int, generator: torch.Generator, *,
                      cfg: SSRModelConfig, dec: DecodeConfig, num_task: int,
                      aug_text: bool, n_slots: int, dtype, read_len,
                      layers=None) -> ServeState:
    """Decode until any live chain finishes, ``step_budget`` steps are taken,
    or no live chain is left (JAX ``_serve_chunk_impl``'s loop condition,
    tested before every step). The body: the embedded tokens, the paged
    step, the heads, the CFG mix, ``_advance_chains`` and ``gen_len + 1`` on
    the rows of live chains (cond and uncond); parked slots
    (``active=False``) ride along frozen. ``read_len`` [S] holds, per slot,
    an upper bound on its rows' ``gen_len`` (steps since its fill), kept on
    the host and advanced here; the step reads the generated cache up to
    their max."""
    S = n_slots
    dev = pfx.k.device
    ts = cfg.tokens
    pe = ssr_model.sine_table(cfg.max_position, cfg.d_model, device=dev)
    silence = torch.tensor(dec.silence_tokens, dtype=torch.int64, device=dev)
    length_cap = x_lens * dec.length_cap_mult
    static_ban = dec_mod._static_ban(ts, dev)
    layers = layers or trf.layer_params(params["decoder"])
    s = state
    while s.steps < step_budget:
        live = s.active & ~s.done
        harvestable = s.active & s.done
        if not bool((live.any() & ~harvestable.any()).item()):
            break
        h = dec_mod._embed_step_tokens(params, cfg, s.next_tokens, pe,
                                       s.y_pos, aug_text, dtype)
        out_h, cache = trf.transformer_decode_step_paged(
            params["decoder"], h, pfx, s.cache, key_banned, s.gen_len, cfg,
            dtype=dtype, read_len=max(max(read_len), 1), layers=layers)
        logits = ssr_model.predict_logits(params, out_h)
        lg, num_cfg = dec_mod._mix_cfg(logits, s, dec, S, aug_text)
        upd = dec_mod._advance_chains(
            s, lg, generator, num_cfg, ts=ts, dec=dec, num_task=num_task,
            length_cap=length_cap, n_tasks=n_tasks,
            sentinel_ids=sentinel_ids, static_ban=static_ban,
            silence=silence)
        adv_r = torch.cat([live, live]) if aug_text else live
        gen_len = torch.where(adv_r, s.gen_len + 1, s.gen_len)
        s = ServeState(**_chain_fields(upd), cache=cache, gen_len=gen_len,
                       active=s.active, steps=s.steps + 1)
        for i in range(S):
            read_len[i] = min(read_len[i] + 1, cache.max_len)
    return s


def _refill_impl(state: ServeState, pfx: trf.KVCache, key_banned, x_lens,
                 n_tasks, slot: int, new_pfx: trf.KVCache, new_banned,
                 x_len: int, p_len: int, n_task_new: int, sentinel0: int,
                 empty_tok: int, *, aug_text: bool, n_slots: int) -> None:
    """Splice a freshly prefilled request into slot ``slot`` of a running
    state (JAX ``_refill_impl``), in place on the device: prefix rows
    ``slot`` and, under CFG, ``S + slot``, their key ban, ``gen_len = 0``,
    and every per-slot field. No other slot's rows are written."""
    S = n_slots
    rows = [(slot, 0)] + ([(S + slot, 1)] if aug_text else [])
    for row, new in rows:
        pfx.k[:, row] = new_pfx.k[:, new]
        pfx.v[:, row] = new_pfx.v[:, new]
        key_banned[row] = new_banned[new]
        state.gen_len[row] = 0
    state.y_pos[slot] = p_len
    state.next_tokens[slot] = sentinel0
    state.out[slot] = empty_tok
    for name in ("out_len", "span_idx", "span_end", "num_gen", "num_eog",
                 "consec_silence"):
        getattr(state, name)[slot] = 0
    state.prev_token[slot] = -1
    state.num_cfg[slot] = 1
    state.done[slot] = False
    state.active[slot] = True
    x_lens[slot] = x_len
    n_tasks[slot] = n_task_new


class ContinuousBatcher:
    """Slot-recycling server over a fixed geometry (JAX
    ``ContinuousBatcher``).

    Streams any number of requests through ``n_slots`` concurrent decode
    lanes. The geometry (text and prefix pads, the span count, the
    per-request generation cap) is fixed at construction; requests beyond
    it are rejected, before any decoding. ``dtype`` is the compute dtype,
    by default that of the decoder's matmul weights (bf16 on CUDA)."""

    def __init__(self, params, cfg: SSRModelConfig, dec: DecodeConfig,
                 n_slots: int, *, sx_pad: int = 128, p_pad: int = 512,
                 num_task: int = 1, dtype: Optional[torch.dtype] = None):
        self.params = params
        self.cfg, self.dec = cfg, dec
        self.S = n_slots
        self.sx_pad, self.p_pad = sx_pad, p_pad
        self.num_task = num_task
        self.cap_total = dec.max_gen_per_span * num_task
        self.dtype = dtype or params["decoder"]["layers"]["qkv_w"].dtype
        self.device = params["text_emb"].device
        self.aug = dec.aug_text
        self.tmax = dec_mod._bucket(sx_pad + p_pad + 8, 256)
        ts = cfg.tokens
        self.sentinels = np.arange(ts.mts, ts.mts + ts.max_n_spans,
                                   dtype=np.int64)[:max(num_task, 1)]
        dev = self.device
        self._sentinels_dev = torch.from_numpy(self.sentinels).to(dev)
        R = n_slots * (2 if self.aug else 1)
        gen_cap = dec_mod._bucket(self.cap_total + 8, 128)
        self._pfx = trf.init_kv_cache(cfg, R, self.tmax, dtype=self.dtype,
                                      device=dev)
        self._pfx = trf.KVCache(self._pfx.k, self._pfx.v, sx_pad + p_pad)
        self._banned = torch.ones((R, self.tmax), dtype=torch.bool, device=dev)
        self._x_lens = torch.ones(n_slots, dtype=torch.int64, device=dev)
        self._n_tasks = torch.ones(n_slots, dtype=torch.int64, device=dev)
        chains = dec_mod._init_chain_state(
            torch.zeros(n_slots, dtype=torch.int64, device=dev),
            self._sentinels_dev, n_slots, cfg.n_codebooks, num_task, ts,
            self.cap_total)
        chains.next_tokens.fill_(ts.empty)
        chains.done.fill_(True)  # empty slots look finished, but not active
        self.state = ServeState(
            **_chain_fields(chains),
            cache=trf.init_kv_cache(cfg, R, gen_cap, dtype=self.dtype,
                                    device=dev),
            gen_len=torch.zeros(R, dtype=torch.int64, device=dev),
            active=torch.zeros(n_slots, dtype=torch.bool, device=dev),
            steps=0)
        self.generator = torch.Generator(device=dev).manual_seed(0)
        # per slot, steps since its fill: a host bound on its rows' gen_len
        self._read_len = [0] * n_slots
        # host-side per-slot request records for the harvest
        self._slot_req: List[Optional[dict]] = [None] * n_slots
        # the random uncond rows when cfg_pretrained is off: a fresh draw
        # each prefill, from a stream of its own
        self._uncond_gen = torch.Generator(device=dev).manual_seed(7)
        self._layers = trf.layer_params(params["decoder"])
        self.stats: Optional[Dict] = None

    # ------------------------------------------------------------- internals

    def _normalize(self, req):
        """Unpack a request, ``(x, y, mask)`` or with aug_context prompts
        ``(x, y, mask, prompt_x, prompt_y)``, and apply the short-span
        context prepend. Returns (x, y, mask, trim_frames); ``trim`` rides
        in the slot's record and is stripped at the harvest."""
        x, y, mask = req[:3]
        ctx = req[3:]
        return dec_mod._apply_aug_context(
            self.dec, np.asarray(x, np.int32), np.asarray(y, np.int32),
            list(mask), *(ctx if len(ctx) == 2 else (None, None)))

    def validate_request(self, x, y, mask):
        """Raise on token ranges, geometry or span count before any
        decoding: a failure mid-run would abandon in-flight lanes. Host work
        only (no tensor on the device). Expects normalized inputs. Returns
        (x, y, prefix, ntask, nm) for reuse."""
        cfg, ts = self.cfg, self.cfg.tokens
        x = np.asarray(x, np.int32)
        y = np.asarray(y, np.int32)
        if x.size and (x.min() < 0 or x.max() >= cfg.text_vocab_size):
            raise ValueError(
                f"text ids out of range [0, {cfg.text_vocab_size})")
        if y.size and (y.min() < 0 or y.max() >= ts.audio_vocab_size):
            raise ValueError(
                f"audio codes out of range [0, {ts.audio_vocab_size})")
        prefix, _, ntask, nm = patterns.build_inference_prefix(
            y, list(mask), ts)
        if len(x) > self.sx_pad or prefix.shape[1] > self.p_pad:
            raise ValueError(
                f"request exceeds server geometry: text {len(x)}/{self.sx_pad}"
                f" prefix {prefix.shape[1]}/{self.p_pad}")
        if ntask > self.num_task:
            raise ValueError(f"request has {ntask} spans > {self.num_task}")
        return x, y, prefix, ntask, nm

    def _prefill_request(self, x, y, mask, pre=None):
        """Pad and prefill one request through ``_prefill_multi_impl`` (the
        flash kernel, a segment id a row); returns (prefix rows, banned
        rows, meta). ``pre``: a saved :meth:`validate_request` result."""
        cfg, dec, ts = self.cfg, self.dec, self.cfg.tokens
        K = cfg.n_codebooks
        dev = self.device
        x, y, prefix, ntask, nm = (self.validate_request(x, y, mask)
                                   if pre is None else pre)
        pfx_row = np.full((1, K, self.p_pad), ts.empty, np.int64)
        pfx_row[0, :, :prefix.shape[1]] = prefix
        xb, x_lens_r = dec_mod.build_text_rows([x], self.sx_pad, cfg, dec,
                                               self._uncond_gen)
        t0 = time.perf_counter()
        new_pfx, new_banned = dec_mod._prefill_multi_impl(
            self.params, torch.from_numpy(xb).to(dev),
            torch.from_numpy(pfx_row).to(dev),
            torch.from_numpy(x_lens_r).to(dev),
            torch.tensor([prefix.shape[1]], dtype=torch.int64, device=dev),
            cfg=cfg, tmax=self.tmax, dtype=self.dtype,
            cfg_pretrained=dec.cfg_pretrained, aug_text=self.aug)
        if self.stats is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.stats.setdefault("prefill_s", []).append(
                time.perf_counter() - t0)
            self.stats.setdefault("prefill_layouts", []).append(dict(
                x_lens=x_lens_r.tolist(), p_lens=[int(prefix.shape[1])],
                sx_pad=self.sx_pad, p_pad=self.p_pad))
        meta = dict(y=y, nm=nm, ntask=ntask, x_len=len(x),
                    p_len=prefix.shape[1])
        return new_pfx, new_banned, meta

    def _fill_slot(self, slot: int, req_idx: int, x, y, mask, trim: int = 0,
                   pre=None):
        self._splice_slot(slot, req_idx,
                          self._prefill_request(x, y, mask, pre=pre),
                          trim=trim)

    def _splice_slot(self, slot: int, req_idx: int, staged, trim: int = 0):
        """Splice an already prefilled request (``staged`` =
        :meth:`_prefill_request`'s result) into a free lane. Splitting the
        prefill from the splice lets the serving loops prefill eagerly,
        behind the in-flight chunk."""
        new_pfx, new_banned, meta = staged
        meta["req_idx"] = req_idx
        meta["trim"] = trim
        self._slot_req[slot] = meta
        self._read_len[slot] = 0
        ts = self.cfg.tokens
        _refill_impl(self.state, self._pfx, self._banned, self._x_lens,
                     self._n_tasks, slot, new_pfx, new_banned, meta["x_len"],
                     meta["p_len"], meta["ntask"], int(self.sentinels[0]),
                     ts.empty, aug_text=self.aug, n_slots=self.S)

    def _run_chunk(self, step_budget: int):
        """Reset the admission counter and run one chunk (the only call
        site of ``_serve_chunk_impl``: ``run``, ``run_online`` and the TTS
        streamers all pace through here)."""
        self.state.steps = 0
        t0 = time.perf_counter()
        self.state = _serve_chunk_impl(
            self.params, self._pfx, self._banned, self.state, self._x_lens,
            self._n_tasks, self._sentinels_dev, step_budget, self.generator,
            cfg=self.cfg, dec=self.dec, num_task=self.num_task,
            aug_text=self.aug, n_slots=self.S, dtype=self.dtype,
            read_len=self._read_len, layers=self._layers)
        if self.stats is not None:
            self.stats["decode_steps"] = (self.stats.get("decode_steps", 0)
                                          + self.state.steps)
            self.stats["decode_s"] = (self.stats.get("decode_s", 0.0)
                                      + time.perf_counter() - t0)
            self.stats["chunks"] = self.stats.get("chunks", 0) + 1

    def _park(self, slot: int) -> None:
        """Free a harvested slot: its rows ride along frozen, unread."""
        self.state.active[slot] = False
        self._read_len[slot] = 0

    def _harvest_slot(self, slot: int):
        meta = self._slot_req[slot]
        out_row = self.state.out[slot].cpu().numpy().astype(np.int32)
        span_end_row = self.state.span_end[slot].cpu().numpy()
        self._slot_req[slot] = None
        if self.stats is not None:
            self.stats.setdefault("out_tokens", {})[meta["req_idx"]] = out_row
        result = dec_mod._trim_context(dec_mod.assemble_result(
            meta["y"], meta["nm"], out_row, span_end_row, meta["ntask"],
            self.cfg.n_codebooks), meta.get("trim", 0))
        return meta["req_idx"], result

    def _harvestable(self) -> np.ndarray:
        return (self.state.active & self.state.done).cpu().numpy()

    # ------------------------------------------------------------------- API

    def run(self, requests: Sequence[Tuple],
            generator: Optional[torch.Generator] = None, progress=None,
            eager_prefill: int = 1, stats: Optional[Dict] = None):
        """Serve ``requests`` (each ``(x, y, mask_intervals)``, the
        :func:`decode.generate` contract, or its aug_context 5-tuple) FIFO
        through the slots; returns results in request order (each ``(codes,
        marks, out_intervals, nm)``). ``progress(completed, total,
        max_gen_len)`` is called after each chunk. ``eager_prefill``: how
        many pending requests to prefill after each chunk, ahead of the
        harvest (0 disables; the fill order, and so greedy results, is FIFO
        either way). ``stats``, when given, receives the decode steps and
        seconds, each prefill's seconds and layout, the sampled token
        stream of each request (``out_tokens``) and each request's
        completion time from the call (``done_at``)."""
        if generator is not None:
            self.generator = generator
        self.stats = stats
        t_start = time.perf_counter()
        norm = [self._normalize(r) for r in requests]
        # fail fast, before any decoding; the validated tuples are reused
        vals = [self.validate_request(x, y, mask) for x, y, mask, _ in norm]
        pending = deque(zip(range(len(norm)), norm, vals))
        staged: deque = deque()  # (idx, _prefill_request result, trim)
        results: List = [None] * len(requests)
        done_at: List = [None] * len(requests)
        n_done = 0

        def next_fill(slot: int) -> None:
            if staged:
                nidx, st, trim = staged.popleft()
                self._splice_slot(slot, nidx, st, trim=trim)
            else:
                nidx, (x, y, mask, trim), pre = pending.popleft()
                self._fill_slot(slot, nidx, x, y, mask, trim, pre=pre)

        try:
            for slot in range(self.S):
                if not pending:
                    break
                next_fill(slot)
            while True:
                self._run_chunk(2 ** 30)
                # a lane has finished: prefill the next request(s) now, so
                # the freed lane pays only the splice
                while pending and len(staged) < eager_prefill:
                    nidx, (x, y, mask, trim), pre = pending.popleft()
                    staged.append((nidx, self._prefill_request(
                        x, y, mask, pre=pre), trim))
                harvestable = self._harvestable()
                if not harvestable.any():
                    break
                for slot in np.nonzero(harvestable)[0]:
                    idx, result = self._harvest_slot(int(slot))
                    results[idx] = result
                    done_at[idx] = time.perf_counter() - t_start
                    n_done += 1
                    if staged or pending:
                        next_fill(int(slot))
                    else:
                        self._park(int(slot))
                if progress is not None:
                    progress(n_done, len(requests),
                             int(self.state.gen_len.max().item()))
        finally:
            self.stats = None
        if stats is not None:
            stats["done_at"] = done_at
        return results

    def run_online(self, requests: Sequence[Tuple], arrival_times,
                   generator: Optional[torch.Generator] = None, clock=None,
                   chunk_steps: int = 64, eager_prefill: int = 1):
        """Serve requests that arrive over time: each becomes eligible
        ``arrival_times[i]`` seconds after the call and is spliced into the
        first free lane. Returns (results, completion_times) on the clock of
        the arrivals; ``clock`` (default ``time.monotonic``) is injectable
        for tests. Chunks run at most ``chunk_steps`` steps, which bounds
        the admission latency."""
        clock = clock or time.monotonic
        if generator is not None:
            self.generator = generator
        norm = [self._normalize(r) for r in requests]
        # fail fast, before any decoding; validated tuples reused at fill
        vals = [self.validate_request(x, y, mask) for x, y, mask, _ in norm]
        t0 = clock()
        order = sorted(range(len(requests)), key=lambda i: arrival_times[i])
        pending = deque((i, norm[i], vals[i]) for i in order)
        staged: deque = deque()  # (idx, _prefill_request result, trim)
        results: List = [None] * len(requests)
        done_at: List = [None] * len(requests)

        def fill_free_slots():
            # occupy every inactive lane: staged (already prefilled) first,
            # then arrived pending requests, FIFO either way
            active = self.state.active.cpu().numpy().copy()
            for slot in range(self.S):
                if active[slot]:
                    continue
                if staged:
                    idx, st, trim = staged.popleft()
                    self._splice_slot(slot, idx, st, trim=trim)
                elif pending and arrival_times[pending[0][0]] <= clock() - t0:
                    idx, req, pre = pending.popleft()
                    self._fill_slot(slot, idx, *req, pre=pre)
                else:
                    break  # FIFO: the head has not arrived (or none left)
                active[slot] = True

        while pending or staged or bool(self.state.active.any().item()):
            if (not bool(self.state.active.any().item()) and not staged
                    and pending):
                # idle: sleep until the next arrival
                wait = arrival_times[pending[0][0]] - (clock() - t0)
                if wait > 0:
                    time.sleep(wait)
            fill_free_slots()
            self._run_chunk(chunk_steps)
            # eager prefill of the next arrived request(s), so that a lane
            # freed at the harvest pays only the splice
            while (pending and len(staged) < eager_prefill
                   and arrival_times[pending[0][0]] <= clock() - t0):
                idx, (x, y, mask, trim), pre = pending.popleft()
                staged.append(
                    (idx, self._prefill_request(x, y, mask, pre=pre), trim))
            harvestable = self._harvestable()
            now = clock() - t0
            for slot in np.nonzero(harvestable)[0]:
                idx, result = self._harvest_slot(int(slot))
                results[idx] = result
                done_at[idx] = now
                self._park(int(slot))
        return results, done_at


def sorted_static_batches(requests, n_slots: int,
                          est_len=None) -> List[List[int]]:
    """Offline-throughput scheduling for the static multi-prompt loop
    (``decode.generate_multi``): order requests by expected output length and
    batch neighbours, so each batch's straggler is barely longer than its
    mean (shortest-processing-time batching). Returns request-index batches;
    ``est_len(request)`` defaults to the text length (output length is capped
    at ``x_len * length_cap_mult``, so text length is the natural proxy)."""
    if est_len is None:
        est_len = lambda r: len(r[0])
    order = sorted(range(len(requests)), key=lambda i: est_len(requests[i]))
    return [order[i:i + n_slots] for i in range(0, len(order), n_slots)]


def serve_geometry(cfg: SSRModelConfig, dec: DecodeConfig, requests, *,
                   x_bucket: int = 64, prefix_bucket: int = 128):
    """The server geometry :func:`serve_requests` sizes for ``requests``:
    (sx_pad, p_pad, num_task), from the largest request after the
    aug_context prepend."""
    ts = cfg.tokens
    sx_max, p_max, nt_max = 1, 1, 1
    for req in requests:
        x, y, mask = req[:3]
        ctx = req[3:]
        x, y, mask, _ = dec_mod._apply_aug_context(
            dec, np.asarray(x, np.int32), np.asarray(y, np.int32), list(mask),
            *(ctx if len(ctx) == 2 else (None, None)))
        prefix, _, ntask, _ = patterns.build_inference_prefix(y, list(mask), ts)
        sx_max = max(sx_max, len(x))
        p_max = max(p_max, prefix.shape[1])
        nt_max = max(nt_max, ntask)
    return (dec_mod._bucket(sx_max, x_bucket),
            dec_mod._bucket(p_max, prefix_bucket), nt_max)


def serve_requests(params, cfg, dec, requests, generator=None, *, n_slots=8,
                   x_bucket=64, prefix_bucket=128, dtype=None, stats=None):
    """One-shot convenience: size a :class:`ContinuousBatcher` to the
    workload (pad buckets from the largest request) and run it."""
    sx_pad, p_pad, num_task = serve_geometry(
        cfg, dec, requests, x_bucket=x_bucket, prefix_bucket=prefix_bucket)
    server = ContinuousBatcher(params, cfg, dec, min(n_slots, len(requests)),
                               sx_pad=sx_pad, p_pad=p_pad, num_task=num_task,
                               dtype=dtype)
    return server.run(requests, generator, stats=stats)
