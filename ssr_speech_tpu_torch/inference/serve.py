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
loop over a body of ``graphs.UNROLL`` steps that evaluates the loop's stop
test (any harvestable slot, no live chain left, the budget) on the device
before every step and gates the step with it, so a chunk stops at the same
step as JAX's and ``steps`` counts what JAX's counter counts. On one CUDA
rank the body is a CUDA graph per stage window of the generated cache,
replayed with one flag read a replay. An admission prefills into a staging
cache the server owns (JAX's ``new_pfx``; a second one only while a
prefilled request waits to be spliced) and the splice copies it into the
slot with index writes at a device slot (JAX traces ``slot``): both are
programs of static buffers, captured once on one CUDA rank and replayed
by every admission (``graphs.GraphProgram``). Under greedy sampling,
served outputs equal :func:`decode.generate`'s
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
from ..models import mla_moe
from ..models import ssr as ssr_model
from ..models import transformer as trf
from ..ops import patterns
from ..parallel.dist import is_main, synced_clock
from ..utils import profiler
from ..utils.profiler import annotate
from . import decode as dec_mod
from . import graphs


@dataclass
class ServeState(dec_mod.ChainState):
    """Per-slot chain state ([S] tensors, ``y_pos`` among them) plus the
    paged cache's write columns and the slots' occupancy, in static buffers
    that the chunk's graphs read and write in place."""

    cache: trf.KVCache  # generated K/V [L, R, H, G, Dh] or latents, a column a row
    gen_len: torch.Tensor  # [R] write column of each row
    active: torch.Tensor  # [S] slot holds a live (unharvested) request
    steps: torch.Tensor  # [1] steps taken in this chunk (the admission budget)
    budget: torch.Tensor  # [1] this chunk's step budget
    flag: torch.Tensor  # [1] the chunk's loop condition after the last step


def _chain_fields(s: dec_mod.ChainState) -> Dict:
    return {f.name: getattr(s, f.name)
            for f in dataclasses.fields(dec_mod.ChainState)}


def _chunk_go(s: ServeState, done: torch.Tensor,
              steps: torch.Tensor) -> torch.Tensor:
    """JAX ``_serve_chunk_impl``'s loop condition on the device: a live
    chain, none harvestable, and steps left in the budget ([1] bool)."""
    live = s.active & ~done
    harvestable = s.active & done
    return live.any() & ~harvestable.any() & (steps < s.budget)


def _serve_chunk_body(params, srv: "ContinuousBatcher"):
    """The chunk's U-step body over the server's static buffers: before each
    step the chunk's condition (:func:`_chunk_go`); then the embedded
    tokens, the paged step through the stage window, the heads, the CFG mix,
    ``_advance_chains`` and ``gen_len + 1`` on the rows of live chains (cond
    and uncond), all gated by it, so a step after the chunk's exit is a
    no-op and the chunk stops where JAX's stops. Parked slots
    (``active=False``) ride along frozen."""
    cfg, dec = srv.cfg, srv.dec
    S, aug_text, dtype = srv.S, srv.aug, srv.dtype
    mla = mla_moe.is_mla_moe(cfg)

    def body(window: int, generator) -> None:
        st = srv.state
        cur, gen_len, steps = st, st.gen_len, st.steps
        length_cap = srv._x_lens * dec.length_cap_mult
        for _ in range(graphs.UNROLL):
            live = st.active & ~cur.done
            go = _chunk_go(st, cur.done, steps)
            adv = live & go
            adv_r = torch.cat([adv, adv]) if aug_text else adv
            h = dec_mod._embed_step_tokens(params, cfg, cur.next_tokens,
                                           srv._pe, cur.y_pos, aug_text, dtype)
            if mla:
                out_h, _ = mla_moe.decode_step_paged(
                    params["decoder"], h, srv._pfx, st.cache, srv._banned,
                    gen_len, cfg, pos=dec_mod.row_positions(cur.y_pos, aug_text),
                    dtype=dtype, read_len=window, layers=srv._layers,
                    counts=srv._routing, live=adv_r)
            else:
                out_h, _ = trf.transformer_decode_step_paged(
                    params["decoder"], h, srv._pfx, st.cache, srv._banned,
                    gen_len, cfg, dtype=dtype, read_len=window,
                    layers=srv._layers)
            logits = ssr_model.predict_logits(params, out_h)
            lg, num_cfg = dec_mod._mix_cfg(logits, cur, dec, S, aug_text)
            cur = dec_mod._advance_chains(
                cur, lg, generator, num_cfg, ts=cfg.tokens, dec=dec,
                num_task=srv.num_task, length_cap=length_cap,
                n_tasks=srv._n_tasks, sentinel_ids=srv._sentinels_dev,
                static_ban=srv._static_ban, silence=srv._silence, go=go)
            gen_len = gen_len + adv_r.long()
            steps = steps + go.long()
        dec_mod._store_chains(st, cur)
        st.gen_len.copy_(gen_len)
        st.steps.copy_(steps)
        st.flag.copy_(_chunk_go(st, cur.done, steps))

    return body


@torch.no_grad()
def _serve_chunk_impl(params, srv: "ContinuousBatcher",
                      step_budget: int) -> int:
    """Decode until any live chain finishes, ``step_budget`` steps are taken,
    or no live chain is left (JAX ``_serve_chunk_impl``'s loop condition,
    evaluated on the device before every step). The body replays as CUDA
    graphs on one CUDA rank (``graphs.GraphLoop``), one flag read a replay;
    each replay reads the generated cache through the stage window that
    bounds its rows' write columns: per slot, the steps taken since its
    fill (``srv._read_len``, kept on the host from each chunk's count) plus
    the steps replayed in this chunk. Returns the steps taken."""
    s = srv.state
    s.steps.zero_()
    s.budget.fill_(step_budget)
    body = _serve_chunk_body(params, srv)
    graphs.loop_steps(
        srv._loop, body, s.flag, max_steps=step_budget,
        generator=srv.generator,
        window_for=lambda n: trf.stage_window(
            srv._windows, max(srv._read_len) + n + graphs.UNROLL))
    steps = int(s.steps.item())
    for i in range(srv.S):
        if srv._slot_req[i] is not None:
            srv._read_len[i] = min(srv._read_len[i] + steps, srv._gen_cap)
    return steps


def _refill_impl(state: ServeState, pfx, key_banned, x_lens,
                 n_tasks, slot, new_pfx, new_banned, x_len, p_len,
                 n_task_new, sentinel0, empty_tok: int, *, aug_text: bool,
                 n_slots: int) -> None:
    """Splice a freshly prefilled request into slot ``slot`` of a running
    state (JAX ``_refill_impl``), in place on the device: prefix rows
    ``slot`` and, under CFG, ``S + slot``, their key ban, ``gen_len = 0``,
    and every per-slot field. ``slot``, ``x_len``, ``p_len``,
    ``n_task_new`` and ``sentinel0`` are device scalars (host ints are
    copied in), as JAX traces them: every write is an index op at a device
    index, so one capture serves every slot. No other slot's rows are
    written."""
    S = n_slots
    dev = key_banned.device
    slot, x_len, p_len, n_task_new, sentinel0 = (
        dec_mod._dev_scalar(v, dev).reshape(1)
        for v in (slot, x_len, p_len, n_task_new, sentinel0))
    rows = torch.cat([slot, slot + S]) if aug_text else slot
    n = rows.shape[0]
    for dst, src in zip(pfx.buffers(), new_pfx.buffers()):
        dst.index_copy_(1, rows, src[:, :n])
    key_banned.index_copy_(0, rows, new_banned[:n])
    state.gen_len.index_fill_(0, rows, 0)
    state.y_pos.index_copy_(0, slot, p_len)
    K = state.next_tokens.shape[1]
    state.next_tokens.index_copy_(0, slot, sentinel0[:, None].expand(1, K))
    state.out.index_fill_(0, slot, empty_tok)
    for name in ("out_len", "span_idx", "span_end", "num_gen", "num_eog",
                 "consec_silence"):
        getattr(state, name).index_fill_(0, slot, 0)
    state.prev_token.index_fill_(0, slot, -1)
    state.num_cfg.index_fill_(0, slot, 1)
    state.done.index_fill_(0, slot, False)
    state.active.index_fill_(0, slot, True)
    x_lens.index_copy_(0, slot, x_len)
    n_tasks.index_copy_(0, slot, n_task_new)


class _Staging:
    """One admission's staging area (JAX's ``new_pfx``): the padded text
    rows, the prefix and their true lengths as the prefill's static inputs,
    the prompt cache [L, 1 or 2, H, tmax, Dh] (or the MLA block's latents)
    and banned keys it fills, and
    the two programs over them: the prefill (``_prefill_multi_impl``) and
    the splice (:func:`_refill_impl`, which also reads the server's splice
    scalars). ``busy`` from the prefill until the splice."""

    def __init__(self, srv: "ContinuousBatcher"):
        cfg, dev = srv.cfg, srv.device
        rows = 2 if srv.aug else 1
        i64 = dict(dtype=torch.int64, device=dev)
        self._cache = dec_mod.init_cache(cfg, rows, srv.tmax, dtype=srv.dtype,
                                         device=dev,
                                         par=trf.parallel_of(srv.params))
        self.banned = torch.ones((rows, srv.tmax), dtype=torch.bool,
                                 device=dev)
        self.x = torch.zeros((rows, srv.sx_pad), **i64)
        self.prefix = torch.zeros((1, cfg.n_codebooks, srv.p_pad), **i64)
        self.x_lens = torch.zeros(rows, **i64)
        self.p_lens = torch.zeros(1, **i64)
        use = srv._loop.use_graphs
        self.prefill = graphs.GraphProgram(dev, use)
        self.splice = graphs.GraphProgram(dev, use)
        self.busy = False

    def cache(self):
        """The staged rows, to be filled from 0 (a prefill writes the same
        [0, sx_pad + p_pad) each time; the rest stays zero)."""
        return dataclasses.replace(self._cache, length=0)


class ContinuousBatcher:
    """Slot-recycling server over a fixed geometry (JAX
    ``ContinuousBatcher``).

    Streams any number of requests through ``n_slots`` concurrent decode
    lanes. The geometry (text and prefix pads, the span count, the
    per-request generation cap) is fixed at construction; requests beyond
    it are rejected, before any decoding. ``dtype`` is the compute dtype,
    by default that of the decoder's matmul weights (bf16 on CUDA).

    The server owns its static buffers (the prompt and generated caches,
    the slots' state) and the CUDA graphs of its chunk, one a stage window
    of the generated cache, captured on first use and replayed by every
    later chunk, on one CUDA rank; ``cuda_graphs=False`` runs the same body
    eagerly there, for comparison. Under tensor parallelism and on the CPU
    the body runs eagerly."""

    def __init__(self, params, cfg: SSRModelConfig, dec: DecodeConfig,
                 n_slots: int, *, sx_pad: int = 128, p_pad: int = 512,
                 num_task: int = 1, dtype: Optional[torch.dtype] = None,
                 cuda_graphs: bool = True):
        self.params = params
        self.cfg, self.dec = cfg, dec
        self.S = n_slots
        self.sx_pad, self.p_pad = sx_pad, p_pad
        self.num_task = num_task
        self.cap_total = dec.max_gen_per_span * num_task
        self.dtype = dtype or dec_mod.decoder_dtype(params)
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
        self._gen_cap = gen_cap
        self._windows = trf.cache_stage_sizes(gen_cap)
        par = trf.parallel_of(params)
        self._pfx = dec_mod.init_cache(cfg, R, self.tmax, dtype=self.dtype,
                                       device=dev, par=par)
        self._pfx.length = sx_pad + p_pad
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
            cache=dec_mod.init_cache(cfg, R, gen_cap, dtype=self.dtype,
                                     device=dev, par=par),
            gen_len=torch.zeros(R, dtype=torch.int64, device=dev),
            active=torch.zeros(n_slots, dtype=torch.bool, device=dev),
            steps=torch.zeros(1, dtype=torch.int64, device=dev),
            budget=torch.zeros(1, dtype=torch.int64, device=dev),
            flag=torch.zeros(1, dtype=torch.bool, device=dev))
        self.generator = torch.Generator(device=dev).manual_seed(0)
        # per slot, steps since its fill: a host bound on its rows' gen_len
        self._read_len = [0] * n_slots
        # host-side per-slot request records for the harvest
        self._slot_req: List[Optional[dict]] = [None] * n_slots
        # the random uncond rows when cfg_pretrained is off: a fresh draw
        # each prefill, from a stream of its own
        self._uncond_gen = torch.Generator(device=dev).manual_seed(7)
        self._layers = dec_mod.layer_params(cfg, params["decoder"])
        # the MLA block's routing counters, accumulated on the device by
        # the replayed steps: per MoE layer, the (row, choice) pairs each
        # expert took and the steps in which it took any [Lm, 2, E]
        self._routing = (torch.zeros((cfg.n_moe_layers, 2,
                                      cfg.n_routed_experts),
                                     dtype=torch.int32, device=dev)
                         if mla_moe.is_mla_moe(cfg) else None)
        self._pe = ssr_model.sine_table(cfg.max_position, cfg.d_model,
                                        device=dev)
        self._silence = torch.tensor(dec.silence_tokens, dtype=torch.int64,
                                     device=dev)
        self._static_ban = dec_mod._static_ban(ts, dev)
        self._loop = graphs.GraphLoop(
            dev, graphs.graphs_wanted(dev, params, cuda_graphs))
        # admissions' staging areas (one unless prefilled requests queue)
        # and the splice's device scalars: slot, x_len, p_len, n_task,
        # the first sentinel
        self._staging: List[_Staging] = []
        self._splice_args = torch.zeros(5, dtype=torch.int64, device=dev)
        self.stats: Optional[Dict] = None
        self._prefills: List = []  # recorded prefill spans not yet in stats

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

    def _free_staging(self) -> _Staging:
        """A staging area no prefilled request holds (made on first need)."""
        for st in self._staging:
            if not st.busy:
                break
        else:
            st = _Staging(self)
            self._staging.append(st)
        st.busy = True
        return st

    def _release_staging(self) -> None:
        """Free every staging area (a serving loop starts with none
        staged)."""
        for st in self._staging:
            st.busy = False

    def _prefill_request(self, x, y, mask, pre=None):
        """Pad and prefill one request through ``_prefill_multi_impl`` (the
        flash kernel, a segment id a row) into a free staging area: its
        inputs by host-to-device copies into the area's buffers, then the
        area's prefill program. Returns (staging area, meta). ``pre``: a
        saved :meth:`validate_request` result. Spans ``serve.admit`` (a new
        request identifier, which the request's splice and harvest spans
        share) and under it ``prefill`` (device): with ``stats`` its device
        time is added to ``stats["prefill_s"]`` when the serving loop ends
        (its events: nothing waits for the device here)."""
        cfg, dec, ts = self.cfg, self.dec, self.cfg.tokens
        K = cfg.n_codebooks
        request = profiler.new_request()
        with annotate("serve.admit", record=self.stats is not None,
                      request=request):
            x, y, prefix, ntask, nm = (self.validate_request(x, y, mask)
                                       if pre is None else pre)
            pfx_row = np.full((1, K, self.p_pad), ts.empty, np.int64)
            pfx_row[0, :, :prefix.shape[1]] = prefix
            xb, x_lens_r = dec_mod.build_text_rows([x], self.sx_pad, cfg, dec,
                                                   self._uncond_gen)
            st = self._free_staging()
            with annotate("prefill", self.device) as span:
                for buf, host in ((st.x, xb), (st.prefix, pfx_row),
                                  (st.x_lens, x_lens_r)):
                    buf.copy_(torch.from_numpy(np.asarray(host, np.int64)))
                st.p_lens.fill_(int(prefix.shape[1]))
                st.prefill.run(lambda: dec_mod._prefill_multi_impl(
                    self.params, st.x, st.prefix, st.x_lens, st.p_lens,
                    cfg=cfg, tmax=self.tmax, dtype=self.dtype,
                    cfg_pretrained=dec.cfg_pretrained, aug_text=self.aug,
                    cache=st.cache(), pe=self._pe, banned=st.banned))
        if self.stats is not None:
            self._prefills.append(span)
            self.stats.setdefault("prefill_layouts", []).append(dict(
                x_lens=x_lens_r.tolist(), p_lens=[int(prefix.shape[1])],
                sx_pad=self.sx_pad, p_pad=self.p_pad))
        meta = dict(y=y, nm=nm, ntask=ntask, x_len=len(x),
                    p_len=prefix.shape[1], request=request)
        return st, meta

    def _flush_prefills(self) -> None:
        """The recorded prefills' device seconds into ``stats["prefill_s"]``
        (read once the serving loop has read its results back: the events
        have completed)."""
        if self.stats is not None and self._prefills:
            self.stats.setdefault("prefill_s", []).extend(
                sp.device_s() or sp.host_s for sp in self._prefills)
        self._prefills = []

    def _fill_slot(self, slot: int, req_idx: int, x, y, mask, trim: int = 0,
                   pre=None):
        self._splice_slot(slot, req_idx,
                          self._prefill_request(x, y, mask, pre=pre),
                          trim=trim)

    def _splice_slot(self, slot: int, req_idx: int, staged, trim: int = 0):
        """Splice an already prefilled request (``staged`` =
        :meth:`_prefill_request`'s result) into a free lane: the splice's
        scalars by one host-to-device copy, then the staging area's splice
        program, which frees the area. Splitting the prefill from the
        splice lets the serving loops prefill eagerly, behind the in-flight
        chunk."""
        st, meta = staged
        meta["req_idx"] = req_idx
        meta["trim"] = trim
        self._slot_req[slot] = meta
        self._read_len[slot] = 0
        a = self._splice_args
        with annotate("serve.splice", self.device,
                      request=meta.get("request"), slot=slot):
            a.copy_(torch.tensor([slot, meta["x_len"], meta["p_len"],
                                  meta["ntask"], int(self.sentinels[0])]))
            st.splice.run(lambda: _refill_impl(
                self.state, self._pfx, self._banned, self._x_lens,
                self._n_tasks, a[0], st.cache(), st.banned,
                a[1], a[2], a[3], a[4], self.cfg.tokens.empty,
                aug_text=self.aug, n_slots=self.S))
        st.busy = False

    def _run_chunk(self, step_budget: int) -> int:
        """Run one chunk of at most ``step_budget`` steps (the only call
        site of ``_serve_chunk_impl``: ``run``, ``run_online`` and the TTS
        streamers all pace through here; span ``serve.chunk``). Returns the
        steps taken. ``stats`` counts the steps, seconds and chunks, and
        ``lane_steps``: the lanes holding an unfinished request at the
        chunk's start (every lane holding one: the loops harvest each
        finished lane before the next chunk, and a chunk with one left
        takes no step) times the steps it took."""
        t0 = time.perf_counter()
        lanes = sum(r is not None for r in self._slot_req)
        with annotate("serve.chunk", lanes=lanes):
            steps = _serve_chunk_impl(self.params, self, step_budget)
            profiler.note(steps=steps)
        if self.stats is not None:
            st = self.stats
            st["decode_steps"] = st.get("decode_steps", 0) + steps
            st["decode_s"] = (st.get("decode_s", 0.0)
                              + time.perf_counter() - t0)
            st["chunks"] = st.get("chunks", 0) + 1
            st["lane_steps"] = st.get("lane_steps", 0) + lanes * steps
        if self._routing is not None:
            self._read_routing(self.stats)
        return steps

    def _read_routing(self, st: Optional[Dict]) -> None:
        """The MLA block's routing counters since the last read, reset,
        and with ``stats`` added to it: ``expert_tokens`` [Lm, E] (the (row,
        choice) pairs each expert of each MoE layer took) and
        ``expert_steps`` [Lm, E] (the steps in which it took any), over the
        steps the chunk took, the rows of live chains counted (a parked
        lane reads no routed expert). One read a chunk, after its step
        count."""
        with annotate("serve.routing"):
            got = self._routing.cpu().numpy().astype(np.int64)
            self._routing.zero_()
        if st is None:
            return
        for key, part in (("expert_tokens", got[:, 0]),
                          ("expert_steps", got[:, 1])):
            st[key] = part if key not in st else st[key] + part

    def _park(self, slot: int) -> None:
        """Free a harvested slot: its rows ride along frozen, unread."""
        self.state.active[slot] = False
        self._read_len[slot] = 0

    def _harvest_slot(self, slot: int):
        meta = self._slot_req[slot]
        with annotate("serve.harvest", request=meta.get("request"),
                      slot=slot):
            out_row = self.state.out[slot].cpu().numpy().astype(np.int32)
            span_end_row = self.state.span_end[slot].cpu().numpy()
            self._slot_req[slot] = None
            if self.stats is not None:
                tokens = self.stats.setdefault("out_tokens", {})
                tokens[meta["req_idx"]] = out_row
            result = dec_mod._trim_context(dec_mod.assemble_result(
                meta["y"], meta["nm"], out_row, span_end_row, meta["ntask"],
                self.cfg.n_codebooks), meta.get("trim", 0))
        return meta["req_idx"], result

    def _harvestable(self) -> np.ndarray:
        with annotate("serve.poll"):
            return (self.state.active & self.state.done).cpu().numpy()

    def _any_active(self) -> bool:
        with annotate("serve.poll"):
            return bool(self.state.active.any().item())

    # ------------------------------------------------------------------- API

    def run(self, requests: Sequence[Tuple],
            generator: Optional[torch.Generator] = None, progress=None,
            eager_prefill: int = 1, stats: Optional[Dict] = None):
        """Serve ``requests`` (each ``(x, y, mask_intervals)``, the
        :func:`decode.generate` contract, or its aug_context 5-tuple) FIFO
        through the slots; returns results in request order (each ``(codes,
        marks, out_intervals, nm)``; on tensor-parallel parameters rank 0
        returns them and the other ranks None). ``progress(completed, total,
        max_gen_len)`` is called after each chunk. ``eager_prefill``: how
        many pending requests to prefill after each chunk, ahead of the
        harvest (0 disables; the fill order, and so greedy results, is FIFO
        either way). ``stats``, when given, receives the decode steps and
        seconds, each prefill's seconds and layout, the sampled token
        stream of each request (``out_tokens``) and each request's
        completion time from the call (``done_at``); it also records the
        loop's spans (root ``serve``)."""
        if generator is not None:
            self.generator = generator
        self.stats = stats
        self._release_staging()
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
            with annotate("serve", record=stats is not None, lanes=self.S,
                          requests=len(requests)):
                for slot in range(self.S):
                    if not pending:
                        break
                    next_fill(slot)
                while True:
                    self._run_chunk(2 ** 30)
                    # a lane has finished: prefill the next request(s) now,
                    # so the freed lane pays only the splice
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
            self._flush_prefills()
            self.stats = None
        if stats is not None:
            stats["done_at"] = done_at
        return results if is_main() else None

    def run_online(self, requests: Sequence[Tuple], arrival_times,
                   generator: Optional[torch.Generator] = None, clock=None,
                   chunk_steps: int = 64, eager_prefill: int = 1):
        """Serve requests that arrive over time: each becomes eligible
        ``arrival_times[i]`` seconds after the call and is spliced into the
        first free lane. Returns (results, completion_times) on the clock of
        the arrivals; ``clock`` (default ``time.monotonic``) is injectable
        for tests. Chunks run at most ``chunk_steps`` steps, which bounds
        the admission latency. On tensor-parallel parameters every rank runs
        the loop on rank 0's clock, and rank 0 alone gets the results (the
        other ranks None).

        With ``self.stats`` (a dict) the loop records its spans (root
        ``serve``) and fills ``stats`` as :meth:`run` does, and by request
        on the arrivals' clock: ``admit_at``, when its admission began (the
        reading that found it arrived), ``lane_at``, when it was spliced
        into a lane (the loop's last reading before the splice), and
        ``done_at``. The loop reads the clock where it always did: under
        tensor parallelism each reading is a broadcast."""
        clock = synced_clock(clock or time.monotonic, self.device)
        if generator is not None:
            self.generator = generator
        self._release_staging()
        norm = [self._normalize(r) for r in requests]
        # fail fast, before any decoding; validated tuples reused at fill
        vals = [self.validate_request(x, y, mask) for x, y, mask, _ in norm]
        t0 = clock()
        last = [0.0]  # the loop's latest reading of the clock, from t0

        def now() -> float:
            last[0] = clock() - t0
            return last[0]

        order = sorted(range(len(requests)), key=lambda i: arrival_times[i])
        pending = deque((i, norm[i], vals[i]) for i in order)
        staged: deque = deque()  # (idx, _prefill_request result, trim)
        results: List = [None] * len(requests)
        done_at: List = [None] * len(requests)
        admit_at: List = [None] * len(requests)
        lane_at: List = [None] * len(requests)
        stats = self.stats

        def fill_free_slots():
            # occupy every inactive lane: staged (already prefilled) first,
            # then arrived pending requests, FIFO either way
            with annotate("serve.poll"):
                active = self.state.active.cpu().numpy().copy()
            for slot in range(self.S):
                if active[slot]:
                    continue
                if staged:
                    idx, st, trim = staged.popleft()
                    lane_at[idx] = last[0]
                    self._splice_slot(slot, idx, st, trim=trim)
                elif pending and arrival_times[pending[0][0]] <= now():
                    idx, req, pre = pending.popleft()
                    admit_at[idx] = lane_at[idx] = last[0]
                    self._fill_slot(slot, idx, *req, pre=pre)
                else:
                    break  # FIFO: the head has not arrived (or none left)
                active[slot] = True

        try:
            with annotate("serve", record=stats is not None, lanes=self.S,
                          requests=len(requests)):
                while pending or staged or self._any_active():
                    if not self._any_active() and not staged and pending:
                        # idle: sleep until the next arrival
                        wait = arrival_times[pending[0][0]] - now()
                        if wait > 0:
                            with annotate("serve.sleep"):
                                time.sleep(wait)
                    fill_free_slots()
                    self._run_chunk(chunk_steps)
                    # eager prefill of the next arrived request(s), so that
                    # a lane freed at the harvest pays only the splice
                    while (pending and len(staged) < eager_prefill
                           and arrival_times[pending[0][0]] <= now()):
                        idx, (x, y, mask, trim), pre = pending.popleft()
                        admit_at[idx] = last[0]
                        staged.append((idx, self._prefill_request(
                            x, y, mask, pre=pre), trim))
                    harvestable = self._harvestable()
                    t_done = now()
                    for slot in np.nonzero(harvestable)[0]:
                        idx, result = self._harvest_slot(int(slot))
                        results[idx] = result
                        done_at[idx] = t_done
                        self._park(int(slot))
        finally:
            self._flush_prefills()
        if stats is not None:
            stats.update(admit_at=admit_at, lane_at=lane_at, done_at=done_at)
        return (results, done_at) if is_main() else None


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
                   x_bucket=64, prefix_bucket=128, dtype=None, stats=None,
                   cuda_graphs=True):
    """One-shot convenience: size a :class:`ContinuousBatcher` to the
    workload (pad buckets from the largest request) and run it
    (``cuda_graphs`` as there)."""
    sx_pad, p_pad, num_task = serve_geometry(
        cfg, dec, requests, x_bucket=x_bucket, prefix_bucket=prefix_bucket)
    server = ContinuousBatcher(params, cfg, dec, min(n_slots, len(requests)),
                               sx_pad=sx_pad, p_pad=p_pad, num_task=num_task,
                               dtype=dtype, cuda_graphs=cuda_graphs)
    return server.run(requests, generator, stats=stats)
