"""Streaming TTS: waveform chunks while the LM decodes (port of
``ssr_speech_tpu/inference/stream.py``).

Three pieces compose into a generator with early first audio:

- the serving chunk (``serve.ContinuousBatcher._run_chunk``) runs the decode
  loop ``chunk_frames`` steps at a time: its admission budget is the
  streaming cadence;
- the delay pattern makes tokens final one by one: after ``n`` raw steps,
  frames ``0 .. n-K`` are resolved (``ops.patterns.revert_delay_pattern``:
  out[q, t] = raw[q, t + q], every needed column already sampled and never
  rewritten), so each LM chunk releases a batch of final codec frames;
- the chunked causal codec decoder (``models.codec.streaming``) turns each
  released batch into waveform with carried conv/LSTM state, warmed on the
  prompt codes, so the stream equals the offline decode-then-crop TTS
  output. The EOG frame is dropped on the last chunk.

Needs a causal codec (``codec_cfg.seanet.causal``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CodecConfig, DecodeConfig, SSRModelConfig
from ..models.codec import streaming as cstream
from ..ops import patterns
from . import serve as serve_mod


def _resolved_frames(out_row: np.ndarray, n: int, done: bool, K: int):
    """The final codec frames of a chain's raw stream of ``n`` steps; the
    EOG frame is dropped once the chain is done (offline parity)."""
    raw = out_row[:, :n]
    frames = (patterns.revert_delay_pattern(raw) if n >= K
              else np.zeros((K, 0), np.int32))
    return frames[:, :-1] if done else frames


class TTSStreamer:
    """Low-latency TTS for one client: ``stream()`` yields waveform chunks as
    they become final. Reusable across utterances."""

    def __init__(self, lm_params, cfg: SSRModelConfig, dec: DecodeConfig,
                 codec_params, codec_cfg: CodecConfig, *,
                 chunk_frames: int = 25,
                 first_chunk_frames: Optional[int] = None, sx_pad: int = 128,
                 p_pad: int = 512, dtype: Optional[torch.dtype] = None,
                 codec_dtype=torch.float32):
        """``chunk_frames`` is the steady emission cadence;
        ``first_chunk_frames`` (default ``chunk_frames // 2``) the first
        chunk's size: smaller means earlier first audio."""
        if not codec_cfg.seanet.causal:
            raise ValueError("streaming TTS needs a causal codec "
                             "(codec_cfg.seanet.causal=True)")
        self.cfg, self.dec = cfg, dec
        self.codec_params, self.codec_cfg = codec_params, codec_cfg
        self.chunk_frames = chunk_frames
        self.first_chunk_frames = ((chunk_frames // 2 or 1)
                                   if first_chunk_frames is None
                                   else first_chunk_frames)
        self.codec_dtype = codec_dtype
        self._server = serve_mod.ContinuousBatcher(
            lm_params, cfg, dec, 1, sx_pad=sx_pad, p_pad=p_pad, num_task=1,
            dtype=dtype)

    def stream(self, x, y_prompt, generator: Optional[torch.Generator] = None
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """TTS from text ids ``x`` and prompt codes ``y_prompt`` [K, T]:
        yields ``(codes_chunk [K, F], wav_chunk [F*hop, channels])`` of the
        generated region only (the TTS crop), ending with one final
        (possibly shorter) flush chunk."""
        srv = self._server
        K = self.cfg.n_codebooks
        F = self.chunk_frames
        F0 = min(self.first_chunk_frames, F)
        y_prompt = np.asarray(y_prompt, np.int32)
        T = y_prompt.shape[1]
        if generator is not None:
            srv.generator = generator
        srv._fill_slot(0, 0, x, y_prompt, [(T, T)])
        # +K steps, so that the first F0 frames are resolved by this chunk
        srv._run_chunk(F0 + K)
        codec = cstream.StreamingCodec(self.codec_params, self.codec_cfg,
                                       batch=1, dtype=self.codec_dtype)
        dev = srv.device
        # warm the decoder's state on the prompt (its audio is discarded:
        # the offline TTS path crops the same region)
        for s in range(0, T, F):
            codec.decode_chunk(torch.from_numpy(
                y_prompt[None, :, s:s + F]).to(dev, torch.int64))
        sent = 0  # frames handed to the codec so far
        target = F0  # the first emission is smaller: earlier first audio
        while True:
            done = bool(srv.state.done[0].item())
            n = int(srv.state.out_len[0].item())
            frames = _resolved_frames(srv.state.out[0].cpu().numpy(), n,
                                      done, K)
            avail = frames.shape[1] - sent
            # fixed-size emission
            while avail >= target or (done and avail > 0):
                take = min(target, avail)
                chunk = frames[:, sent:sent + take]
                wav = codec.decode_chunk(torch.from_numpy(
                    np.ascontiguousarray(chunk[None])).to(dev, torch.int64))
                sent += take
                avail -= take
                target = F
                yield chunk, wav[0].cpu().numpy()
            if done:
                srv._slot_req[0] = None
                srv._park(0)
                return
            srv._run_chunk(F)


class _Lane:
    """Host-side bookkeeping of one slot's stream for
    :class:`StreamingServer`. ``queue`` holds codec frames awaiting decode:
    the prompt codes at fill time, then the resolved generated frames as LM
    chunks land; ``discard`` counts the leading frames whose audio belongs
    to the prompt and is suppressed (the offline TTS path crops the same
    region)."""

    __slots__ = ("req_idx", "queue", "discard", "resolved", "eos", "codes",
                 "wavs", "first_at")

    def __init__(self, req_idx: int, queue: np.ndarray, discard: int):
        self.req_idx = req_idx
        self.queue = np.asarray(queue, np.int32)
        self.discard = int(discard)
        self.resolved = 0  # generated frames already enqueued
        self.eos = False  # the LM finished: flush the rest of the queue
        self.codes: List[np.ndarray] = []
        self.wavs: List[np.ndarray] = []
        self.first_at: Optional[float] = None

    @property
    def flushed(self) -> bool:
        return self.eos and self.queue.shape[1] == 0


class StreamingServer:
    """Multi-client streaming TTS: ``n_slots`` concurrent decode lanes, each
    emitting waveform chunks to its own client as its tokens become final
    (:class:`TTSStreamer`'s incremental release over
    :class:`serve.ContinuousBatcher`'s slot recycling).

    All lanes' codec streams advance through one batched call
    (:class:`models.codec.streaming.LaneDecoder`) in fixed
    ``first_chunk_frames``-sized steps. A lane's prompt codes and generated
    frames share one decode queue (the prompt's audio is discarded by frame
    count); within a loop iteration every pending codec step is issued
    before the first output is copied to the host. Only the final flush
    pads (to the step size); that state dies with the lane (reset on
    refill).

    Under greedy sampling each client's concatenated stream equals the
    offline generate -> causal decode -> crop pipeline
    (``tests/test_torch_stream_tts.py``)."""

    def __init__(self, lm_params, cfg: SSRModelConfig, dec: DecodeConfig,
                 codec_params, codec_cfg: CodecConfig, n_slots: int, *,
                 chunk_frames: int = 25,
                 first_chunk_frames: Optional[int] = None, sx_pad: int = 128,
                 p_pad: int = 512, dtype: Optional[torch.dtype] = None,
                 codec_dtype=torch.float32, warm_chunk: int = 50):
        if not codec_cfg.seanet.causal:
            raise ValueError("streaming TTS needs a causal codec "
                             "(codec_cfg.seanet.causal=True)")
        if chunk_frames <= 2 * cfg.n_codebooks:
            # a fresh lane resolves chunk_frames - K frames a chunk; the
            # first emission (chunk_frames // 2) must fit in one chunk
            raise ValueError(
                f"chunk_frames={chunk_frames} too small vs the delay pattern "
                f"(need > 2*K = {2 * cfg.n_codebooks})")
        self.cfg, self.dec = cfg, dec
        self.codec_params, self.codec_cfg = codec_params, codec_cfg
        self.chunk_frames = chunk_frames
        # the emission granularity is the batched codec step's size
        self.first_chunk_frames = ((chunk_frames // 2 or 1)
                                   if first_chunk_frames is None
                                   else first_chunk_frames)
        self.warm_chunk = warm_chunk
        self._lane_codec = cstream.LaneDecoder(codec_params, codec_cfg,
                                               n_slots, dtype=codec_dtype)
        self._server = serve_mod.ContinuousBatcher(
            lm_params, cfg, dec, n_slots, sx_pad=sx_pad, p_pad=p_pad,
            num_task=1, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self._server.device

    # ------------------------------------------------------------- internals

    def _drain(self, lanes: List[Optional[_Lane]], now_fn, on_chunk) -> None:
        """Advance the batched codec until no lane has a full step pending
        (end-of-stream remainders flush padded). Every step is issued before
        the first output is copied, then the outputs are read in order, so
        the emission times follow when each chunk is ready."""
        f = self.first_chunk_frames
        hop = self.codec_cfg.hop_length
        K = self.cfg.n_codebooks
        S = len(lanes)
        plan = []  # per step: [(slot, emitted codes, skip, take)]
        outs = []
        while True:
            steps = []
            codes = np.zeros((S, K, f), np.int64)
            active = np.zeros((S,), bool)
            for slot, lane in enumerate(lanes):
                if lane is None:
                    continue
                pending = lane.queue.shape[1]
                if pending >= f:
                    take = f
                elif lane.eos and pending > 0:
                    take = pending
                else:
                    continue
                chunk = lane.queue[:, :take]
                if take < f:  # final flush: pad to the step size
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[:, -1:], f - take, axis=1)],
                        axis=1)
                codes[slot] = chunk
                active[slot] = True
                skip = min(lane.discard, take)
                steps.append((slot, chunk[:, skip:take], skip, take))
                lane.queue = lane.queue[:, take:]
                lane.discard -= skip
            if not steps:
                break
            outs.append(self._lane_codec.step(codes, active))
            plan.append(steps)
        for steps, out in zip(plan, outs):
            if all(take - skip <= 0 for _, _, skip, take in steps):
                continue  # prompt region only: nothing to emit
            wav = out.cpu().numpy()
            now = now_fn()
            for slot, c_emit, skip, take in steps:
                if take - skip <= 0:
                    continue  # still inside the prompt region
                lane = lanes[slot]
                w = wav[slot][skip * hop: take * hop]
                if lane.first_at is None:
                    lane.first_at = now
                lane.codes.append(c_emit)
                lane.wavs.append(w)
                if on_chunk is not None:
                    on_chunk(lane.req_idx, c_emit, w, now)

    # ------------------------------------------------------------------- API

    def projected_prompt_frames(self, wav) -> int:
        """Frames :meth:`encode_prompt` makes of ``wav`` (pad to the hop):
        admission-time geometry checks use this. Host work only."""
        n = np.asarray(wav).reshape(-1).shape[0]
        return max(1, -(-n // self.codec_cfg.hop_length))

    @torch.no_grad()
    def encode_prompt(self, wav, bucket_frames: int = 150) -> np.ndarray:
        """Encode a raw prompt waveform (mono float in [-1, 1] at the codec's
        rate) to codec tokens [K, F] on the device, for clients that send
        audio rather than codes. The frame count follows the pad-to-hop
        tokenizer contract; the wav is padded to a multiple of
        ``bucket_frames`` frames and the trailing frames are trimmed (the
        causal encoder's first frames do not see the padding). Call it from
        the thread that drives :meth:`serve_loop`: one thread owns the
        device."""
        from ..models.codec import wmencodec as wm

        wav = np.asarray(wav, np.float32).reshape(-1)
        hop = self.codec_cfg.hop_length
        frames = self.projected_prompt_frames(wav)
        bucket = -(-frames // bucket_frames) * bucket_frames
        padded = np.zeros((1, bucket * hop, 1), np.float32)
        padded[0, :len(wav), 0] = wav
        codes, _, _ = wm.encode(self.codec_params,
                                torch.from_numpy(padded).to(self.device),
                                self.codec_cfg)
        return codes.cpu().numpy()[0, :, :frames].astype(np.int32)

    def prepare_request(self, x, y_prompt) -> Tuple:
        """Normalize and validate one TTS request (text ids, prompt codes
        [K, T], T may be 0) on the host. Raises on geometry violations;
        returns the prepared tuple :meth:`serve_loop`'s ``poll`` supplies,
        so that callers reject a bad request at admission."""
        y_prompt = np.asarray(y_prompt, np.int32)
        T = y_prompt.shape[1]
        x = np.asarray(x, np.int32)
        pre = self._server.validate_request(x, y_prompt, [(T, T)])
        return (x, y_prompt, [(T, T)], pre)

    def serve_loop(self, poll, on_chunk=None, on_done=None,
                   generator: Optional[torch.Generator] = None, clock=None,
                   should_stop=None, on_idle=None, eager_prefill: int = 1):
        """Open-ended serving engine: pull requests, stream chunks.

        ``poll()`` returns ``(req_id, prepared)`` with ``prepared`` from
        :meth:`prepare_request`, or None when nothing is pending (with
        ``eager_prefill`` > 0 it may be called while every lane is busy, to
        prefill the next request behind the chunk; a polled request is
        committed and served FIFO). ``on_chunk(req_id, codes [K, f], wav
        [f*hop, ch], t)`` fires per emitted chunk; ``on_done(req_id, codes
        [K, T], wav, first_at, t)`` once per request with the concatenated
        stream (times in seconds on ``clock`` since the loop started). The
        loop returns when ``should_stop()`` is true and every lane is idle;
        ``on_idle(now)`` is called when no lane is active and ``poll``
        returned None (default: a 5 ms sleep)."""
        srv = self._server
        clock = clock or time.monotonic
        if generator is not None:
            srv.generator = generator
        S = srv.S
        K = self.cfg.n_codebooks
        F = self.chunk_frames
        if should_stop is None:
            should_stop = lambda: False
        if on_idle is None:
            on_idle = lambda now: time.sleep(0.005)
        t0 = clock()
        lanes: List[Optional[_Lane]] = [None] * S
        # requests polled and prefilled after a chunk, before the harvest;
        # a staged request is filled before newly polled ones
        staged: deque = deque()  # (req_id, _prefill_request result, y_prompt)

        def stage_pending():
            while len(staged) < eager_prefill:
                item = poll()
                if item is None:
                    return
                req_id, (x, y_prompt, mask, pre) = item
                staged.append(
                    (req_id, srv._prefill_request(x, y_prompt, mask, pre=pre),
                     y_prompt))

        def fill_free_lanes():
            reset_mask = np.zeros((S,), bool)
            warms = []
            for slot in range(S):
                if lanes[slot] is not None:
                    continue
                if staged:
                    req_id, st, y_prompt = staged.popleft()
                else:
                    item = poll()
                    if item is None:
                        break
                    req_id, (x, y_prompt, mask, pre) = item
                    st = srv._prefill_request(x, y_prompt, mask, pre=pre)
                srv._splice_slot(slot, req_id, st)
                warms.append((slot, req_id, y_prompt))
                reset_mask[slot] = True
            if reset_mask.any():
                self._lane_codec.reset(reset_mask)
            for slot, req_id, y_prompt in warms:
                # the prompt's bulk at batch 1, then its state into the
                # lane; the remainder (< warm_chunk) joins the step queue
                consumed = self._lane_codec.warm_lane(slot, y_prompt,
                                                      self.warm_chunk)
                lanes[slot] = _Lane(req_id, y_prompt[:, consumed:],
                                    y_prompt.shape[1] - consumed)

        while True:
            fill_free_lanes()
            if not any(lane is not None for lane in lanes):
                if should_stop():
                    return
                on_idle(clock() - t0)
                continue
            # snapshot, then run the chunk: the lanes are fed from the state
            # before it (JAX's pipelined order), while it has decoded ahead
            done_d = srv.state.done.clone()
            len_d = srv.state.out_len.clone()
            out_d = srv.state.out.clone()
            srv._run_chunk(F)
            if eager_prefill:
                stage_pending()
            done_h = done_d.cpu().numpy()
            len_h = len_d.cpu().numpy()
            out_h = out_d.cpu().numpy()
            for slot in range(S):
                lane = lanes[slot]
                if lane is None or lane.eos:
                    continue
                done = bool(done_h[slot])
                frames = _resolved_frames(out_h[slot], int(len_h[slot]), done,
                                          K)
                lane.eos = done
                new = frames[:, lane.resolved:]
                if new.shape[1]:
                    lane.queue = np.concatenate([lane.queue, new], axis=1)
                    lane.resolved = frames.shape[1]
            self._drain(lanes, lambda: clock() - t0, on_chunk)
            now = clock() - t0
            for slot in range(S):
                lane = lanes[slot]
                if lane is None or not lane.flushed:
                    continue
                codes = (np.concatenate(lane.codes, axis=1) if lane.codes
                         else np.zeros((K, 0), np.int32))
                wav = (np.concatenate(lane.wavs, axis=0) if lane.wavs
                       else np.zeros((0, 1), np.float32))
                if on_done is not None:
                    on_done(lane.req_idx, codes, wav, lane.first_at, now)
                lanes[slot] = None
                srv._slot_req[slot] = None
                srv._park(slot)

    def run_online(self, requests: Sequence[Tuple],
                   arrival_times: Sequence[float], on_chunk=None,
                   generator: Optional[torch.Generator] = None, clock=None,
                   eager_prefill: int = 1):
        """Serve TTS requests (each ``(x, y_prompt)``) arriving at
        ``arrival_times`` seconds after the call; each request's waveform
        streams through ``on_chunk(req_idx, codes [K, f], wav [f*hop, ch],
        t)`` as it becomes final. Returns ``(results, first_chunk_at,
        done_at)``: ``results[i]`` the concatenated ``(codes [K, T], wav
        [T*hop, ch])`` of the generated region, the first audio's and the
        last chunk's emission times (time to first audio is
        ``first_chunk_at[i] - arrival_times[i]``). ``clock`` is injectable
        for tests."""
        clock = clock or time.monotonic
        # fail fast on every request before any decoding
        norm = [self.prepare_request(x, y) for x, y in requests]
        order = sorted(range(len(requests)), key=lambda i: arrival_times[i])
        pending = deque((i, norm[i]) for i in order)
        results: List = [None] * len(requests)
        first_at: List = [None] * len(requests)
        done_at: List = [None] * len(requests)
        t0 = [None]  # serve_loop's clock origin (its first clock() call)

        def loop_clock():
            now = clock()
            if t0[0] is None:
                t0[0] = now
            return now

        def poll():
            if not pending:
                return None
            idx, prepared = pending[0]
            if arrival_times[idx] > loop_clock() - t0[0]:
                return None  # FIFO: the head has not arrived yet
            pending.popleft()
            return idx, prepared

        def on_idle(now):
            if pending:  # idle until the next arrival
                wait = arrival_times[pending[0][0]] - now
                if wait > 0:
                    time.sleep(wait)

        def on_done(idx, codes, wav, first, t):
            results[idx] = (codes, wav)
            first_at[idx] = first
            done_at[idx] = t

        self.serve_loop(poll, on_chunk=on_chunk, on_done=on_done,
                        generator=generator, clock=loop_clock,
                        should_stop=lambda: not pending, on_idle=on_idle,
                        eager_prefill=eager_prefill)
        return results, first_at, done_at
