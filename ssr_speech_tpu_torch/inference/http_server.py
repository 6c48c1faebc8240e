"""Stdlib HTTP streaming-TTS server over :meth:`stream.StreamingServer.
serve_loop` (port of ``ssr_speech_tpu/inference/http_server.py``).

    python -m ssr_speech_tpu_torch.inference.http_server --model_path lm.pkl \\
        --codec_path causal_codec.pkl --port 8080 --n_slots 8 --device cuda

  POST /tts   body JSON:
                ``text_ids``      [int]           phoneme ids, or
                ``text``          str             with a text frontend
                ``prompt_codes``  [[int] x K]     optional codec prompt
                                                  (omit or empty: cold TTS)
                ``prompt_wav``    base64 str      or raw prompt audio (s16le
                                                  mono PCM at the server's
                                                  rate), encoded to codec
                                                  tokens by the engine thread
              response: 200 ``audio/pcm;rate=R;encoding=s16le`` (signed
              16-bit little-endian mono PCM, not ``audio/L16``, which RFC 2586
              defines big-endian), streamed chunk by chunk as frames become
              final, with ``X-Sample-Rate`` / ``X-Frame-Rate`` /
              ``X-Request-Id`` headers; 400 with a JSON error for malformed
              or oversized requests, checked before admission.
  GET /health JSON {"status": ..., "lanes": N, counters}; 200 only while
              servable ("ok"), 503 when stopping or when the engine died.
  GET /       a browser demo page.

Handler threads (``ThreadingHTTPServer``) validate and enqueue on the host
and then block on a per-request emission queue; they touch no tensor on the
device. One engine thread drives ``serve_loop``: it owns the CUDA device and
its stream (``torch.cuda.set_device`` before its first launch), replays
its decode chunk's CUDA graphs (captured by the first requests that reach
each window), and all concurrency lives in the lane dimension of the
batched LM and codec calls.
A client that disconnects leaves its lane to finish its bounded utterance.
Responses are HTTP/1.0 close-delimited bodies, so the first PCM bytes leave
at the time to first audio.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time as time_mod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)

# tag of a raw-audio prompt not yet encoded, in the pending queue
# (compared by identity: a prepared request tuple starts with an ndarray)
_RAW_WAV = object()

# The browser demo served at GET /: type text or ids, hear the stream as it
# decodes. The JS plays the s16le body through WebAudio with a small jitter
# buffer and reports the time to first audio; __HAS_TEXT__ is filled in at
# request time.
DEMO_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ssr_speech_tpu_torch TTS</title><style>
body{font-family:system-ui,sans-serif;max-width:640px;margin:3em auto;padding:0 1em}
textarea,input{width:100%;box-sizing:border-box;font:inherit;padding:.5em}
button{font:inherit;padding:.5em 1.5em;margin-top:.7em;cursor:pointer}
#status{margin-top:1em;color:#444;white-space:pre-line}
small{color:#777}</style></head><body>
<h2>ssr_speech_tpu_torch &mdash; streaming TTS</h2>
<p><small>Audio plays while the LM decodes; the first chunk arrives at
time-to-first-audio, not at completion.</small></p>
<div id="textbox" style="display:__TEXT_DISPLAY__">
<label>Text<br><textarea id="text" rows="3">hello from the streaming tts server</textarea></label></div>
<div id="idsbox" style="display:__IDS_DISPLAY__">
<label>Phoneme ids (comma separated)<br><input id="ids" value="3,5,7,9,11,2,4"></label></div>
<button id="go">Speak</button>
<div id="status"></div>
<script>
const st = document.getElementById('status');
document.getElementById('go').onclick = async () => {
  const hasText = __HAS_TEXT__;
  const payload = hasText
    ? {text: document.getElementById('text').value}
    : {text_ids: document.getElementById('ids').value.split(',')
        .map(s => parseInt(s.trim(), 10)).filter(Number.isFinite)};
  st.textContent = 'requesting\\u2026';
  const t0 = performance.now();
  const ctx = new (window.AudioContext || window.webkitAudioContext)();
  let resp;
  try { resp = await fetch('/tts', {method: 'POST', body: JSON.stringify(payload)}); }
  catch (e) { st.textContent = 'fetch failed: ' + e; return; }
  if (!resp.ok) { st.textContent = 'error ' + resp.status + ': ' + await resp.text(); return; }
  const sr = parseInt(resp.headers.get('X-Sample-Rate') || '16000', 10);
  const reader = resp.body.getReader();
  let t = ctx.currentTime + 0.25, carry = new Uint8Array(0), total = 0, ttfa = null;
  while (true) {
    const {done, value} = await reader.read();
    if (done) break;
    if (ttfa === null) { ttfa = performance.now() - t0; }
    const merged = new Uint8Array(carry.length + value.length);
    merged.set(carry); merged.set(value, carry.length);
    const n = merged.length >> 1;
    const pcm = new Int16Array(merged.buffer.slice(0, n * 2));
    carry = merged.slice(n * 2);
    if (!n) continue;
    const f = Float32Array.from(pcm, v => v / 32768);
    const buf = ctx.createBuffer(1, f.length, sr);
    buf.getChannelData(0).set(f);
    const src = ctx.createBufferSource();
    src.buffer = buf; src.connect(ctx.destination);
    t = Math.max(t, ctx.currentTime);
    src.start(t); t += f.length / sr; total += f.length;
    st.textContent = 'first audio ' + ttfa.toFixed(0) + ' ms\\n'
      + (total / sr).toFixed(2) + ' s received';
  }
  st.textContent += '\\ndone (' + ((performance.now() - t0) / 1000).toFixed(2) + ' s wall)';
};
</script></body></html>
"""


def float_to_pcm16(wav: np.ndarray) -> bytes:
    """[-1, 1] float mono waveform -> s16le bytes (clipped)."""
    x = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
    return (x * 32767.0).round().astype("<i2").tobytes()


class TTSHttpServer:
    """HTTP front end for a :class:`~ssr_speech_tpu_torch.inference.stream.
    StreamingServer`.

    server: the StreamingServer (owns the LM and codec on their device).
    text_to_ids: optional ``str -> np.ndarray[int32]`` frontend enabling the
    JSON ``text`` field (e.g. ``pipeline.text_to_ids`` with a phonemizer +
    phn2num); without it only ``text_ids`` is accepted.
    sample_rate: advertised in ``X-Sample-Rate`` (the codec's rate).
    generator: the sampling stream the engine uses (default: the server's).
    on_done: optional ``(req_id, codes [K, T], wav [T*hop, ch])`` callback,
    run on the engine thread when a request's stream is complete.
    """

    def __init__(
        self,
        server,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        text_to_ids: Optional[Callable[[str], np.ndarray]] = None,
        sample_rate: int = 16000,
        generator=None,
        max_queue: int = 256,
        on_done: Optional[Callable] = None,
    ):
        self._srv = server
        self._text_to_ids = text_to_ids
        self._sample_rate = sample_rate
        self._generator = generator
        self._done_hook = on_done
        self._pending: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._emit = {}  # req_id -> per-request emission queue
        self._emit_lock = threading.Lock()
        self._next_id = 0
        # serving counters (reported by /health); guarded by _emit_lock
        self._stats = dict(admitted=0, completed=0, rejected=0, errors=0,
                           chunks=0, pcm_seconds=0.0)
        self._ttfa: list = []  # seconds from admission to first chunk
        self._admit_t = {}  # req_id -> admission clock time
        self._stop = threading.Event()
        self._engine_err: Optional[str] = None
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._engine = threading.Thread(target=self._run_engine,
                                        name="tts-engine", daemon=True)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="tts-http", daemon=True)

    # --------------------------------------------------------------- engine

    def _poll(self):
        try:
            req_id, prepared = self._pending.get_nowait()
        except queue.Empty:
            return None
        if prepared[0] is _RAW_WAV:
            # engine-thread prompt encode (admission geometry-checked the
            # projected frame count). Errors here — a transient device
            # failure, a shape the admission dummy could not foresee — must
            # fail THIS request, never the serving loop all clients share.
            _, x, wav = prepared
            try:
                codes = self._srv.encode_prompt(wav)
                prepared = self._srv.prepare_request(x, codes)
            except Exception as e:  # noqa: BLE001 - isolate the request
                logger.exception("prompt encode failed for request %s",
                                 req_id)
                q = self._q(req_id)
                if q is not None:
                    q.put(("error", f"{type(e).__name__}: {e}"))
                with self._emit_lock:
                    self._emit.pop(req_id, None)
                    self._admit_t.pop(req_id, None)
                    self._stats["errors"] += 1
                return None
        return req_id, prepared

    def _q(self, req_id):
        with self._emit_lock:
            return self._emit.get(req_id)

    def _on_chunk(self, req_id, codes, wav, t):
        q = self._q(req_id)
        if q is not None:
            q.put(("chunk", wav, t))
        with self._emit_lock:
            self._stats["chunks"] += 1
            self._stats["pcm_seconds"] += len(wav) / self._sample_rate
            t0 = self._admit_t.pop(req_id, None)
            if t0 is not None:
                self._ttfa.append(time_mod.monotonic() - t0)
                del self._ttfa[:-512]  # rolling window

    def _on_done(self, req_id, codes, wav, first_at, t):
        if self._done_hook is not None:  # before the client can see "done"
            self._done_hook(req_id, codes, wav)
        q = self._q(req_id)
        if q is not None:
            q.put(("done", first_at, t))
        with self._emit_lock:
            self._emit.pop(req_id, None)
            self._admit_t.pop(req_id, None)
            self._stats["completed"] += 1

    def _run_engine(self):
        try:
            # this thread owns the device and its stream: bind it before the
            # first launch (the flash kernel's tensor maps need the context)
            if self._srv.device.type == "cuda":
                import torch

                torch.cuda.set_device(self._srv.device)
            self._srv.serve_loop(
                self._poll, on_chunk=self._on_chunk, on_done=self._on_done,
                generator=self._generator, should_stop=self._stop.is_set)
        except Exception as e:  # pragma: no cover - defensive
            logger.exception("serving engine died")
            self._engine_err = f"{type(e).__name__}: {e}"
            with self._emit_lock:
                qs, self._emit = list(self._emit.values()), {}
                self._stats["errors"] += len(qs)
                self._admit_t.clear()
            for q in qs:
                q.put(("error", self._engine_err))

    # ------------------------------------------------------------ lifecycle

    @property
    def address(self):
        """(host, port) actually bound (port 0 resolves at construction)."""
        return self._httpd.server_address

    def start(self):
        self._engine.start()
        self._http_thread.start()
        return self

    def shutdown(self):
        """Stop accepting work, drain in-flight lanes, stop both threads."""
        self._stop.set()
        self._engine.join(timeout=60)
        # a request admitted in the set-stop window would otherwise wait on
        # a queue no engine will ever feed — wake every remaining waiter
        with self._emit_lock:
            qs, self._emit = list(self._emit.values()), {}
            self._stats["errors"] += len(qs)
            self._admit_t.clear()
        for q in qs:
            q.put(("error", "server stopped"))
        self._httpd.shutdown()
        self._http_thread.join(timeout=10)
        self._httpd.server_close()

    # ------------------------------------------------------------- handlers

    def _admit(self, payload):
        """Validate + enqueue one request. Returns (req_id, emit_queue);
        raises ValueError (400) / RuntimeError (503) with a client-facing
        message."""
        if self._engine_err:
            raise RuntimeError(self._engine_err)
        if self._stop.is_set():
            raise RuntimeError("server is shutting down")
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        if "text_ids" in payload:
            x = np.asarray(payload["text_ids"], np.int32)
            if x.ndim != 1:
                raise ValueError("text_ids must be a flat int list")
        elif "text" in payload:
            if self._text_to_ids is None:
                raise ValueError(
                    "server has no text frontend; send text_ids")
            x = np.asarray(self._text_to_ids(payload["text"]), np.int32)
        else:
            raise ValueError("need text_ids or text")
        K = self._srv.cfg.n_codebooks
        pc = payload.get("prompt_codes")
        pw = payload.get("prompt_wav")
        if pw is not None and pc not in (None, []):
            raise ValueError("send prompt_codes or prompt_wav, not both")
        if pw is not None:
            # raw prompt audio: base64 s16le mono PCM at the server's sample
            # rate. Validated + geometry-checked NOW (dummy codes of the
            # projected frame count); encoded to codec tokens by the ENGINE
            # thread at fill time: one thread owns the device.
            import base64
            import binascii

            try:
                raw = base64.b64decode(pw, validate=True)
            except (binascii.Error, TypeError, ValueError):
                raise ValueError("prompt_wav must be base64")
            if not raw or len(raw) % 2:
                raise ValueError("prompt_wav must be non-empty s16le PCM")
            wav = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
            # the codec's code space must fit the LM's audio vocab, else
            # fill-time codes would fail the range check the zero-valued
            # dummy passes (a server-config mismatch, not a client error)
            bins = self._srv.codec_cfg.rvq.bins
            if bins > self._srv.cfg.tokens.audio_vocab_size:
                raise ValueError(
                    f"server codec emits codes in [0, {bins}) but the LM "
                    f"audio vocab is {self._srv.cfg.tokens.audio_vocab_size}"
                    " — send prompt_codes, or fix the server bundles")
            frames = self._srv.projected_prompt_frames(wav)
            dummy = np.zeros((K, frames), np.int32)
            self._srv.prepare_request(x, dummy)  # raises on geometry
            prepared = (_RAW_WAV, x, wav)
        else:
            y = (np.zeros((K, 0), np.int32) if pc in (None, [])
                 else np.asarray(pc, np.int32))
            if y.ndim != 2 or y.shape[0] != K:
                raise ValueError(f"prompt_codes must be [{K}, T]")
            prepared = self._srv.prepare_request(x, y)  # raises on geometry
        q: "queue.Queue" = queue.Queue()
        with self._emit_lock:
            req_id = self._next_id
            self._next_id += 1
            self._emit[req_id] = q
            # stats BEFORE the queue insert: once the engine can see the
            # request it may emit chunks (or finish) immediately, and the
            # TTFA bookkeeping must already exist
            self._stats["admitted"] += 1
            self._admit_t[req_id] = time_mod.monotonic()

        def _rollback():
            with self._emit_lock:
                self._emit.pop(req_id, None)
                self._admit_t.pop(req_id, None)
                self._stats["admitted"] -= 1

        try:
            self._pending.put_nowait((req_id, prepared))
        except queue.Full:
            _rollback()
            raise ValueError("server queue full, retry later")
        # close the admit-vs-engine-death race: if the engine died between
        # the check at entry and our insert, its error broadcast may have
        # missed this queue — re-check and refuse instead of hanging a client
        if self._engine_err:
            _rollback()
            raise RuntimeError(self._engine_err)
        return req_id, q

    def _count(self, key: str):
        with self._emit_lock:
            self._stats[key] += 1

    def _make_handler(outer):  # noqa: N805 - closure over the server
        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.0: close-delimited streaming bodies, no chunked framing
            protocol_version = "HTTP/1.0"

            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    has_text = outer._text_to_ids is not None
                    page = (DEMO_HTML
                            .replace("__HAS_TEXT__", "true" if has_text
                                     else "false")
                            .replace("__TEXT_DISPLAY__",
                                     "block" if has_text else "none")
                            .replace("__IDS_DISPLAY__",
                                     "none" if has_text else "block")
                            ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                    return
                if self.path != "/health":
                    return self._json(404, {"error": "unknown path"})
                st = ("error" if outer._engine_err else
                      "stopping" if outer._stop.is_set() else "ok")
                with outer._emit_lock:
                    stats = dict(outer._stats)
                    ttfa = sorted(outer._ttfa)
                if ttfa:
                    stats["ttfa_p50_ms"] = round(
                        1e3 * ttfa[len(ttfa) // 2], 1)
                    stats["ttfa_p95_ms"] = round(
                        1e3 * ttfa[min(len(ttfa) - 1,
                                       int(0.95 * len(ttfa)))], 1)
                stats["pcm_seconds"] = round(stats["pcm_seconds"], 2)
                # non-200 when unservable so LB probes keyed on HTTP status
                # eject a dead/stopping instance
                self._json(200 if st == "ok" else 503, dict(
                    status=st, lanes=outer._srv._server.S,
                    pending=outer._pending.qsize(),
                    sample_rate=outer._sample_rate,
                    error=outer._engine_err, **stats))

            # generous bound: the largest legal request (p_pad codec frames
            # x K codebooks + sx_pad text ids as JSON ints) is ~100 KB; cap
            # well above that so a hostile Content-Length cannot OOM the host
            MAX_BODY = 16 << 20

            def do_POST(self):
                if self.path != "/tts":
                    return self._json(404, {"error": "unknown path"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n < 0:
                        # read(-1) would block until the client closes —
                        # a held socket pins a handler thread (DoS)
                        outer._count("rejected")
                        return self._json(
                            400, {"error": "invalid Content-Length"})
                    if n > self.MAX_BODY:
                        outer._count("rejected")
                        return self._json(
                            413, {"error": f"body exceeds {self.MAX_BODY} B"})
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    req_id, q = outer._admit(payload)
                except (ValueError, KeyError, TypeError, OverflowError,
                        json.JSONDecodeError) as e:
                    outer._count("rejected")
                    return self._json(400, {"error": str(e)})
                except RuntimeError as e:
                    outer._count("rejected")
                    return self._json(503, {"error": str(e)})
                self.send_response(200)
                # NOT audio/L16: RFC 2586 L16 is big-endian; the body is s16le
                self.send_header("Content-Type",
                                 "audio/pcm;rate=%d;encoding=s16le"
                                 % outer._sample_rate)
                self.send_header("X-Sample-Rate", str(outer._sample_rate))
                self.send_header("X-Frame-Rate",
                                 str(outer._srv.codec_cfg.frame_rate))
                self.send_header("X-Request-Id", str(req_id))
                self.end_headers()
                try:
                    while True:
                        try:
                            kind, *rest = q.get(timeout=30)
                        except queue.Empty:
                            # backstop for any residual admit-vs-exit race:
                            # a dead engine will never feed this queue
                            if not outer._engine.is_alive():
                                return
                            continue
                        if kind == "chunk":
                            self.wfile.write(float_to_pcm16(rest[0]))
                            self.wfile.flush()
                        elif kind == "done":
                            return
                        else:  # error
                            return  # body truncation signals the failure
                except (BrokenPipeError, ConnectionResetError):
                    # client went away: drop the emission queue; the lane
                    # finishes its (bounded) utterance and recycles
                    with outer._emit_lock:
                        outer._emit.pop(req_id, None)

        return Handler


def main(argv=None):
    """``python -m ssr_speech_tpu_torch.inference.http_server``: load the
    bundles, serve until SIGINT. The flags are the JAX server's plus
    ``--device`` (default ``cuda``; asking for it without a card is an
    error)."""
    import argparse

    import torch

    from ..config import DecodeConfig
    from ..data.tokenizer import TextTokenizer
    from ..device import resolve_device, set_precision_policy
    from ..models import pretrained
    from . import stream as stream_mod
    from .pipeline import text_to_ids as t2i

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cpu, cuda or cuda:N")
    p.add_argument("--model_path", required=True)
    p.add_argument("--codec_path", required=True,
                   help="a causal codec bundle")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--language", default="en", choices=["en", "zh"],
                   help="text-frontend phonemizer language (en-us / cmn)")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--n_slots", type=int, default=8)
    p.add_argument("--chunk_frames", type=int, default=25)
    p.add_argument("--sx_pad", type=int, default=128)
    p.add_argument("--p_pad", type=int, default=512)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--cfg_coef", type=float, default=1.5)
    p.add_argument("--cfg_stride", type=int, default=5)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(args.device)
    set_precision_policy()
    lm, cfg, phn2num = pretrained.load_lm(args.model_path, device)
    audio_tok = pretrained.load_codec(args.codec_path, device)
    dec = DecodeConfig(top_k=args.top_k, top_p=args.top_p,
                       temperature=args.temperature, cfg_coef=args.cfg_coef,
                       cfg_stride=args.cfg_stride, aug_text=True,
                       cfg_pretrained=True, stop_repetition=-1)
    server = stream_mod.StreamingServer(
        lm, cfg, dec, audio_tok.params, audio_tok.cfg, args.n_slots,
        chunk_frames=args.chunk_frames, sx_pad=args.sx_pad, p_pad=args.p_pad)
    tok = TextTokenizer(language="cmn" if args.language == "zh" else "en-us")
    http = TTSHttpServer(
        server, host=args.host, port=args.port,
        text_to_ids=lambda text: t2i(tok, phn2num, text),
        sample_rate=audio_tok.sample_rate,
        generator=torch.Generator(device=device).manual_seed(args.seed)
    ).start()
    logger.info("serving TTS on http://%s:%d (%d lanes)",
                *http.address, args.n_slots)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        http.shutdown()


if __name__ == "__main__":
    main()
