"""The port's HTTP streaming-TTS server (``inference/http_server.py``) on the
CPU: the cases of tests/test_http_server.py. Admission validation, health
and its counters, the demo page, PCM streamed before completion, concurrent
clients each equal to the port's offline generate -> causal decode -> crop
(to 16-bit rounding), a raw-wav prompt against its codes, and a client that
disconnects freeing its lane. The engine thread is the only one that runs
the model: the handler threads only validate on the host."""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu_torch.inference import stream as tstream
from ssr_speech_tpu_torch.inference.http_server import (TTSHttpServer,
                                                        float_to_pcm16)
from ssr_speech_tpu_torch.models.from_jax import codec_from_jax
from tests.test_http_server import CODEC, DEC
from tests.test_torch_batched_decode import (CFG, TCFG, models,
                                             one_torch_thread)
from tests.test_torch_hostcopies import port_config
from tests.test_torch_stream_tts import _offline

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared


@pytest.fixture(scope="module")
def http_srv(models):
    """A 2-lane port server on 127.0.0.1:0 over the JAX tests' tiny LM and
    causal codec; ``done`` collects the engine's own finished waveforms."""
    _, lm = models
    codec = codec_from_jax(jax.tree.map(
        np.asarray, jwm.init_wmencodec(jax.random.PRNGKey(1), CODEC)),
        port_config(CODEC))
    server = tstream.StreamingServer(lm, TCFG, port_config(DEC), codec,
                                     port_config(CODEC), 2, chunk_frames=16,
                                     sx_pad=64, p_pad=64)
    done, threads = {}, set()

    def on_done(req_id, codes, wav):
        done[req_id] = wav
        threads.add(threading.current_thread().name)

    srv = TTSHttpServer(server, port=0, sample_rate=16000,
                        generator=torch.Generator().manual_seed(5),
                        on_done=on_done).start()
    srv.done, srv.done_threads = done, threads
    yield srv, lm, codec
    srv.shutdown()


def _post_tts(addr, payload):
    """POST /tts, return (status, headers, pcm_bytes, read_times)."""
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request("POST", "/tts", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    chunks, times = [], []
    while True:
        b = resp.read1(65536) if hasattr(resp, "read1") else resp.read(65536)
        if not b:
            break
        chunks.append(b)
        times.append(time.monotonic())
    conn.close()
    return resp.status, dict(resp.getheaders()), b"".join(chunks), times


def _offline_pcm(lm, codec, x, y_prompt):
    """The port's offline TTS waveform of the request (float)."""
    return _offline(lm, codec, DEC, x, y_prompt)[1]


def test_health(http_srv):
    srv, _, _ = http_srv
    conn = http.client.HTTPConnection(*srv.address, timeout=30)
    conn.request("GET", "/health")
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200 and body["status"] == "ok"
    assert body["lanes"] == 2 and body["sample_rate"] == 16000
    for k in ("admitted", "completed", "rejected", "errors", "chunks",
              "pcm_seconds"):
        assert k in body, k


def test_health_counters_advance(http_srv):
    """After a served request, /health shows it admitted+completed with
    TTFA percentiles and PCM seconds accounted."""
    srv, _, _ = http_srv
    rng = np.random.default_rng(23)
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(20,))
    status, _, pcm, _ = _post_tts(srv.address, {"text_ids": x.tolist()})
    assert status == 200
    deadline = time.time() + 30
    while time.time() < deadline:  # done-callback races the body close
        conn = http.client.HTTPConnection(*srv.address, timeout=30)
        conn.request("GET", "/health")
        body = json.loads(conn.getresponse().read())
        if body["completed"] >= 1:
            break
        time.sleep(0.1)
    assert body["admitted"] >= 1 and body["completed"] >= 1
    assert body["chunks"] >= 1 and body["pcm_seconds"] > 0
    assert "ttfa_p50_ms" in body and body["ttfa_p50_ms"] > 0


def test_demo_page(http_srv):
    """GET / serves the browser demo; with no text frontend the ids box is
    shown and the JS is told hasText=false."""
    srv, _, _ = http_srv
    conn = http.client.HTTPConnection(*srv.address, timeout=30)
    conn.request("GET", "/")
    resp = conn.getresponse()
    body = resp.read().decode()
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("text/html")
    assert "<html" in body and "/tts" in body
    assert "const hasText = false" in body  # fixture has no text frontend
    assert 'id="idsbox" style="display:block"' in body


def test_rejects_bad_requests(http_srv):
    srv, _, _ = http_srv
    for payload, msg in [
        ({}, "need text_ids"),
        ({"text": "hi"}, "no text frontend"),
        ({"text_ids": [[1, 2]]}, "flat int list"),
        ({"text_ids": [1] * 200}, "exceeds server geometry"),
        ({"text_ids": [1, 2], "prompt_codes": [[1, 2]]}, "prompt_codes"),
    ]:
        status, _, body, _ = _post_tts(srv.address, payload)
        assert status == 400, payload
        assert msg in json.loads(body)["error"]
    # unknown paths
    conn = http.client.HTTPConnection(*srv.address, timeout=30)
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404
    # oversize body rejected by Content-Length BEFORE reading it
    conn = http.client.HTTPConnection(*srv.address, timeout=30)
    conn.putrequest("POST", "/tts")
    conn.putheader("Content-Length", str(64 << 20))
    conn.endheaders()
    assert conn.getresponse().status == 413
    # negative Content-Length must not become a blocking read(-1)
    conn = http.client.HTTPConnection(*srv.address, timeout=30)
    conn.putrequest("POST", "/tts")
    conn.putheader("Content-Length", "-1")
    conn.endheaders()
    assert conn.getresponse().status == 400
    # non-object JSON bodies are a 400, not a handler crash
    for raw in (b"123", b'"text_ids"', b"[1,2,3]", b"{not json"):
        conn = http.client.HTTPConnection(*srv.address, timeout=30)
        conn.request("POST", "/tts", raw,
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400, raw
    # ints that overflow int32 conversion are a 400 too
    status, _, body, _ = _post_tts(srv.address, {"text_ids": [2 ** 70]})
    assert status == 400


def test_http_streams_before_completion(http_srv):
    """One request with a prompt: streamed PCM equals the offline pipeline
    to 16-bit quantization, and bytes arrive over MULTIPLE reads (the body
    streams as frames become final, it is not buffered to completion)."""
    srv, lm, codec = http_srv
    rng = np.random.default_rng(3)
    ts = CFG.tokens
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(40,))
    y = rng.integers(0, ts.audio_vocab_size, size=(CFG.n_codebooks, 24))
    status, headers, pcm, times = _post_tts(
        srv.address, {"text_ids": x.tolist(), "prompt_codes": y.tolist()})
    assert status == 200
    assert headers["Content-Type"] == "audio/pcm;rate=16000;encoding=s16le"
    assert headers["X-Sample-Rate"] == "16000"
    got = np.frombuffer(pcm, "<i2")
    assert got.size > 0

    # greedy decoding: the served stream equals the offline one
    want = float_to_pcm16(_offline_pcm(lm, codec, x, y))
    want = np.frombuffer(want, "<i2")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2)  # 16-bit rounding slack

    assert len(times) >= 2, "body arrived in one read: not streaming"


def test_concurrent_clients_parity(http_srv):
    """Two concurrent clients (+ an empty-prompt request) each get their own
    offline-parity stream through the 2-lane server, the PCM of the
    engine's own finished waveform, which only the engine thread made."""
    srv, lm, codec = http_srv
    rng = np.random.default_rng(7)
    ts = CFG.tokens
    reqs = []
    for T, sx in [(24, 40), (0, 28), (17, 36)]:
        x = rng.integers(0, CFG.text_vocab_size - 1, size=(sx,))
        y = rng.integers(0, ts.audio_vocab_size, size=(CFG.n_codebooks, T))
        reqs.append((x, y))

    outs = [None] * len(reqs)

    def client(i):
        x, y = reqs[i]
        status, headers, pcm, _ = _post_tts(
            srv.address, {"text_ids": x.tolist(),
                          "prompt_codes": y.tolist()})
        outs[i] = (status, pcm, int(headers["X-Request-Id"]))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, (x, y) in enumerate(reqs):
        status, pcm, req_id = outs[i]
        assert status == 200
        assert pcm == float_to_pcm16(srv.done[req_id])
        got = np.frombuffer(pcm, "<i2")
        want = np.frombuffer(
            float_to_pcm16(_offline_pcm(lm, codec, x, y)), "<i2")
        assert got.shape == want.shape, f"req {i}"
        np.testing.assert_allclose(got, want, atol=2)
    assert srv.done_threads == {"tts-engine"}


def test_prompt_wav_matches_prompt_codes(http_srv):
    """A raw base64 PCM prompt must produce exactly the stream that posting
    its on-device encoding as prompt_codes produces (the engine thread runs
    the same encode_prompt), and malformed/conflicting wavs are 400s."""
    import base64

    srv, lm, codec = http_srv
    rng = np.random.default_rng(17)
    ts = CFG.tokens
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(36,))
    hop = CODEC.hop_length
    wav = (rng.normal(size=(hop * 10 - 3,)) * 0.1).astype(np.float32)
    pcm = np.clip(wav * 32767, -32768, 32767).astype("<i2").tobytes()

    status, _, got, _ = _post_tts(srv.address, {
        "text_ids": x.tolist(),
        "prompt_wav": base64.b64encode(pcm).decode()})
    assert status == 200 and len(got)

    codes = srv._srv.encode_prompt(np.frombuffer(pcm, "<i2")
                                   .astype(np.float32) / 32768.0)
    assert codes.shape == (CFG.n_codebooks, 10)  # pad-to-hop frame count
    status2, _, want, _ = _post_tts(srv.address, {
        "text_ids": x.tolist(), "prompt_codes": codes.tolist()})
    assert status2 == 200
    assert got == want

    # malformed / conflicting prompts are admission-time 400s
    for bad in [{"prompt_wav": "!!!not-base64!!!"},
                {"prompt_wav": base64.b64encode(b"abc").decode()},  # odd len
                {"prompt_wav": base64.b64encode(pcm).decode(),
                 "prompt_codes": codes.tolist()},
                {"prompt_wav": base64.b64encode(b"\0" * 2 * hop * 2000)
                 .decode()}]:  # oversize vs server geometry
        status, _, body, _ = _post_tts(srv.address,
                                       {"text_ids": x.tolist(), **bad})
        assert status == 400, (bad.keys(), body)


def test_client_disconnect_frees_lane(http_srv):
    """A client that drops mid-stream must not wedge the engine: its lane
    finishes the (bounded) utterance, the dead socket's BrokenPipe drops the
    emission queue, and a SUBSEQUENT request is served normally."""
    srv, lm, codec = http_srv
    rng = np.random.default_rng(11)
    ts = CFG.tokens
    x = rng.integers(0, CFG.text_vocab_size - 1, size=(40,))
    y = rng.integers(0, ts.audio_vocab_size, size=(CFG.n_codebooks, 24))

    # raw socket: send the request, read ONLY the status line, slam shut
    import socket

    body = json.dumps({"text_ids": x.tolist(),
                       "prompt_codes": y.tolist()}).encode()
    sock = socket.create_connection(srv.address, timeout=120)
    sock.sendall(b"POST /tts HTTP/1.0\r\nContent-Type: application/json\r\n"
                 + b"Content-Length: %d\r\n\r\n" % len(body) + body)
    head = sock.recv(64)
    assert head.startswith(b"HTTP/1.0 200"), head
    sock.close()  # mid-stream disconnect (before the body drains)

    # the engine must still serve the next client with exact parity
    status, _, pcm, _ = _post_tts(
        srv.address, {"text_ids": x.tolist(), "prompt_codes": y.tolist()})
    assert status == 200
    got = np.frombuffer(pcm, "<i2")
    want = np.frombuffer(
        float_to_pcm16(_offline_pcm(lm, codec, x, y)), "<i2")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2)
    # and the dropped request's emission queue must be gone (no leak)
    deadline = time.monotonic() + 60
    while srv._emit and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not srv._emit, "disconnected request's emission queue leaked"
