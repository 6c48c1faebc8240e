"""The port's span-and-counter recorder (``utils/profiler.py``) over the
served paths, on the CPU with a tiny LM (the port's own init, no JAX): the
span trees of ``generate``, ``generate_batch``, ``generate_multi`` and the
continuous server's ``run_online`` (names, nesting, one request identifier
per request, host times ordered); nothing recorded and no CUDA event made
without ``stats`` or a recording context; the server's per-request
timestamps on an injected clock and its ``lane_steps`` against a hand
count; the ``stats`` keys the readers read; the ring's limit; the codec's
and the trainer's spans; the names in a ``torch.profiler`` trace. On a
CUDA card (marker ``cuda``): a request's device spans on the anchored
host clock."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.config import (DecodeConfig, MaskingConfig,
                                         OptimConfig, SSRModelConfig,
                                         TokenSpace, TrainConfig)
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.inference import graphs
from ssr_speech_tpu_torch.inference import serve as tserve
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models.from_jax import lm_from_jax
from ssr_speech_tpu_torch.utils import profiler, prng

CFG = SSRModelConfig(d_model=64, nhead=4, num_layers=2, n_codebooks=4,
                     audio_embedding_dim=64, text_vocab_size=40,
                     tokens=TokenSpace(audio_vocab_size=32), head_hidden=32,
                     max_position=512)
DEC = DecodeConfig(top_k=1, top_p=1.0, temperature=1.0, stop_repetition=-1,
                   cfg_coef=1.5, cfg_stride=2, cfg_pretrained=True,
                   aug_text=True, max_gen_per_span=40, length_cap_mult=10)
GEOM = [(30, 20, [(8, 15)]), (24, 14, [(5, 12)]), (36, 25, [(20, 30)]),
        (28, 18, [(4, 9), (14, 20)])]
GENERATE = ["generate.prompt", "prefill", "decode", "decode.copy_out",
            "generate.assemble"]


@pytest.fixture(scope="module")
def lm():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lm_from_jax(tssr.init_ssr(prng.PRNGKey(0), CFG), CFG)
    torch.set_num_threads(n)


def _requests(n, seed=21):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.text_vocab_size - 1, size=(sx,)),
             rng.integers(0, CFG.tokens.audio_vocab_size, size=(4, T)), mask)
            for T, sx, mask in GEOM[:n]]


def _gen():
    return torch.Generator().manual_seed(0)


def _fake_clock(step=0.002):
    """A clock that advances ``step`` seconds at every reading."""
    ticks = itertools.count()
    return lambda: next(ticks) * step


def _new_roots(before):
    roots = profiler.roots()
    last = before[-1] if before else None
    i = next((j for j, r in enumerate(roots) if r is last), -1)
    return roots[i + 1:]


def _assert_nested(span):
    """Host times ordered: every child inside its parent, siblings one
    after another, the request identifier shared unless a child names its
    own."""
    assert span.t1 is not None and span.t0 <= span.t1
    prev = span.t0
    for c in span.children:
        assert c.parent is span
        assert prev <= c.t0 <= c.t1 <= span.t1
        prev = c.t1
        _assert_nested(c)


def _run(path, lm, stats):
    x, y, mask = _requests(1)[0]
    if path == "generate":
        return tdecode.generate(lm, CFG, DEC, x, y, mask, _gen(), stats=stats)
    if path == "generate_batch":
        return tdecode.generate_batch(lm, CFG, DEC, x, y, mask, _gen(), 2,
                                      stats=stats)
    return tdecode.generate_multi(lm, CFG, DEC, _requests(2), _gen(),
                                  stats=stats)


@pytest.mark.parametrize("path", ["generate", "generate_batch",
                                  "generate_multi"])
def test_generate_span_tree(lm, path):
    """One root ``generate`` a call, its children in order, the decode
    loop's replays and polls alternating, one request identifier."""
    before = profiler.roots()
    stats = {}
    _run(path, lm, stats)
    (root,) = _new_roots(before)
    assert root.name == "generate"
    assert [c.name for c in root.children] == GENERATE
    _assert_nested(root)
    assert {s.request for s in root.walk()} == {root.request}
    loop = root.children[2]
    names = [c.name for c in loop.children]
    replays = names.count("decode.replay")
    assert replays == -(-stats["decode_steps"] // graphs.UNROLL)
    # a poll after each replay but the one that reached the step bound
    assert names[::2] == ["decode.replay"] * replays
    assert names[1::2] == ["decode.poll"] * (len(names) - replays)
    assert len(names) - replays in (replays - 1, replays)
    assert root.attrs["decode_steps"] == stats["decode_steps"]
    assert root.attrs.get("prompt_len", 0) >= 0
    if path != "generate_multi":
        assert root.attrs["text_len"] == len(_requests(1)[0][0])
    for s in root.walk():  # host spans on the CPU
        assert s.device() is None and s.device_s() is None


def test_generate_stats_keys_keep_their_values(lm):
    """The keys ``stats`` had, with their meanings on the CPU: the
    prefill's span, the decode from its first replay to the copy-out,
    the step count, the token stream the run without ``stats`` samples."""
    x, y, mask = _requests(1)[0]
    before = profiler.roots()
    stats = {}
    got = tdecode.generate(lm, CFG, DEC, x, y, mask, _gen(), stats=stats)
    want = tdecode.generate(lm, CFG, DEC, x, y, mask, _gen())
    (root,) = _new_roots(before)
    assert set(stats) == {"prefill_s", "prefill_tokens", "decode_s",
                          "decode_steps", "out_tokens"}
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
    pre, loop, copy = root.children[1:4]
    assert stats["prefill_s"] == pre.host_s
    first = loop.children[0]
    assert stats["decode_s"] == (copy.t1 - first.t0) / 1e9
    assert 0 < stats["decode_s"] < root.host_s
    assert stats["prefill_tokens"] == 64 + 128
    assert 0 < stats["decode_steps"] <= stats["out_tokens"].shape[1]


def test_nothing_recorded_without_stats(lm):
    """Without ``stats`` and outside a recording context: no root, no
    span, no CUDA event, also for a span that names a CUDA device."""
    before, made = profiler.roots(), profiler.events_made()
    _run("generate", lm, None)
    srv = tserve.ContinuousBatcher(lm, CFG, DEC, 2, sx_pad=64, p_pad=128,
                                   num_task=2)
    srv.run_online(_requests(2), [0.0, 0.0], _gen(), clock=_fake_clock(),
                   chunk_steps=16)
    srv.run(_requests(2), _gen())
    with profiler.annotate("x", torch.device("cuda", 0)) as span:
        assert span is None
    assert _new_roots(before) == [] and len(profiler.roots()) == len(before)
    assert profiler.events_made() == made


def test_recording_context_records_without_stats(lm):
    before = profiler.roots()
    with profiler.recording():
        _run("generate", lm, None)
        with profiler.annotate("outer") as outer:
            _run("generate", lm, None)
    first, second = _new_roots(before)
    assert first.name == "generate" and "decode_steps" not in first.attrs
    assert [c.name for c in first.children] == GENERATE
    assert second is outer and [c.name for c in outer.children] == [
        "generate"]
    assert outer.children[0].request == outer.request != first.request


def _online(lm, reqs, arrivals, chunk_steps=7, eager_prefill=1):
    srv = tserve.ContinuousBatcher(lm, CFG, DEC, 2, sx_pad=64, p_pad=128,
                                   num_task=2)
    srv.stats = stats = {}
    before = profiler.roots()
    results, done_at = srv.run_online(reqs, arrivals, _gen(),
                                      clock=_fake_clock(),
                                      chunk_steps=chunk_steps,
                                      eager_prefill=eager_prefill)
    srv.stats = None
    (root,) = _new_roots(before)
    return results, done_at, stats, root


def test_run_online_span_tree(lm):
    """Root ``serve``; per request one ``serve.admit`` (with its
    ``prefill``), one ``serve.splice`` and one ``serve.harvest``, all under
    the request's own identifier; chunks hold the replays; every request's
    prefill device time (its host span on the CPU) in ``prefill_s``."""
    reqs = _requests(4)
    _, _, stats, root = _online(lm, reqs, [0.0, 0.0, 0.01, 0.05])
    assert root.name == "serve" and root.attrs["lanes"] == 2
    _assert_nested(root)
    top = {c.name for c in root.children}
    assert top <= {"serve.admit", "serve.splice", "serve.chunk", "serve.poll",
                   "serve.harvest", "serve.sleep"}
    assert {"serve.admit", "serve.splice", "serve.chunk", "serve.poll",
            "serve.harvest"} <= top
    by_request = {}
    for c in root.children:
        if c.name in ("serve.admit", "serve.splice", "serve.harvest"):
            by_request.setdefault(c.request, []).append(c.name)
            assert all(s.request == c.request for s in c.walk())
    assert len(by_request) == len(reqs)
    assert root.request not in by_request
    for names in by_request.values():
        assert sorted(names) == ["serve.admit", "serve.harvest",
                                 "serve.splice"]
        assert names.index("serve.admit") < names.index("serve.splice")
    admits = root.find("serve.admit")
    assert [c.name for a in admits for c in a.children] == ["prefill"] * 4
    assert stats["prefill_s"] == [a.children[0].host_s for a in admits]
    for chunk in root.find("serve.chunk"):
        assert {c.name for c in chunk.children} <= {"decode.replay",
                                                     "decode.poll"}
        assert chunk.children[0].name == "decode.replay"


def test_run_online_timestamps_on_the_fake_clock(lm):
    """``admit_at`` <= ``lane_at`` <= ``done_at`` and ``admit_at`` >= due
    for every request, each a reading of the clock the loop already read:
    two requests due at 0 are admitted at the fill's second and third
    readings (0.004, 0.006), each spliced at once."""
    reqs = _requests(4)
    arrivals = [0.0, 0.0, 0.01, 0.05]
    _, done_at, stats, _ = _online(lm, reqs, arrivals)
    assert stats["done_at"] == done_at
    for due, a, l, d in zip(arrivals, stats["admit_at"], stats["lane_at"],
                            done_at):
        assert due <= a <= l <= d
        for t in (a, l, d):
            assert abs(t / 0.002 - round(t / 0.002)) < 1e-6
    assert stats["admit_at"][:2] == stats["lane_at"][:2] == [0.004, 0.006]
    # the later two wait for a lane freed by the first two
    assert min(stats["lane_at"][2:]) >= min(done_at[:2])


def test_lane_steps_hand_count(lm):
    """Two requests through two lanes: ``lane_steps`` is the sum over
    chunks of busy lanes times steps (the chunk spans' counts), which is
    each request's own step count from ``generate`` summed."""
    reqs = _requests(4)[2:]
    _, _, stats, root = _online(lm, reqs, [0.0, 0.0], chunk_steps=16)
    hand = 0
    for chunk in root.find("serve.chunk"):
        hand += chunk.attrs["lanes"] * chunk.attrs["steps"]
    assert stats["lane_steps"] == hand > 0
    singles = []
    for x, y, mask in reqs:
        st = {}
        tdecode.generate(lm, CFG, DEC, x, y, mask, _gen(), stats=st)
        singles.append(st["decode_steps"])
    assert stats["lane_steps"] == sum(singles)
    assert stats["decode_steps"] == max(singles)


def test_run_stats_keys(lm):
    """``run``'s ``stats``: the keys it had, a prefill time a request."""
    srv = tserve.ContinuousBatcher(lm, CFG, DEC, 2, sx_pad=64, p_pad=128,
                                   num_task=2)
    stats = {}
    before = profiler.roots()
    srv.run(_requests(3), _gen(), stats=stats)
    (root,) = _new_roots(before)
    assert root.name == "serve"
    assert {"decode_steps", "decode_s", "chunks", "prefill_s",
            "prefill_layouts", "out_tokens", "done_at",
            "lane_steps"} <= set(stats)
    assert len(stats["prefill_s"]) == len(stats["prefill_layouts"]) == 3
    assert all(s > 0 for s in stats["prefill_s"])
    assert sorted(stats["out_tokens"]) == [0, 1, 2]


def test_ring_drops_the_oldest_root():
    with profiler.recording():
        with profiler.annotate("first"):
            pass
        first = profiler.roots()[-1]
        for i in range(profiler.RING):
            with profiler.annotate("r", i=i):
                pass
    roots = profiler.roots()
    assert len(roots) == profiler.RING and first not in roots
    assert [r.attrs["i"] for r in roots] == list(range(profiler.RING))


def test_codec_spans():
    from ssr_speech_tpu_torch.config import CodecConfig, RVQConfig, SEANetConfig
    from ssr_speech_tpu_torch.data.tokenizer import AudioTokenizer
    from ssr_speech_tpu_torch.models.codec import wmencodec
    from ssr_speech_tpu_torch.models.from_jax import codec_from_jax

    ccfg = CodecConfig(seanet=SEANetConfig(dimension=16, n_filters=4, lstm=1,
                                           ratios=(4, 2)),
                       rvq=RVQConfig(n_q=4, bins=32, dimension=16))
    params = codec_from_jax(wmencodec.init_wmencodec(prng.PRNGKey(1), ccfg),
                            ccfg)
    tok = AudioTokenizer(params, ccfg)
    wav = np.random.default_rng(0).standard_normal((1, 64, 1)).astype(
        np.float32)
    before = profiler.roots()
    codes, _, _ = tok.encode(wav)
    assert _new_roots(before) == []
    with profiler.recording():
        codes, _, _ = tok.encode(wav)
        marks = np.ones(codes.shape[::2], np.int64)
        tok.wmdecode(codes, marks, wav)
    enc, wmdec, copy = _new_roots(before)
    assert (enc.name, wmdec.name, copy.name) == (
        "codec.encode", "codec.wmdecode", "codec.copy_out")


def test_train_step_spans():
    """The trainer's step: one ``train.forward`` and ``train.backward`` a
    micro-batch and one ``train.update``, under the trainer's
    ``train_step`` span."""
    from ssr_speech_tpu_torch.models.from_jax import trainable_lm_from_jax
    from ssr_speech_tpu_torch.training import optim as toptim
    from ssr_speech_tpu_torch.training.trainer import make_train_step

    cfg = dataclasses.replace(
        CFG, trm_dropout=0.0, text_embedding_dropout=0.0,
        text_positional_embedding_dropout=0.0,
        audio_positional_embedding_dropout=0.0)
    tcfg = TrainConfig(precision="float32", gradient_accumulation_steps=2,
                       optim=OptimConfig(optimizer_name="adamw", lr=1e-3),
                       masking=MaskingConfig(predict_mask_token=True,
                                             predict_all=False))
    model = trainable_lm_from_jax(tssr.init_ssr(prng.PRNGKey(0), cfg), cfg)
    opt, _ = toptim.build_optimizer(tcfg.optim, total_steps=10)
    state = opt.init(model.tree())
    step = make_train_step(cfg, tcfg, opt, torch.device("cpu"))
    rng = np.random.default_rng(4)
    sy, sx = 24, 8
    batch = dict(
        x=rng.integers(0, cfg.text_vocab_size, size=(4, sx)).astype(np.int32),
        x_lens=np.array([sx, sx - 3, sx, 4], np.int32),
        y=rng.integers(0, cfg.tokens.audio_vocab_size,
                       size=(4, sy, cfg.n_codebooks)).astype(np.int32),
        y_lens=np.array([sy, 20, sy - 5, sy], np.int32))
    batch = {k: np.stack([v[0::2], v[1::2]]) for k, v in batch.items()}
    before = profiler.roots()
    with profiler.recording(), profiler.annotate("train_step"):
        m = step(model, state, batch, torch.Generator().manual_seed(0))
    assert m["skipped"] == 0.0
    (root,) = _new_roots(before)
    assert [c.name for c in root.children] == [
        "train.forward", "train.backward"] * 2 + ["train.update"]
    _assert_nested(root)


def test_profiler_trace_shows_the_span_names(lm):
    """Under ``torch.profiler`` every span enters ``record_function``, with
    or without recording."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run("generate", lm, None)
    names = {e.key for e in prof.key_averages()}
    assert set(GENERATE) | {"generate", "decode.replay",
                             "decode.poll"} <= names


@pytest.mark.cuda
def test_device_spans_on_the_anchored_clock():
    """On the card: a request's ``prefill`` device span ends before its
    first ``decode.replay`` begins, and both lie inside the host span of
    their ``generate``, on the host clock the anchor gives the events; the
    stats' prefill time is the prefill's device span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    gpu = lm_from_jax(tssr.init_ssr(prng.PRNGKey(0), CFG), CFG, device=dev)
    x, y, mask = _requests(1)[0]
    for _ in range(3):  # the first request captures
        stats = {}
        before = profiler.roots()
        tdecode.generate(gpu, CFG, DEC, x, y, mask,
                         torch.Generator(device=dev).manual_seed(0),
                         stats=stats)
        (root,) = _new_roots(before)
        pre = root.find("prefill")[0]
        replays = root.find("decode.replay")
        copy = root.find("decode.copy_out")[0]
        spans = [pre] + replays + [copy]
        times = [s.device() for s in spans]
        assert all(t is not None for t in times)
        assert times[0][1] <= times[1][0]
        for a, b in zip(times, times[1:]):
            assert a[0] <= a[1] <= b[0] <= b[1]
        assert root.t0 <= times[0][0] and times[-1][1] <= root.t1
        assert stats["prefill_s"] == pre.device_s()
