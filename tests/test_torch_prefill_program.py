"""The prefill and splice programs of the PyTorch port against
``ssr_speech_tpu``'s compiled ``_prefill_impl``, ``_prefill_multi_impl`` and
``_refill_impl``.

JAX compiles each once per shape, with the lengths and the slot traced. The
port runs them as programs over static buffers, the lengths and the slot as
device scalars (``graphs.GraphProgram``: a CUDA graph on one card, eager
here). Covered, both packages on the CPU in fp32 with the same parameters:
the one-prompt prefill at two (x_len, p_len) pairs through one workspace's
buffers, CFG-pretrained uncond rows on and off (K/V at every attended key
within 1e-6, a decode step's output within 1e-5, the ban and the fill
identical); the multi-prompt prefill at two ragged layouts through one
workspace's buffers, the second equal to a fresh eager call bit for bit;
the splice at slots 0 and S - 1, aug_text on and off, against JAX's (every
field bit for bit, every other slot untouched); and a program's accounting
of the flash forwards it captured, with CUDA's graph calls stubbed.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.inference import serve as jserve
from ssr_speech_tpu.models import transformer as jtrf
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.inference import graphs
from ssr_speech_tpu_torch.inference import serve as tserve
from ssr_speech_tpu_torch.models import transformer as ttrf
from ssr_speech_tpu_torch.ops import cuda_build
from ssr_speech_tpu_torch.ops import flash_attention as fa
from tests.test_torch_batched_decode import (CFG, TCFG, TS, _dec, models,
                                             one_torch_thread)
from tests.test_torch_hostcopies import port_config

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared

F32 = torch.float32
KV_TOL = dict(atol=1e-6, rtol=1e-6)
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
SX, P, TMAX = 64, 128, 256


def _rows(rng, x_len, cfg_pretrained):
    """[cond; uncond] text rows padded to SX: the uncond row the reserved
    token over x_len (cfg_pretrained) or random text."""
    x = np.full((2, SX), CFG.text_pad_token, np.int64)
    x[0, :x_len] = rng.integers(0, CFG.text_vocab_size - 1, size=x_len)
    if cfg_pretrained:
        x[1, :x_len] = CFG.text_vocab_size - 1
    else:
        x[1] = rng.integers(0, CFG.n_text_tokens, size=SX)
    return x


@pytest.mark.parametrize("cfg_pretrained", [True, False],
                         ids=["uncond_pretrained", "uncond_random"])
def test_prefill_program_matches_jax(models, cfg_pretrained):
    """Two requests of other lengths through one workspace's prefill
    program: each against JAX's ``_prefill_impl`` with traced lengths."""
    params, model = models
    dec = port_config(_dec(aug_text=True, cfg_pretrained=cfg_pretrained))
    ws = tdecode.single_workspace(model, TCFG, dec, rows=2, tmax=TMAX,
                                  num_task=1, cap_total=120, dtype=F32)
    rng = np.random.default_rng(4)
    bufs = None
    for x_len, p_len in ((41, 97), (23, 50)):
        x = _rows(rng, x_len, cfg_pretrained)
        prefix = np.full((CFG.n_codebooks, P), TS.empty, np.int64)
        prefix[:, :p_len] = rng.integers(0, TS.audio_vocab_size,
                                         size=(CFG.n_codebooks, p_len))
        jcache, jban = jdecode._prefill_impl(
            params, jnp.asarray(x, jnp.int32), jnp.asarray(prefix, jnp.int32),
            jnp.asarray(x_len, jnp.int32), jnp.asarray(p_len, jnp.int32),
            cfg=CFG, tmax=TMAX, dtype_name="float32",
            cfg_pretrained=cfg_pretrained, aug_text=True)
        got = tdecode._prefill_one(
            model, ws, dict(xb=x, prefix=prefix, x_len=x_len, p_len=p_len),
            cfg=TCFG, dec=dec, tmax=TMAX, dtype=F32)
        assert bufs is None or got is bufs  # the same static buffers
        bufs = got
        assert int(bufs["x_len"]) == x_len and int(bufs["p_len"]) == p_len
        np.testing.assert_array_equal(ws.banned.numpy(), np.asarray(jban))
        assert int(ws.pfx.length) == int(jcache.length) == SX + p_len
        n = SX + p_len
        for b, (lo, hi) in enumerate(np.asarray(jban)):
            keep = np.ones(n, bool)
            keep[lo:hi] = False
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(ws.pfx, name)[:, b, :, :n].numpy()[:, :, keep],
                    np.asarray(getattr(jcache, name))[:, b, :, :n][:, :, keep],
                    **KV_TOL, err_msg=name)
        h = rng.standard_normal((2, CFG.d_model)).astype(np.float32)
        jout, _ = jtrf.transformer_decode_step(params["decoder"], h, jcache,
                                               jban, CFG, dtype=jnp.float32)
        cache = ttrf.KVCache(ws.pfx.k.clone(), ws.pfx.v.clone(),
                             ws.pfx.length.clone())
        tout, _ = ttrf.transformer_decode_step(
            model["decoder"], torch.from_numpy(h), cache, ws.banned, TCFG,
            dtype=F32)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **OUT_TOL)
    # one program for both lengths (the workspace is kept per parameter
    # object, so the other case's program may sit beside it)
    assert sum(key[-1] == cfg_pretrained for key in ws.prefills) == 1


def _multi_inputs(seed, x_lens_s, p_lens):
    rng = np.random.default_rng(seed)
    S, K = len(p_lens), CFG.n_codebooks
    xs = np.full((2 * S, SX), CFG.text_pad_token, np.int64)
    for i, n in enumerate(x_lens_s):
        xs[i, :n] = rng.integers(0, CFG.text_vocab_size - 1, size=n)
        xs[S + i, :n] = CFG.text_vocab_size - 1
    prefix = np.full((S, K, P), TS.empty, np.int64)
    for i, n in enumerate(p_lens):
        prefix[i, :, :n] = rng.integers(0, TS.audio_vocab_size, size=(K, n))
    return (xs, prefix, np.asarray(list(x_lens_s) * 2, np.int64),
            np.asarray(p_lens, np.int64))


def test_prefill_multi_program_two_layouts(models):
    """Two ragged layouts of three prompts through one workspace's multi
    prefill program: each against JAX's ``_prefill_multi_impl`` on the
    attended keys, the ban identical; the second equal bit for bit to a
    fresh eager call (a new cache, nothing left of the first layout)."""
    params, model = models
    dec = port_config(_dec(aug_text=True, cfg_pretrained=True))
    ws = tdecode.shared_workspace(model, TCFG, dec, groups=6, n_chains=3,
                                  tmax=TMAX, banned_bool=True, num_task=1,
                                  cap_total=120, aug_text=True, dtype=F32)

    def fill(x, prefix, x_lens, p_lens):
        cache, _ = tdecode._prefill_multi_impl(
            model, x, prefix, x_lens, p_lens, cfg=TCFG, tmax=TMAX, dtype=F32,
            cfg_pretrained=True, aug_text=True, cache=ws.prefill_cache(),
            pe=ws.pe, banned=ws.banned)
        ws.pfx.length.copy_(cache.length)

    for seed, x_lens_s, p_lens in ((1, (20, 14, 25), (90, 60, 120)),
                                   (2, (33, 9, 17), (45, 128, 70))):
        xs, prefix, x_lens, p_lens = _multi_inputs(seed, x_lens_s, p_lens)
        ws.prefill(("multi", xs.shape, prefix.shape, True),
                   dict(x=xs, prefix=prefix, x_lens=x_lens, p_lens=p_lens),
                   fill)
        want, want_ban = jdecode._prefill_multi_impl(
            params, jnp.asarray(xs, jnp.int32), jnp.asarray(prefix, jnp.int32),
            jnp.asarray(x_lens, jnp.int32), jnp.asarray(p_lens, jnp.int32),
            cfg=CFG, tmax=TMAX, dtype_name="float32", cfg_pretrained=True,
            aug_text=True)
        np.testing.assert_array_equal(ws.banned.numpy(), np.asarray(want_ban))
        assert int(ws.pfx.length) == int(want.length) == SX + P
        live = ~ws.banned.numpy()
        for name in ("k", "v"):
            g = getattr(ws.pfx, name).numpy().transpose(1, 3, 0, 2, 4)[live]
            w = np.asarray(getattr(want, name)).transpose(1, 3, 0, 2, 4)[live]
            np.testing.assert_allclose(g, w, **KV_TOL, err_msg=name)
    fresh, fresh_ban = tdecode._prefill_multi_impl(
        model, torch.from_numpy(xs), torch.from_numpy(prefix),
        torch.from_numpy(x_lens), torch.from_numpy(p_lens), cfg=TCFG,
        tmax=TMAX, dtype=F32, cfg_pretrained=True, aug_text=True)
    assert torch.equal(ws.banned, fresh_ban)
    assert torch.equal(ws.pfx.k, fresh.k) and torch.equal(ws.pfx.v, fresh.v)
    assert sum(key[0] == "multi" for key in ws.prefills) == 1


# ------------------------------------------------------------- the splice

L, H, DH, TP, GC, NT, CAP = 2, 2, 8, 16, 8, 2, 12


def _serve_state(rng, S, R, K):
    ints = lambda *shape: rng.integers(0, 30, size=shape)  # noqa: E731
    return dict(
        cache_k=rng.standard_normal((L, R, H, GC, DH)).astype(np.float32),
        cache_v=rng.standard_normal((L, R, H, GC, DH)).astype(np.float32),
        y_pos=ints(S), next_tokens=ints(S, K), out=ints(S, K, CAP),
        out_len=ints(S), span_idx=ints(S), span_end=ints(S, NT),
        num_gen=ints(S), num_eog=ints(S), prev_token=ints(S),
        consec_silence=ints(S), num_cfg=ints(S), done=rng.random(S) < 0.5,
        gen_len=ints(R), active=rng.random(S) < 0.5)


FIELDS = ("y_pos", "next_tokens", "out", "out_len", "span_idx", "span_end",
          "num_gen", "num_eog", "prev_token", "consec_silence", "num_cfg",
          "done", "gen_len", "active")


def _port_state(st):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    for k in FIELDS:
        if t[k].dtype != torch.bool:
            t[k] = t[k].long()
    cache = ttrf.KVCache(t.pop("cache_k"), t.pop("cache_v"), 0)
    return tserve.ServeState(cache=cache, steps=torch.zeros(1, dtype=torch.long),
                             budget=torch.zeros(1, dtype=torch.long),
                             flag=torch.zeros(1, dtype=torch.bool), **t)


def _jax_state(st):
    j = {k: jnp.asarray(v if v.dtype == bool or v.dtype == np.float32
                        else v.astype(np.int32)) for k, v in st.items()}
    cache = jtrf.KVCache(j.pop("cache_k"), j.pop("cache_v"),
                         jnp.asarray(0, jnp.int32))
    return jserve.ServeState(cache=cache, key=jax.random.PRNGKey(0),
                             steps=jnp.asarray(0, jnp.int32), **j)


@pytest.mark.parametrize("aug_text", [True, False], ids=["cfg", "nocfg"])
def test_refill_matches_jax(aug_text):
    """The device-slot splice into slots 0 and S - 1 of a random state
    against JAX's ``_refill_impl`` (every field, the prefix cache rows and
    the ban bit for bit), every other slot's rows and fields untouched."""
    S, K = 3, 4
    R = 2 * S if aug_text else S
    n = 2 if aug_text else 1
    rng = np.random.default_rng(7)
    for slot in (0, S - 1):
        st = _serve_state(rng, S, R, K)
        pk = rng.standard_normal((L, R, H, TP, DH)).astype(np.float32)
        pv = rng.standard_normal((L, R, H, TP, DH)).astype(np.float32)
        ban = rng.random((R, TP)) < 0.5
        x_lens, n_tasks = rng.integers(1, 9, size=S), rng.integers(1, 3, size=S)
        nk = rng.standard_normal((L, n, H, TP, DH)).astype(np.float32)
        nv = rng.standard_normal((L, n, H, TP, DH)).astype(np.float32)
        nban = rng.random((n, TP)) < 0.5
        args = (5, 11, 1, TS.mts, TS.empty)  # x_len, p_len, n_task, sentinel0

        jst, jpfx, jban, jx, jn = jserve._refill_impl(
            _jax_state(st), jtrf.KVCache(jnp.asarray(pk), jnp.asarray(pv),
                                         jnp.asarray(TP, jnp.int32)),
            jnp.asarray(ban), jnp.asarray(x_lens, jnp.int32),
            jnp.asarray(n_tasks, jnp.int32), jnp.asarray(slot, jnp.int32),
            jtrf.KVCache(jnp.asarray(nk), jnp.asarray(nv),
                         jnp.asarray(TP, jnp.int32)),
            jnp.asarray(nban), *(jnp.asarray(a, jnp.int32) for a in args),
            aug_text=aug_text, n_slots=S)

        tst = _port_state(st)
        tpfx = ttrf.KVCache(torch.from_numpy(pk.copy()),
                            torch.from_numpy(pv.copy()), TP)
        tban = torch.from_numpy(ban.copy())
        tx, tn = torch.from_numpy(x_lens.copy()), torch.from_numpy(n_tasks.copy())
        dev = [torch.tensor(a) for a in (slot,) + args[:4]]  # device scalars
        tserve._refill_impl(
            tst, tpfx, tban, tx, tn, dev[0],
            ttrf.KVCache(torch.from_numpy(nk), torch.from_numpy(nv), 0),
            torch.from_numpy(nban), *dev[1:], TS.empty, aug_text=aug_text,
            n_slots=S)

        for name in FIELDS:
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(tpfx.k.numpy(), np.asarray(jpfx.k))
        np.testing.assert_array_equal(tpfx.v.numpy(), np.asarray(jpfx.v))
        np.testing.assert_array_equal(tban.numpy(), np.asarray(jban))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        # every other slot, and its rows, as they were
        others = [i for i in range(S) if i != slot]
        rows = [r for r in range(R) if r % S != slot]
        for name in FIELDS:
            keep = rows if name == "gen_len" else others
            np.testing.assert_array_equal(
                getattr(tst, name).numpy()[keep], np.asarray(st[name])[keep],
                err_msg=name)
        assert np.array_equal(tpfx.k.numpy()[:, rows], pk[:, rows])
        assert np.array_equal(tban.numpy()[rows], ban[rows])
        assert np.array_equal(tst.cache.k.numpy(), st["cache_k"])


# -------------------------------------------------- the launch accounting

class _StubGraph:
    fail = False

    def register_generator_state(self, generator):
        pass

    def replay(self):
        if self.fail:
            raise RuntimeError("replay refused")


class _Ctx:
    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _StubStream(_Ctx):
    def wait_stream(self, other):
        pass


def test_program_counts_the_flash_forwards_it_replays(monkeypatch):
    """A program whose function launches the flash forward 16 times (the
    counter logic of ``flash_forward``, driven here without a card): the
    warm-up counts 16, the capture none (it enqueues nothing), each replay
    16 more on the replaying thread; a failed replay raises."""
    monkeypatch.setattr(torch.cuda, "Stream", _StubStream)
    monkeypatch.setattr(torch.cuda, "stream", _Ctx)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _StubStream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _Ctx)
    fa.reset_launches()
    calls = []

    def fn():
        calls.append(1)
        for _ in range(16):
            cuda_build.launched(fa._count_forward)

    prog = graphs.GraphProgram(torch.device("cpu"), use_graphs=True)
    prog.run(fn)  # warm-up and capture
    assert len(calls) == 2 and prog.captures == 1 and prog.recorded.n == 16
    me = threading.current_thread().name
    assert fa.launches == 16 and fa.launches_by_thread == {me: 16}
    prog.run(fn)  # a replay: no Python call of fn
    assert len(calls) == 2 and prog.replays == 1 and fa.launches == 32
    worker = threading.Thread(target=prog.run, args=(fn,), name="engine")
    worker.start()
    worker.join()
    assert fa.launches == 48 and fa.launches_by_thread == {me: 32,
                                                           "engine": 16}
    prog.graph.fail = True
    with pytest.raises(RuntimeError, match="replay refused"):
        prog.run(fn)
    assert fa.launches == 48 and len(calls) == 2
    eager = graphs.GraphProgram(torch.device("cpu"), use_graphs=False)
    eager.run(fn)
    assert len(calls) == 3 and eager.captures == 0 and fa.launches == 64
    fa.reset_launches()


@pytest.mark.parametrize("kind", ["loop", "program"])
def test_graphs_count_every_kernel_they_replay(monkeypatch, kind):
    """A decode loop's window graph and a program each record the launches
    of every hand-written kernel their capture makes (here 2 flash forwards
    and 3 decode attentions, by the wrappers' counter logic, without a
    card) and add each kernel's to its own counter at every replay."""
    from ssr_speech_tpu_torch.ops import decode_attention as da

    monkeypatch.setattr(torch.cuda, "Stream", _StubStream)
    monkeypatch.setattr(torch.cuda, "stream", _Ctx)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: _StubStream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _Ctx)
    fa.reset_launches()
    da.reset_launches()
    calls = []

    def fn(*args):
        calls.append(1)
        for count, n in ((fa._count_forward, 2), (da._count, 3)):
            for _ in range(n):
                cuda_build.launched(count)

    cpu = torch.device("cpu")
    if kind == "loop":
        loop = graphs.GraphLoop(cpu, use_graphs=True)
        run, recorded = (lambda: loop.run(8, fn, None)), loop.recorded
    else:
        prog = graphs.GraphProgram(cpu, use_graphs=True)
        run, recorded = (lambda: prog.run(fn)), None
    run()  # warm-up and capture
    rec = recorded[8] if kind == "loop" else prog.recorded
    assert len(calls) == 2 and rec.n == 5
    assert (fa.launches, da.launches) == (2, 3)
    for n in (1, 2):  # replays: no Python call of fn
        run()
        assert len(calls) == 2
        assert (fa.launches, da.launches) == (2 + 2 * n, 3 + 3 * n)
    fa.reset_launches()
    da.reset_launches()
