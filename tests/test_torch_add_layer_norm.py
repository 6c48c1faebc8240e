"""Bias + residual + LayerNorm of the inference steps (``ops/add_layer_norm.py``)
on the CPU: the plain version against ``layer_norm`` and the adds it
replaces, the route by device, dtype and width (never by catching an error),
and the prefill and decode steps, whose loops carry the next layer's norm
across the layer boundary, against the unfused loop they had, bit for bit.
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.config import SSRModelConfig
from ssr_speech_tpu_torch.models import transformer as ttrf
from ssr_speech_tpu_torch.ops import add_layer_norm as aln

CFG = SSRModelConfig(d_model=64, nhead=4, num_layers=3)
DTYPES = [torch.float32, torch.bfloat16]


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _operands(dtype, d=64, rows=(3, 2), seed=0):
    rng = np.random.default_rng(seed)
    h, y = (_normal(rng, *rows, d).to(dtype) for _ in range(2))
    bias = _normal(rng, d, scale=0.1).to(dtype)
    w, b = 1 + _normal(rng, d, scale=0.2), _normal(rng, d, scale=0.2)
    return h, y, bias, w, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", aln.MODES)
def test_plain_version_is_layer_norm_after_the_adds(mode, dtype):
    """Each mode's h' is the steps' former residual expression and hn
    ``layer_norm`` of it, bit for bit."""
    h, y, bias, w, b = _operands(dtype)
    want_h = {aln.NORM: h,
              aln.BIAS_THEN_RESIDUAL: h + (y + bias.to(y.dtype)),
              aln.RESIDUAL_THEN_BIAS: (h + y) + bias}[mode]
    got_h, got_n = aln.plain_add_layer_norm(h, y, bias, w, b, mode)
    assert got_h.dtype == got_n.dtype == dtype
    assert torch.equal(got_h, want_h)
    assert torch.equal(got_n, ttrf.layer_norm(want_h, w, b))
    assert torch.equal(got_n, aln.layer_norm(want_h, w, b, 1e-5))


def _like(device, dtype, shape):
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=shape)


def test_route_by_device_dtype_and_width():
    """Every CUDA bf16 stream is the kernel's, whatever its width; the CPU
    and fp32 are the plain version's."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert aln.uses_kernel(_like("cuda", bf16, (2, 1, 2048)))
    assert aln.uses_kernel(_like("cuda", bf16, (1280, aln.MAX_D)))
    assert aln.uses_kernel(_like("cuda", bf16, (2, 1, 2044)))
    assert aln.uses_kernel(_like("cuda", bf16, (2, aln.MAX_D + 8)))
    assert not aln.uses_kernel(_like("cpu", bf16, (2, 1, 2048)))
    assert not aln.uses_kernel(_like("cuda", f32, (2, 1, 2048)))


@pytest.mark.parametrize("d,norm_dtype", [(2044, torch.float32),
                                          (aln.MAX_D + 8, torch.float32),
                                          (2048, torch.bfloat16)])
def test_route_refuses_a_cuda_stream_the_kernel_cannot_take(monkeypatch, d,
                                                            norm_dtype):
    """A CUDA bf16 stream at a width the kernel does not take, or with norm
    weights that are not fp32, raises through the route before any build:
    it is never quietly the plain chain."""
    def refuse(*args, **kw):
        raise AssertionError("a refused call reached the kernel")

    monkeypatch.setattr(aln, "load_kernel", refuse)
    monkeypatch.setattr(aln, "plain_add_layer_norm", refuse)
    h = _like("cuda", torch.bfloat16, (2, 1, d))
    w = _like("cuda", norm_dtype, (d,))
    with pytest.raises(ValueError):
        aln.add_layer_norm(h, None, None, w, w, aln.NORM)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 60)])
def test_cpu_takes_the_plain_version(monkeypatch, dtype, d):
    """A CPU call, bf16 or fp32, at a width the kernel takes or not: the
    plain version, the kernel never asked for and nothing counted."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel was asked for on the CPU")

    monkeypatch.setattr(aln, "kernel_add_layer_norm", refuse)
    monkeypatch.setattr(aln, "load_kernel", refuse)
    aln.reset_launches()
    for mode in aln.MODES:
        args = _operands(dtype, d)
        got = aln.add_layer_norm(*args, mode)
        want = aln.plain_add_layer_norm(*args, mode)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert aln.launches == 0


def test_kernel_entry_refuses_what_it_cannot_take(monkeypatch):
    """The kernel's own entry raises, before any build, on a tensor off the
    card and on an unknown mode."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel was built for a refused call")

    monkeypatch.setattr(aln, "load_kernel", refuse)
    args = _operands(torch.bfloat16)
    with pytest.raises(ValueError):
        aln.kernel_add_layer_norm(*args, aln.NORM)
    with pytest.raises(ValueError):
        aln.kernel_add_layer_norm(*args, "bias_last")
    with pytest.raises(ValueError):
        aln.add_layer_norm(*args, "bias_last")


# ------------------------------------------------- the steps' layer loops


def _unfused_layers(params, layers, h, attend, act, par, nhead):
    """The loop the prefill and decode steps had: a ``layer_norm`` at the
    top of each layer, ``h + (y + b)``, ``layer_norm``, the FFN and
    ``(h + y) + b2``, the final ``layer_norm`` after the loop."""
    assert par is None
    for l, lp in enumerate(layers):
        hn = ttrf.layer_norm(h, lp["ln1_w"], lp["ln1_b"])
        attn = attend(l, *ttrf._qkv(lp, hn, nhead))
        h = h + ttrf._linear(attn, lp["out_w"], lp["out_b"])
        hn = ttrf.layer_norm(h, lp["ln2_w"], lp["ln2_b"])
        ff = act(ttrf._linear(hn, lp["ffn1_w"], lp["ffn1_b"]))
        h = h + ff @ lp["ffn2_w"] + lp["ffn2_b"]
    return ttrf.layer_norm(h, params["final_ln_w"], params["final_ln_b"])


def _params(dtype, seed=1):
    """Random decoder weights, the norms' scales and shifts drawn too (so
    that a norm carried to the wrong place shows); matmul tensors in
    ``dtype``, norms fp32 as the serving path stores them."""
    rng = np.random.default_rng(seed)
    L, d, f = CFG.num_layers, CFG.d_model, CFG.ffn_dim
    shapes = dict(ln1_w=(L, d), ln1_b=(L, d), qkv_w=(L, d, 3 * d),
                  qkv_b=(L, 3 * d), out_w=(L, d, d), out_b=(L, d),
                  ln2_w=(L, d), ln2_b=(L, d), ffn1_w=(L, d, f),
                  ffn1_b=(L, f), ffn2_w=(L, f, d), ffn2_b=(L, d))
    layers = {k: _normal(rng, *s, scale=0.2) + (1.0 if k.endswith("_w")
                                                and k.startswith("ln") else 0)
              for k, s in shapes.items()}
    for k in ttrf.MATMUL_KEYS:
        layers[k] = (layers[k] / 2).to(dtype)
    return dict(layers=layers, final_ln_w=1 + _normal(rng, d, scale=0.2),
                final_ln_b=_normal(rng, d, scale=0.2))


def _run_path(path, params, dtype):
    """One call of ``path`` from fixed inputs; returns every tensor it
    produced or wrote (outputs and caches)."""
    rng = np.random.default_rng(2)
    L, H, dh, d = CFG.num_layers, CFG.nhead, CFG.head_dim, CFG.d_model
    b = 4

    def cache(rows, n, length):
        return ttrf.KVCache(*(_normal(rng, L, rows, H, n, dh).to(dtype)
                              for _ in range(2)), length)

    if path == "prefill":
        s = 12
        c = ttrf.init_kv_cache(CFG, b, 16, dtype=dtype)
        valid = torch.ones((b, s), dtype=torch.int32)
        valid[1, 2:5] = 0
        out, c = ttrf.transformer_prefill(params, _normal(rng, b, s, d), c,
                                          CFG, key_valid=valid, dtype=dtype)
        return out, c.k, c.v
    h = _normal(rng, b, d)
    if path == "single":
        c = cache(b, 16, 9)
        banned = torch.tensor([[2, 4], [0, 0], [3, 9], [1, 2]])
        out, c = ttrf.transformer_decode_step(params, h, c, banned, CFG,
                                              dtype=dtype, window=12)
        return out, c.k, c.v
    if path == "shared":
        pfx, gen = cache(2, 10, 8), cache(b, 8, 3)
        banned = torch.tensor([[1, 3], [0, 0]])
        out, gen = ttrf.transformer_decode_step_shared(
            params, h, pfx, gen, banned, CFG, n_groups=2, dtype=dtype,
            window=6)
        return out, gen.k, gen.v
    pfx, gen = cache(b, 10, 10), cache(b, 8, 0)
    banned = torch.from_numpy(rng.random((b, 10)) < 0.3)
    banned[:, 0] = False
    out, gen = ttrf.transformer_decode_step_paged(
        params, h, pfx, gen, banned, torch.tensor([5, 0, 7, 2]), CFG,
        dtype=dtype, read_len=8)
    return out, gen.k, gen.v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", ["prefill", "single", "shared", "paged"])
def test_steps_match_the_unfused_loop(monkeypatch, path, dtype):
    """Each step with its norms carried across the loop (``ops.add_layer_norm``
    a chain) against the same step run through the unfused loop: the output
    and every cache written, bit for bit."""
    params = _params(dtype)
    got = _run_path(path, params, dtype)
    monkeypatch.setattr(ttrf, "_inference_layers", _unfused_layers)
    want = _run_path(path, params, dtype)
    assert got[0].dtype == dtype
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("path", ["prefill", "single", "shared", "paged"])
def test_each_step_calls_it_2l_plus_1_times(monkeypatch, path):
    """Layer 0's norm, two chains a layer (the last one with the final
    norm): 2L + 1 calls a step, whatever the route."""
    calls = []
    real = aln.add_layer_norm

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(aln, "add_layer_norm", spy)
    _run_path(path, _params(torch.float32), torch.float32)
    L = CFG.num_layers
    assert calls == ([aln.NORM] + [aln.BIAS_THEN_RESIDUAL,
                                   aln.RESIDUAL_THEN_BIAS] * L)


def test_the_mla_block_never_calls_it(monkeypatch):
    """The MLA + MoE block (its own RMS norms) decodes a request without
    one call."""
    from ssr_speech_tpu_torch.inference import decode
    from ssr_speech_tpu_torch.models import mla_moe
    from tests.test_torch_mla_moe import CFG as MLA_CFG
    from tests.test_torch_mla_moe import DEC, _request

    def refuse(*args, **kw):
        raise AssertionError("add_layer_norm called by the MLA block")

    monkeypatch.setattr(aln, "add_layer_norm", refuse)
    tree = mla_moe.init_params(torch.Generator().manual_seed(3), MLA_CFG)
    model = mla_moe.lm_from_tree(tree, MLA_CFG)
    stats = {}
    decode.generate(model, MLA_CFG, DEC, *_request(4),
                    torch.Generator().manual_seed(0), stats=stats)
    assert stats["decode_steps"] > 0
