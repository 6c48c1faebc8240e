"""The port's int8 weight-streaming matvecs against the TPU probe kernels.

On the CPU the port's wrappers take their plain versions
(``ssr_speech_tpu_torch/ops/int8_matmul.py``: ``reference_*``); the CUDA
kernels are held against those plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here the plain versions are
held against the Pallas kernels themselves, run in interpret mode on the same
seeded numpy inputs at a small size (D = 128, F = 512, 3 layers):

- ``tools/int8_matmul.py`` imports cleanly: ``int8_matmul(interpret=True)``,
  ``int8_matmul_reference`` and ``quantize_weight`` (bit for bit);
- ``tools/int8_kernel_probe2.py`` and ``..._probe3.py`` benchmark on a TPU at
  import and have no interpret switch, so only their function definitions
  (``make``; ``kern`` and ``mega``) are taken from the parsed source and run
  with small ``D, F, L, BN`` and a ``pl`` whose ``pallas_call`` interprets.

Tolerances: the int8 mode and the megakernel equal the interpreted kernel
after the bf16 cast up to one bf16 ulp of the max (2^-8 relative: the int32
sums are exact, only the last fp32 product's rounding can differ); the fp32
and bf16 modes within 2e-2 of the max (fp32 summation order, amplified by the
bf16 rounding between layers).
"""

import ast
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ssr_speech_tpu_torch import int8_probe
from ssr_speech_tpu_torch.models.from_jax import int8_ffn_from_jax
from ssr_speech_tpu_torch.ops import int8_matmul as ti8

TOOLS = Path(__file__).resolve().parent.parent / "tools"
D, F, L, BN = 128, 512, 3, 128
ULP = 2.0 ** -8  # one bf16 ulp relative to the max
REL = 2e-2


def _load_tools_int8_matmul():
    spec = importlib.util.spec_from_file_location("tools_int8_matmul",
                                                  TOOLS / "int8_matmul.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jm = _load_tools_int8_matmul()


def _probe_functions(filename, names, **consts):
    """The named top-level functions of a probe script, compiled from its
    parsed source (nothing else of the script runs), in a namespace where
    ``pl.pallas_call`` interprets."""
    tree = ast.parse((TOOLS / filename).read_text())
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in defs) == sorted(names)
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                    if not k.startswith("_")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(jax=jax, jnp=jnp, np=np, pl=shim, pltpu=pltpu,
              functools=functools, **consts)
    exec(compile(ast.Module(body=defs, type_ignores=[]), filename, "exec"), ns)
    return ns


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.float().numpy()


def _probe_inputs(rows, seed=0, layers=None):
    """Weights as the probes draw them: int8 in [-127, 127), scales
    0.01 |normal|."""
    rng = np.random.default_rng(seed)
    shape = (D, F) if layers is None else (layers, D, F)
    wq = rng.integers(-127, 127, size=shape).astype(np.int8)
    s = (np.abs(rng.normal(size=shape[:-2] + (1, F))) * 0.01).astype(np.float32)
    x = rng.normal(size=(rows, D)).astype(np.float32)
    return wq, s, x


# ----------------------------------------------------------------------- K7


@pytest.mark.parametrize("seed,scale", [(0, 0.02), (1, 1.0), (2, 1e-3)])
def test_quantize_weight_bit_for_bit(seed, scale):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(D, F), scale=scale).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    w[5, 7] = np.abs(w[:, 7]).max() * 2  # the amax itself maps to 127
    q_j, s_j = jm.quantize_weight(jnp.asarray(w))
    q_t, s_t = ti8.quantize_weight(torch.from_numpy(w))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert s_t[3] == np.float32(1e-12) and q_t[5, 7] == 127


@pytest.mark.parametrize("rows", [2, 8, 1, 3, 9, 17, 64])
def test_matvec_plain_version_matches_the_pallas_kernel(rows):
    rng = np.random.default_rng(rows)
    w = rng.normal(size=(D, F), scale=0.02).astype(np.float32)
    x = rng.normal(size=(rows, D)).astype(np.float32)
    q_j, s_j = jm.quantize_weight(jnp.asarray(w))
    xj = jnp.asarray(x, jnp.bfloat16)
    kern = jm.int8_matmul(xj, q_j, s_j, block_n=BN, interpret=True)
    ref = jm.int8_matmul_reference(xj, q_j, s_j)
    q_t, s_t = ti8.quantize_weight(torch.from_numpy(w))
    got = ti8.int8_matvec(_bf16(x), q_t, s_t)  # CPU tensor: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (rows, F)
    assert _rel(_np(got), np.asarray(kern, np.float32)) <= REL
    assert _rel(_np(got), np.asarray(ref, np.float32)) <= ULP
    torch.testing.assert_close(got, ti8.reference_int8_matvec(_bf16(x), q_t, s_t),
                               rtol=0, atol=0)


# ----------------------------------------------------------------------- K8


@pytest.fixture(scope="module")
def probe2():
    return _probe_functions("int8_kernel_probe2.py", ["make"], D=D, F=F)


@pytest.mark.parametrize("mode,tol", [("bf16", REL), ("int8", ULP)])
def test_chain_plain_version_matches_the_pallas_chain(probe2, mode, tol):
    """The probe's own 16-layer chain over one shared matrix, 2 rows."""
    wq, s, x = _probe_inputs(2, seed=3)
    want = np.asarray(probe2["make"](BN, mode)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(s)), np.float32)
    got = ti8.int8_matvec_chain(_bf16(x), torch.from_numpy(wq),
                                torch.from_numpy(s), mode, n_layers=16)
    assert got.shape == (2, D) and got.dtype == torch.bfloat16
    assert np.isfinite(want).all() and np.isfinite(_np(got)).all()
    assert _rel(_np(got), want) <= tol


@pytest.fixture(scope="module")
def probe2_kern():
    """``kern`` of each mode, the Pallas kernel body of probe 2 (one
    layer), taken from the ``pallas_call`` of its chain."""
    kerns = {}
    ns = _probe_functions("int8_kernel_probe2.py", ["make"], D=D, F=F)
    wq, s, x = _probe_inputs(2, seed=0)
    for mode in ti8.MODES:
        def record(kernel, mode=mode, **kwargs):
            kerns[mode] = kernel
            return functools.partial(pl.pallas_call, interpret=True)(kernel, **kwargs)

        ns["pl"].pallas_call = record
        ns["make"](BN, mode)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                             jnp.asarray(s))
    return kerns


def _one_pallas_layer(kern, x, wq, s, out_dtype):
    """One layer through ``kern`` in interpret mode, for any rows."""
    rows = x.shape[0]
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((rows, F), out_dtype),
        grid=(F // BN,),
        in_specs=[pl.BlockSpec((rows, D), lambda i: (0, 0)),
                  pl.BlockSpec((D, BN), lambda i: (0, i)),
                  pl.BlockSpec((1, BN), lambda i: (0, i))],
        out_specs=pl.BlockSpec((rows, BN), lambda i: (0, i)),
        interpret=True)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                        jnp.asarray(s)), np.float32)


@pytest.mark.parametrize("k_parts,stage_rows", [(None, 256), (2, 32)])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_tiled_layer_is_the_pallas_layer(probe2_kern, mode, k_parts, stage_rows):
    """The streaming kernel's walk (stages dealt to the two blocks of a
    cluster, k-steps to ``k_parts`` warps, fp32 or int32 partials added in
    the kernel's order) against the probe's ``kern``: the int8 mode bit for
    bit, the bf16 mode in fp32 within 1e-6 of the largest magnitude (the
    order of the fp32 sum). The kernel's own walk for 5 rows (8 k-parts),
    and one whose short stages give both blocks and every part a share of
    D = 128."""
    wq, s, x = _probe_inputs(5, seed=11)
    x[0, :4] = [1 / 64, 3 / 64, -5 / 64, 300.0]  # halves and a clip
    args = (_bf16(x), torch.from_numpy(wq), torch.from_numpy(s[0]))
    walk = dict(k_parts=k_parts, stage_rows=stage_rows)
    got32 = ti8.tiled_int8_layer(*args, mode, **walk, dtype=torch.float32)
    got = ti8.tiled_int8_layer(*args, mode, **walk)
    want32 = _one_pallas_layer(probe2_kern[mode], x, wq, s, jnp.float32)
    want = _one_pallas_layer(probe2_kern[mode], x, wq, s, jnp.bfloat16)
    plain = ti8.reference_int8_layer(*args, mode)
    assert got.shape == (5, F) and got.dtype == torch.bfloat16
    if mode == "int8":
        np.testing.assert_array_equal(got32.numpy(), want32)
        np.testing.assert_array_equal(_np(got), want)
        assert torch.equal(got, plain)
    else:
        assert np.abs(got32.numpy() - want32).max() <= 1e-6 * np.abs(want32).max()
        assert _rel(_np(got), want) <= ULP and _rel(_np(got), _np(plain)) <= ULP


def test_tiled_layer_refuses_what_the_kernel_cannot_walk():
    wq, s, x = _probe_inputs(2)
    args = (_bf16(x), torch.from_numpy(wq), torch.from_numpy(s[0]))
    with pytest.raises(ValueError, match="power of two"):
        ti8.tiled_int8_layer(*args, "bf16", k_parts=3)
    with pytest.raises(ValueError, match="multiples of 32"):
        ti8.tiled_int8_layer(args[0][:, :112], args[1][:112], args[2], "int8")
    with pytest.raises(ValueError, match="mode"):
        ti8.tiled_int8_layer(*args, "fp8")


def test_int8_mode_quantises_half_to_even_and_clips():
    """x = k/64 lands on .5 after the x32 scale: rounds to the even integer,
    as ``jnp.round`` does; large values clip to +-127."""
    x = np.zeros((2, D), np.float32)
    x[0, :8] = np.array([1, 3, 5, 7, -1, -3, -5, 300]) / 64.0
    x[1, :3] = [100.0, -100.0, 3.97]
    wq = np.zeros((D, F), np.int8)
    wq[np.arange(D), np.arange(D)] = 1  # column n picks xq[n]
    s = np.ones((F,), np.float32)
    y = ti8.reference_int8_layer(_bf16(x), torch.from_numpy(wq),
                                 torch.from_numpy(s), "int8")
    want0 = np.array([0, 2, 2, 4, 0, -2, -2, 127]) / 32.0
    np.testing.assert_array_equal(_np(y)[0, :8], want0.astype(np.float32))
    np.testing.assert_array_equal(_np(y)[1, :3],
                                  np.array([127, -127, 127], np.float32) / 32.0)
    xq = jnp.clip(jnp.round(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32) * 32.0),
                  -127, 127)
    np.testing.assert_array_equal(_np(y)[:, :D], np.asarray(xq) / 32.0)


def test_chain_takes_one_matrix_per_layer_too():
    wq, s, x = _probe_inputs(8, seed=4, layers=L)
    for mode in ti8.MODES:
        got = ti8.int8_matvec_chain(_bf16(x), torch.from_numpy(wq),
                                    torch.from_numpy(s), mode, n_layers=L)
        h = _bf16(x)
        for layer in range(L):
            h = ti8.reference_int8_layer(h, torch.from_numpy(wq[layer]),
                                         torch.from_numpy(s[layer, 0]), mode)[:, :D]
        torch.testing.assert_close(got, h.contiguous(), rtol=0, atol=0)
        assert torch.equal(got, ti8.reference_int8_chain(
            _bf16(x), torch.from_numpy(wq), torch.from_numpy(s), mode, L))


# ----------------------------------------------------------------------- K9


@pytest.fixture(scope="module")
def probe3():
    return _probe_functions("int8_kernel_probe3.py", ["kern", "mega"],
                            D=D, F=F, L=L, BN=BN)


@pytest.mark.parametrize("seed", [0, 5])
def test_mega_plain_version_matches_the_pallas_megakernel(probe3, seed):
    wq, s, x = _probe_inputs(8, seed=seed, layers=L)
    want = np.asarray(probe3["mega"](jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                                     jnp.asarray(s)), np.float32)
    got = ti8.int8_megakernel(_bf16(x), torch.from_numpy(wq), torch.from_numpy(s))
    assert got.shape == (8, D) and got.dtype == torch.bfloat16
    assert np.isfinite(want).all() and np.abs(want).max() > 1e3  # |h| grows
    assert _rel(_np(got), want) <= ULP


def test_mega_keeps_h_in_fp32_between_layers():
    """The chain rounds h to bf16 between layers, the megakernel only for the
    product: same values here (the product rounds again), different path."""
    wq, s, x = _probe_inputs(8, seed=6, layers=L)
    args = (_bf16(x), torch.from_numpy(wq), torch.from_numpy(s))
    mega = ti8.reference_int8_mega(*args)
    chain = ti8.reference_int8_chain(*args, "bf16", L)
    assert _rel(_np(chain), _np(mega)) <= ULP


@functools.lru_cache(maxsize=None)
def _probe3_at(d, layers):
    """probe 3's ``mega`` compiled for another D and L (F and BN as above)."""
    return _probe_functions("int8_kernel_probe3.py", ["kern", "mega"],
                            D=d, F=F, L=layers, BN=BN)["mega"]


def _mega_inputs(d, layers, seed):
    rng = np.random.default_rng(seed)
    wq = rng.integers(-127, 127, size=(layers, d, F)).astype(np.int8)
    s = (np.abs(rng.normal(size=(layers, 1, F))) * 0.01).astype(np.float32)
    x = rng.normal(size=(8, d)).astype(np.float32)
    return wq, s, x


# the kernel's 256-row stages, and stages short enough that every block and
# k-part of D = 128 gets a share
@pytest.mark.parametrize("stage_rows", [256, 32])
def test_tiled_mega_is_the_pallas_megakernel(probe3, stage_rows):
    """The megakernel's walk (``tiled_int8_mega``: bf16 h slots, each layer
    summed as the kernel's stages, parts and blocks add them) against probe
    3's ``mega`` in interpret mode and against ``reference_int8_mega``, at
    one bf16 ulp of the max; its first K fp32 columns round to its output."""
    wq, s, x = _probe_inputs(8, seed=1 + stage_rows, layers=L)
    want = np.asarray(probe3["mega"](jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                                     jnp.asarray(s)), np.float32)
    args = (_bf16(x), torch.from_numpy(wq), torch.from_numpy(s))
    got, acc = ti8.tiled_int8_mega(*args, stage_rows=stage_rows, return_acc=True)
    assert got.shape == (8, D) and got.dtype == torch.bfloat16
    assert acc.shape == (8, F) and acc.dtype == torch.float32
    assert _rel(_np(got), want) <= ULP
    assert _rel(_np(got), _np(ti8.reference_int8_mega(*args))) <= ULP
    assert torch.equal(acc[:, :D].to(torch.bfloat16), got)


@pytest.mark.parametrize("d,layers", [(128, 1), (160, 2), (288, 2), (416, 3)])
def test_tiled_mega_one_layer_and_k_off_the_stage_size(d, layers):
    """One layer, and K not a multiple of the 256-row stage (160: one short
    stage, the cluster's second block gets none; 288: a full stage and a
    short one; 416: four feedback strips, the last past K, over two
    stages), against probe 3 compiled at that D and L."""
    wq, s, x = _mega_inputs(d, layers, seed=d + layers)
    want = np.asarray(_probe3_at(d, layers)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                                            jnp.asarray(s)), np.float32)
    args = (_bf16(x), torch.from_numpy(wq), torch.from_numpy(s))
    plain = ti8.int8_megakernel(*args)  # CPU tensors: the plain version
    assert plain.shape == (8, d) and _rel(_np(plain), want) <= ULP
    got = ti8.tiled_int8_mega(*args)
    assert got.shape == (8, d) and _rel(_np(got), want) <= ULP


@pytest.mark.parametrize("layers", [1, L])
def test_mega_return_acc_is_the_last_layer_on_every_column(layers):
    """``return_acc``: the last layer's fp32 sums times the scale on all N
    columns, not only the K fed back. On the CPU the wrapper's is the plain
    version's, bit for bit the last layer taken alone from the h before it;
    the kernel's walk agrees within fp32 summation order, column by column."""
    wq, s, x = _probe_inputs(5, seed=20 + layers, layers=layers)
    args = (_bf16(x), torch.from_numpy(wq), torch.from_numpy(s))
    out, acc = ti8.int8_megakernel(*args, return_acc=True)
    assert torch.equal(out, ti8.int8_megakernel(*args))
    h = ti8.reference_int8_mega(args[0], args[1][:-1], args[2][:-1]) if layers > 1 \
        else args[0]
    want = (h.float() @ args[1][-1].float()) * args[2][-1].float()
    assert acc.shape == (5, F) and acc.dtype == torch.float32
    assert torch.equal(acc, want)
    _, walk = ti8.tiled_int8_mega(*args, return_acc=True)
    err = (walk - want).abs().amax(dim=0)
    assert (err <= 1e-6 * want.abs().amax(dim=0)).all()


def test_mega_grid_requests():
    """A grid of 2-block clusters: even requests are passed on, odd or
    smaller than one cluster refused before any launch; None is the
    kernel's own grid."""
    assert ti8._mega_grid(None) == 0 and ti8._mega_grid(6) == 6
    for bad in (7, 1, 0, -2):
        with pytest.raises(ValueError, match="even"):
            ti8._mega_grid(bad)
    wq, _, _ = _probe_inputs(2, layers=L)
    with pytest.raises(ValueError, match="is on cpu"):  # the stream needs the card
        ti8.int8_mega_stream(torch.from_numpy(wq))


# -------------------------------------------------- wrappers and the probe


def test_wrappers_refuse_bad_arguments():
    wq, s, x = _probe_inputs(2)
    xt, wt, st = _bf16(x), torch.from_numpy(wq), torch.from_numpy(s[0])
    with pytest.raises(ValueError, match="mode"):
        ti8.int8_matvec_layer(xt, wt, st, "fp8")
    with pytest.raises(ValueError, match="weight matrices"):
        ti8.int8_matvec_chain(xt, torch.from_numpy(np.stack([wq, wq])),
                              torch.from_numpy(np.stack([s, s])), "bf16", 3)
    with pytest.raises(ValueError, match="N < K"):
        ti8.int8_matvec_chain(xt, wt[:, :64].contiguous(), st[:64], "bf16", 2)
    # the checks a CUDA launch makes, on tensors that would fail them
    for bad, exc in (((xt, wt[:100], st), ValueError),          # K mismatch
                     ((xt, wt, st[:100]), ValueError),          # scale length
                     ((xt.float(), wt, st), TypeError),         # x dtype
                     ((xt, wt.int(), st), TypeError),           # w dtype
                     ((xt, wt, st.double()), TypeError),        # scale dtype
                     ((xt, wt[:, :100], st[:100]), ValueError),  # N % 64
                     ((xt[:, ::2], wt[:64], st), ValueError),   # x pitch
                     ((xt, wt, st), ValueError)):               # on the CPU
        with pytest.raises(exc):
            ti8._check_layer_args("int8_matvec", *bad)
    # more than 8 rows: the layer kernels take them, the megakernel not
    with pytest.raises(ValueError, match="rows"):
        ti8._check_mega_args("int8_megakernel", xt.repeat(5, 1), wt[None],
                             st[None, None])
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ti8.int8_matvec(xt.to(meta), wt.to(meta), st.to(meta))
    with pytest.raises(ValueError, match="unsupported device"):
        ti8.int8_megakernel(xt.to(meta), wt.to(meta)[None], st.to(meta)[None, None])


def test_layer_wrappers_take_any_number_of_rows():
    """10 rows (more than the megakernel's 8), on the CPU: the plain
    versions; the checks a CUDA launch makes pass up to the device."""
    wq, s, x = _probe_inputs(2)
    xt = _bf16(x).repeat(5, 1)
    wt, st = torch.from_numpy(wq), torch.from_numpy(s[0])
    got = ti8.int8_matvec(xt, wt, st)
    assert got.shape == (10, F)
    assert torch.equal(got, ti8.reference_int8_matvec(xt, wt, st))
    assert torch.equal(ti8.int8_matvec_layer(xt, wt, st, "int8"),
                       ti8.reference_int8_layer(xt, wt, st, "int8"))
    with pytest.raises(ValueError, match="is on cpu"):  # the last check
        ti8._check_layer_args("int8_matvec", xt, wt, st)


def test_launch_counts_stay_zero_on_the_cpu():
    ti8.reset_launches()
    wq, s, x = _probe_inputs(2)
    ti8.int8_matvec(_bf16(x), torch.from_numpy(wq), torch.from_numpy(s[0]))
    ti8.int8_matvec_chain(_bf16(x), torch.from_numpy(wq), torch.from_numpy(s),
                          "int8", 2)
    assert (ti8.matvec_launches, ti8.chain_bf16_launches,
            ti8.chain_int8_launches, ti8.mega_launches) == (0, 0, 0, 0)


def test_int8_ffn_from_jax_quantises_each_layer():
    rng = np.random.default_rng(7)
    w1 = rng.normal(size=(L, D, F), scale=0.05).astype(np.float32)
    wq, s = int8_ffn_from_jax({"decoder": {"layers": {"ffn1_w": jnp.asarray(w1)}}})
    assert wq.shape == (L, D, F) and wq.dtype == torch.int8
    assert s.shape == (L, 1, F) and s.dtype == torch.float32
    for layer in range(L):
        q_j, s_j = jm.quantize_weight(jnp.asarray(w1[layer]))
        np.testing.assert_array_equal(wq[layer].numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s[layer, 0].numpy(), np.asarray(s_j))
    out = ti8.int8_megakernel(_bf16(rng.normal(size=(8, D))), wq, s)
    assert torch.isfinite(out.float()).all()


def test_probe_runs_on_the_cpu_at_a_small_size(tmp_path, capsys):
    argv = ["--device", "cpu", "--d_model", str(D), "--ffn_dim", str(F),
            "--layers", str(L), "--iters", "1"]
    res = int8_probe.main(argv)
    names = {(r["name"], r["rows"], r["weights"]) for r in res["lines"]}
    # 2 rows x 2 weight variants x (bf16 matmul, weight_int8pack_mm,
    # int8_matvec, chain bf16, chain int8) + 2 megakernel lines; no graph line
    assert len(res["lines"]) == len(names) == 22
    assert all(r["finite"] and r["launches"] == 0 and r["device"] == "cpu"
               and "int8_effective_gb_s" not in r for r in res["lines"])
    out = capsys.readouterr().out
    assert "GB/s" not in out  # no device rate from a CPU
    assert "CUDA-graph lines are skipped" in out
    assert not any("graph" in name for name, _, _ in names)
    o = res["outputs"]
    assert torch.equal(o[("chain bf16", 8, "distinct")],
                       o[("megakernel", 8, "distinct")])
    # the probe on a model's own weights
    from ssr_speech_tpu_torch.utils.checkpoint import save_bundle
    rng = np.random.default_rng(1)
    params = {"decoder": {"layers": {"ffn1_w": rng.normal(
        size=(L, D, F), scale=0.05).astype(np.float32)}}}
    path = str(tmp_path / "lm.pkl")
    save_bundle(path, params=params)
    res = int8_probe.main(argv + ["--model_path", path])
    assert all(r["finite"] for r in res["lines"])
    with pytest.raises(ValueError, match="ffn1_w"):
        int8_probe.main(argv[:-4] + ["--layers", "5", "--iters", "1",
                                     "--model_path", path])


def test_probe_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        int8_probe.main([])
