"""Int8 weight-streaming matvecs: a few activation rows against an int8 weight
with one fp32 scale per output column (port of the TPU probe kernels under
``tools/``: ``int8_matmul.py``, ``int8_kernel_probe2.py``,
``int8_kernel_probe3.py``).

Kernels: ``csrc/int8_matmul.cu``, hand-written for Hopper (sm_90a), one entry
point per TPU kernel (and per mode of the second):

- :func:`int8_matvec` <- ``int8_matmul``: y = (x . w) * scale with an fp32
  sum. Every product of a bf16 x and an int8 w is exact in fp32, so it runs
  the same tensor-core body as the chain's bf16 mode;
- :func:`int8_matvec_chain` <- the probe's chain of 16 ``pallas_call``s, one
  launch per layer, ``h <- y[:, :K]``. Mode ``bf16``: the weight converted to
  bf16 (exact), bf16 x bf16 products on the tensor cores with fp32
  accumulation. Mode ``int8``: the activation quantised inside the kernel,
  ``xq = clip(round(32 x), +-127)`` (half to even), int8 x int8 products
  accumulated in int32, times ``(1/32) * scale``; the int32 sums are exact, so
  this mode equals its plain version bit for bit;
- :func:`int8_megakernel` <- ``mega``: all layers in ONE persistent launch
  (at most 8 rows, as the TPU probe). The weights of every layer stream by
  TMA through one ring without a break; layer l + 1 waits only for the
  columns of layer l that feed it (a flag a layer, no grid-wide barrier). h
  is rounded to bf16 once a layer, where the TPU kernel rounds its fp32 h
  for each product: the same values.

The first two take any number of rows; the weight arrives by TMA and the
launches use programmatic dependent launch (``PDL``), so that in a chain a
layer streams its weights while the one before drains. :class:`Captured` puts
a chain into one CUDA graph, as the TPU probe dispatches its chain as one
``jax.jit`` executable. All are bound by the weight's bytes up to about 64
rows (K*N a layer against 2*B*K*N operations); the source says what the
design does about it. None is wired into ``inference.decode``: the JAX
decode has no int8 option either; their entry point is ``python3 -m
ssr_speech_tpu_torch.int8_probe``.

Beside each wrapper stands its plain PyTorch version (``reference_*``), and
beside the streaming kernel and the megakernel their own walks
(:func:`tiled_int8_layer`, :func:`tiled_int8_mega`). On a
CPU tensor a wrapper takes the plain version (the CPU tests); on a CUDA
tensor it launches the kernel or raises. The probes' random weights multiply
|h| by about 25 a layer in the bf16 modes, so outputs are compared by max
error over max magnitude, never absolutely.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_build import check_layout, load

_KERNEL = "int8_matmul"
MEGA_ROWS = 8  # activation rows the megakernel carries (its h slots are [8, K])
TILE_N = 64  # N must be a multiple (a lane stores 8 columns, a warp 64)
STRIP_N = 128  # output columns of a cluster of the streaming kernel
K_MULTIPLE = 32  # K must be a multiple (the int8 mode's k-step)
ACT_SCALE = 32.0  # the int8 mode's activation quantisation step is 1/32
MODES = ("bf16", "int8")
# K7 and K8 launch with programmatic dependent launch, so that a layer's
# blocks stream their weights while the previous layer drains; the tests
# switch it off to hold a chain against the same chain without it
PDL = True

# kernel launches since the last reset (plain integers; read by chip_smoke.py)
matvec_launches = 0  # int8_matvec
chain_bf16_launches = 0  # int8_matvec_chain, mode "bf16", one per layer
chain_int8_launches = 0  # int8_matvec_chain, mode "int8", one per layer
mega_launches = 0  # int8_megakernel, one per call


def reset_launches() -> None:
    global matvec_launches, chain_bf16_launches, chain_int8_launches
    global mega_launches
    matvec_launches = chain_bf16_launches = chain_int8_launches = 0
    mega_launches = 0


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (int8 [K, N], scale fp32 [N]): per-output-channel
    symmetric, scale = max(amax / 127, 1e-12), round half to even, clip to
    +-127. The same int8 matrix and scale as the JAX ``quantize_weight``."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


# ------------------------------------------------------------ plain versions


def reference_int8_matvec(x, w_q, scale):
    """Dequantise to fp32, fp32 matmul, cast to bf16 (the JAX
    ``int8_matmul_reference``)."""
    w = w_q.float() * scale.float()[None, :]
    return torch.matmul(x.float(), w).to(torch.bfloat16)


def reference_int8_layer(x, w_q, scale, mode: str):
    """One layer of the chain in ``mode``: bf16 [B, K] -> bf16 [B, N]."""
    scale = scale.float().reshape(1, -1)
    if mode == "bf16":  # int8 -> bf16 is exact; products exact in fp32
        y = torch.matmul(x.to(torch.bfloat16).float(), w_q.float())
    elif mode == "int8":
        xq = torch.clamp(torch.round(x.float() * ACT_SCALE), -127, 127)
        # integers below 2^53: the fp64 product is the exact int32 sum
        acc = torch.matmul(xq.double(), w_q.double()).to(torch.int32)
        y = acc.float() * (1.0 / ACT_SCALE)
    else:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    return (y * scale).to(torch.bfloat16)


K_STEP = {"bf16": 16, "int8": 32}  # k-rows of one of the kernel's products
CLUSTER = 2  # blocks that split K for one strip of columns
STAGE_ROWS = 256  # k-rows of one TMA stage; stage t goes to block t % CLUSTER


def kernel_k_parts(rows: int) -> int:
    """Warps along K in a block of the streaming kernel: 8 (16 warps) for up
    to 8 rows, 4 (8 warps) above, where the accumulators need the
    registers."""
    return 8 if rows <= 8 else 4


def tiled_int8_layer(x, w_q, scale, mode: str, k_parts: Optional[int] = None,
                     blocks: int = CLUSTER, stage_rows: int = STAGE_ROWS,
                     dtype=torch.bfloat16):
    """One layer as the streaming kernel walks it. K is cut into stages of
    ``stage_rows`` rows, stage t going to block t % ``blocks`` of a cluster;
    in a block, k-step i of a stage (16 rows in mode bf16, 32 in int8) goes
    to part i % ``k_parts`` (by default the kernel's for these rows). Each part sums its k-steps in order in fp32
    (int32 in mode int8); a block adds its parts as the kernel's tree does
    (part i += part i + h, for h = k_parts / 2 down to 1), the cluster adds
    its blocks in rank order, then the scale; the result in ``dtype``
    (float32: before the last rounding). Inside one product the kernel sums
    in the tensor cores' order, which this does not repeat: mode int8 agrees
    bit for bit, mode bf16 to fp32 rounding."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if k_parts is None:
        k_parts = kernel_k_parts(x.shape[0])
    if k_parts < 1 or k_parts & (k_parts - 1):
        raise ValueError(f"k_parts {k_parts}: a power of two")
    k, step = x.shape[1], K_STEP[mode]
    if k % step or stage_rows % step:
        raise ValueError(f"K = {k} and stage_rows = {stage_rows}: multiples of "
                         f"{step} in mode {mode}")
    if mode == "bf16":
        xs = x.to(torch.bfloat16).double()
    else:
        xs = torch.clamp(torch.round(x.float() * ACT_SCALE), -127, 127).double()
    ws, acc_type = w_q.double(), torch.float32 if mode == "bf16" else torch.int32
    per_stage = stage_rows // step
    zero = torch.zeros((x.shape[0], w_q.shape[1]), dtype=acc_type, device=x.device)
    parts = [[zero] * k_parts for _ in range(blocks)]
    for s0 in range(0, k, step):  # products exact in fp64 (integers below 2^53 in int8)
        i = s0 // step
        rank, part = (i // per_stage) % blocks, (i % per_stage) % k_parts
        prod = (xs[:, s0:s0 + step] @ ws[s0:s0 + step]).to(acc_type)
        parts[rank][part] = parts[rank][part] + prod
    total = None
    for rank in range(blocks):
        p, h = list(parts[rank]), k_parts // 2
        while h >= 1:
            for j in range(h):
                p[j] = p[j] + p[j + h]
            h //= 2
        total = p[0] if total is None else total + p[0]
    y = total.float()
    if mode == "int8":
        y = y * (1.0 / ACT_SCALE)
    return (y * scale.float().reshape(1, -1)).to(dtype)


def _layer_weights(w_q, scale, layer: int):
    """Layer ``layer`` of stacked ([L, K, N], [L, 1, N] or [L, N]) weights, or
    the one shared matrix ([K, N], [N] or [1, N])."""
    if w_q.dim() == 3:
        return w_q[layer], scale[layer].reshape(-1)
    return w_q, scale.reshape(-1)


def reference_int8_chain(x, w_q, scale, mode: str, n_layers: int = 16):
    """``n_layers`` chained layers, ``h <- y[:, :K]`` (bf16 between layers)."""
    h, k = x, x.shape[1]
    for layer in range(n_layers):
        w, s = _layer_weights(w_q, scale, layer)
        h = reference_int8_layer(h, w, s, mode)[:, :k]
    return h.contiguous()


def reference_int8_mega(x, w_q, scale, return_acc: bool = False):
    """The megakernel's math: h fp32 between layers, rounded to bf16 for each
    product, acc = dot * scale in fp32, h <- acc[:, :K]; bf16 of the last.
    ``return_acc``: also the last layer's acc, fp32 [B, N]."""
    h, k = x.float(), x.shape[1]
    for layer in range(w_q.shape[0]):
        y = torch.matmul(h.to(torch.bfloat16).float(), w_q[layer].float())
        y = y * scale[layer].float().reshape(1, -1)
        h = y[:, :k]
    out = h.to(torch.bfloat16).contiguous()
    return (out, y) if return_acc else out


MEGA_PARTS = 8  # the megakernel's k-parts: 16 consumer warps, 2 column halves
def tiled_int8_mega(x, w_q, scale, k_parts: int = MEGA_PARTS,
                    stage_rows: int = STAGE_ROWS, return_acc: bool = False):
    """The megakernel as it walks: each layer in mode bf16 as
    :func:`tiled_int8_layer` sums it (k-steps dealt to ``k_parts``, a tree of
    them a block, every 128-column strip summed by a 2-block cluster
    (``CLUSTER``) splitting K by alternate stages), and its first K columns,
    rounded to bf16, are the next layer's h slot. Returns bf16 [B, K], and
    with ``return_acc`` the last layer's fp32 [B, N] too."""
    h, k = x.to(torch.bfloat16), x.shape[1]
    for layer in range(w_q.shape[0]):
        y = tiled_int8_layer(h, w_q[layer], scale[layer].reshape(-1), "bf16",
                             k_parts=k_parts, blocks=CLUSTER, stage_rows=stage_rows,
                             dtype=torch.float32)
        h = y[:, :k].to(torch.bfloat16)
    out = h.contiguous()
    return (out, y) if return_acc else out


# ------------------------------------------------------------------ kernels


_PTR, _I32, _OUT = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_LAYER = [_PTR, _I32, _PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR]
ENTRY_POINTS = {  # name: argtypes; every one returns a CUDA error code
    "ssr_int8_matvec_f32": _LAYER, "ssr_int8_matvec_bf16": _LAYER,
    "ssr_int8_matvec_int8": _LAYER,
    "ssr_int8_mega_bf16": [_PTR] * 7 + [_I32] * 5 + [_OUT, _PTR],
    "ssr_int8_mega_stream": [_PTR] + [_I32] * 4 + [_OUT, _PTR],
    "ssr_int8_mega_resident": [_OUT],
    "ssr_int8_set_pdl": [_I32],
    "ssr_int8_stream_occupancy": [_I32, _I32, _OUT],
    "ssr_graph_programmatic_edges": [_PTR, _OUT, _OUT]}


def bind(lib, names) -> None:
    """Set the argument and result types of the named entry points."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = ENTRY_POINTS[name], _I32


def load_kernel():
    """Build (first call only) and bind the entry points."""
    built = load(_KERNEL)
    if built.lib.ssr_int8_matvec_f32.argtypes is None:
        bind(built.lib, ENTRY_POINTS)
    return built


def _check_layer_args(name: str, x, w_q, scale) -> None:
    """The TPU wrapper's refusals (shape mismatch, wrong dtype, N not a
    multiple of the tile) plus what the kernels' vector loads assume. x may
    be a column slice of a wider row-major tensor (the chain's feedback)."""
    if x.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name}: x [B, K], w_q [K, N], scale [N]; got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    (b, k), (kk, n) = x.shape, w_q.shape
    if k != kk or scale.shape[0] != n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
                         f"and scale {tuple(scale.shape)} do not fit")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: bfloat16 x, int8 w_q, float32 scale; got "
                        f"{x.dtype}, {w_q.dtype}, {scale.dtype}")
    if b < 1:
        raise ValueError(f"{name}: at least 1 row, got {b}")
    if n % TILE_N or k % K_MULTIPLE:
        raise ValueError(f"{name}: N a multiple of {TILE_N} and K of "
                         f"{K_MULTIPLE}, got K = {k}, N = {n}")
    if x.stride(1) != 1 or x.stride(0) % 8 or x.stride(0) < k:
        raise ValueError(f"{name} kernel needs x rows contiguous with a pitch "
                         f"that is a multiple of 8, got strides {x.stride()}")
    if x.device.type != "cuda" or x.data_ptr() % 16:
        raise ValueError(f"{name} kernel: x is on {x.device} or not 16-byte "
                         "aligned")
    check_layout(name, w_q=w_q, scale=scale)
    if not x.device == w_q.device == scale.device:
        raise ValueError(f"{name}: tensors on different devices")


_pdl_state = {}  # library path -> the PDL setting it was last given


def _sync_pdl(built) -> None:
    """Hand ``PDL`` to the library when it changed (a launch with it on that
    the card refuses fails; nothing falls back to a launch without it)."""
    if _pdl_state.get(built.path, True) != PDL:
        err = built.lib.ssr_int8_set_pdl(int(PDL))
        if err != 0:
            raise RuntimeError(f"int8 kernels: PDL {PDL} refused: CUDA error {err}")
        _pdl_state[built.path] = PDL


def _check_mega_args(name: str, x, w_q, scale) -> None:
    """The megakernel's refusals: shapes, types, at most ``MEGA_ROWS`` rows,
    N >= K and the tiles' multiples, then the layout a launch needs."""
    if x.dim() != 2 or w_q.dim() != 3 or scale.dim() != 3:
        raise ValueError(f"{name}: x [B, K], w_q [L, K, N], scale [L, 1, N]; "
                         f"got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    (b, k), (n_layers, kk, n) = x.shape, w_q.shape
    if k != kk or tuple(scale.shape) != (n_layers, 1, n) or n < k:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
                         f"and scale {tuple(scale.shape)} do not fit (N >= K)")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"{name}: bfloat16 x, int8 w_q, float32 scale; got "
                        f"{x.dtype}, {w_q.dtype}, {scale.dtype}")
    if not 1 <= b <= MEGA_ROWS or n % TILE_N or k % K_MULTIPLE:
        raise ValueError(f"{name}: 1 to {MEGA_ROWS} rows, N a multiple of "
                         f"{TILE_N}, K of {K_MULTIPLE}; got B = {b}, K = {k}, "
                         f"N = {n}")
    check_layout(name, x=x, w_q=w_q, scale=scale)


def _launch_layer(entry: str, name: str, x, w_q, scale) -> torch.Tensor:
    _check_layer_args(name, x, w_q, scale)
    (b, k), n = x.shape, w_q.shape[1]
    out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    built = load_kernel()
    _sync_pdl(built)
    with torch.cuda.device(x.device):
        err = getattr(built.lib, entry)(
            x.data_ptr(), x.stride(0), w_q.data_ptr(), scale.data_ptr(),
            out.data_ptr(), b, k, n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _not_cpu_or_cuda(name: str, x) -> ValueError:
    return ValueError(f"{name}: unsupported device {x.device}")


def int8_matvec(x, w_q, scale) -> torch.Tensor:
    """x bf16 [B, K] (any B >= 1), w_q int8 [K, N], scale fp32 [N] -> bf16
    [B, N]: y[b, n] = (sum_k x[b, k] * float(w_q[k, n])) * scale[n]."""
    global matvec_launches
    if x.device.type == "cpu":
        return reference_int8_matvec(x, w_q, scale)
    if x.device.type != "cuda":
        raise _not_cpu_or_cuda("int8_matvec", x)
    out = _launch_layer("ssr_int8_matvec_f32", "int8_matvec", x, w_q, scale)
    matvec_launches += 1
    return out


def int8_matvec_layer(x, w_q, scale, mode: str) -> torch.Tensor:
    """One layer of the chain in ``mode`` ("bf16" or "int8"): one launch."""
    global chain_bf16_launches, chain_int8_launches
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if x.device.type == "cpu":
        return reference_int8_layer(x, w_q, scale, mode)
    if x.device.type != "cuda":
        raise _not_cpu_or_cuda("int8_matvec_layer", x)
    out = _launch_layer(f"ssr_int8_matvec_{mode}", f"int8_matvec_{mode}", x,
                        w_q, scale)
    if mode == "bf16":
        chain_bf16_launches += 1
    else:
        chain_int8_launches += 1
    return out


def int8_matvec_chain(x, w_q, scale, mode: str, n_layers: int = 16):
    """``n_layers`` chained layers, one launch each, ``h <- y[:, :K]``.
    w_q is one shared matrix [K, N] (scale [N] or [1, N]), as the TPU probe
    chains it, or one per layer [L, K, N] (scale [L, 1, N] or [L, N]).
    Returns bf16 [B, K]."""
    if w_q.dim() == 3 and w_q.shape[0] < n_layers:
        raise ValueError(f"int8_matvec_chain: {n_layers} layers but only "
                         f"{w_q.shape[0]} weight matrices")
    if w_q.shape[-1] < x.shape[1]:
        raise ValueError("int8_matvec_chain: N < K, nothing to feed back")
    h, k = x, x.shape[1]
    for layer in range(n_layers):
        w, s = _layer_weights(w_q, scale, layer)
        h = int8_matvec_layer(h, w, s, mode)[:, :k]
    return h.contiguous()


def _mega_grid(grid_blocks: Optional[int]) -> int:
    """0 (the kernel's own grid) or the even grid the caller asks for."""
    if grid_blocks is None:
        return 0
    if grid_blocks < CLUSTER or grid_blocks % CLUSTER:
        raise ValueError(f"int8_megakernel: grid_blocks {grid_blocks}: an even "
                         f"number (clusters of {CLUSTER} blocks), at least {CLUSTER}")
    return int(grid_blocks)


def int8_megakernel(x, w_q, scale, grid_blocks: Optional[int] = None,
                    return_acc: bool = False):
    """x bf16 [B, K] (B <= 8), w_q int8 [L, K, N], scale fp32 [L, 1, N] ->
    bf16 [B, K]: L chained layers in one persistent launch. ``grid_blocks``
    (tests) asks for an even grid of that size instead of two blocks a
    128-column strip; a grid the device cannot hold at once is refused with
    an error, never launched. ``return_acc`` (tests) also returns the last
    layer's fp32 sums times the scale, [B, N]: every column the kernel
    computes, not only the K it feeds back."""
    global mega_launches
    if x.device.type == "cpu":
        return reference_int8_mega(x, w_q, scale, return_acc=return_acc)
    if x.device.type != "cuda":
        raise _not_cpu_or_cuda("int8_megakernel", x)
    name = "int8_megakernel"
    _check_mega_args(name, x, w_q, scale)
    request = _mega_grid(grid_blocks)
    (b, k), (n_layers, _, n) = x.shape, w_q.shape
    hs = torch.empty((max(n_layers - 1, 1), MEGA_ROWS, k), dtype=torch.bfloat16,
                     device=x.device)
    flags = torch.zeros((n_layers,), dtype=torch.int32, device=x.device)
    last = torch.empty((b, n), dtype=torch.float32, device=x.device)
    out = torch.empty((b, k), dtype=torch.bfloat16, device=x.device)
    grid = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = load_kernel().lib.ssr_int8_mega_bf16(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), hs.data_ptr(),
            flags.data_ptr(), last.data_ptr(), out.data_ptr(), b, n_layers, k, n,
            request, ctypes.byref(grid), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} (grid of "
                           f"{grid.value} blocks; a persistent grid must be "
                           f"resident at once)")
    mega_launches += 1
    return (out, last) if return_acc else out


def int8_mega_stream(w_q, grid_blocks: Optional[int] = None) -> None:
    """The megakernel's weight stream alone over int8 [L, K, N] weights: its
    grid, ring and tiles with no products, h or flags (a measurement of the
    rate the stream reaches, not a function: nothing is written). Not counted
    in ``mega_launches``; needs the card."""
    n_layers, k, n = w_q.shape
    if w_q.dtype != torch.int8 or n < k or n % TILE_N or k % K_MULTIPLE:
        raise ValueError(f"int8_mega_stream: int8 [L, K, N] with N >= K, N a "
                         f"multiple of {TILE_N}, K of {K_MULTIPLE}; got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    check_layout("int8_mega_stream", w_q=w_q)
    grid = ctypes.c_int(0)
    with torch.cuda.device(w_q.device):
        err = load_kernel().lib.ssr_int8_mega_stream(
            w_q.data_ptr(), n_layers, k, n, _mega_grid(grid_blocks), ctypes.byref(grid),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_mega_stream launch failed: CUDA error {err} "
                           f"(grid of {grid.value} blocks)")


def mega_resident() -> int:
    """The largest megakernel grid the card holds at once (blocks); needs the
    card."""
    blocks = ctypes.c_int(0)
    err = load_kernel().lib.ssr_int8_mega_resident(ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"megakernel occupancy query failed: CUDA error {err}")
    return blocks.value


def occupancy(mode: str, rows: int) -> int:
    """Blocks of the streaming kernel one SM holds at once for ``rows`` rows
    in ``mode`` (``int8_matvec`` is mode bf16); needs the card."""
    blocks = ctypes.c_int(0)
    err = load_kernel().lib.ssr_int8_stream_occupancy(int(mode == "int8"), rows,
                                                      ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return blocks.value


class Captured:
    """``fn`` (a chain: ``lambda: int8_matvec_chain(x, w_q, scale, mode)``)
    warmed up and captured once into a CUDA graph, raising where the capture
    fails; calling it replays the graph and returns the output tensor of the
    capture (the same storage each time). ``edges`` and
    ``programmatic_edges`` count the graph's dependencies, and those that
    captured launches with programmatic dependent launch became."""

    def __init__(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up (and build) off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph):
            self.out = fn()
        edges, prog = ctypes.c_int(0), ctypes.c_int(0)
        err = load_kernel().lib.ssr_graph_programmatic_edges(
            self.graph.raw_cuda_graph(), ctypes.byref(edges), ctypes.byref(prog))
        if err != 0:
            raise RuntimeError(f"reading the graph's edges failed: CUDA error {err}")
        self.edges, self.programmatic_edges = edges.value, prog.value
        self.graph.instantiate()

    def __call__(self):
        self.graph.replay()
        return self.out
