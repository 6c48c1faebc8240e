#!/usr/bin/env python3
"""Where a launch's time goes in the int8 weight-streaming kernels K7 and K8,
and where a layer's time goes in the megakernel K9.

    python3 tools/torch_int8_cycles.py [--rows 2,8] [--source FILE.cu] [--only mega]

Copies ``ssr_speech_tpu_torch/csrc/int8_matmul.cu`` (or ``--source``) to
``int8_matmul_cycles.cu`` (``..._cycles_first.cu``) beside it with ``SSR_INT8_TIMES`` defined (removed
again at exit). The kernel's ``SSR_BEGIN`` / ``SSR_MARK`` / ``SSR_END`` hooks
then record, for thread 0 of every block, ``%globaltimer`` and ``clock64()``
at five points: the block's start, its first weight stage in shared memory,
the activations readable (after ``griddepcontrol.wait``), the end of the
streaming loop, and the end of its reduction and store. A ``--source``
without the hooks (the first form, ``git show
d28c1c8:ssr_speech_tpu_torch/csrc/int8_matmul.cu``) gets them inserted at
its own lines (``FIRST_FORM_EDITS``); its first weight point is the end of
the first k-step's products.

It runs one 16-layer chain over 16 distinct [2048, 8192] int8 matrices for
each kernel (``int8_matvec``, the chain in modes bf16 and int8) and each row
count, queued behind a blocker so that the launches run back to back, and
prints per kernel and rows, in microseconds (means over the chain):

- ``gap``: a launch's first block starting minus the previous launch's last
  block ending (negative: the launches overlap);
- ``to first weight``, ``x wait``, ``loop``, ``reduce+store``: a block's
  phases, from ``clock64()`` at the card's clock (measured from the two
  timers);
- ``end spread``: the last block's end minus the first block's end within a
  launch; ``span``: a launch's first start to its last end;
- ``copy_chain_ms``: the chain's queued time through the instrumented copy,
  and ``chain_ms`` through the repo's own kernel, without counters.

The megakernel (``mega``: 16 layers in one launch, and its weight stream
alone, ``mega stream``) records with ``SSR_MEGA_MARK`` thread 0's
``%globaltimer`` at each layer's phases of the block's first strip, and
with ``SSR_MEGA_ISSUE`` when its producer warp issues a layer's first tile. Per
rows, in microseconds, means over the layers after the first:

- ``flag_wait``: the layer's start to flags[l - 1] seen (every block);
- ``h_first_stage``: from there to the end of the first stage's products
  (h from L2 into registers, the stage's wait and products), and
  ``products`` to the end of the last stage's, for the feedback blocks
  (rank 0 and 1 of the strips with columns < K);
- ``tree``, ``combine`` (rank 1's sums waited for and added), ``publish``
  (scale, stores, release), rank 0 of the feedback strips;
- ``flag_trip``: the last publisher's release to the first block seeing the
  flag, ``layer_period``: one layer's last release to the next's, and
  ``issue_lead``: how far a layer's first tile issued precedes the
  flag that lets its products start (positive: the stream runs ahead);
- ``span_us`` and ``stream_gb_s``: the launch's first start to last end,
  and L*K*N bytes over it; ``mega_ms``: the call queued through the repo's
  own kernel.

Needs the card.
"""

from __future__ import annotations

import argparse
import subprocess
import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SLOTS = ("start", "weight", "x", "loop", "end", "tree")
# u64 a block: globaltimer at the slots (0-5) and the SM's id (7), then
# clock64 at the slots (8-13) and the loop's weight waits in cycles (14)
RECORD = 16

HOOKS = r"""
#define SSR_INT8_TIMES 1
#include <stdint.h>
__device__ unsigned long long* ssr_times_buf;
__device__ unsigned int ssr_times_cap;
__device__ unsigned int ssr_times_seq;
__device__ unsigned int ssr_times_blk[4096];
__device__ __forceinline__ void ssr_times_put(unsigned rec, int slot) {
  unsigned long long gt, sm;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));
  const long long ck = clock64();
  asm volatile("mov.u32 %0, %%smid;" : "=r"(*reinterpret_cast<unsigned*>(&sm)));
  if (ssr_times_buf != nullptr && rec < ssr_times_cap) {
    ssr_times_buf[rec * 16 + slot] = gt;
    ssr_times_buf[rec * 16 + 8 + slot] = static_cast<unsigned long long>(ck);
    if (slot == 0) ssr_times_buf[rec * 16 + 7] = sm & 0xFFFFFFFFull;
  }
}
__device__ __forceinline__ unsigned ssr_times_begin() {
  unsigned rec = 0;
  if (threadIdx.x == 0) {
    rec = atomicAdd(&ssr_times_seq, 1u);
    ssr_times_blk[blockIdx.x & 4095] = rec;
    ssr_times_put(rec, 0);
  }
  return rec;
}
#define SSR_BEGIN() const unsigned ssr_rec_ = ssr_times_begin(); long long ssr_w0_ = 0, ssr_wsum_ = 0
#define SSR_MARK(slot) do { if (threadIdx.x == 0) ssr_times_put(ssr_rec_, slot); } while (0)
#define SSR_MARK_BLK(slot) do { if (threadIdx.x == 0) \
  ssr_times_put(ssr_times_blk[blockIdx.x & 4095], slot); } while (0)
#define SSR_WAIT_START() do { ssr_w0_ = clock64(); } while (0)
#define SSR_WAIT_STOP() do { ssr_wsum_ += clock64() - ssr_w0_; } while (0)
#define SSR_END() do { __syncthreads(); SSR_MARK(4); \
  if (threadIdx.x == 0 && ssr_times_buf != nullptr && ssr_rec_ < ssr_times_cap) \
    ssr_times_buf[ssr_rec_ * 16 + 14] = static_cast<unsigned long long>(ssr_wsum_); } while (0)
// [grid][layers][16]: globaltimer at slots 0-7, clock64 at 8-15; the first write wins
__device__ unsigned long long* ssr_mega_buf;
__device__ unsigned int ssr_mega_layers;
__device__ __forceinline__ void ssr_mega_put(int layer, int slot) {
  if (ssr_mega_buf == nullptr || layer >= static_cast<int>(ssr_mega_layers)) return;
  unsigned long long gt;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));
  const long long ck = clock64();
  unsigned long long* p = ssr_mega_buf + (static_cast<size_t>(blockIdx.x) * ssr_mega_layers + layer) * 16 + slot;
  if (*p == 0) {
    p[0] = gt;
    p[8] = static_cast<unsigned long long>(ck);
  }
}
#define SSR_MEGA_MARK(layer, slot) do { if (threadIdx.x == 0) ssr_mega_put(layer, slot); } while (0)
#define SSR_MEGA_ISSUE(layer) ssr_mega_put(layer, 7)
"""

READER = r"""
extern "C" int ssr_times_setup(void* buf, unsigned cap) {
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(ssr_times_buf, &buf, sizeof(buf));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ssr_times_cap, &cap, sizeof(cap));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ssr_times_seq, &zero, sizeof(zero));
  return static_cast<int>(e);
}
extern "C" int ssr_mega_times_setup(void* buf, unsigned layers) {
  cudaError_t e = cudaMemcpyToSymbol(ssr_mega_buf, &buf, sizeof(buf));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ssr_mega_layers, &layers, sizeof(layers));
  return static_cast<int>(e);
}
"""

# The first form (PR 3): (anchor, replacement); each anchor must occur once.
_END = "  }\n  SSR_END();\n}\n\n// -----------------------------------------------------------"
FIRST_FORM_EDITS = (
    # matvec_bf16_kernel
    ("  float acc[4][4];\n  warp_tile_bf16<false>(w, x, ldx, B, K, N, n0, warp, lane, acc);\n",
     "  SSR_BEGIN();\n  SSR_MARK(2);\n  float acc[4][4];\n"
     "  warp_tile_bf16<false>(w, x, ldx, B, K, N, n0, warp, lane, acc);\n  SSR_MARK(3);\n"),
    ("      mma_16816(acc[j], a, b0, b1);\n    }\n",
     "      mma_16816(acc[j], a, b0, b1);\n    }\n    if (k0 == warp * 16) SSR_MARK_BLK(1);\n"),
    ("  }\n}\n\n// ------------------------------------------------------------ int8 products",
     _END + "- int8 products"),
    # matvec_int8_kernel
    ("  int acc[4][4];\n", "  SSR_BEGIN();\n  SSR_MARK(2);\n  int acc[4][4];\n"),
    ("      mma_16832_s8(acc[j], a, b0, b1);\n    }\n",
     "      mma_16832_s8(acc[j], a, b0, b1);\n    }\n    if (k0 == warp * 32) SSR_MARK(1);\n"),
    ("  store_partials<int>(red, warp, lane, acc);",
     "  SSR_MARK(3);\n  store_partials<int>(red, warp, lane, acc);"),
    ("  }\n}\n\n// ------------------------------------------------------------ fp32 products",
     _END + "- fp32 products"),
    # matvec_f32_kernel
    ("  for (int i = threadIdx.x; i < R * K; i += kThreads) {",
     "  SSR_BEGIN();\n  for (int i = threadIdx.x; i < R * K; i += kThreads) {"),
    ("  __syncthreads();\n  float acc[R][4];", "  __syncthreads();\n  SSR_MARK(2);\n  float acc[R][4];"),
    ("      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv, f[j], acc[r][j]);\n    }\n",
     "      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv, f[j], acc[r][j]);\n    }\n"
     "    if (k == 2 * warp + half) SSR_MARK(1);\n"),
    ("#pragma unroll\n  for (int r = 0; r < R; ++r)\n#pragma unroll\n    for (int j = 0; j < 4; ++j) {\n"
     "      acc[r][j] += __shfl_xor_sync",
     "  SSR_MARK(3);\n#pragma unroll\n  for (int r = 0; r < R; ++r)\n#pragma unroll\n"
     "    for (int j = 0; j < 4; ++j) {\n      acc[r][j] += __shfl_xor_sync"),
    ("  }\n}\n\n// -------------------------------------------------------------- megakernel",
     _END + "--- megakernel"),
)

# the first form has no switch for programmatic dependent launch
NO_PDL = '\nextern "C" int ssr_int8_set_pdl(int on) { return on ? 801 : 0; }\n'


def instrumented_source(src: str) -> tuple:
    """(source with the counters on, whether it is the first form)."""
    first_form = "SSR_MARK(" not in src
    if first_form:
        for old, new in FIRST_FORM_EDITS:
            if src.count(old) != 1:
                raise RuntimeError(f"the source no longer has this line once: {old[:60]!r}")
            src = src.replace(old, new)
        if "ssr_int8_set_pdl" not in src:
            src += NO_PDL
    return HOOKS + src + READER, first_form


def summarise(rec, grid: int, launches: int) -> dict:
    """rec: int64 [launches * grid, 16] -> microseconds by phase."""
    import numpy as np

    rec = rec.reshape(launches, grid, RECORD).astype(np.float64)
    gt, ck = rec[..., :6], rec[..., 8:14]
    span_ns = gt[..., 4] - gt[..., 0]
    span_ck = ck[..., 4] - ck[..., 0]
    ghz = float(span_ck.sum() / span_ns.sum())  # cycles a nanosecond
    starts, ends = gt[..., 0], gt[..., 4]
    gaps = starts[1:].min(axis=1) - ends[:-1].max(axis=1)
    phase = lambda a, b: float((ck[..., b] - ck[..., a]).mean() / ghz / 1e3)  # noqa: E731
    gtick = np.diff(np.unique(gt[..., 0].ravel()))
    return {
        "gap_us": float(gaps.mean() / 1e3), "gap_min_us": float(gaps.min() / 1e3),
        "gap_max_us": float(gaps.max() / 1e3),
        "to_first_weight_us": phase(0, 1), "x_wait_us": phase(0, 2),
        "loop_us": phase(1, 3),
        "loop_weight_wait_us": float(rec[..., 14].mean() / ghz / 1e3),
        "reduce_store_us": phase(3, 4),
        **({"tree_us": phase(3, 5), "exchange_store_us": phase(5, 4)}
           if (ck[..., 5] > 0).all() else {}),
        "block_us": phase(0, 4),
        "end_spread_us": float((ends.max(axis=1) - ends.min(axis=1)).mean() / 1e3),
        "span_us": float((ends.max(axis=1) - starts.min(axis=1)).mean() / 1e3),
        "sm_clock_ghz": ghz, "globaltimer_step_ns": float(gtick.min()) if gtick.size else 0.0,
        "sms": int(len(np.unique(rec[..., 7].astype(np.int64)))),
    }


def summarise_mega(rec, mrec, grid: int, n_layers: int, k: int, n: int) -> dict:
    """rec: int64 [grid, 16] (the block records), mrec: int64 [grid, L, 16]
    (globaltimer at a layer's slots 0-7: 0 start, 1 flag seen, 2 first
    stage's products, 3 last stage's, 4 tree, 5 combined, 6 published, 7
    first tile issued; clock64 at 8-15) -> microseconds by phase: a block's
    own phases from clock64, what crosses blocks from globaltimer. A layer's
    first strip is a feedback one for the clusters below the feedback strips;
    slots a block did not reach are left out."""
    import numpy as np

    rec, mm = rec.reshape(grid, RECORD).astype(np.float64), mrec.astype(np.float64)
    starts, ends = rec[:, 0], rec[:, 4]
    span_ns = ends.max() - starts.min()
    ghz = float((rec[:, 12] - rec[:, 8]).sum() / (ends - starts).sum())
    out = {"span_us": span_ns / 1e3, "stream_gb_s": n_layers * k * n / span_ns,
           "grid": grid, "sm_clock_ghz": ghz}
    if (mm[:, :, 3] == 0).all():  # the stream alone: no products, no phases
        return out
    mm[mm == 0] = np.nan  # slots not reached
    m, ck = mm[:, :, :8], mm[:, :, 8:] / ghz  # ns
    clusters = grid // 2
    blocks = np.arange(grid)
    fb = (blocks // 2) < -(-k // 128)
    rank0 = blocks % 2 == 0
    later = slice(1, n_layers)  # layer 0 waits for no flag
    mean = lambda a: float(np.nanmean(a) / 1e3)  # noqa: E731
    d = lambda sel, a, b: ck[sel, later, b] - ck[sel, later, a]  # noqa: E731
    published = np.nanmax(m[fb, :, 6], axis=0)  # the last release of a layer
    seen = np.nanmin(m[:, :, 1], axis=0)  # the first block to see the previous one's flag
    out.update({
        "flag_wait_us": mean(d(slice(None), 0, 1)),
        "h_first_stage_us": mean(d(fb, 1, 2)), "products_us": mean(d(fb, 1, 3)),
        "tree_us": mean(d(fb, 3, 4)), "combine_us": mean(d(fb & rank0, 4, 5)),
        "publish_us": mean(d(fb & rank0, 5, 6)),
        "flag_trip_us": mean(seen[1:] - published[:-1]),
        "layer_period_us": mean(np.diff(published)),
        "issue_lead_us": mean(m[:, 1:, 1] - m[:, 1:, 7]),
        "nonfeedback_products_us": mean(d(~fb, 1, 3)) if (~fb).any() else 0.0,
        "clusters": clusters,
    })
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", default="2,8")
    p.add_argument("--source", default=None, help="a .cu to instrument instead of the repo's")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--only", default=None,
                   help="comma-separated: int8_matvec, chain bf16, chain int8, mega")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from ssr_speech_tpu_torch import int8_probe
    from ssr_speech_tpu_torch.device import resolve_device
    from ssr_speech_tpu_torch.ops import int8_matmul as i8
    from ssr_speech_tpu_torch.ops.cuda_build import CSRC, load

    device = resolve_device("cuda")
    print("[card] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    d, f, n_layers = 2048, 8192, 16
    rng = np.random.default_rng(args.seed)
    wq = torch.from_numpy(rng.integers(-127, 127, size=(n_layers, d, f)).astype(np.int8)).to(device)
    s = torch.from_numpy((np.abs(rng.normal(size=(n_layers, 1, f))) * 0.01).astype(np.float32)).to(device)
    rows = [int(r) for r in args.rows.split(",")]
    xs = {r: torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32)).to(device, torch.bfloat16)
          for r in rows}
    chains = {
        "int8_matvec": lambda x: int8_probe.matvec_chain(x, wq, s, n_layers),
        "chain bf16": lambda x: i8.int8_matvec_chain(x, wq, s, "bf16", n_layers),
        "chain int8": lambda x: i8.int8_matvec_chain(x, wq, s, "int8", n_layers),
    }

    def queued(fn):
        fn()
        eager = int8_probe._time_ms(fn, 3, device)
        return int8_probe.queued_ms(fn, eager, device)

    only = args.only.split(",") if args.only else None
    chains = {k: v for k, v in chains.items() if only is None or k in only}
    plain_ms = {(name, r): queued(lambda: fn(xs[r])) for name, fn in chains.items() for r in rows}
    mega = only is None or "mega" in only
    if mega:
        plain_ms.update({("mega", r): queued(lambda: i8.int8_megakernel(xs[r], wq, s))
                         for r in rows})
    src_path = Path(args.source) if args.source else CSRC / "int8_matmul.cu"
    text, first_form = instrumented_source(src_path.read_text())
    name = "int8_matmul_cycles" + ("_first" if first_form else "")  # one library each
    copy = CSRC / f"{name}.cu"
    copy.write_text(text)
    grid = f // i8.TILE_N if first_form else i8.CLUSTER * (f // i8.STRIP_N)
    cap = grid * n_layers
    buf = torch.zeros((cap, RECORD), dtype=torch.int64, device=device)
    pdl = i8.PDL
    out = {}
    try:
        i8._KERNEL = name
        i8.PDL = pdl and not first_form
        if args.source:  # an earlier form: bind the entry points it shares with the kernel
            lib = load(name).lib
            i8.bind(lib, [n for n in i8.ENTRY_POINTS if hasattr(lib, n) and (
                n != "ssr_int8_mega_bf16" or "SSR_MEGA_MARK" in text)])
        lib = i8.load_kernel().lib
        lib.ssr_times_setup.argtypes = [ctypes.c_void_p, ctypes.c_uint]
        lib.ssr_times_setup.restype = ctypes.c_int
        for name, fn in chains.items():
            for r in rows:
                run = lambda: fn(xs[r])  # noqa: E731
                copy_ms = queued(run)
                buf.zero_()
                torch.cuda.synchronize(device)
                if lib.ssr_times_setup(buf.data_ptr(), cap):
                    raise RuntimeError("setting up the counters failed")
                int8_probe.queued_ms(run, copy_ms, device, calls=1)
                torch.cuda.synchronize(device)
                if lib.ssr_times_setup(None, 0):
                    raise RuntimeError("switching the counters off failed")
                res = summarise(buf.cpu().numpy(), grid, n_layers)
                res.update(chain_ms=plain_ms[(name, r)], copy_chain_ms=copy_ms)
                out[f"{name} rows {r}"] = res
                print(f"[int8 cycles] {name} rows {r} ({'first form' if first_form else 'kernel'}, "
                      f"PDL {'on' if i8.PDL else 'off'}): "
                      + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in res.items()), flush=True)
        if mega and "SSR_MEGA_MARK" in src_path.read_text():
            lib.ssr_mega_times_setup.argtypes = [ctypes.c_void_p, ctypes.c_uint]
            lib.ssr_mega_times_setup.restype = ctypes.c_int
            mgrid = min(2 * (f // i8.STRIP_N), i8.mega_resident())
            mbuf = torch.zeros((mgrid, n_layers, 16), dtype=torch.int64, device=device)
            runs = {f"mega rows {r}": (lambda r=r: i8.int8_megakernel(xs[r], wq, s),
                                       plain_ms[("mega", r)]) for r in rows}
            runs["mega stream"] = (lambda: i8.int8_mega_stream(wq), None)
            for label, (run, ms) in runs.items():
                copy_ms = queued(run)
                buf.zero_()
                mbuf.zero_()
                torch.cuda.synchronize(device)
                if lib.ssr_times_setup(buf.data_ptr(), cap) or \
                        lib.ssr_mega_times_setup(mbuf.data_ptr(), n_layers):
                    raise RuntimeError("setting up the counters failed")
                int8_probe.queued_ms(run, copy_ms, device, calls=1)
                torch.cuda.synchronize(device)
                if lib.ssr_times_setup(None, 0) or lib.ssr_mega_times_setup(None, 0):
                    raise RuntimeError("switching the counters off failed")
                res = summarise_mega(buf.cpu().numpy()[:mgrid], mbuf.cpu().numpy(), mgrid,
                                     n_layers, d, f)
                res.update(mega_ms=ms if ms is not None else 0.0, copy_ms=copy_ms)
                out[label] = res
                print(f"[int8 cycles] {label} (kernel): " + ", ".join(
                    f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in res.items()), flush=True)
    finally:
        i8._KERNEL = "int8_matmul"
        i8.PDL = pdl
        copy.unlink()
    return out


if __name__ == "__main__":
    main()
