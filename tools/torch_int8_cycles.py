#!/usr/bin/env python3
"""Where a launch's time goes in the int8 weight-streaming kernels K7 and K8.

    python3 tools/torch_int8_cycles.py [--rows 2,8] [--source FILE.cu]

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

Needs the card.
"""

from __future__ import annotations

import argparse
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
"""

READER = r"""
extern "C" int ssr_times_setup(void* buf, unsigned cap) {
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(ssr_times_buf, &buf, sizeof(buf));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ssr_times_cap, &cap, sizeof(cap));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ssr_times_seq, &zero, sizeof(zero));
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", default="2,8")
    p.add_argument("--source", default=None, help="a .cu to instrument instead of the repo's")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from ssr_speech_tpu_torch import int8_probe
    from ssr_speech_tpu_torch.device import resolve_device
    from ssr_speech_tpu_torch.ops import int8_matmul as i8
    from ssr_speech_tpu_torch.ops.cuda_build import CSRC

    device = resolve_device("cuda")
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

    plain_ms = {(name, r): queued(lambda: fn(xs[r])) for name, fn in chains.items() for r in rows}
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
    finally:
        i8._KERNEL = "int8_matmul"
        i8.PDL = pdl
        copy.unlink()
    return out


if __name__ == "__main__":
    main()
