#!/usr/bin/env python3
"""Where a vocab tile's cycles go inside the fused CE head's dhidden kernel.

    python3 tools/torch_ce_dhidden_cycles.py [--shape K,N,Hh,C]

Copies ``ssr_speech_tpu_torch/csrc/fused_ce.cu`` to ``fused_ce_cycles.cu``
beside it with ``clock64()`` counters around the steps of
``ce_dhidden_kernel``'s tile loop (the copy is removed again at exit), builds
and runs it at the shape (default the training batch's 4,13230,1024,2056),
and prints, per vocab tile and warpgroup, the mean cycles spent: waiting for
the tile's w2t (TMA), waiting for the previous tile's second product (and
the warpgroup barrier before its stage is refilled), waiting for the
cluster's partial logits, summing them and forming the dlogits, waiting for
the next tile's logits, publishing them, and the whole tile. What the
counters do not cover is issuing the wgmmas: with the tensor cores' queue
full, the next wgmma waits to be accepted. The counters cost registers, so
the copy runs somewhat slower than the kernel; its time is printed beside
the kernel's. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NAMES = ("w2t tile wait", "previous product wait", "partials wait",
         "sum and dlogits", "next logits wait", "publish", "tile")

# (anchor in fused_ce.cu, what replaces it)
EDITS = (
    ("// ------------------------------------------------------------------ dhidden\n",
     "// ------------------------------------------------------------------ dhidden\n"
     "__device__ unsigned long long dh_cycles[8];\n"
     "#define SSR_CYC(slot, stmt) do { const long long c_ = clock64(); stmt; "
     "cyc[slot] += clock64() - c_; } while (0)\n"),
    ("  float lg[16];\n  uint32_t a[2][4] = {};",
     "  long long cyc[7] = {0, 0, 0, 0, 0, 0, 0};\n  float lg[16];\n  uint32_t a[2][4] = {};"),
    ("  for (int i = 0; i < ntiles; ++i) {\n    const int v0 = i * kDhVt;",
     "  const long long c_loop = clock64();\n"
     "  for (int i = 0; i < ntiles; ++i) {\n    const int v0 = i * kDhVt;"),
    ("      mbar_wait(full_w + 8 * (t % kDhStages), (t / kDhStages) & 1);\n",
     "      SSR_CYC(0, mbar_wait(full_w + 8 * (t % kDhStages), (t / kDhStages) & 1));\n"),
    ("      if (more) {\n        wgmma_wait<1>();\n      } else {\n        wgmma_wait<0>();\n      }\n"
     "      fence_operands(a[0]);\n      fence_operands(a[1]);\n      warpgroup_barrier(w);\n",
     "      const long long c_ = clock64();\n"
     "      if (more) {\n        wgmma_wait<1>();\n      } else {\n        wgmma_wait<0>();\n      }\n"
     "      fence_operands(a[0]);\n      fence_operands(a[1]);\n      warpgroup_barrier(w);\n"
     "      cyc[1] += clock64() - c_;\n"),
    ("    mbar_wait(recv_bar, i & 1);\n",
     "    SSR_CYC(2, mbar_wait(recv_bar, i & 1));\n    const long long c_sum = clock64();\n"),
    ("      a[j >> 1][2 * (j & 1) + 1] = pack_bf16(d[2], d[3]);\n    }\n",
     "      a[j >> 1][2 * (j & 1) + 1] = pack_bf16(d[2], d[3]);\n    }\n"
     "    cyc[3] += clock64() - c_sum;\n"),
    ("      wgmma_wait<1>();\n      fence_operands(lg);\n      publish(lg, i + 1);\n    }\n  }\n",
     "      SSR_CYC(4, wgmma_wait<1>());\n      fence_operands(lg);\n"
     "      SSR_CYC(5, publish(lg, i + 1));\n    }\n  }\n  cyc[6] += clock64() - c_loop;\n"
     "  if (tig == 0) {\n"
     "    for (int j = 0; j < 7; ++j) atomicAdd(&dh_cycles[j], static_cast<unsigned long long>(cyc[j]));\n"
     "    atomicAdd(&dh_cycles[7], 1ull);\n  }\n"),
)

READER = """
extern "C" int ssr_dh_cycles(void* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, dh_cycles, sizeof(dh_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[8] = {};
    e = cudaMemcpyToSymbol(dh_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
"""


def instrumented_source(src: str) -> str:
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_ce.cu no longer has this step once: {old[:60]!r}")
        src = src.replace(old, new)
    return src + READER


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", default="4,13230,1024,2056", help="K,N,Hh,C")
    p.add_argument("--seed", type=int, default=6)
    args = p.parse_args(argv)
    import torch

    from ssr_speech_tpu_torch import ce_bench
    from ssr_speech_tpu_torch.device import resolve_device
    from ssr_speech_tpu_torch.ops import fused_ce as fce
    from ssr_speech_tpu_torch.ops.cuda_build import CSRC

    device = resolve_device("cuda")
    shape = tuple(int(x) for x in args.shape.split(","))
    gen = torch.Generator().manual_seed(args.seed)
    hidden, w2, b2, tgt, g = ce_bench.make_inputs(shape, gen, device, torch.bfloat16)
    w2t = fce.transpose_w2(w2)
    _, logz, _ = fce.ce_forward(hidden, w2, b2, tgt, w2t=w2t)
    run = lambda: fce.ce_backward_dhidden(hidden, w2, b2, tgt, logz, g, w2t)  # noqa: E731
    kernel_ms = ce_bench.kernel_device_ms(run, 10)

    copy = CSRC / "fused_ce_cycles.cu"
    copy.write_text(instrumented_source((CSRC / "fused_ce.cu").read_text()))
    try:
        fce._KERNEL = "fused_ce_cycles"
        lib = fce.load_kernel().lib
        lib.ssr_dh_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ssr_dh_cycles.restype = ctypes.c_int
        buf = (ctypes.c_ulonglong * 8)()
        run()
        torch.cuda.synchronize(device)
        if lib.ssr_dh_cycles(ctypes.addressof(buf), 1):
            raise RuntimeError("reading the counters failed")
        run()
        torch.cuda.synchronize(device)
        if lib.ssr_dh_cycles(ctypes.addressof(buf), 0):
            raise RuntimeError("reading the counters failed")
        copy_ms = ce_bench.kernel_device_ms(run, 10)
    finally:
        fce._KERNEL = "fused_ce"
        copy.unlink()
    groups, tiles = buf[7], -(-shape[3] // 32)
    per_tile = {name: buf[j] / groups / tiles for j, name in enumerate(NAMES)}
    print(f"[dhidden cycles] {list(shape)}: {groups} warpgroups x {tiles} tiles; "
          "cycles a tile a warpgroup: "
          + ", ".join(f"{k} {v:.1f}" for k, v in per_tile.items())
          + f"; kernel {kernel_ms}, instrumented copy {copy_ms} (ms by kernel)", flush=True)
    return {"shape": list(shape), "per_tile": per_tile, "kernel_ms": kernel_ms,
            "copy_ms": copy_ms}


if __name__ == "__main__":
    main()
