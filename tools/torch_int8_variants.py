#!/usr/bin/env python3
"""Variants of the int8 streaming kernel (K7/K8) and the megakernel (K9),
timed against them on one card.

    python3 tools/torch_int8_variants.py [--first_form FILE.cu] [--rounds 2]
        [--only NAME,...] [--cases k8,k9]

Each variant is ``ssr_speech_tpu_torch/csrc/int8_matmul.cu`` with a few lines
replaced (``VARIANTS``: anchor, replacement; each anchor must occur once, so
the tool fails loudly once the kernel changes). They are written beside it as
``int8_matmul_v_<name>.cu`` (removed at exit), built in parallel and loaded
through ``int8_matmul._KERNEL``. ``--first_form`` adds the kernels a file
holds as they are (for instance the tree before the megakernel's rebuild,
whose megakernel is the first form: ``git show
2413141:ssr_speech_tpu_torch/csrc/int8_matmul.cu``;
a file without the switch for programmatic dependent launch gets a stub).
Per round, each kernel in turn, a line with the queued ms
(``int8_probe.queued_ms``) of

- ``k8``: one 16-layer chain over 16 distinct [2048, 8192] matrices in mode
  bf16 at 2, 8 and 64 rows and in mode int8 at 2 rows, and over one shared
  (L2-resident) matrix at 2 rows, each with PDL on and off;
- ``k9``: the megakernel over the same 16 distinct matrices at 2 and 8
  rows, and, where the library has it, its weight stream alone
  (``int8_mega_stream``: the persistent grid's ring with no products). The
  first form's megakernel is called through its own signature (h fp32 [2,
  8, K], no flags).

Outputs are checked against the kernel's: the int8 mode bit for bit, bf16
within 5e-2 of the largest (a variant may sum in another order; the
megakernel's ring depth does not change its order, so its variants must
agree bit for bit); a ``probe_`` variant is not a kernel and is not
checked. Needs the card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

_TRIG_PROLOGUE = ("  if (Tr <= kStages) pdl_launch_dependents();  // every thread: its last "
                  "stage is issued\n")
_TRIG_LOOP = ("    if (u >= 1 && u - 1 + kStages == Tr - 1) pdl_launch_dependents();  // the "
              "last stage is issued\n")

VARIANTS = {
    # 8 warps a block at one row group too (4 k-parts), not 16
    "parts4": (("constexpr int kWideParts = 8;", "constexpr int kWideParts = 4;"),),
    # two stages in flight a block instead of three
    "stages2": (("constexpr int kStages = 3; ", "constexpr int kStages = 2; "),),
    # four: all of a block's K at [2048, 8192] is issued before the wait
    "stages4": (("constexpr int kStages = 3; ", "constexpr int kStages = 4; "),),
    # the next grid scheduled once the loop ends, not once the last stage is issued
    "trigger_after_loop": ((_TRIG_PROLOGUE, ""), (_TRIG_LOOP, ""),
                           ("  SSR_MARK(3);\n", "  SSR_MARK(3);\n  pdl_launch_dependents();\n")),
    # the two blocks of a cluster take the two halves of K, not alternate stages
    "halves": (("  const int Tr = (T - static_cast<int>(rank) + kCluster - 1) / kCluster;  "
                "// ... of this block",
                "  const int Th = (T + 1) / 2;\n  const int Tr = rank == 0 ? Th : T - Th;"),
               ("  auto stage_k = [&](int u) { return (kCluster * u + static_cast<int>(rank)) "
                "* kStageRows; };",
                "  auto stage_k = [&](int u) { return (static_cast<int>(rank) * Th + u) * "
                "kStageRows; };")),
    # the TMA's L2 promotion: none, or 256 bytes, instead of 128
    "l2_none": (("CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_NONE"),),
    "l2_256": (("CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"),),
    # not a kernel: the stream alone, every k-step's loads and products left
    # out (its output is not checked), for the rate the TMA ring reaches
    "probe_stream_only": (("      if (k0 < K) {  // warp-uniform; K is a multiple of kStep",
                           "      if (k0 < 0) {"),),
    # the megakernel with a ring of 4 stages (128 KB) instead of 6
    "mega_ring4": (("constexpr int kMegaStages = 6;", "constexpr int kMegaStages = 4;"),),
}

# a first form without the switch for programmatic dependent launch
NO_PDL = '\nextern "C" int ssr_int8_set_pdl(int on) { return 0; }\n'
CASES = (("bf16", 2, "distinct"), ("bf16", 8, "distinct"), ("bf16", 64, "distinct"),
         ("int8", 2, "distinct"), ("bf16", 2, "same"))
MEGA_ROWS = (2, 8)


def first_form_mega(lib, x, wq, s):
    """The first form's megakernel entry point: (x, w, scale, h fp32 [2, 8, K], out,
    B, L, K, N, grid_request, *grid_used, stream)."""
    import ctypes

    import torch

    fn = lib.ssr_int8_mega_bf16
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.POINTER(i32), ptr]
    (b, k), (n_layers, _, n) = x.shape, wq.shape
    h = torch.empty((2, 8, k), dtype=torch.float32, device=x.device)
    out = torch.empty((b, k), dtype=torch.bfloat16, device=x.device)
    grid = ctypes.c_int(0)
    err = fn(x.data_ptr(), wq.data_ptr(), s.data_ptr(), h.data_ptr(), out.data_ptr(), b,
             n_layers, k, n, 0, ctypes.byref(grid), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the first form's megakernel failed: CUDA error {err}")
    return out


def bind_first_form(i8, lib) -> None:
    """Bind the entry points the first form shares with the kernel, so that
    ``int8_matmul.load_kernel`` finds its library bound; its megakernel has
    its own signature (``first_form_mega``) and it has no weight stream
    alone."""
    i8.bind(lib, [name for name in i8.ENTRY_POINTS
                  if name != "ssr_int8_mega_bf16" and hasattr(lib, name)])


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel no longer has this line once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--first_form", default=None, help="a .cu of the first form to time beside")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--only", default=None, help="comma-separated variant names")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--cases", default="k8,k9", help="k8, k9 or both")
    args = p.parse_args(argv)
    cases = args.cases.split(",")
    import numpy as np
    import torch

    from ssr_speech_tpu_torch import int8_probe
    from ssr_speech_tpu_torch.device import resolve_device
    from ssr_speech_tpu_torch.ops import cuda_build
    from ssr_speech_tpu_torch.ops import int8_matmul as i8

    device = resolve_device("cuda")
    print("[card] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    src = (cuda_build.CSRC / "int8_matmul.cu").read_text()
    names = args.only.split(",") if args.only else list(VARIANTS)
    sources = {"kernel": None}
    for name in names:
        sources[name] = variant_source(src, VARIANTS[name])
    if args.first_form:
        text = Path(args.first_form).read_text()
        sources["first_form"] = text + ("" if "ssr_int8_set_pdl" in text else NO_PDL)
    libs = {}
    for name, text in sources.items():
        if text is None:
            libs[name] = "int8_matmul"
            continue
        libs[name] = f"int8_matmul_v_{name}"
        (cuda_build.CSRC / f"{libs[name]}.cu").write_text(text)
    results = {}
    try:
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(cuda_build.load, libs.values()))
        if "first_form" in libs:
            bind_first_form(i8, cuda_build.load(libs["first_form"]).lib)
        d, f, n_layers = 2048, 8192, 16
        rng = np.random.default_rng(args.seed)
        wq = torch.from_numpy(rng.integers(-127, 127, size=(n_layers, d, f)).astype(np.int8)
                              ).to(device)
        s = torch.from_numpy((np.abs(rng.normal(size=(n_layers, 1, f))) * 0.01
                              ).astype(np.float32)).to(device)
        xs = {r: torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32)).to(
            device, torch.bfloat16) for r in (2, 8, 64)}
        ref = {}
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                i8._KERNEL = lib
                line = {}
                for mode, rows, variant in CASES if "k8" in cases else ():
                    if name.startswith("mega_"):
                        continue  # the megakernel's variants leave K7/K8 as they are
                    w, sc = (wq, s) if variant == "distinct" else (wq[0], s[0])
                    run = lambda: i8.int8_matvec_chain(xs[rows], w, sc, mode, n_layers)  # noqa: E731
                    out = run()
                    key = (mode, rows, variant)
                    if name.startswith("probe_"):
                        pass
                    elif key not in ref:
                        ref[key] = out
                    elif mode == "int8" and not torch.equal(out, ref[key]):
                        raise RuntimeError(f"{name} {key}: the int8 mode differs")
                    elif ((out.float() - ref[key].float()).abs().max()
                          / ref[key].float().abs().max()).item() > 5e-2:
                        raise RuntimeError(f"{name} {key}: bf16 differs beyond 5e-2")
                    eager = int8_probe._time_ms(run, 3, device)
                    on = int8_probe.queued_ms(run, eager, device)
                    i8.PDL = False
                    try:
                        off = int8_probe.queued_ms(run, eager, device)
                    finally:
                        i8.PDL = True
                    line[f"{mode} rows {rows} {variant}"] = (on, off)
                lib_handle = i8.load_kernel().lib
                for rows in MEGA_ROWS if "k9" in cases else ():
                    if name == "first_form":
                        run = lambda: first_form_mega(lib_handle, xs[rows], wq, s)  # noqa: E731
                    else:
                        run = lambda: i8.int8_megakernel(xs[rows], wq, s)  # noqa: E731
                    out = run()
                    key = ("mega", rows)
                    if name.startswith("probe_"):
                        pass
                    elif key not in ref:
                        ref[key] = out
                    elif name.startswith("mega_") and not torch.equal(out, ref[key]):
                        raise RuntimeError(f"{name} {key}: the megakernel differs")
                    elif ((out.float() - ref[key].float()).abs().max()
                          / ref[key].float().abs().max()).item() > 5e-2:
                        raise RuntimeError(f"{name} {key}: differs beyond 5e-2")
                    eager = int8_probe._time_ms(run, 3, device)
                    q = int8_probe.queued_ms(run, eager, device)
                    line[f"megakernel rows {rows}"] = (q, None)
                if "k9" in cases and hasattr(lib_handle, "ssr_int8_mega_stream"):
                    run = lambda: i8.int8_mega_stream(wq)  # noqa: E731
                    eager = int8_probe._time_ms(run, 3, device)
                    line["megakernel stream alone"] = (int8_probe.queued_ms(run, eager, device), None)
                results.setdefault(name, []).append(line)
                print(f"[int8 variants] round {rnd} {name}: " + "; ".join(
                    f"{k} {v[0]:.4f}" + (f" (PDL off {v[1]:.4f})" if v[1] is not None else "")
                    for k, v in line.items()), flush=True)
    finally:
        i8._KERNEL = "int8_matmul"
        for lib in libs.values():
            if lib != "int8_matmul":
                (cuda_build.CSRC / f"{lib}.cu").unlink(missing_ok=True)
    return results


if __name__ == "__main__":
    main()
