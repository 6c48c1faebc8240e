"""Time the fused CE head's three kernels alone, at the training path's shape.

    python3 -m ssr_speech_tpu_torch.ce_bench        # from the root of a checkout

For ``--shape K,N,Hh,C`` (default 4,13230,1024,2056: the 830M head on a
training batch of 18 rows x 735 frames) it prints one line a kernel — the
forward (``ops/fused_ce.py::ce_forward``: the transpose of w2, the target-logit
pre-pass and the pass), dhidden (``ce_backward_dhidden``) and dw2/db2
(``ce_backward_dw2``; both handed the transposed weights as the training path
hands them) — with:

- its largest error against the plain version (``reference_ce_head`` and its
  autograd), relative to the plain output's largest magnitude; for the forward
  also the pre-pass's target logit against the plain one and the rows whose
  top-k hit differs;
- ``ms`` as a caller sees it (eager Python launches), ``queued`` with the
  launches enqueued behind a long matmul, so that the host's pace drops out,
  and the plain version's time;
- the device time of each kernel by name, from ``torch.profiler`` (the
  forward's pre-pass and the transpose apart from its pass), or "not measured"
  where the profiler sees no device time;
- its bound (the larger of bytes over the card's memory rate and operations
  over its bf16 tensor-core peak; the backward kernels recompute the logits,
  two products each) and the share of that peak that ``queued`` comes to.

Before the lines come ptxas's register, spill and C75xx lines of the library.
The default device is the card, and the script raises without one.
``--device cpu`` runs the plain versions (dense and tiled) at whatever small
``--shape`` is asked for (the tests) and reports host milliseconds, no rate.
``main`` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List, Optional

import torch

from .device import resolve_device
from .flash_bench import PEAK_BF16_OPS_PER_S, kernel_device_ms
from .int8_probe import _time_ms, queued_ms
from .ops import fused_ce as fce

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM
TRAIN_SHAPE = (4, 13230, 1024, 2056)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=6)
    p.add_argument("--shape", default=",".join(str(x) for x in TRAIN_SHAPE),
                   help="K,N,Hh,C")
    return p


def make_inputs(shape, gen, device, dtype):
    k, n, hh, c = shape
    hidden = torch.randn((k, n, hh), generator=gen).to(device, dtype)
    w2 = (torch.randn((k, hh, c), generator=gen) / hh ** 0.5).to(device, dtype)
    b2 = (torch.randn((k, c), generator=gen) * 0.1).to(device, dtype)
    tgt = torch.randint(0, c, (k, n), generator=gen, dtype=torch.int32).to(device)
    g = torch.randn((k, n), generator=gen).to(device)
    return hidden, w2, b2, tgt, g


def rel_err(got, want) -> float:
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    return err / scale if scale > 0 else err


def bounds_ms(shape) -> dict:
    """The least time one H100 could take for each kernel's work: every input
    read once and every output written once over the memory rate, or the
    products over the bf16 peak."""
    k, n, hh, c = shape
    one_pass = 2 * k * n * hh * c
    ins = 2 * (k * n * hh + k * hh * c + k * c) + 4 * k * n
    work = {"fwd": (ins + 3 * 4 * k * n, one_pass),
            "dhidden": (ins + 2 * 4 * k * n + 2 * k * n * hh, 2 * one_pass),
            "dw2": (ins + 2 * 4 * k * n + 4 * (k * hh * c + k * c), 2 * one_pass)}
    return {name: {"ms": max(b / HBM_BYTES_PER_S, ops / PEAK_BF16_OPS_PER_S) * 1e3,
                   "ops": ops} for name, (b, ops) in work.items()}


def by_kernel(d) -> str:
    if d is None:
        return "by kernel not measured"
    return ", ".join(
        f"{n.replace('(anonymous namespace)::', '').split('(')[0][:60]} {t:.4f}"
        for n, t in sorted(d.items()))


def measure_cpu(shape, args, device, gen) -> dict:
    hidden, w2, b2, tgt, g = make_inputs(shape, gen, device, torch.float32)
    nll, logz, hits = fce.tiled_ce_forward(hidden, w2, b2, tgt)
    p_nll, p_hits = fce.reference_ce_head(hidden, w2, b2, tgt)
    rec = {"shape": list(shape),
           "nll_abs_err": (nll - p_nll).abs().max().item(),
           "hits_differ": int((hits != p_hits).sum()),
           "plain_ms": _time_ms(lambda: fce.reference_ce_head(hidden, w2, b2, tgt),
                                args.iters, device),
           "tiled_fwd_ms": _time_ms(lambda: fce.tiled_ce_forward(hidden, w2, b2, tgt),
                                    args.iters, device),
           "tiled_dw2_ms": _time_ms(lambda: fce.tiled_ce_dw2(hidden, w2, b2, tgt, logz, g),
                                    args.iters, device)}
    print(f"[ce_bench] {list(shape)} on the host: plain forward "
          f"{rec['plain_ms']:.3f} ms, tiled plain forward "
          f"{rec['tiled_fwd_ms']:.3f} ms (nll off by {rec['nll_abs_err']:.2e}, "
          f"hits differ on {rec['hits_differ']} rows), tiled plain dw2/db2 "
          f"{rec['tiled_dw2_ms']:.3f} ms", flush=True)
    return rec


def measure(shape, args, device, gen) -> dict:
    k, n, hh, c = shape
    hidden, w2, b2, tgt, g = make_inputs(shape, gen, device, torch.bfloat16)
    w2t = fce.transpose_w2(w2)
    fce._check_cuda_args(hidden, w2, b2, tgt)
    nll, logz, hits, tlogit = fce.ce_forward_with_target_logits(hidden, w2, b2, tgt)
    dhid = fce.ce_backward_dhidden(hidden, w2, b2, tgt, logz, g, w2t)
    dw2, db2 = fce.ce_backward_dw2(hidden, w2, b2, tgt, logz, g, w2t)
    torch.cuda.synchronize(device)

    leaves = [t.clone().requires_grad_() for t in (hidden, w2, b2)]
    p_nll, p_hits = fce.reference_ce_head(*leaves, tgt)
    want = torch.autograd.grad(p_nll, leaves, g, retain_graph=True)
    with torch.no_grad():
        p_tlogit = fce.target_logits(hidden, w2t, b2, tgt)
        p_logz = p_nll + p_tlogit
    rec = {"shape": list(shape), "bounds": bounds_ms(shape),
           "errs": {"nll": rel_err(nll, p_nll), "logz": rel_err(logz, p_logz),
                    "dhidden": rel_err(dhid, want[0]), "dw2": rel_err(dw2, want[1]),
                    "db2": rel_err(db2, want[2])},
           "tlogit_abs_err": (tlogit - p_tlogit).abs().max().item(),
           "hits_differ": int((hits != p_hits).sum())}

    def plain_bwd(inputs):
        return lambda: torch.autograd.grad(p_nll, inputs, g, retain_graph=True)

    def plain_fwd():
        with torch.no_grad():
            return fce.reference_ce_head(hidden, w2, b2, tgt)

    runs = (("fwd", lambda: fce.ce_forward(hidden, w2, b2, tgt), plain_fwd),
            ("dhidden", lambda: fce.ce_backward_dhidden(hidden, w2, b2, tgt, logz, g, w2t),
             plain_bwd(leaves[:1])),
            ("dw2", lambda: fce.ce_backward_dw2(hidden, w2, b2, tgt, logz, g, w2t),
             plain_bwd(leaves[1:])))
    for name, fn, plain in runs:
        ms = _time_ms(fn, args.iters, device)
        dev_ms = queued_ms(fn, ms, device, calls=args.iters)
        bound = rec["bounds"][name]
        rec[name] = {"ms": ms, "device_ms": dev_ms,
                     "plain_ms": _time_ms(plain, args.iters, device),
                     "share_of_bf16_peak": bound["ops"] / PEAK_BF16_OPS_PER_S / (dev_ms / 1e3),
                     "kernels_device_ms": kernel_device_ms(fn, args.iters)}
    errs = rec["errs"]
    notes = {"fwd": f"nll {errs['nll']:.2e}, logz {errs['logz']:.2e} of the plain "
                    f"version's max, the pre-pass's target logit off by "
                    f"{rec['tlogit_abs_err']:.2e}, hits differ on "
                    f"{rec['hits_differ']} of {k * n} rows",
             "dhidden": f"{errs['dhidden']:.2e} of the plain version's max",
             "dw2": f"dw2 {errs['dw2']:.2e}, db2 {errs['db2']:.2e} of the plain "
                    f"version's max"}
    for name in ("fwd", "dhidden", "dw2"):
        r = rec[name]
        print(f"[ce_bench] {name} {list(shape)}: {notes[name]}; {r['ms']:.4f} ms "
              f"as called, {r['device_ms']:.4f} queued "
              f"({r['share_of_bf16_peak']:.3f} of the bf16 peak; bound "
              f"{rec['bounds'][name]['ms']:.4f} ms; "
              f"{by_kernel(r['kernels_device_ms'])}), plain {r['plain_ms']:.4f}",
              flush=True)
    return rec


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    shape = tuple(int(x) for x in args.shape.split(","))
    if len(shape) != 4:
        raise ValueError(f"--shape takes K,N,Hh,C, got {args.shape!r}")
    res = {}
    if device.type != "cuda":
        res["case"] = measure_cpu(shape, args, device, gen)
        return res
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    for line in fce.load_kernel().ptxas_log.splitlines():
        if any(w in line for w in ("Used", "spill", "C75", "Compiling")):
            print(f"[ce_bench] {line.strip()[:200]}")
    res["case"] = measure(shape, args, device, gen)
    print(f"[ce_bench] {res['card']}")
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
