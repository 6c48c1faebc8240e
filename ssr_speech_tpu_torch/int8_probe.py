"""Can a decode step stream its weights at int8 bandwidth? The port's
counterpart of the TPU probes ``tools/int8_kernel_probe{,2,3}.py``.

    python3 -m ssr_speech_tpu_torch.int8_probe      # from the root of a checkout

At the 830M LM's widths (d_model 2048, FFN 8192, 16 layers) it runs chains of
16 matvecs, ``h <- (h @ W)[:, :d_model]``, with 2 and with 8 activation rows,
and prints for each one line with its time and the int8-effective rate (the
int8 weight bytes of the chain over the time):

- ``bf16 matmul``: ``torch.matmul`` on the dequantised bf16 weights, the
  baseline (the TPU probe's ``chain_bf16``, which also runs outside any
  hand-written kernel);
- ``weight_int8pack_mm``: PyTorch's own int8-weight matmul
  (``torch._weight_int8pack_mm`` on the transposed weight, scales rounded to
  bf16), a yardstick the port never calls;
- ``int8_matvec``: 16 launches of K7;
- ``chain bf16`` / ``chain int8``: 16 launches of K8 in each mode;
- ``int8_matvec chain graph``, ``chain bf16 graph``, ``chain int8 graph``:
  the same 16 launches captured once in a CUDA graph and replayed (the
  TPU probe dispatches its chain as one ``jax.jit`` executable); the replay
  must equal the eager chain bit for bit. On the card only: ``--device cpu``
  prints why they are skipped;
- ``megakernel``: all 16 layers in one persistent launch.

The TPU probes chain ONE [2048, 8192] matrix 16 times. On an H100 that
matrix (16.8 MB) stays in the 50 MB L2, so each chain is timed twice: over
the one shared matrix (``same``: streams from L2) and over 16 distinct
matrices (``distinct``, 268 MB, the megakernel's own input: streams from
device memory). Only the ``distinct`` lines speak of memory bandwidth.

Weights are the probes' own seeded random ones (``int8_matvec`` takes
``quantize_weight`` of a normal(0, 0.02) matrix as probe 1 does; the others
integers in [-127, 127) with scales 0.01 |normal|), or with ``--model_path``
the first FFN weights of an LM bundle, quantised per output channel.

Times come from CUDA events after a warm-up, twice for each line: ``ms`` as
a caller sees it (eager Python launches, the host's time between launches
included) and ``device_ms`` with the launches queued behind a long matmul, so
that the kernels run back to back and the host's pace drops out. The rate
printed is that of ``device_ms``. The default device is the card and the
probe raises without one; ``--device cpu`` runs the plain versions at
whatever small size is asked for (the tests) and reports host seconds, no
rate. ``main`` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .device import resolve_device
from .ops import int8_matmul as i8

ROWS = (2, 8)  # the probes' own: 2 rows in probes 1 and 2, 8 in probe 3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--d_model", type=int, default=2048)
    p.add_argument("--ffn_dim", type=int, default=8192)
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_path", default=None,
                   help="LM bundle (.pkl): probe its first FFN weights "
                        "instead of the seeded random ones")
    return p


def probe_weights(args, device) -> Dict[str, torch.Tensor]:
    """The seeded weights of the three TPU probes (numpy, as they draw them),
    or a bundle's ffn1_w quantised."""
    d, f, n_layers = args.d_model, args.ffn_dim, args.layers
    rng = np.random.default_rng(args.seed)
    w1 = torch.from_numpy(rng.normal(size=(d, f), scale=0.02).astype(np.float32))
    q1, s1 = i8.quantize_weight(w1.to(device))
    if args.model_path:
        from .models.from_jax import int8_ffn_from_jax
        from .utils.checkpoint import load_bundle

        wq, s = int8_ffn_from_jax(load_bundle(args.model_path)["params"], device)
        if tuple(wq.shape[1:]) != (d, f) or wq.shape[0] < n_layers:
            raise ValueError(f"--model_path: ffn1_w is {tuple(wq.shape)}, the "
                             f"probe was asked for {(n_layers, d, f)}")
        wq, s = wq[:n_layers].contiguous(), s[:n_layers].contiguous()
    else:
        wq = torch.from_numpy(rng.integers(-127, 127, size=(n_layers, d, f)
                                           ).astype(np.int8)).to(device)
        s = torch.from_numpy((np.abs(rng.normal(size=(n_layers, 1, f))) * 0.01
                              ).astype(np.float32)).to(device)
    x = {b: torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)
                             ).to(device, torch.bfloat16) for b in ROWS}
    return dict(q1=q1, s1=s1, wq=wq, s=s, x=x)


def _time_ms(fn: Callable, iters: int, device) -> float:
    """Milliseconds per call: CUDA events on the card, the host clock on the
    CPU."""
    out = fn()  # warm-up (and the kernels' build)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    del out
    return start.elapsed_time(end) / iters


QUEUED_CALLS = 5


def queued_ms(fn: Callable, eager_ms: float, device, calls: int = QUEUED_CALLS
              ) -> float:
    """Milliseconds per call of the device work alone: ``calls`` calls are
    enqueued while the card is busy with a blocker (square bf16 matmuls
    lasting longer than the host needs to enqueue them, judged from
    ``eager_ms``), so they run back to back."""
    a = torch.ones((8192, 8192), dtype=torch.bfloat16, device=device)
    scratch = torch.empty_like(a)
    torch.matmul(a, a, out=scratch)
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(4 + int(calls * eager_ms * 2.0)):  # >= ~1.2 ms each
        torch.matmul(a, a, out=scratch)
    start.record()
    for _ in range(calls):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    del out
    return start.elapsed_time(end) / calls


def library_chain(x, w_t, s_bf, n_layers: int):
    """The yardstick: ``torch._weight_int8pack_mm`` a layer, ``w_t`` the
    int8 weight transposed ([N, K] shared or [L, N, K]), ``s_bf`` its scales
    in bf16 ([N] or [L, N])."""
    h, k = x, x.shape[1]
    for layer in range(n_layers):
        w, sc = (w_t[layer], s_bf[layer]) if w_t.dim() == 3 else (w_t, s_bf)
        h = torch._weight_int8pack_mm(h, w, sc)[:, :k]
    return h


def _launch_counts() -> Dict[str, int]:
    return {"int8_matvec": i8.matvec_launches,
            "int8_chain_bf16": i8.chain_bf16_launches,
            "int8_chain_int8": i8.chain_int8_launches,
            "int8_megakernel": i8.mega_launches}


def matmul_chain(x, w_bf, n_layers: int):
    """The baseline: bf16 ``torch.matmul`` on dequantised weights ([K, N]
    shared or [L, K, N])."""
    h, k = x, x.shape[1]
    for layer in range(n_layers):
        h = torch.matmul(h, w_bf[layer] if w_bf.dim() == 3 else w_bf)[:, :k]
    return h


def matvec_chain(x, w_q, scale, n_layers: int):
    """Probe 1's chain: ``int8_matvec`` per layer, ``h <- y[:, :K]``."""
    h, k = x, x.shape[1]
    for layer in range(n_layers):
        w, s = i8._layer_weights(w_q, scale, layer)
        h = i8.int8_matvec(h, w, s)[:, :k]
    return h


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = "cpu (plain versions, host clock)"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.strip().splitlines()[device.index or 0]
    n_layers, d, f = args.layers, args.d_model, args.ffn_dim
    wts = probe_weights(args, device)
    q1, s1, wq, s = wts["q1"], wts["s1"], wts["wq"], wts["s"]
    dequant = lambda q, sc: (q.float() * sc.float()).to(torch.bfloat16)
    w_bf = dequant(wq, s)
    weights = {  # variant -> (int8 weights, scales, bf16 dequantised)
        "same": {"matvec": (q1, s1, dequant(q1, s1[None, :])),
                 "chain": (wq[0], s[0], w_bf[0])},
        "distinct": {"matvec": (wq, s, w_bf), "chain": (wq, s, w_bf)}}
    library = {  # variant -> (transposed int8 weights, bf16 scales)
        "same": (wq[0].t().contiguous(), s[0, 0].to(torch.bfloat16)),
        "distinct": (wq.transpose(1, 2).contiguous(),
                     s[:, 0].to(torch.bfloat16))}
    mb = n_layers * d * f / 1e6  # int8 weight bytes a chain streams
    lines, outputs = [], {}
    print(f"[int8_probe] D {d}, F {f}, {n_layers} layers, {mb:.1f} MB of int8 "
          f"weights a chain, rows {ROWS}, {args.iters} timed calls [{card}]")

    def measure(name, kernel, rows, variant, fn, eager=None):
        """One line. ``eager``: the name of the eager chain whose launches
        ``fn`` replays from a CUDA graph: the capture's launches are
        counted apart, and the replay must equal that chain's output."""
        rec = {}
        if eager is not None:
            before = _launch_counts()
            graph = i8.Captured(fn)
            after = _launch_counts()
            rec = {"captured_launches": after[kernel] - before[kernel],
                   "graph_edges": graph.edges,
                   "programmatic_edges": graph.programmatic_edges}
            fn = graph
        before = _launch_counts()
        ms = _time_ms(fn, args.iters, device)
        calls = args.iters + 1
        if cuda:
            device_ms = queued_ms(fn, ms, device)
            calls += QUEUED_CALLS
        after = _launch_counts()
        out = fn().clone()
        rec.update({"name": name, "kernel": kernel, "rows": rows,
                    "weights": variant, "ms": ms, "calls": calls,
                    "launches": after[kernel] - before[kernel] if kernel else 0,
                    "finite": bool(torch.isfinite(out.float()).all()),
                    "device": device.type})
        if eager is not None:
            rec["equal_to_eager"] = torch.equal(out, outputs[(eager, rows, variant)])
        if cuda:
            rec["device_ms"] = device_ms
            rec["int8_effective_gb_s"] = mb / device_ms
        lines.append(rec)
        outputs[(name, rows, variant)] = out
        rate = (f"queued {device_ms:8.4f} ms = {mb / device_ms:6.0f} GB/s "
                f"int8-effective" if cuda else "host clock, no device rate")
        graph = (f"; graph of {rec['captured_launches']} captured launches, "
                 f"{rec['programmatic_edges']} of {rec['graph_edges']} edges "
                 f"programmatic, equal to the eager chain: {rec['equal_to_eager']}"
                 if eager is not None else "")
        print(f"[int8_probe] rows {rows} {variant:8s} {name:24s}: {ms:8.4f} ms  "
              f"{rate}{graph}")

    if not cuda:
        print("[int8_probe] the CUDA-graph lines are skipped: a graph needs the "
              "card (the CPU runs the plain versions)")
    for rows in ROWS:
        x = wts["x"][rows]
        for variant, w in weights.items():
            mq, ms_, mbf = w["matvec"]
            cq, cs, cbf = w["chain"]
            measure("bf16 matmul", None, rows, variant,
                    lambda: matmul_chain(x, cbf, n_layers))
            measure("weight_int8pack_mm", None, rows, variant,
                    lambda: library_chain(x, *library[variant], n_layers))
            chains = {"int8_matvec": ("int8_matvec", lambda: matvec_chain(
                x, mq, ms_, n_layers))}
            for mode in i8.MODES:
                chains[f"chain {mode}"] = (f"int8_chain_{mode}", functools.partial(
                    i8.int8_matvec_chain, x, cq, cs, mode, n_layers))
            for name, (kernel, fn) in chains.items():
                measure(name, kernel, rows, variant, fn)
            for name, (kernel, fn) in chains.items():
                if cuda:
                    measure(f"{name} graph", kernel, rows, variant, fn, eager=name)
        measure("megakernel", "int8_megakernel", rows, "distinct",
                lambda: i8.int8_megakernel(x, wq, s))
    if cuda:
        for key, label in (("ms", "as called"), ("device_ms", "queued")):
            best = {r["name"]: r[key] for r in lines
                    if r["rows"] == ROWS[-1] and r["weights"] == "distinct"}
            print(f"[int8_probe] distinct weights, rows {ROWS[-1]}, {label}: "
                  "bf16 matmul chain / time: " + ", ".join(
                      f"{k} {best['bf16 matmul'] / v:.2f}x"
                      for k, v in best.items() if k != "bf16 matmul")
                  + f" [{card}]")
    return {"card": card, "device": device.type, "d_model": d, "ffn_dim": f,
            "layers": n_layers, "chain_int8_mb": mb, "lines": lines,
            "outputs": outputs}


if __name__ == "__main__":
    main()
    sys.exit(0)
