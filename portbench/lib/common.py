"""What every cell shares: the files found by name, the card's peaks, the
guard against JAX in the process, and the result line.

Everything a cell, a configuration, a traffic mix or a per-layer metric owns
lives in a file of its own, found here by the name ``BENCHMARK.json`` gives
it:

- ``workloads/<cell>.json``: the configuration, the traffic mix, the loop
  that drives it (``loops/<loop>.py``) and the cell's settings;
- ``configs/<config>.json``: the sizes as run;
- ``traffic/<mix>.json``: the parameters ``lib/traffic.py`` draws from;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``rooflines/<unit>.py``: operations and bytes of a counted unit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent  # the checkout

# NVIDIA H100 SXM data sheet, dense: what a roofline share is taken against
# (the card's power limit is printed beside every result)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores: TF32 is off
PEAK_HBM_BYTES = 3.35e12

# top-level module names that may not be loaded in a measured process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ssr_speech_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic_params(mix: str) -> dict:
    return load_json(HERE / "traffic" / f"{mix}.json")


def load_file_module(path: Path, name: str):
    """A module from a file whose name may hold dots (``metrics/a.b.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return load_file_module(HERE / "metrics" / f"{name}.py",
                            "portbench_metric_" + name.replace(".", "_"))


def roofline(unit: str):
    return load_file_module(HERE / "rooflines" / f"{unit}.py",
                            "portbench_roofline_" + unit)


def loop(name: str):
    return load_file_module(HERE / "loops" / f"{name}.py",
                            "portbench_loop_" + name)


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole: ``ssr_speech_tpu_torch`` is not ``ssr_speech_tpu``."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout (the
    port's nvcc builds go to its own ``csrc/build``)."""
    cache = HERE / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv_compute"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def metrics_for(cell: str, bench: dict, trace: bool) -> Dict[str, dict]:
    """The metric entries of ``BENCHMARK.json`` this cell reports: its
    end-to-end metrics with ``--trace 0`` (one without ``workloads`` in
    every cell), its per-layer ones with 1 (each lists its cells)."""
    if trace:
        return {m["name"]: m for m in bench["per_layer"]
                if cell in m["workloads"]}
    return {m["name"]: m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: List[dict], breakdown: Optional[dict] = None) -> str:
    """The last line of standard output; ``checks`` (each number compared,
    with its limit) goes last."""
    line = dict(correct=bool(correct), attempted=int(attempted),
                failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def checks_text(checks: List[dict]) -> str:
    return "\n".join(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
                     f"({'ok' if c['ok'] else 'FAILED'})" for c in checks)
