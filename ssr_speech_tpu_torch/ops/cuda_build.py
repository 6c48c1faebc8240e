"""Build the port's hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled for Hopper
(``sm_90a``) into ``csrc/build/lib<name>_<hash>.so`` at first use; the hash
covers the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one is loaded as built. Nothing here runs at import time: a CPU-only process
imports the wrappers and never builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH, else
    the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


class BuiltLibrary:
    """A loaded kernel library plus how it was obtained (for reports)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 ptxas_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when the .so was reused
        self.ptxas_log = ptxas_log


def check_layout(kernel: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA tensor
    (what the kernels' vector loads and raw pointers assume)."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel needs contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel needs 16-byte aligned {name}")


@functools.cache
def load(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` if needed and ``dlopen`` it (once per
    process)."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds, log = 0.0, ""
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return BuiltLibrary(ctypes.CDLL(str(so)), so, seconds, log)
