"""Explicit device and dtype resolution for the port.

Nothing in the port picks a device on its own: callers name one. Asking for
``cuda`` on a machine without a usable card raises instead of carrying on on
the CPU. The compute dtype follows the device: float32 on the CPU (parity with
the JAX reference), bfloat16 on CUDA (the JAX package's ``dtype_name``
default).
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` -> a checked ``torch.device``.
    A CUDA device is initialised here: the allocator's statistics calls
    (``reset_peak_memory_stats``, which the CLIs make first) refuse a device
    of a process that has not touched CUDA yet."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False (no card, or a CPU-only PyTorch build)")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(name)!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        dev = torch.device("cuda", index)
        torch.cuda.init()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cpu or cuda)")
    return dev


def set_precision_policy() -> None:
    """Process-wide: fp32 matmuls and cuDNN convolutions in full fp32, not
    TF32 (cuDNN defaults it on). The codec and the LM heads run in fp32 as in
    JAX, and TF32 would keep only about three decimal digits of them. Entry
    points (the CLI, ``chip_smoke.py``) call this once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compute_dtype(device: torch.device) -> torch.dtype:
    """Activation/weight dtype of the LM decoder on ``device``."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


@contextlib.contextmanager
def deterministic_algorithms():
    """Deterministic kernels inside the block, process-wide, restored after:
    cuDNN's deterministic convolution algorithms and PyTorch's deterministic
    implementations where it has them (an op without one warns and runs as
    before), so that a run repeats on one machine as a JAX run does. Memory
    is not filled on allocation."""
    import torch.utils.deterministic as det

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark, det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         det.fill_uninitialized_memory) = before[2:]
