"""Explicit device and dtype resolution for the port.

Nothing in the port picks a device on its own: callers name one. Asking for
``cuda`` on a machine without a usable card raises instead of carrying on on
the CPU. The compute dtype follows the device: float32 on the CPU (parity with
the JAX reference), bfloat16 on CUDA (the JAX package's ``dtype_name``
default).
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` -> a checked ``torch.device``."""
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
