"""Checkpoint store: atomic bundle save/load (the port's own copy of
``ssr_speech_tpu/utils/checkpoint.py``).

A bundle is one pickle of nested dicts and lists of numpy arrays with the
model config beside them as a plain dict: host-portable, no framework pin, so
a bundle written by either package loads in the other. Writes are atomic
(tmp + rename) and numbered checkpoints keep the newest N.

Left out against the JAX module: ``save_sharded`` / ``load_sharded`` (orbax,
one writer per host) wait for the port's parallelism; ``_to_numpy`` walks the
tree itself (tensors to numpy arrays, dataclass configs to dicts) instead of
``jax.tree.map``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
from typing import Any, Dict, Optional

from .tree import to_numpy_tree

_CKPT = r"ckpt_\d+\.pkl"


def save_bundle(path: str, **entries: Any) -> None:
    """Atomically write a checkpoint bundle (tmp + rename). Tensors become
    numpy arrays and dataclass configs dicts."""
    payload = {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
               else to_numpy_tree(v) for k, v in entries.items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_bundle(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


def _checkpoints(dirpath: str):
    return sorted(f for f in os.listdir(dirpath) if re.fullmatch(_CKPT, f))


def save_step_checkpoint(dirpath: str, step: int, keep_last: int = 3,
                         **entries: Any) -> None:
    """``ckpt_<step:08d>.pkl`` under ``dirpath``, keeping the newest
    ``keep_last``."""
    os.makedirs(dirpath, exist_ok=True)
    save_bundle(os.path.join(dirpath, f"ckpt_{step:08d}.pkl"), **entries)
    for old in _checkpoints(dirpath)[:-keep_last]:
        os.remove(os.path.join(dirpath, old))


def latest_checkpoint(dirpath: str) -> Optional[str]:
    if not os.path.isdir(dirpath):
        return None
    cks = _checkpoints(dirpath)
    return os.path.join(dirpath, cks[-1]) if cks else None
