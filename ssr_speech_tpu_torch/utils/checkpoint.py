"""Checkpoint store: atomic bundle save/load (the port's own copy of
``ssr_speech_tpu/utils/checkpoint.py``).

A bundle is one pickle of nested dicts and lists of numpy arrays with the
model config beside them as a plain dict: host-portable, no framework pin, so
a bundle written by either package loads in the other. Writes are atomic
(tmp + rename) and numbered checkpoints keep the newest N.

``save_sharded`` / ``load_sharded`` are the counterpart of JAX's orbax pair on
``torch.distributed.checkpoint``: each rank writes its own blocks, and a
restore re-shards onto whatever layout the reader runs (tp=2 training ->
tp=4 serving, an fsdp layout -> one process). The directory format is
torch's, not orbax's: neither package reads the other's sharded checkpoints
(bundles stay the interchange). ``_to_numpy`` walks the tree itself (tensors
to numpy arrays, dataclass configs to dicts) instead of ``jax.tree.map``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
from typing import Any, Dict, Optional

import torch

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


# ------------------------------------------------------- sharded checkpoints

def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _unflat(template, flat, path=""):
    if isinstance(template, dict):
        return {k: _unflat(v, flat, f"{path}/{k}" if path else k)
                for k, v in template.items()}
    return flat[path]


def _dtensor(mesh, local, spec):
    """``local`` (this rank's block under ``spec``) as a DTensor over the
    mesh. A packed dim (``mesh.QKV``) is viewed as [.., n, d] so that each
    rank's block is one contiguous shard of it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    spec, local = _unpacked(spec, local)
    placements = []
    for name in mesh.names:
        dims = [d for d, e in enumerate(spec) if e == name]
        placements.append(Shard(dims[0]) if dims and mesh.size(name) > 1
                          else Replicate())
    if mesh.device_mesh.device_type == "cpu":
        local = local.cpu()
    return DTensor.from_local(local.contiguous(), mesh.device_mesh, placements,
                              run_check=False)


def _unpacked(spec, t):
    """A spec without packed entries, and ``t`` viewed to match it."""
    for d, e in enumerate(spec):
        if isinstance(e, tuple):
            axis, n = e
            t = t.reshape(t.shape[:d] + (n, t.shape[d] // n) + t.shape[d + 1:])
            return spec[:d] + (None, axis) + spec[d + 1:], t
    return spec, t


def save_sharded(path: str, tree, mesh=None, specs=None) -> None:
    """Write a tree of tensors with ``torch.distributed.checkpoint``.

    Over a mesh, ``tree`` holds this rank's blocks and ``specs`` their
    placement (``parallel.mesh`` specs); every rank calls this and writes
    its own shards. Without a mesh the tensors are whole (one process)."""
    import torch.distributed.checkpoint as dcp

    from ..parallel.mesh import _align

    flat = _flat(tree)
    if mesh is None or mesh.device_mesh is None:
        dcp.save({k: v.detach() for k, v in flat.items()}, checkpoint_id=path,
                 no_dist=True)
        return
    fspecs = _flat(_align(specs, tree))
    dcp.save({k: _dtensor(mesh, v.detach(), fspecs[k]) for k, v in flat.items()},
             checkpoint_id=path)


def load_sharded(path: str, template, mesh=None, specs=None):
    """Read what :func:`save_sharded` wrote into the layout of ``template``:
    a tree of tensors of the reader's local shapes and dtypes (its blocks
    under ``specs`` over ``mesh``; whole tensors without a mesh), on the
    device the result should live on. Returns a new tree."""
    import torch.distributed.checkpoint as dcp

    from ..parallel.mesh import _align

    flat = _flat(template)
    if mesh is None or mesh.device_mesh is None:
        # a packed leaf was written as [.., n, d]: read it in that shape
        stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        state = {k: torch.empty(tuple(stored[k].size), dtype=v.dtype,
                                device=v.device) for k, v in flat.items()}
        dcp.load(state, checkpoint_id=path, no_dist=True)
        return _unflat(template, {k: state[k].reshape(flat[k].shape)
                                  for k in flat})
    fspecs = _flat(_align(specs, template))
    state = {k: _dtensor(mesh, torch.empty_like(v), fspecs[k])
             for k, v in flat.items()}
    dcp.load(state, checkpoint_id=path)
    out = {k: state[k].to_local().reshape(flat[k].shape).to(flat[k].device)
           for k in flat}
    return _unflat(template, out)
