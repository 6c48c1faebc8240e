"""Load LM and codec bundles into the port (the ``.pkl`` branch of
``ssr_speech_tpu/models/pretrained.py``).

A bundle is the JAX package's format: a pickle of numpy pytrees with the model
config beside them (``ssr_speech_tpu/utils/checkpoint.py``), so bundles
written by the JAX trainer load here as they are. Converting the published
torch checkpoints (``English.pth``, ``wmencodec.th``) waits until those files
are available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
from typing import Any, Dict, Tuple

import torch

from ssr_speech_tpu.config import (CodecConfig, SSRModelConfig,
                                   codec_config_from_json, ssr_config_from_json)
from ssr_speech_tpu.utils.checkpoint import load_bundle

from ..data.tokenizer import AudioTokenizer
from ..device import compute_dtype
from .from_jax import SSRLM, codec_from_jax, lm_from_jax, to_numpy_tree


def _bundle_path(path: str) -> str:
    if path.endswith((".pth", ".th", ".pt")):
        raise NotImplementedError(
            f"{path}: converting published torch checkpoints is not ported "
            "yet; pass a .pkl bundle")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path


def load_lm(path: str, device: torch.device
            ) -> Tuple[SSRLM, SSRModelConfig, Dict[str, int]]:
    """LM bundle -> (model on ``device`` in its compute dtype, config,
    phn2num)."""
    bundle = load_bundle(_bundle_path(path))
    cfg = ssr_config_from_json(json.dumps(bundle["model_config"]))
    model = lm_from_jax(bundle.pop("params"), cfg, device=device,
                        dtype=compute_dtype(device))
    return model, cfg, bundle["phn2num"]


def load_codec(path: str, device: torch.device) -> AudioTokenizer:
    """Codec bundle -> ``AudioTokenizer`` on ``device`` (the stored config
    when the bundle has one, else the default ``CodecConfig()``)."""
    bundle = load_bundle(_bundle_path(path))
    cfg = CodecConfig()
    if bundle.get("config") is not None:
        cfg = codec_config_from_json(json.dumps(bundle["config"]))
    return AudioTokenizer(codec_from_jax(bundle["params"], cfg, device=device),
                          cfg)


def save_bundle(path: str, **entries: Any) -> None:
    """Atomically write a bundle in the JAX package's format (tensors become
    numpy arrays, dataclass configs dicts) without importing JAX."""
    payload = {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
               else to_numpy_tree(v) for k, v in entries.items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def save_step_checkpoint(dirpath: str, step: int, keep_last: int = 3,
                         **entries: Any) -> None:
    """``ckpt_<step:08d>.pkl`` under ``dirpath``, keeping the newest
    ``keep_last`` (the rule of the JAX ``save_step_checkpoint``; the JAX
    ``latest_checkpoint`` finds them)."""
    os.makedirs(dirpath, exist_ok=True)
    save_bundle(os.path.join(dirpath, f"ckpt_{step:08d}.pkl"), **entries)
    cks = sorted(f for f in os.listdir(dirpath)
                 if re.fullmatch(r"ckpt_\d+\.pkl", f))
    for old in cks[:-keep_last]:
        os.remove(os.path.join(dirpath, old))
