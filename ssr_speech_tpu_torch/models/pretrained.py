"""Load LM and codec bundles into the port (the ``.pkl`` branch of
``ssr_speech_tpu/models/pretrained.py``).

A bundle is the format both packages share: a pickle of numpy pytrees with the
model config beside them as a dict (``utils/checkpoint.py``, which also holds
``save_bundle`` / ``save_step_checkpoint``, re-exported here), so bundles
written by the JAX trainer load here as they are. Converting the published
torch checkpoints (``English.pth``, ``wmencodec.th``) waits until those files
are available.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

from ..config import (CodecConfig, SSRModelConfig, codec_config_from_json,
                      ssr_config_from_json)
from ..data.tokenizer import AudioTokenizer
from ..device import compute_dtype
from ..utils.checkpoint import (load_bundle, save_bundle,  # noqa: F401
                                save_step_checkpoint)
from .from_jax import SSRLM, codec_from_jax, lm_from_jax


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
