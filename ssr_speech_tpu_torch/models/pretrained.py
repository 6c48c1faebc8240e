"""Load LM and codec checkpoints into the port (port of
``ssr_speech_tpu/models/pretrained.py``).

Two formats, as in JAX:
- our bundles (``.pkl``): a pickle of numpy pytrees with the model config
  beside them as a dict (``utils/checkpoint.py``, which also holds
  ``save_bundle`` / ``save_step_checkpoint``, re-exported here), so bundles
  written by the JAX trainer load here as they are;
- the reference's torch checkpoints (``.pth`` / ``.th`` / ``.pt``): the LM
  bundle ``{model, config (argparse namespace), phn2num}``
  (``steps/trainer.py:220-229``; the published ``English.pth`` /
  ``Mandarin.pth``) and the audiocraft codec export (``wmencodec.th``). They
  go through ``models.convert`` (the port's copy of JAX's converter) into the
  JAX parameter layout, then through ``models.from_jax`` into tensors.

``fetch_checkpoint`` resolves a local file, or a directory plus a file name.
The URL and hub branches of the JAX package download, which the port does
not do: they raise and name the local path to pass instead.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..config import (CodecConfig, SSRModelConfig, TokenSpace,
                      codec_config_from_json, ssr_config_from_json)
from ..data.tokenizer import AudioTokenizer
from ..device import compute_dtype
from ..utils.checkpoint import (load_bundle, save_bundle,  # noqa: F401
                                save_step_checkpoint)
from . import convert as cvt
from .from_jax import SSRLM, codec_from_jax, lm_from_jax

# file names of the published checkpoints (reference README.md:60-72)
LM_FILENAME = "English.pth"
CODEC_FILENAME = "wmencodec.th"
TORCH_SUFFIXES = (".pth", ".th", ".pt")

# Expected SHA256 of the published files, keyed by basename; None until a
# verified copy has been hashed (the JAX package's registry, the same keys).
KNOWN_SHA256: Dict[str, Optional[str]] = {
    "English.pth": None,
    "Mandarin.pth": None,
    "wmencodec.th": None,
}


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _verify_sha256(path: str, expected: Optional[str]) -> None:
    if expected is None:
        expected = KNOWN_SHA256.get(os.path.basename(path))
    if expected is None:
        return
    got = file_sha256(path)
    if got != expected:
        raise ValueError(
            f"checkpoint SHA256 mismatch for {path}: expected {expected}, "
            f"got {got} — corrupted download or wrong file")


def fetch_checkpoint(file_or_dir: str, filename: Optional[str] = None,
                     sha256: Optional[str] = None) -> str:
    """Resolve a checkpoint reference to a local path: an existing file is
    itself, an existing directory gives ``dir/filename``. When a SHA256 is
    known (``sha256`` or :data:`KNOWN_SHA256`), the file is checked first. A
    URL or a hub repo id raises: download the file and pass its path."""
    ref = str(file_or_dir)
    if os.path.isfile(ref):
        path = ref
    elif os.path.isdir(ref):
        assert filename, "filename required with a checkpoint directory"
        path = os.path.join(ref, filename)
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
    elif ref.startswith(("https://", "http://")):
        raise RuntimeError(
            f"{ref}: the port does not download checkpoints; fetch the file "
            "and pass its local path")
    elif os.path.splitext(ref)[1] in TORCH_SUFFIXES + (".pkl",):
        raise FileNotFoundError(ref)
    else:
        assert filename is not None, \
            "filename needs to be defined if using HF checkpoints"
        raise RuntimeError(
            f"{ref}: the port does not fetch hub checkpoints; download "
            f"{filename} and pass its local path (a file, or its directory)")
    _verify_sha256(path, sha256)
    return path


def _unwrap_state_dict(sd):
    """audiocraft checkpoints nest the weights (``{'best_state': {'model':
    ...}}``); LM bundles keep them under ``model``: unwrap until a flat
    tensor dict."""
    for key in ("best_state", "model", "state_dict"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return sd


def _numpy_state_dict(sd) -> Dict:
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in _unwrap_state_dict(sd).items()}


def torch_state_dict(path: str) -> Dict:
    """A reference torch checkpoint's flat weights as numpy arrays (nested
    audiocraft layouts unwrapped)."""
    return _numpy_state_dict(torch.load(path, map_location="cpu",
                                        weights_only=False))


def load_lm_params(path: str):
    """LM checkpoint -> (JAX-layout numpy params, config, phn2num), from our
    ``.pkl`` bundle or the reference's torch bundle (its geometry from the
    pickled argparse namespace)."""
    path = fetch_checkpoint(path, filename=LM_FILENAME)
    if path.endswith(TORCH_SUFFIXES):
        bundle = torch.load(path, map_location="cpu", weights_only=False)
        args = bundle["config"]
        ns = vars(args) if not isinstance(args, dict) else args
        cfg = SSRModelConfig(
            d_model=ns["d_model"], nhead=ns["nhead"],
            num_layers=ns["num_decoder_layers"],
            n_codebooks=ns["n_codebooks"],
            audio_embedding_dim=ns["audio_embedding_dim"],
            text_vocab_size=ns["text_vocab_size"],
            tokens=TokenSpace(audio_vocab_size=int(ns["audio_vocab_size"]),
                              max_n_spans=ns["max_n_spans"]))
        params = cvt.convert_ssr_lm(_numpy_state_dict(bundle["model"]), cfg)
        return params, cfg, bundle["phn2num"]
    bundle = load_bundle(path)
    cfg = ssr_config_from_json(json.dumps(bundle["model_config"]))
    return bundle.pop("params"), cfg, bundle["phn2num"]


def load_lm(path: str, device: torch.device
            ) -> Tuple[SSRLM, SSRModelConfig, Dict[str, int]]:
    """LM checkpoint -> (model on ``device`` in its compute dtype, config,
    phn2num)."""
    params, cfg, phn2num = load_lm_params(path)
    model = lm_from_jax(params, cfg, device=device,
                        dtype=compute_dtype(device))
    return model, cfg, phn2num


def load_codec_params(path: str):
    """Codec checkpoint -> (JAX-layout numpy params, config): our ``.pkl``
    bundle (its stored config when it has one, else the default
    ``CodecConfig()``) or the published torch export (the default
    geometry)."""
    path = fetch_checkpoint(path, filename=CODEC_FILENAME)
    cfg = CodecConfig()
    if path.endswith(TORCH_SUFFIXES):
        return cvt.convert_wmencodec(torch_state_dict(path), cfg), cfg
    bundle = load_bundle(path)
    if bundle.get("config") is not None:
        cfg = codec_config_from_json(json.dumps(bundle["config"]))
    return bundle["params"], cfg


def load_codec(path: str, device: torch.device) -> AudioTokenizer:
    """Codec checkpoint -> ``AudioTokenizer`` on ``device``."""
    params, cfg = load_codec_params(path)
    return AudioTokenizer(codec_from_jax(params, cfg, device=device), cfg)
