"""Build the port's modules from JAX parameter pytrees.

A JAX bundle (``ssr_speech_tpu/utils/checkpoint.py``) is a pickle of nested
dicts and lists of numpy arrays. :class:`ParamTree` mirrors that nesting as an
``nn.Module`` (dict -> submodule, list -> ``nn.ModuleList``, array -> buffer),
so ``.to(device)`` moves a whole model and the port's functions index it with
the JAX keys: ``params["decoder"]["layers"]["qkv_w"]``. Arrays become buffers,
not parameters: the port serves, it does not train yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ssr_speech_tpu.config import CodecConfig, SSRModelConfig


class ParamTree(nn.Module):
    """A nested parameter dict as a module; indexed like the JAX pytree."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(x) for x in val))
            else:
                self.register_buffer(key, _as_tensor(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._buffers or key in self._modules


def _as_tensor(val) -> torch.Tensor:
    if isinstance(val, torch.Tensor):
        return val
    arr = np.ascontiguousarray(np.asarray(val))
    if not arr.flags.writeable:  # e.g. a view of a jax.Array
        arr = arr.copy()
    return torch.from_numpy(arr)


class SSRLM(ParamTree):
    """SSR-Speech LM parameters plus the config they were built for."""

    def __init__(self, params: Dict[str, Any], cfg: SSRModelConfig):
        super().__init__(params)
        self.cfg = cfg
        _check_shape(self["decoder"]["layers"]["qkv_w"],
                     (cfg.num_layers, cfg.d_model, 3 * cfg.d_model), "qkv_w")
        _check_shape(self["audio_emb"],
                     (cfg.n_codebooks, cfg.cardinality, cfg.d_model), "audio_emb")
        _check_shape(self["text_emb"], (cfg.n_text_tokens, cfg.d_model),
                     "text_emb")


class WMEncodec(ParamTree):
    """Watermarked EnCodec parameters plus their config."""

    def __init__(self, params: Dict[str, Any], cfg: CodecConfig):
        super().__init__(params)
        self.cfg = cfg
        _check_shape(self["quantizer"]["embed"],
                     (cfg.rvq.n_q, cfg.rvq.bins, cfg.rvq.dimension), "embed")


def _check_shape(t: torch.Tensor, want, name: str) -> None:
    """Bundles come from outside: fail on a config/params mismatch here,
    not as a shape error deep inside a forward."""
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name}: params have shape {tuple(t.shape)}, the "
                         f"config implies {tuple(want)}")


def lm_from_jax(params: Dict[str, Any], cfg: SSRModelConfig, *,
                device="cpu", dtype: torch.dtype = torch.float32) -> SSRLM:
    """JAX ``init_ssr`` / bundle params -> :class:`SSRLM` on ``device``.

    The decoder's matmul weights and biases are stored in ``dtype`` (the
    compute dtype: bf16 on CUDA), as JAX casts them at each use; embeddings,
    norms, positional alphas and the prediction heads stay fp32."""
    from .transformer import MATMUL_KEYS

    model = SSRLM(params, cfg).to(device)
    layers = model["decoder"]["layers"]
    for key in MATMUL_KEYS:
        setattr(layers, key, layers[key].to(dtype))
    return model.eval()


def codec_from_jax(params: Dict[str, Any], cfg: CodecConfig, *,
                   device="cpu") -> WMEncodec:
    """JAX ``init_wmencodec`` / bundle params -> :class:`WMEncodec` (fp32,
    as the JAX codec runs)."""
    return WMEncodec(params, cfg).to(device).eval()


def to_numpy_tree(tree):
    """Tensors -> numpy arrays throughout a nested dict/list (for bundles)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
