"""Build the port's modules from JAX parameter pytrees.

A JAX bundle (``ssr_speech_tpu/utils/checkpoint.py``) is a pickle of nested
dicts and lists of numpy arrays. :class:`ParamTree` mirrors that nesting as an
``nn.Module`` (dict -> submodule, list -> ``nn.ModuleList``), so ``.to(device)``
moves a whole model and the port's functions index it with the JAX keys:
``params["decoder"]["layers"]["qkv_w"]``. For serving an array becomes a
buffer (:func:`lm_from_jax`); for training it becomes a trainable fp32
``nn.Parameter`` (:func:`trainable_lm_from_jax`), and :func:`lm_to_numpy` turns
the trained tree back into a bundle pytree that both packages load.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ssr_speech_tpu.config import CodecConfig, SSRModelConfig

from ..utils.tree import tree_map


class ParamTree(nn.Module):
    """A nested parameter dict as a module; indexed like the JAX pytree."""

    def __init__(self, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, trainable))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(x, trainable)
                                                   for x in val))
            elif trainable:  # an fp32 master copy, never a view of ``val``
                self.register_parameter(key, nn.Parameter(
                    _as_tensor(val).to(torch.float32, copy=True)))
            else:
                self.register_buffer(key, _as_tensor(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return (key in self._parameters or key in self._buffers
                or key in self._modules)

    def tree(self) -> Dict[str, Any]:
        """The tensors themselves (parameters or buffers) in the JAX
        nesting: dicts, lists for ``nn.ModuleList``."""
        out: Dict[str, Any] = {**self._parameters, **self._buffers}
        for key, mod in self._modules.items():
            out[key] = ([m.tree() for m in mod] if isinstance(mod, nn.ModuleList)
                        else mod.tree())
        return out


def _as_tensor(val) -> torch.Tensor:
    if isinstance(val, torch.Tensor):
        return val
    arr = np.ascontiguousarray(np.asarray(val))
    if not arr.flags.writeable:  # e.g. a view of a jax.Array
        arr = arr.copy()
    return torch.from_numpy(arr)


class SSRLM(ParamTree):
    """SSR-Speech LM parameters plus the config they were built for."""

    def __init__(self, params: Dict[str, Any], cfg: SSRModelConfig,
                 trainable: bool = False):
        super().__init__(params, trainable)
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


def trainable_lm_from_jax(params: Dict[str, Any], cfg: SSRModelConfig, *,
                          device="cpu") -> SSRLM:
    """JAX ``init_ssr`` / bundle params (or the port's ``init_ssr`` tree) ->
    :class:`SSRLM` of fp32 ``nn.Parameter`` master weights on ``device``, in
    the same nesting. The trainer casts them to the compute dtype at each
    use, as the JAX trainer does."""
    return SSRLM(params, cfg, trainable=True).to(device)


def lm_to_numpy(model: ParamTree) -> Dict[str, Any]:
    """Inverse of :func:`trainable_lm_from_jax`: the params pytree as numpy
    arrays (what ``params`` holds in a bundle)."""
    return to_numpy_tree(model.tree())


def codec_from_jax(params: Dict[str, Any], cfg: CodecConfig, *,
                   device="cpu") -> WMEncodec:
    """JAX ``init_wmencodec`` / bundle params -> :class:`WMEncodec` (fp32,
    as the JAX codec runs)."""
    return WMEncodec(params, cfg).to(device).eval()


def to_numpy_tree(tree):
    """Tensors -> numpy arrays throughout a nested dict/list (for bundles)."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)
