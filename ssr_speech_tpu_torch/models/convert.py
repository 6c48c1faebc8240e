"""Checkpoint converters of the port (host copy of
``ssr_speech_tpu/models/convert.py``): reference PyTorch state dicts ->
JAX-layout numpy parameter trees.

The two reference model families:
  - the wmencodec codec (keys per ``audiocraft`` module naming; loaded by
    reference ``solvers/wmcompression.py:281-362``),
  - the SSR LM bundle (``steps/trainer.py:220-241`` saves
    ``{model, optimizer, scheduler, config, phn2num}``).

Input is a flat dict of numpy arrays (:func:`load_torch_file` reads a
``.th``/``.pth``). The output is the JAX package's parameter layout, which
``models.from_jax.lm_from_jax`` and ``codec_from_jax`` turn into the port's
tensors, so a published checkpoint reaches the port through the same
numbers as the JAX package's conversion.

Layout conventions (see ``models/codec/conv.py`` and ``models/transformer.py``):
  torch Conv1d     [Cout, Cin, K]  -> ours [K, Cin, Cout]
  torch ConvTr1d   [Cin, Cout, K]  -> ours [K, Cin, Cout], kernel flipped
  torch Linear     [Out, In]       -> ours [In, Out]
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import CodecConfig, SSRModelConfig

Array = np.ndarray
StateDict = Mapping[str, Array]


class _TrackingStateDict(dict):
    """Records which keys a converter read, so the caller can assert that no
    reference weight was silently dropped (a renamed/resized checkpoint would
    otherwise convert 'successfully' with garbage gaps)."""

    def __init__(self, sd: StateDict):
        super().__init__(sd)
        self.used: set = set()

    def __getitem__(self, k):
        self.used.add(k)
        return dict.__getitem__(self, k)


def _check_consumed(tracked: _TrackingStateDict, ignorable: List[str],
                    what: str) -> None:
    pats = [re.compile(p) for p in ignorable]
    left = sorted(k for k in tracked
                  if k not in tracked.used
                  and not any(p.fullmatch(k) for p in pats))
    if left:
        raise ValueError(
            f"{what}: {len(left)} state-dict keys were not consumed by the "
            f"converter (checkpoint layout mismatch?): {left[:8]}"
            + (" ..." if len(left) > 8 else ""))


def _j(prefix: str, rest: str) -> str:
    return rest if not prefix else f"{prefix}.{rest}"


def load_torch_file(path: str, key: Optional[str] = None) -> Dict[str, Array]:
    """Load a torch checkpoint into numpy arrays (on the host)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None:
        obj = obj[key]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------- convs

def _conv_params(sd: StateDict, prefix: str) -> Dict[str, Array]:
    """StreamableConv1d: ``<prefix>.conv.conv.{weight|weight_g+weight_v,bias}``."""
    base = _j(prefix, "conv.conv")
    out: Dict[str, Array] = {"b": np.asarray(sd[f"{base}.bias"])}
    if f"{base}.weight_v" in sd:
        v = np.asarray(sd[f"{base}.weight_v"])  # [Cout, Cin, K]
        g = np.asarray(sd[f"{base}.weight_g"])  # [Cout, 1, 1]
        out["v"] = v.transpose(2, 1, 0)  # [K, Cin, Cout]
        out["g"] = g.reshape(1, 1, -1)  # per-Cout gain
    else:
        w = np.asarray(sd[f"{base}.weight"])
        out["w"] = w.transpose(2, 1, 0)
    return out


def _convtr_params(sd: StateDict, prefix: str) -> Dict[str, Array]:
    """StreamableConvTranspose1d: ``<prefix>.convtr.convtr.*`` with
    time-flip into the lhs-dilated-conv layout."""
    base = _j(prefix, "convtr.convtr")
    out: Dict[str, Array] = {"b": np.asarray(sd[f"{base}.bias"])}
    if f"{base}.weight_v" in sd:
        v = np.asarray(sd[f"{base}.weight_v"])  # [Cin, Cout, K]
        g = np.asarray(sd[f"{base}.weight_g"])  # [Cin, 1, 1]
        out["v"] = v[:, :, ::-1].transpose(2, 0, 1).copy()  # [K, Cin, Cout]
        out["g"] = g.reshape(1, -1, 1)  # per-Cin gain (torch dim=0 on convtr)
    else:
        w = np.asarray(sd[f"{base}.weight"])
        out["w"] = w[:, :, ::-1].transpose(2, 0, 1).copy()
    return out


def _resblock_params(sd: StateDict, prefix: str) -> Dict[str, Any]:
    """SEANetResnetBlock: block.1 (k3) and block.3 (k1) convs
    (reference seanet.py:42-51, true_skip identity shortcut)."""
    return dict(
        conv1=_conv_params(sd, _j(prefix, "block.1")),
        conv2=_conv_params(sd, _j(prefix, "block.3")),
    )


def _lstm_params(sd: StateDict, prefix: str, num_layers: int) -> Dict[str, Any]:
    layers = []
    for i in range(num_layers):
        layers.append(dict(
            wih=np.asarray(sd[_j(prefix, f"lstm.weight_ih_l{i}")]),
            whh=np.asarray(sd[_j(prefix, f"lstm.weight_hh_l{i}")]),
            bih=np.asarray(sd[_j(prefix, f"lstm.bias_ih_l{i}")]),
            bhh=np.asarray(sd[_j(prefix, f"lstm.bias_hh_l{i}")]),
        ))
    return dict(layers=layers)


# ------------------------------------------------------------------- SEANets

def convert_seanet_encoder(sd: StateDict, prefix: str, cfg: CodecConfig) -> Dict[str, Any]:
    """Map the encoder's flat nn.Sequential indices (reference
    seanet.py:113-150) onto our structured params."""
    sn = cfg.seanet
    ratios = list(reversed(sn.ratios))
    idx = 0
    params: Dict[str, Any] = dict(conv_in=_conv_params(sd, _j(prefix, f"model.{idx}")))
    idx += 1
    params["groups"] = []
    for ratio in ratios:
        res = []
        for j in range(sn.n_residual_layers):
            res.append(_resblock_params(sd, _j(prefix, f"model.{idx}")))
            idx += 1
        idx += 1  # activation
        down = _conv_params(sd, _j(prefix, f"model.{idx}"))
        idx += 1
        params["groups"].append(dict(res=res, down=down))
    if sn.lstm:
        params["lstm"] = _lstm_params(sd, _j(prefix, f"model.{idx}"), sn.lstm)
        idx += 1
    idx += 1  # activation
    params["conv_out"] = _conv_params(sd, _j(prefix, f"model.{idx}"))
    return params


def convert_seanet_decoder(sd: StateDict, prefix: str, cfg: CodecConfig) -> Dict[str, Any]:
    """Map the decoder's flat indices (reference seanet.py:209-254)."""
    sn = cfg.seanet
    idx = 0
    params: Dict[str, Any] = dict(conv_in=_conv_params(sd, _j(prefix, f"model.{idx}")))
    idx += 1
    if sn.lstm:
        params["lstm"] = _lstm_params(sd, _j(prefix, f"model.{idx}"), sn.lstm)
        idx += 1
    params["groups"] = []
    for ratio in sn.ratios:
        idx += 1  # activation
        up = _convtr_params(sd, _j(prefix, f"model.{idx}"))
        idx += 1
        res = []
        for j in range(sn.n_residual_layers):
            res.append(_resblock_params(sd, _j(prefix, f"model.{idx}")))
            idx += 1
        params["groups"].append(dict(up=up, res=res))
    idx += 1  # activation
    params["conv_out"] = _conv_params(sd, _j(prefix, f"model.{idx}"))
    return params


def convert_wm_decoder(sd: StateDict, prefix: str, cfg: CodecConfig) -> Dict[str, Any]:
    """WMSEANetDecoder (reference seanet.py:425-553)."""
    n_up = len(cfg.seanet.ratios)
    params: Dict[str, Any] = dict(
        decoder=convert_seanet_decoder(sd, prefix, cfg),
        skip_encoder=convert_seanet_encoder(sd, _j(prefix, "skip_encoder"), cfg),
        wm_encoder=convert_seanet_encoder(sd, _j(prefix, "wm_encoder"), cfg),
        wm_embed=np.asarray(sd[_j(prefix, "wm_embed.weight")]),
        projs=[
            dict(conv=_conv_params(sd, _j(prefix, f"wm_proj{i}.1"))) for i in range(n_up)
        ],
        predictor=dict(conv=_conv_params(sd, _j(prefix, "wm_predictor.1"))),
    )
    return params


def convert_wmencodec(sd: StateDict, cfg: CodecConfig,
                      strict: bool = True) -> Dict[str, Any]:
    """Full WMEncodecModel state dict -> params for
    ``models.codec.wmencodec`` (reference wmencodec.py:142-160).

    With ``strict`` (default) every checkpoint tensor must be consumed,
    except known inference-irrelevant training state: the RVQ codebook EMA
    buffers (core_vq.py ``cluster_size``/``embed_avg``/``inited``) and — only
    at non-published geometries with fewer than 4 upsampling stages — the
    reference's hardcoded-but-unused extra ``wm_proj{2,3}`` stacks
    (seanet.py:513-539 always creates four)."""
    n_q = cfg.rvq.n_q
    tracked = _TrackingStateDict(sd)
    embed = np.stack(
        [np.asarray(tracked[f"quantizer.vq.layers.{k}._codebook.embed"]) for k in range(n_q)]
    )
    params = dict(
        encoder=convert_seanet_encoder(tracked, "encoder", cfg),
        decoder=convert_seanet_decoder(tracked, "decoder", cfg),
        wmdecoder=convert_wm_decoder(tracked, "wmdecoder", cfg),
        quantizer=dict(embed=embed),
    )
    if strict:
        n_up = len(cfg.seanet.ratios)
        ignorable = [
            r"quantizer\.vq\.layers\.\d+\._codebook\.(cluster_size|embed_avg|inited)",
        ] + [rf"wmdecoder\.wm_proj{i}\..*" for i in range(n_up, 4)]
        _check_consumed(tracked, ignorable, "convert_wmencodec")
    return params


# -------------------------------------------------------------------- SSR LM

def convert_ssr_lm(sd: StateDict, cfg: SSRModelConfig,
                   strict: bool = True) -> Dict[str, Any]:
    """Reference SSR_Speech state dict -> params for ``models.ssr``
    (key names per models/ssr.py:132-179 and modules/transformer.py).

    With ``strict`` (default) every checkpoint tensor must be consumed —
    mask-embedding rows live inside ``audio_embedding.*`` (card includes the
    mts sentinels) so a full bundle has no legitimate leftovers; a leftover
    means the geometry passed in ``cfg`` does not match the file."""
    K, L = cfg.n_codebooks, cfg.num_layers
    sd = _TrackingStateDict(sd)

    def t(name):  # torch Linear weight -> [In, Out]
        return np.asarray(sd[name]).T

    layers = []
    for l in range(L):
        p = f"decoder.layers.{l}"
        layers.append(dict(
            ln1_w=np.asarray(sd[f"{p}.norm1.weight"]),
            ln1_b=np.asarray(sd[f"{p}.norm1.bias"]),
            qkv_w=t(f"{p}.self_attn.in_proj_weight"),
            qkv_b=np.asarray(sd[f"{p}.self_attn.in_proj_bias"]),
            out_w=t(f"{p}.self_attn.out_proj.weight"),
            out_b=np.asarray(sd[f"{p}.self_attn.out_proj.bias"]),
            ln2_w=np.asarray(sd[f"{p}.norm2.weight"]),
            ln2_b=np.asarray(sd[f"{p}.norm2.bias"]),
            ffn1_w=t(f"{p}.linear1.weight"),
            ffn1_b=np.asarray(sd[f"{p}.linear1.bias"]),
            ffn2_w=t(f"{p}.linear2.weight"),
            ffn2_b=np.asarray(sd[f"{p}.linear2.bias"]),
        ))
    stacked = {
        k: np.stack([lay[k] for lay in layers]) for k in layers[0]
    }
    decoder = dict(
        layers=stacked,
        final_ln_w=np.asarray(sd["decoder.norm.weight"]),
        final_ln_b=np.asarray(sd["decoder.norm.bias"]),
    )
    params = dict(
        text_emb=np.asarray(sd["text_embedding.word_embeddings.weight"]),
        audio_emb=np.stack(
            [np.asarray(sd[f"audio_embedding.{k}.word_embeddings.weight"]) for k in range(K)]
        ),
        text_pos_alpha=np.asarray(sd["text_positional_embedding.alpha"]).reshape(1),
        audio_pos_alpha=np.asarray(sd["audio_positional_embedding.alpha"]).reshape(1),
        decoder=decoder,
        head1_w=np.stack([t(f"predict_layer.{k}.0.weight") for k in range(K)]),
        head1_b=np.stack([np.asarray(sd[f"predict_layer.{k}.0.bias"]) for k in range(K)]),
        head2_w=np.stack([t(f"predict_layer.{k}.2.weight") for k in range(K)]),
        head2_b=np.stack([np.asarray(sd[f"predict_layer.{k}.2.bias"]) for k in range(K)]),
    )
    if strict:
        _check_consumed(sd, [], "convert_ssr_lm")
    return params
