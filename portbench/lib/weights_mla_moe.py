"""Seeded random weights of the SSR LM with Moonlight-16B-A3B's block
(``configs/ssr-moonlight-a3b-greedy.json``), made on the device, in the
layout of the port's parameter tree (``ssr_speech_tpu_torch/models/
mla_moe.py``): stacked layers, attention and dense matrices [in, out], the
experts' [out, in].

Both sides get them from here, as ``lib/weights.py``'s: the port as its
parameters, the plain reference (``reference/lm_mla_moe.py``) by calling
the same function again with the same seed after the window. The SSR
leaves (embeddings and heads, fp32) are ``lib/weights.py``'s draw; the
block's matrices are drawn in place in their served dtype, a layer's at a
time, so that no draw holds more than one layer and nothing is drawn in
fp32 first. Distributions (``assumed`` in the configuration): every block
matrix and the router U(+-1/sqrt(fan_in)), norm weights 1.

``e_bias`` is not drawn: it is what a trained ``noaux_tc`` correction bias
is, the one that balances the experts' load. DeepSeek-V3's update (bias -=
gamma * sign(load - mean load)) runs on it, layer by layer from 0, over a
seeded batch of the mix's sequences (:func:`balancing_batch`) through the
plain reference's own router (``reference/lm_mla_moe.LM.balance_e_bias``),
at the served dtype. Both sides run it on the same draw, so both hold the
same bias, and neither reads it from the other.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.lib import weights
from portbench.reference import lm_mla_moe as moe_ref

# the bias update: sequences (cond and uncond text on each audio), their
# lengths, and the steps and step size of the update
BALANCE_AUDIO, BALANCE_TEXT, BALANCE_FRAMES = 4, 24, 232
BALANCE_STEPS, BALANCE_GAMMA, BALANCE_DECAY = 500, 0.01, 0.99


def sizes(cfg: dict) -> dict:
    """The block's sizes under the port's names, from the configuration's
    published keys."""
    return dict(
        d=cfg["hidden_size"], H=cfg["num_attention_heads"],
        L=cfg["num_hidden_layers"], r=cfg["kv_lora_rank"],
        nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
        v=cfg["v_head_dim"], I=cfg["intermediate_size"],
        F=cfg["moe_intermediate_size"], E=cfg["n_routed_experts"],
        k=cfg["num_experts_per_tok"], shared=cfg["n_shared_experts"],
        dense=cfg["first_k_dense_replace"], theta=float(cfg["rope_theta"]),
        scale=cfg["routed_scaling_factor"], eps=cfg["rms_norm_eps"])


def decoder_leaves(cfg: dict):
    """(group, key, shape, bound) of every decoder leaf; bound None for a
    norm weight (ones), 0 for ``e_bias`` (zeros, then balanced), else
    U(-bound, bound)."""
    s = sizes(cfg)
    d, H, L, r, nope, rope = s["d"], s["H"], s["L"], s["r"], s["nope"], s["rope"]
    Ld, Lm, E, F = s["dense"], s["L"] - s["dense"], s["E"], s["F"]
    Fs, I = s["shared"] * F, s["I"]
    return [
        ("layers", "attn_norm", (L, d), None),
        ("layers", "wq_kva", (L, d, H * (nope + rope) + r + rope), d ** -0.5),
        ("layers", "kv_norm", (L, r), None),
        ("layers", "kvb_k", (L, H, nope, r), r ** -0.5),
        ("layers", "kvb_v", (L, H, r, s["v"]), r ** -0.5),
        ("layers", "wo", (L, H * s["v"], d), (H * s["v"]) ** -0.5),
        ("layers", "ffn_norm", (L, d), None),
        ("dense", "gu", (Ld, d, 2 * I), d ** -0.5),
        ("dense", "down", (Ld, I, d), I ** -0.5),
        ("moe", "router", (Lm, d, E), d ** -0.5),
        ("moe", "e_bias", (Lm, E), 0.0),
        ("moe", "experts_gu", (Lm, E, 2 * F, d), d ** -0.5),
        ("moe", "experts_down", (Lm, E, d, F), F ** -0.5),
        ("moe", "shared_gu", (Lm, d, 2 * Fs), d ** -0.5),
        ("moe", "shared_down", (Lm, Fs, d), Fs ** -0.5),
    ]


FP32_KEYS = ("attn_norm", "kv_norm", "ffn_norm", "router", "e_bias")


def lm_weights(cfg: dict, seed: int, device, matmul_dtype=torch.bfloat16
               ) -> Dict[str, object]:
    """The LM of ``cfg``: the block's matrices in ``matmul_dtype`` (as
    served), the router, ``e_bias`` and norm weights fp32, SSR's embeddings
    and heads fp32 (``lib/weights.py``'s leaves and draw); the EOG logit's
    bias set to ``cfg["eog_logit_bias"]`` when given."""
    d, K, hh = cfg["hidden_size"], cfg["n_codebooks"], cfg["head_hidden"]
    ts = cfg["tokens"]
    card = ts["audio_vocab_size"] + ts["n_special"] + ts["max_n_spans"]
    f32 = dict(device=device, dtype=torch.float32)
    leaves = weights._Leaves()
    tree: Dict[str, object] = {}
    leaves.add(tree, "text_emb", (cfg["text_vocab_size"] + 1, d), "normal")
    leaves.add(tree, "audio_emb", (K, card, d), "normal")
    for key, shape, bound in (("head1_w", (K, d, hh), d ** -0.5),
                              ("head1_b", (K, hh), d ** -0.5),
                              ("head2_w", (K, hh, card), hh ** -0.5),
                              ("head2_b", (K, card), hh ** -0.5)):
        leaves.add(tree, key, shape, "uniform", bound)
    leaves.fill(weights.generator(seed, 1, device), device,
                lambda it: torch.float32)
    tree["text_pos_alpha"] = torch.ones((1,), **f32)
    tree["audio_pos_alpha"] = torch.ones((1,), **f32)
    dec: Dict[str, Dict[str, torch.Tensor]] = dict(layers={}, dense={}, moe={})
    gen = weights.generator(seed, 3, device)
    for group, key, shape, bound in decoder_leaves(cfg):
        dtype = torch.float32 if key in FP32_KEYS else matmul_dtype
        if not bound:
            fill = torch.ones if bound is None else torch.zeros
            dec[group][key] = fill(shape, device=device, dtype=dtype)
            continue
        t = torch.empty(shape, device=device, dtype=dtype)
        for layer in t:  # a layer a draw
            layer.uniform_(-bound, bound, generator=gen)
        dec[group][key] = t
    dec["final_norm"] = torch.ones((d,), **f32)
    tree["decoder"] = dec
    if cfg.get("eog_logit_bias") is not None:
        tree["head2_b"][:, ts["audio_vocab_size"] + 1] = cfg["eog_logit_bias"]
    moe_ref.LM(tree, cfg, matmul_dtype).balance_e_bias(
        balancing_batch(cfg, seed), BALANCE_STEPS, BALANCE_GAMMA, BALANCE_DECAY)
    return tree


def balancing_batch(cfg: dict, seed: int):
    """The sequences the bias is balanced on, drawn from ``seed``: each of
    ``BALANCE_AUDIO`` audio sequences of ``BALANCE_FRAMES`` uniform codes
    under ``BALANCE_TEXT`` uniform text ids and under the unconditional
    text token, as a lane's two rows see them under CFG."""
    rng = np.random.default_rng([seed, 4])
    K, nt = cfg["n_codebooks"], cfg["text_vocab_size"]
    out = []
    for _ in range(BALANCE_AUDIO):
        audio = rng.integers(0, cfg["tokens"]["audio_vocab_size"],
                             (K, BALANCE_FRAMES))
        out.append((rng.integers(0, nt - 1, BALANCE_TEXT), audio))
        out.append((np.array([nt - 1]), audio))
    return out


def decoder_bytes(cfg: dict, matmul_bytes: int = 2) -> int:
    """Bytes of the decoder as served."""
    return sum(math.prod(shape) * (4 if key in FP32_KEYS else matmul_bytes)
               for _, key, shape, _ in decoder_leaves(cfg))
