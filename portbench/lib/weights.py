"""Seeded random weights, made on the device in a few large draws, in the
layout the port's parameter trees use (JAX's nesting: stacked decoder
layers, matmul weights [in, out], conv weights [K, Cin, Cout]).

Both sides get them from here: the port as its parameters, the plain
reference (``reference/``) by calling the same function again with the same
seed after the window, so it takes nothing that the program made. The
distributions are those of the models' own initialisers (torch's Linear and
Conv1d defaults, xavier for the packed QKV, unit normals for embeddings;
the RVQ codebooks at the encoder's latents' scale); the draw itself is
``torch.Generator``'s, not JAX's threefry.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of a run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


class _Leaves:
    """Leaves by kind, each filled from one draw of its kind."""

    def __init__(self):
        self.items: List[Tuple[dict, str, tuple, str, float]] = []

    def add(self, node: dict, key: str, shape, kind: str, scale: float = 1.0):
        self.items.append((node, key, tuple(shape), kind, scale))

    def fill(self, gen: torch.Generator, device, dtype_of) -> None:
        for kind in ("uniform", "normal"):
            for dtype in (torch.bfloat16, torch.float32):
                mine = [it for it in self.items
                        if it[3] == kind and dtype_of(it) == dtype]
                if not mine:
                    continue
                n = sum(math.prod(it[2]) for it in mine)
                draw = (torch.rand if kind == "uniform" else torch.randn)(
                    n, generator=gen, device=device, dtype=dtype)
                off = 0
                for node, key, shape, _, scale in mine:
                    size = math.prod(shape)
                    t = draw[off:off + size].view(shape)
                    off += size
                    if kind == "uniform":  # U(-scale, scale)
                        t.mul_(2.0 * scale).sub_(scale)
                    elif scale != 1.0:
                        t.mul_(scale)
                    node[key] = t


def lm_weights(cfg: dict, seed: int, device, matmul_dtype=torch.bfloat16
               ) -> Dict[str, object]:
    """The SSR-Speech LM of ``cfg`` (a ``configs/*.json`` ``lm`` group):
    decoder matrices and their biases in ``matmul_dtype`` (as served),
    embeddings, norms and heads in fp32; the EOG logit's bias set to
    ``cfg["eog_logit_bias"]`` when given."""
    d, L, K = cfg["d_model"], cfg["num_layers"], cfg["n_codebooks"]
    f = d * cfg["ffn_mult"]
    hh = cfg["head_hidden"]
    ts = cfg["tokens"]
    card = ts["audio_vocab_size"] + ts["n_special"] + ts["max_n_spans"]
    n_text = cfg["text_vocab_size"] + 1
    f32 = dict(device=device, dtype=torch.float32)
    leaves = _Leaves()
    layers: Dict[str, torch.Tensor] = {}
    tree = dict(decoder=dict(layers=layers))
    leaves.add(tree, "text_emb", (n_text, d), "normal")
    leaves.add(tree, "audio_emb", (K, card, d), "normal")
    b_d, b_f = 1 / math.sqrt(d), 1 / math.sqrt(f)
    for key, shape, bound in (
            ("qkv_w", (L, d, 3 * d), math.sqrt(6.0 / (d + 3 * d))),
            ("out_w", (L, d, d), b_d), ("out_b", (L, d), b_d),
            ("ffn1_w", (L, d, f), b_d), ("ffn1_b", (L, f), b_d),
            ("ffn2_w", (L, f, d), b_f), ("ffn2_b", (L, d), b_f)):
        leaves.add(layers, key, shape, "uniform", bound)
    b_h = 1 / math.sqrt(hh)
    for key, shape, bound in (("head1_w", (K, d, hh), b_d),
                              ("head1_b", (K, hh), b_d),
                              ("head2_w", (K, hh, card), b_h),
                              ("head2_b", (K, card), b_h)):
        leaves.add(tree, key, shape, "uniform", bound)
    leaves.fill(generator(seed, 1, device), device,
                lambda it: matmul_dtype if it[0] is layers else torch.float32)
    layers["qkv_b"] = torch.zeros((L, 3 * d), device=device, dtype=matmul_dtype)
    for name in ("ln1", "ln2"):
        layers[name + "_w"] = torch.ones((L, d), **f32)
        layers[name + "_b"] = torch.zeros((L, d), **f32)
    tree["decoder"]["final_ln_w"] = torch.ones((d,), **f32)
    tree["decoder"]["final_ln_b"] = torch.zeros((d,), **f32)
    tree["text_pos_alpha"] = torch.ones((1,), **f32)
    tree["audio_pos_alpha"] = torch.ones((1,), **f32)
    if cfg.get("eog_logit_bias") is not None:
        tree["head2_b"][:, ts["audio_vocab_size"] + 1] = cfg["eog_logit_bias"]
    return tree


def _conv(leaves: _Leaves, kernel: int, cin: int, cout: int, norm: bool,
          transpose: bool = False) -> dict:
    """Conv weights [K, Cin, Cout] and bias, U(+-1/sqrt(Cin*K)); with weight
    norm ``v`` plus the gain ``g`` (filled by :func:`_gains`)."""
    p: dict = {}
    bound = 1 / math.sqrt(cin * kernel)
    leaves.add(p, "v" if norm else "w", (kernel, cin, cout), "uniform", bound)
    leaves.add(p, "b", (cout,), "uniform", bound)
    if norm:
        p["_g_axes"] = (0, 2) if transpose else (0, 1)
    return p


def _lstm(leaves: _Leaves, dim: int, n_layers: int) -> dict:
    bound = 1 / math.sqrt(dim)
    out = []
    for _ in range(n_layers):
        lp: dict = {}
        for key, shape in (("wih", (4 * dim, dim)), ("whh", (4 * dim, dim)),
                           ("bih", (4 * dim,)), ("bhh", (4 * dim,))):
            leaves.add(lp, key, shape, "uniform", bound)
        out.append(lp)
    return dict(layers=out)


def _encoder(leaves: _Leaves, c: dict) -> dict:
    nf, norm = c["n_filters"], c["norm"] == "weight_norm"
    p = dict(conv_in=_conv(leaves, c["kernel_size"], c["channels"], nf, norm),
             groups=[])
    mult = 1
    for ratio in reversed(c["ratios"]):
        dim = mult * nf
        res = [dict(conv1=_conv(leaves, c["residual_kernel_size"], dim,
                                dim // c["compress"], norm),
                    conv2=_conv(leaves, 1, dim // c["compress"], dim, norm))
               for _ in range(c["n_residual_layers"])]
        p["groups"].append(dict(res=res, down=_conv(leaves, 2 * ratio, dim,
                                                    2 * dim, norm)))
        mult *= 2
    if c["lstm"]:
        p["lstm"] = _lstm(leaves, mult * nf, c["lstm"])
    p["conv_out"] = _conv(leaves, c["last_kernel_size"], mult * nf,
                          c["dimension"], norm)
    return p


def _decoder(leaves: _Leaves, c: dict) -> dict:
    nf, norm = c["n_filters"], c["norm"] == "weight_norm"
    mult = 2 ** len(c["ratios"])
    p = dict(conv_in=_conv(leaves, c["kernel_size"], c["dimension"], mult * nf,
                           norm), groups=[])
    if c["lstm"]:
        p["lstm"] = _lstm(leaves, mult * nf, c["lstm"])
    for ratio in c["ratios"]:
        dim = mult * nf
        up = _conv(leaves, 2 * ratio, dim, dim // 2, norm, transpose=True)
        res = [dict(conv1=_conv(leaves, c["residual_kernel_size"], dim // 2,
                                dim // 2 // c["compress"], norm),
                    conv2=_conv(leaves, 1, dim // 2 // c["compress"], dim // 2,
                                norm))
               for _ in range(c["n_residual_layers"])]
        p["groups"].append(dict(up=up, res=res))
        mult //= 2
    p["conv_out"] = _conv(leaves, c["last_kernel_size"], nf, c["channels"], norm)
    return p


def _gains(node) -> None:
    """g = ||v|| over the axes the gain spans (so w = v at the start)."""
    if isinstance(node, dict):
        axes = node.pop("_g_axes", None)
        if axes is not None:
            node["g"] = node["v"].square().sum(dim=axes, keepdim=True).sqrt()
        for v in node.values():
            _gains(v)
    elif isinstance(node, list):
        for v in node:
            _gains(v)


def codec_weights(cfg: dict, seed: int, device) -> Dict[str, object]:
    """The watermarked EnCodec of ``cfg`` (a ``codec`` group: ``seanet``,
    ``rvq`` and ``codebook_scale``), all fp32: encoder, decoder, the
    watermark decoder (its own decoder, skip and watermark encoders, label
    embedding, fusion projections, predictor) and the RVQ codebooks, normal
    at ``codebook_scale``: a trained codebook's codewords are centroids of
    the encoder's latents, so they are drawn at the latents' scale, or
    every frame would take the codeword of least norm."""
    c, q = cfg["seanet"], cfg["rvq"]
    leaves = _Leaves()
    dim, nf = c["dimension"], c["n_filters"]
    emb = dim // 16
    wm = dict(decoder=_decoder(leaves, c), skip_encoder=_encoder(leaves, c),
              wm_encoder=_encoder(leaves, c))
    leaves.add(wm, "wm_embed", (2, emb), "normal")
    mult = 2 ** len(c["ratios"])
    wm["projs"] = [dict(conv=_conv(leaves, 1, dim + emb, dim, False))]
    for _ in range(1, len(c["ratios"])):
        mult //= 2
        wm["projs"].append(dict(conv=_conv(leaves, 1, mult * nf + emb,
                                           mult * nf, False)))
    wm["predictor"] = dict(conv=_conv(leaves, 1, dim, 2, False))
    tree = dict(encoder=_encoder(leaves, c), decoder=_decoder(leaves, c),
                wmdecoder=wm, quantizer={})
    leaves.add(tree["quantizer"], "embed", (q["n_q"], q["bins"], q["dimension"]),
               "normal", cfg["codebook_scale"])
    leaves.fill(generator(seed, 2, device), device, lambda it: torch.float32)
    _gains(tree)
    return tree
