"""One decode step of the SSR LM with Moonlight-16B-A3B's block
(``models/mla_moe.py`` decode steps, the K heads, the embedding of the fed
tokens): the operations and bytes the step needs.

Bytes, read once a step whatever the rows: the attention's matrices (the
q / latent product, the absorbed W_k and W_v, W_o), the dense layer, the
shared experts and the router in their served dtypes, the norms' weights,
the heads in fp32, the K codebook rows of each fed token, and the routed
experts that the step's rows chose (``touched``: the distinct experts of
every MoE layer, summed over the layers), each read once; per row the
latents of its live keys in every layer, read once, and its new latents
and logits written. Operations, per row: 2 x the weights a token meets (the
attention's, the dense or shared and its 6 experts', the heads'), and 2 x
16 heads x (576 + 512) a live key a layer for the scores and the weighted
latents."""

from __future__ import annotations

from portbench.lib import weights_mla_moe


def sizes(cfg: dict):
    s = weights_mla_moe.sizes(cfg)
    ts = cfg["tokens"]
    card = ts["audio_vocab_size"] + ts["n_special"] + ts["max_n_spans"]
    return s, cfg["n_codebooks"], cfg["head_hidden"], card


def expert_params(cfg: dict) -> int:
    s = weights_mla_moe.sizes(cfg)
    return 3 * s["F"] * s["d"]


def ops_bytes(cfg: dict, ctx_rows, touched: float, *, matmul_bytes: int = 2):
    """``ctx_rows``: the live keys of each row this step (its new token's
    included); ``touched``: the routed experts read this step, over all
    MoE layers."""
    s, K, hh, card = sizes(cfg)
    d, L, H, r, rope = s["d"], s["L"], s["H"], s["r"], s["rope"]
    Ld, Lm = s["dense"], s["L"] - s["dense"]
    lat = r + rope
    rows = len(ctx_rows)
    attn = L * (d * (H * (s["nope"] + rope) + lat) + 2 * H * s["nope"] * r
                + H * s["v"] * d)
    dense = Ld * 3 * d * s["I"]
    shared = Lm * 3 * d * s["shared"] * s["F"]
    router = Lm * (d * s["E"] + s["E"])
    heads = K * (d * hh + hh * card)
    per_token = attn + dense + shared + Lm * s["k"] * expert_params(cfg) + heads
    flops = (rows * 2 * (per_token + Lm * d * s["E"])
             + 2 * H * (lat + r) * L * sum(ctx_rows))
    nbytes = ((attn + dense + shared + touched * expert_params(cfg))
              * matmul_bytes
              + router * 4 + L * (2 * d + r) * 4 + d * 4
              + (heads + K * (hh + card)) * 4
              + rows * K * d * 4  # the fed tokens' embedding rows
              + lat * matmul_bytes * L * sum(ctx_rows)  # live latents read
              + rows * (lat * matmul_bytes * L + K * card * 4))  # written
    return flops, nbytes
