"""One decode step of the SSR-Speech LM (``models/transformer.py`` decode
step, the K heads, the embedding of the fed tokens): the operations and
bytes that the step needs.

Operations, per row: 2 * (12 d^2) * L for the packed QKV, output and FFN
products (FFN width 4 d), 4 * d * ctx * L for the scores and the weighted
values over the row's ctx attendable keys, and 2 * K * (d * hh + hh * card)
for the heads. Bytes, read once a step whatever the rows: the decoder's
matrices and biases in their served dtype, the heads in fp32, the K
codebook rows of each fed token; per row the K/V of its ctx keys in every
layer (bf16), and the new K/V and the logits written."""

from __future__ import annotations


def sizes(cfg: dict):
    d, L, K = cfg["d_model"], cfg["num_layers"], cfg["n_codebooks"]
    f = d * cfg["ffn_mult"]
    hh = cfg["head_hidden"]
    ts = cfg["tokens"]
    card = ts["audio_vocab_size"] + ts["n_special"] + ts["max_n_spans"]
    return d, L, K, f, hh, card


def ops_bytes(cfg: dict, ctx_rows, *, matmul_bytes: int = 2):
    """``ctx_rows``: the attendable keys of each row this step (the new
    token's included)."""
    d, L, K, f, hh, card = sizes(cfg)
    rows = len(ctx_rows)
    dec_params = L * (4 * d * d + 2 * d * f)
    dec_bias = L * (3 * d + d + f + d)
    head_params = K * (d * hh + hh * card)
    flops = (rows * (2 * dec_params + 2 * head_params)
             + 4 * d * L * sum(ctx_rows))
    nbytes = ((dec_params + dec_bias) * matmul_bytes
              + L * 4 * d * 4  # the two LayerNorms' fp32 scale and shift
              + (head_params + K * (hh + card)) * 4
              + rows * K * d * 4  # the fed tokens' embedding rows
              + 2 * 2 * d * L * sum(ctx_rows)  # K/V read, bf16
              + rows * (2 * 2 * d * L + K * card * 4))  # K/V and logits out
    return flops, nbytes


def bound_s(cfg: dict, ctx_rows, *, peak_flops: float, peak_bytes: float):
    flops, nbytes = ops_bytes(cfg, ctx_rows)
    return max(flops / peak_flops, nbytes / peak_bytes)
