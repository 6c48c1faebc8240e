"""K12, the paged step's latent attention (``csrc/mla_attention.cu``):
operations and bytes one launch (one layer of one step) needs.

Bytes: the live latents of each row (its prompt's open keys, its generated
columns and its new latent, [c | k_pe] 576 wide, bf16) read once, the
absorbed query [16, 576] read and the output [16, 512] written (bf16).
Operations: 2 x 16 heads x (576 + 512) a live key."""

from __future__ import annotations

HEADS, LATENT, C_WIDTH = 16, 576, 512


def ops_bytes(live_keys: float, rows: float, *, elem_bytes: int = 2):
    flops = 2 * HEADS * (LATENT + C_WIDTH) * live_keys
    nbytes = (LATENT * live_keys + rows * HEADS * (LATENT + C_WIDTH)) * elem_bytes
    return flops, nbytes
