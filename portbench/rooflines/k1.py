"""K1, the prefill's causal attention (``csrc/flash_attention_fwd.cu``):
operations and bytes that a prompt needs, per launch (one a layer).

A row of n attendable positions (text, then audio prompt; padding and
banned keys are not needed) has n (n + 1) / 2 unmasked (query, key) pairs;
each costs 2 * head_dim flops for the score and 2 * head_dim for the
weighted value, in every head. Bytes: Q, K and V read once and O written
once, bf16, for the needed positions only."""

from __future__ import annotations

from typing import Iterable


def ops_bytes(rows: Iterable[int], *, heads: int, head_dim: int,
              elem_bytes: int = 2):
    """``rows``: attendable positions of each row of one launch."""
    rows = list(rows)
    pairs = sum(n * (n + 1) // 2 for n in rows)
    flops = 4 * head_dim * heads * pairs
    nbytes = 4 * elem_bytes * heads * head_dim * sum(rows)
    return flops, nbytes


def bound_s(rows, *, heads: int, head_dim: int, peak_flops: float,
            peak_bytes: float) -> float:
    flops, nbytes = ops_bytes(rows, heads=heads, head_dim=head_dim)
    return max(flops / peak_flops, nbytes / peak_bytes)
