"""K11, the routed experts of a MoE decode step (``csrc/moe_experts.cu``):
operations and bytes a launch pair (one MoE layer of one step) needs.

Bytes: each touched expert's gate, up and down weights read once (bf16),
the rows' inputs read once, each (row, choice) pair's intermediate written
and read back (bf16, F wide) and its weighted output written (fp32, D
wide). Operations: 2 x 3 x F x D for each (row, choice) pair."""

from __future__ import annotations


def ops_bytes(*, touched: float, pairs: float, rows: float, d: int, f: int,
              elem_bytes: int = 2):
    flops = 2 * 3 * f * d * pairs
    nbytes = (touched * 3 * f * d * elem_bytes + rows * d * elem_bytes
              + pairs * (2 * f * elem_bytes + 4 * d))
    return flops, nbytes
