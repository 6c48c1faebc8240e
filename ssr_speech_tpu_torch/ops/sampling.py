"""Top-k / nucleus (top-p) filtered categorical sampling (port of
``ssr_speech_tpu/ops/sampling.py``).

  - top_k > 0 keeps every logit >= the k-th largest value (ties at the
    threshold survive, as in JAX: a threshold, not top-k indices);
  - top_p < 1 drops tokens whose sorted cumulative probability exceeds top_p,
    always keeping the first token above the threshold. The order is JAX's: a
    stable ascending sort, reversed (not a descending sort, which orders ties
    the other way);
  - sampling is Gumbel-max with noise drawn from an explicit
    ``torch.Generator``. It cannot reproduce JAX's PRNG stream, so only greedy
    decoding (top_k = 1) is held bit for bit against JAX.
"""

from __future__ import annotations

import torch

FILTER_VALUE = float("-inf")


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 1.0) -> torch.Tensor:
    """logits [..., V] -> filtered logits."""
    v = logits.shape[-1]
    if top_k > 0:
        k = min(max(top_k, 1), v)
        thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < thresh, FILTER_VALUE)
    if top_p < 1.0:
        asc, asc_idx = torch.sort(logits, dim=-1, stable=True)
        sorted_logits, sorted_idx = asc.flip(-1), asc_idx.flip(-1)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = cum > top_p
        # shift right so the first token above the threshold is kept
        remove = torch.cat([torch.zeros_like(remove[..., :1]),
                            remove[..., :-1]], dim=-1)
        # back to vocabulary order through the permutation
        remove_orig = torch.empty_like(remove).scatter_(-1, sorted_idx, remove)
        logits = logits.masked_fill(remove_orig, FILTER_VALUE)
    return logits


def categorical(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Sample indices [...] from logits [..., V] (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def sample_tokens(generator: torch.Generator, logits: torch.Tensor,
                  top_k: int = 0, top_p: float = 1.0,
                  temperature: float = 1.0) -> torch.Tensor:
    """Sample token ids [...] from logits [..., V]."""
    if temperature != 1.0:
        logits = logits / temperature
    logits = top_k_top_p_filter(logits, top_k=top_k, top_p=top_p)
    return categorical(generator, logits)
