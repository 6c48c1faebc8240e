"""Request scheduling for batched serving (port of the host part of
``ssr_speech_tpu/inference/serve.py``).

Only the static scheduler is here: :func:`sorted_static_batches`, which
``pipeline.inference_multi`` uses to batch more jobs than it has slots. The
continuous-batching server of the JAX module is not ported yet.
"""

from __future__ import annotations

from typing import List


def sorted_static_batches(requests, n_slots: int,
                          est_len=None) -> List[List[int]]:
    """Offline-throughput scheduling for the static multi-prompt loop
    (``decode.generate_multi``): order requests by expected output length and
    batch neighbours, so each batch's straggler is barely longer than its
    mean (shortest-processing-time batching). Returns request-index batches;
    ``est_len(request)`` defaults to the text length (output length is capped
    at ``x_len * length_cap_mult``, so text length is the natural proxy)."""
    if est_len is None:
        est_len = lambda r: len(r[0])
    order = sorted(range(len(requests)), key=lambda i: est_len(requests[i]))
    return [order[i:i + n_slots] for i in range(0, len(order), n_slots)]
