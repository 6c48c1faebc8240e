"""The dp gradient all-reduce of the PyTorch port in bounded buckets
(``training/trainer.py::_sum_grads``, ``parallel/collectives.py::
all_reduce_``): the buckets' pieces cover every gradient in order, as views,
none larger than the bucket; over two gloo ranks the bucketed sums equal one
flat all-reduce of every gradient bit for bit (a + b element by element,
whatever the buckets), bf16 and transposed gradients included."""

import numpy as np
import pytest
import torch

from ssr_speech_tpu_torch.parallel.dist import spawn
from ssr_speech_tpu_torch.training import trainer
from tests import torch_parallel_ranks as ranks


@pytest.mark.parametrize("size", [1, 4, 7, 64])
def test_buckets_cover_the_gradients_as_views(size):
    gs = [torch.arange(n, dtype=torch.float32) + 100 * i
          for i, n in enumerate((5, 13, 1, 8))]
    buckets = list(trainer._grad_buckets(gs, size))
    assert all(0 < sum(p.numel() for p in b) <= size for b in buckets)
    assert all(sum(p.numel() for p in b) == size for b in buckets[:-1])
    pieces = [p for b in buckets for p in b]
    assert torch.equal(torch.cat(pieces), torch.cat(gs))
    for p in pieces:
        p.add_(1)  # a view: the write lands in its gradient
    assert torch.equal(torch.cat(gs), torch.cat(pieces))
    assert float(gs[0][0]) == 1.0


def test_bucketed_sums_equal_one_flat_all_reduce():
    flat, small, default = spawn(ranks.bucketed_sums, 2, args=(3,))[0]
    for want, a, b in zip(flat, small, default):
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)
