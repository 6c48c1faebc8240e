"""Sharded checkpoints of the port (``utils.checkpoint.save_sharded`` /
``load_sharded`` on ``torch.distributed.checkpoint``) across layouts, as the
JAX package's orbax test does: tp=2 -> tp=4, and fsdp layer stacks over
dp=4 -> replicated; a one-process reader; the restored layout runs a forward
whose loss is JAX's. Ranks are spawned over gloo on the CPU. The restored
parameters must be bit-identical; the loss within rtol 1e-5."""

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import tiny_ssr_config
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu_torch.parallel.dist import spawn
from ssr_speech_tpu_torch.utils import checkpoint as tck
from ssr_speech_tpu_torch.utils.tree import tree_map
from tests import torch_parallel_ranks as ranks
from tests.test_torch_hostcopies import port_config

CFG = tiny_ssr_config(num_layers=4, nhead=4)
PARAMS = jax.tree.map(np.asarray, jssr.init_ssr(jax.random.PRNGKey(0), CFG))
BATCH = dict(x=np.zeros((4, 8), np.int32), x_lens=np.full(4, 8, np.int32),
             y=np.ones((4, 16, CFG.n_codebooks), np.int32),
             y_lens=np.full(4, 16, np.int32))


LAYOUTS = [((2, False), (4, False)),   # tp=2 -> tp=4
           ((1, True), (1, False))]    # fsdp stacks over dp=4 -> replicated


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both layout pairs in one spawn of 4 ranks."""
    root = tmp_path_factory.mktemp("ckpt")
    cases = [(str(root / f"ckpt{i}"), s, l) for i, (s, l) in enumerate(LAYOUTS)]
    return cases, spawn(ranks.sharded_checkpoint, 4,
                        args=(PARAMS, port_config(CFG), cases, BATCH))


@pytest.mark.parametrize("case", [0, 1], ids=["tp2_to_tp4", "fsdp_to_replicated"])
def test_sharded_save_restore_across_layouts(saved, case):
    cases, res = saved
    want_loss = float(jssr.ssr_forward(PARAMS, CFG, BATCH,
                                       deterministic=True)["loss"])
    for r in res:
        r = r[case]
        for got, want in zip(jax.tree.leaves(r["gathered"]),
                             jax.tree.leaves(PARAMS)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-5)
    # one process, no process group: the whole tensors
    template = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32),
                        PARAMS)
    whole = tck.load_sharded(cases[case][0], template)
    for got, want in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), whole)),
                         jax.tree.leaves(PARAMS)):
        np.testing.assert_array_equal(got, want)
