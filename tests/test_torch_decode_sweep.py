"""The served and multi-prompt paths of the port under tests/test_decode_fuzz.
py's seeded sweep of ``DecodeConfig``: ``stop_repetition`` with silence
tokens, CFG coefficient and stride, ``aug_text``, ``aug_context`` (the
prompt prepend, taken or not), 1-3 edit spans or a TTS continuation.

JAX's sweep holds its ``generate_multi`` and ``ContinuousBatcher`` bit-exact
to its single-chain ``generate``; here the port's ``generate``,
``generate_multi`` and ``serve_requests`` (the ``ContinuousBatcher``, two
lanes) must give JAX's ``generate`` codes, marks and intervals exactly, in
fp32 on the CPU, greedy with ``cfg_pretrained``."""

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu_torch.inference import decode as tdecode
from ssr_speech_tpu_torch.inference import serve as tserve
from tests.test_decode_fuzz import CFG, _random_case
from tests.test_torch_batched_decode import (TCFG, _assert_same, models,
                                             one_torch_thread)
from tests.test_torch_hostcopies import port_config

__all__ = ["models", "one_torch_thread"]  # module-scoped fixtures, shared


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("trial", range(8))
def test_sweep_served_and_multi_identical_to_jax(models, trial):
    params, model = models
    dec, x, y, mask, px, py = _random_case(np.random.default_rng(1000 + trial))
    _, x2, y2, mask2, px2, py2 = _random_case(
        np.random.default_rng(5000 + trial))
    key = jax.random.PRNGKey(0)
    want = [jdecode.generate(params, CFG, dec, a, b, m, key, prompt_x=p,
                             prompt_y=q, dtype_name="float32")
            for a, b, m, p, q in ((x, y, mask, px, py),
                                  (x2, y2, mask2, px2, py2))]
    tdec = port_config(dec)
    reqs = [(x, y, mask, px, py), (x2, y2, mask2, px2, py2)]
    _assert_same(tdecode.generate(model, TCFG, tdec, x, y, mask, _gen(),
                                  prompt_x=px, prompt_y=py), want[0])
    for got, w in zip(tdecode.generate_multi(model, TCFG, tdec, reqs, _gen()),
                      want):
        _assert_same(got, w)
    for got, w in zip(tserve.serve_requests(model, TCFG, tdec, reqs, _gen(),
                                            n_slots=2), want):
        _assert_same(got, w)
