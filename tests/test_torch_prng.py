"""JAX's threefry draw in the port (``ssr_speech_tpu_torch/utils/prng.py``)
against ``jax.random`` on the CPU.

- keys, ``split``, ``fold_in``, the 32-bit random bits, ``uniform``,
  ``permutation`` and ``choice(replace=False)``: bit for bit, over several
  seeds and shapes, odd and empty ones included;
- XLA's float32 ``log`` (the Cephes polynomial with fused steps) and
  ``log1p`` (Cephes' rational form below sqrt(2) - 1): bit for bit against
  ``jnp.log`` and ``jnp.log1p``; the port's square root is the correctly
  rounded one;
- ``normal`` and ``erf_inv``: bit for bit, over several seeds and shapes;
- whole trees from the same seed: ``init_ssr`` bit for bit,
  ``init_wmencodec`` (within 1e-6 relative:
  weight norm's gains are sums in the backend's order); the port's
  ``Trainer(seed)`` against JAX's is in ``tests/test_torch_trainer.py``.

The mode JAX draws in is pinned: a JAX whose ``jax_threefry_partitionable``
default changes fails here first.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssr_speech_tpu.config import tiny_ssr_config
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu_torch.models import ssr as tssr
from ssr_speech_tpu_torch.models.codec import wmencodec as twm
from ssr_speech_tpu_torch.utils import prng
from ssr_speech_tpu_torch.utils.tree import tree_leaves
from tests.test_codec_training import TINY as TINY_CODEC
from tests.test_torch_hostcopies import port_config

SEEDS = (0, 1, 42, 2 ** 31 - 1, -1)
SHAPES = ((), (1,), (7,), (3, 5), (2, 3, 4), (0,), (2, 0, 3), (33, 65))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _words(key):
    return np.asarray(key).astype(np.int64)


def test_jax_draws_in_partitionable_mode():
    """The port follows jax 0.9's default: ``split`` and the random bits
    hash the flat index (``jax_threefry_partitionable``)."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_bit_for_bit(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _words(jkey))
    for num in (2, 3, 1, (2, 3)):
        np.testing.assert_array_equal(prng.split(key, num).numpy(),
                                      _words(jax.random.split(jkey, num)))
    for data in (0, 1, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data).numpy(),
                                      _words(jax.random.fold_in(jkey, data)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_for_bit(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(
            prng.random_bits(key, shape).numpy(),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64))
        for lo, hi in ((0.0, 1.0), (-0.3, 0.3), (-0.0125, 0.0125)):
            got = prng.uniform(key, shape, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, hi))
            assert got.dtype == np.float32 and got.shape == want.shape
            assert _ulps(got, want).max(initial=0) == 0, (shape, lo, hi)


def test_permutation_and_choice_bit_for_bit():
    for seed in (0, 5):
        for n, k in ((1, 1), (10, 3), (100, 100), (1000, 16), (7000, 512)):
            got = prng.choice(prng.PRNGKey(seed), n, k).numpy()
            want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                                (k,), replace=False))
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        prng.choice(prng.PRNGKey(0), 3, 4)


def test_xla_log_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-6, 0.6, 100000),
                        rng.uniform(0.5, 2.0, 100000)]).astype(np.float32)
    got = prng.log(torch.from_numpy(x)).numpy()
    assert _ulps(got, np.asarray(jnp.log(jnp.asarray(x)))).max() == 0


def test_xla_log1p_bit_for_bit():
    """Both branches of XLA's float32 ``log1p`` on (-1, 0], the threshold's
    neighbourhood and tiny arguments included."""
    rng = np.random.default_rng(1)
    x = -np.concatenate([rng.uniform(0.0, 1.0, 200000),
                         rng.uniform(0.40, 0.43, 100000),
                         rng.uniform(0.0, 1e-6, 20000), [0.0]]).astype(np.float32)
    x = x[x > -1.0]
    got = prng.log1p(torch.from_numpy(x)).numpy()
    assert _ulps(got, np.asarray(jnp.log1p(jnp.asarray(x)))).max() == 0


def test_sqrt_correctly_rounded():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(0.0, 20.0, 200000),
                        rng.uniform(0.0, 1e-30, 10000),
                        [0.0, 1.0, 4.0, 2.0 ** -126, 3.4e38]]).astype(np.float32)
    assert _ulps(prng.sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x)).max() == 0


def test_normal_and_erf_inv_within_the_stated_ulps():
    """The stated bound is 0 ulp: bit for bit over seeds and shapes."""
    n = 100000
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    for seed in (0, 3, -1):
        key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
        u = prng.uniform(key, (n,), lo, 1.0)
        assert _ulps(prng.erf_inv(u).numpy(), np.asarray(
            jax.lax.erf_inv(jnp.asarray(u.numpy())))).max() == 0, seed
        for shape in ((n,), (333, 77), (), (0,), (5, 3)):
            got = prng.normal(key, shape).numpy()
            want = np.asarray(jax.random.normal(jkey, shape))
            assert got.shape == want.shape == shape
            assert _ulps(got, want).max(initial=0) == 0, (seed, shape)


def _tree_ulps(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), [t.detach().numpy() for t in tree_leaves(ttree)]
    assert len(jl) == len(tl)
    return [_ulps(t, j) for j, t in zip(jl, tl)]


def test_init_ssr_tree_matches_jax():
    cfg = tiny_ssr_config()
    jtree = jssr.init_ssr(jax.random.PRNGKey(0), cfg)
    ttree = tssr.init_ssr(prng.PRNGKey(0), port_config(cfg))
    d = _tree_ulps(jtree, ttree)
    # the uniform leaves and the normal embeddings alike
    assert all(x.max(initial=0) == 0 for x in d)


def test_init_wmencodec_tree_matches_jax():
    jtree = jwm.init_wmencodec(jax.random.PRNGKey(1), TINY_CODEC)
    ttree = twm.init_wmencodec(prng.PRNGKey(1), port_config(TINY_CODEC))
    jl = jax.tree.leaves(jtree)
    tl = [t.numpy() for t in tree_leaves(ttree)]
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-6, atol=0)
    assert sum(int((x == 0).all()) for x in _tree_ulps(jtree, ttree)) > len(jl) // 2
