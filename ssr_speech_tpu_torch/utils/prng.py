"""JAX's threefry2x32 draws in PyTorch: the keys and samplers JAX's inits use.

The JAX package initialises every parameter from ``jax.random`` (threefry2x32,
``jax_threefry_partitionable`` on, the default of jax 0.5 and later). This
module computes the same keys and the same float32 samples with torch ops,
on the device the caller names, so that ``init_ssr(PRNGKey(seed), ...)`` in
the port gives the parameters JAX's ``init_ssr(jax.random.PRNGKey(seed))``
gives:

- a key is an int64 tensor ``[..., 2]`` holding two uint32 words (JAX's raw
  ``uint32[2]`` key); :func:`PRNGKey`, :func:`split` and :func:`fold_in`
  follow ``jax._src.prng``'s ``threefry_seed``, ``_threefry_split_foldlike``
  and ``threefry_fold_in``;
- :func:`random_bits` is ``_threefry_random_bits_partitionable`` at 32 bits:
  element ``i`` of the flattened shape hashes the counter ``(i >> 32, i &
  0xffffffff)`` and xors the two words;
- :func:`uniform` and :func:`normal` are ``jax.random.uniform`` and
  ``jax.random.normal`` in float32: mantissa bits under exponent 0, then
  ``floats * (maxval - minval) + minval``; ``sqrt(2) * erf_inv(u)`` with
  XLA's float32 ``ErfInv`` polynomial, XLA's ``log1p`` (Cephes' rational
  form below sqrt(2) - 1, XLA's ``log`` above) and a correctly rounded
  square root, op for op;
- :func:`choice` (without replacement) and :func:`permutation` are JAX's
  sort-based shuffle.

The integer work runs in int64 masked to 32 bits (torch's uint32 lacks
shifts on CUDA). Each float op is its own torch op, so every intermediate is
rounded to float32 as XLA rounds it, and a multiply that XLA's CPU code
fuses into the add after it is fused here too (:func:`fma`). No library
``log`` is called, and the square root is corrected to the IEEE one
(:func:`sqrt`: ``torch.sqrt`` of float32 is not correctly rounded on every
CPU). The keys, ``uniform`` and ``normal`` match JAX bit for
bit on the CPU (``tests/test_torch_prng.py``), and the card's draw is held
to the CPU's bit for bit (``chip_smoke.py``'s ``[prng]``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(
        int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counters (x1, x2) under key (k1, k2): JAX's
    ``_threefry2x32_lowering``, 20 rounds, on int64 words < 2**32."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x[0], x[1]


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX gives it without x64: the seed
    is an int32, so the key is (0, seed's 32 bits)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit an int32")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: the flat index as (high, low) words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> keys ``[*num, 2]``
    (``_threefry_split_foldlike``: key i is the hash of counter i)."""
    shape = _shape(num)
    hi, lo = _counters(math.prod(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1).reshape(*shape, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data) (``threefry_2x32(key, threefry_seed(data))``)."""
    d = torch.tensor([0, int(data) & MASK], dtype=torch.int64,
                     device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], d[:1], d[1:])
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits an element (int64 < 2**32), JAX's partitionable
    ``random_bits(key, 32, shape)``."""
    shape = _shape(shape)
    hi, lo = _counters(math.prod(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU code contracts a
    multiply feeding an add. The product is exact in float64; the sum is
    rounded to odd there (its TwoSum error tells the direction), and
    rounding that to float32 is the correctly rounded fused result on any
    device."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    odd = torch.where((err > 0) == (s > 0), bits | 1, (bits - 1) | 1)
    return torch.where(err != 0, odd.view(torch.float64), s).float()


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)``."""
    dev = key.device
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = floats - _f32(1.0, dev)
    lo, hi = _f32(minval, dev), _f32(maxval, dev)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


# XLA's float32 ErfInv (M. Giles, "Approximating the erfinv function"):
# Horner coefficients, highest power first, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 log (the Cephes polynomial in the mantissa, centred on 1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG1P_SMALL = 0.41421356237309504880  # sqrt(2) - 1
# XLA's float32 log1p below |x| = sqrt(2) - 1: Cephes' rational form
# x - x^2/2 + x^3 P(x)/Q(x), Horner coefficients highest power first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` for positive normal x, op for op: the mantissa
    m in [0.5, 1) and exponent e, m moved to [sqrt(1/2), sqrt(2)) - 1, a
    degree-8 polynomial in three fused parts, and e's ln 2 in two parts."""
    f = lambda v: _f32(v, x.device)
    bits = torch.maximum(x, f(1.1754943508222875e-38)).view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    e = f(1.0) + ((bits >> 23) - 0x7F).float()
    small = m < f(0.707106781186547524)
    t = m - f(1.0)
    e = e - torch.where(small, f(1.0), f(0.0))
    t = t + torch.where(small, m, f(0.0))
    t2 = t * t
    t3 = t2 * t
    y = fma(t, f(_LOG_P[0]), f(_LOG_P[1]))
    y1 = fma(t, f(_LOG_P[3]), f(_LOG_P[4]))
    y2 = fma(t, f(_LOG_P[6]), f(_LOG_P[7]))
    y = fma(y, t, f(_LOG_P[2]))
    y1 = fma(y1, t, f(_LOG_P[5]))
    y2 = fma(y2, t, f(_LOG_P[8]))
    y = fma(y, t3, y1)
    y = fma(y, t3, y2)
    y = fma(y, t3, f(-2.12194440e-4) * e)
    t = fma(f(-0.5), t2, t)
    return fma(f(0.693359375), e, t + y)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` for x in (-1, 0], op for op: :func:`log` of
    ``x + 1`` where |x| >= sqrt(2) - 1, else Cephes' rational form with
    each Horner step fused."""
    f = lambda v: _f32(v, x.device)

    def horner(cs):
        p = torch.zeros_like(x)
        for c in cs:
            p = fma(p, x, f(c))
        return p

    x2 = x * x
    r = horner(_LOG1P_P) / horner(_LOG1P_Q)
    small = x + fma(f(-0.5), x2, (x * x2) * r)
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + f(1.0)))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of x >= 0 on any device: the
    float64 root rounded to float32, then moved to the neighbour whose
    midpoint brackets x (the midpoints' squares are exact in float64).
    ``torch.sqrt`` of float32 is not correctly rounded on every CPU."""
    s = torch.sqrt(x.double()).float()
    xd = x.double()
    up = torch.nextafter(s, torch.full_like(s, math.inf))
    down = torch.nextafter(s, torch.zeros_like(s))
    hi = (s.double() + up.double()) / 2
    lo = (s.double() + down.double()) / 2
    return torch.where(hi * hi < xd, up, torch.where(lo * lo > xd, down, s))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv``: w = -log1p(-x*x); a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, each Horner step fused; times x; +-inf
    at |x| = 1."""
    f = lambda v: _f32(v, x.device)
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - f(2.5), sqrt(w) - f(3.0))
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, torch.where(lt, lt5[i], ge5[i]))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.float32)``: sqrt(2) erf_inv(u),
    u uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _f32(math.sqrt(2.0), key.device) * erf_inv(u)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` through JAX's
    ``_shuffle`` (rounds of a stable sort by fresh 32-bit keys)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first ``k``
    of :func:`permutation`."""
    if k > n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    return permutation(key, n)[:k]
