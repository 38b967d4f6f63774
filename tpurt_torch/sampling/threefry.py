"""Threefry-2x32 counter-based random bits, bit for bit what ``jax.random``
draws for tpurt's samplers.

tpurt's random, stratified, (0,2)-sequence and maxmindist samplers take
their bits from ``jax.random``: ``key(seed)``, ``fold_in(key, data)`` and
``bits(key, shape, uint32)``.  To compare images sample for sample the
port computes the same stream with plain integer arithmetic:

* ``key(seed)``          = the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``
* ``fold_in(key, x)``    = ``threefry2x32(key, (0, x))`` (both output words
                           are the new key)
* ``bits(key, n)[i]``    = ``w0 ^ w1`` of ``threefry2x32(key, (0, i))``
* ``split(key, num)[i]`` = both words of ``threefry2x32(key, (0, i))``
* ``uniform(key, shape)`` = ``bits(key, n)`` in row-major order, each
                           element's top 23 bits as the mantissa of a
                           float32 in [1, 2), less 1

(MLT's bootstrap draws its primary samples through split and uniform.)
The bits and split lines are JAX's ``jax_threefry_partitionable=True``
scheme (the default since JAX 0.5): each element's counter is its own
index, split into a high and a low word, and the two output words are
xored.  With that flag off JAX pairs the counters of a whole array
differently, and this module would not reproduce it.

Every function works on Python ints (host-side keys) and on int64 tensors
holding uint32 values alike; words are masked to 32 bits after every add
and shift.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011).  Key and counter
    words are Python ints or int64 tensors of uint32 values, in any mix."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int):
    """``jax.random.key(seed)`` as its two key words."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(k, data):
    """``jax.random.fold_in(key, data)``; data is a uint32 value (Python
    int or int64 tensor).  Returns the new key's two words."""
    return threefry2x32(k[0], k[1], 0, data)


def bits(k, index=0):
    """Element ``index`` of ``jax.random.bits(key, shape, uint32)`` for a
    one-dimensional (or scalar, index 0) shape of fewer than 2^32 elements."""
    w0, w1 = threefry2x32(k[0], k[1], 0, index)
    return w0 ^ w1


def split(k, num: int = 2):
    """``jax.random.split(key, num)`` as a list of ``num`` keys (word
    pairs of Python ints)."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def uniform(k, shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` (minval 0, maxval 1),
    bit for bit, as a float32 tensor on ``device``: the element bits of
    ``bits`` over the flat index, their top 23 bits under the exponent of
    1.0, less 1.  The shape's size must stay below 2^32."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    w = bits(k, idx)
    # (w >> 9) | bits(1.0f): a float in [1, 2), held in an int32's bits
    f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0).reshape(tuple(shape))
