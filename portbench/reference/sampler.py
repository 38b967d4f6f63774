"""The samplers' streams, on the host in numpy: sample dimension ``d`` of
sample ``s`` of pixel (x, y) as a float32 in [0, 1).

- "halton": pbrt-v3's HaltonSampler (``samplers/halton.cpp``): the global
  index of a pixel's sample from the base-2 and base-3 scales of the
  first 128 x 128 pixels (``GetIndexForSample``); dimension 0 the base-2
  radical inverse of the index shifted by the base-2 exponent, dimension 1
  the base-3 radical inverse of the index over the base-3 scale, and
  dimension d >= 2 the radical inverse in the d-th prime with each digit
  permuted.  The permutation is tpurt's arithmetic one in place of
  pbrt's PCG32 tables: pi(x) = (m x + s) mod b with m = 1 + fmix32(d *
  0x9E3779B1) mod (b - 1) and s = fmix32(d * 0x85EBCA77 + 0x6A09E667) mod
  b, fmix32 being MurmurHash3's finalizer; the digits past the index's
  last add pbrt's closed form b^-n s / (b - 1).
- "random": counter-based, from Threefry-2x32 with 20 rounds (Salmon et
  al. 2011, "Parallel random numbers: as easy as 1, 2, 3") under JAX's
  key conventions: key(seed) = (seed >> 32, seed mod 2^32), fold_in(k, x)
  = threefry(k, (0, x)), a scalar draw = the xor of the two words of
  threefry(k, (0, 0)).  Dimension d of a lane is the draw of
  fold_in(fold_in(key(0), d), c) with c = ((y * width + x) * 16384 + s)
  mod 2^32.

Values are worked out exactly (integers and float64) and rounded once to
float32, capped at 1 - 2^-24.
"""

from __future__ import annotations

import numpy as np

ONE_MINUS_EPS = np.float32(1.0) - np.float32(2.0 ** -24)
K_MAX_RESOLUTION = 128
_M32 = np.uint64(0xFFFFFFFF)


def primes(n: int):
    """The first ``n`` primes."""
    out, k = [], 2
    while len(out) < n:
        if all(k % p for p in out if p * p <= k):
            out.append(k)
        k += 1
    return out


PRIMES = primes(256)


def _unit(v):
    return np.minimum(np.asarray(v, np.float64).astype(np.float32),
                      ONE_MINUS_EPS)


def _fmix32(h: int) -> int:
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _inverse_radical_inverse(base: int, inverse, n_digits: int):
    index = np.zeros_like(inverse)
    for _ in range(n_digits):
        index = index * base + inverse % base
        inverse = inverse // base
    return index


def _mult_inverse(a: int, n: int) -> int:
    return pow(a, -1, n)


class Halton:
    def __init__(self, res_x: int, res_y: int):
        self.scales, self.exps = [], []
        for base, res in ((2, res_x), (3, res_y)):
            scale, exp = 1, 0
            while scale < min(res, K_MAX_RESOLUTION):
                scale *= base
                exp += 1
            self.scales.append(scale)
            self.exps.append(exp)
        self.stride = self.scales[0] * self.scales[1]
        self.mult_inv = (_mult_inverse(self.scales[1], self.scales[0]),
                         _mult_inverse(self.scales[0], self.scales[1]))

    def index(self, x, y, s):
        """The global index of sample ``s`` of pixel (x, y) (int64)."""
        x, y, s = (np.asarray(a, np.int64) for a in (x, y, s))
        off = (_inverse_radical_inverse(2, x % K_MAX_RESOLUTION, self.exps[0])
               * (self.stride // self.scales[0]) * self.mult_inv[0]
               + _inverse_radical_inverse(3, y % K_MAX_RESOLUTION,
                                          self.exps[1])
               * (self.stride // self.scales[1]) * self.mult_inv[1])
        return off % self.stride + s * self.stride

    @staticmethod
    def _radical_inverse(a, base: int, perm=None):
        """sum of perm(digit_i) base^-(i+1) over a's digits, plus the tail
        of permuted zeros; perm None: no permutation and no tail."""
        a = a.copy()
        rev = np.zeros(a.shape, np.int64)
        scale = np.ones(a.shape, np.float64)
        m, s = perm if perm is not None else (1, 0)
        while (a > 0).any():
            live = a > 0
            digit = a % base
            rev = np.where(live, rev * base + (m * digit + s) % base, rev)
            scale = np.where(live, scale / base, scale)
            a = a // base
        tail = s / (base - 1) if perm is not None else 0.0
        return (rev + tail) * scale

    def dim(self, x, y, s, d: int):
        idx = self.index(x, y, s)
        if d == 0:
            return _unit(self._radical_inverse(idx >> self.exps[0], 2))
        if d == 1:
            return _unit(self._radical_inverse(idx // self.scales[1], 3))
        base = PRIMES[d]
        m = 1 + _fmix32(d * 0x9E3779B1) % (base - 1)
        sh = _fmix32(d * 0x85EBCA77 + 0x6A09E667) % base
        return _unit(self._radical_inverse(idx, base, (m, sh)))


_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def _rotl(x, r):
    return ((x << np.uint64(r)) & _M32) | (x >> np.uint64(32 - r))


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint64 arrays holding 32-bit words."""
    k0, k1, x0, x1 = (np.asarray(v, np.uint64) & _M32
                      for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for r in range(20):
        x0 = (x0 + x1) & _M32
        x1 = _rotl(x1, _ROT[r % 8]) ^ x0
        if r % 4 == 3:
            j = r // 4 + 1
            x0 = (x0 + ks[j % 3]) & _M32
            x1 = (x1 + ks[(j + 1) % 3] + np.uint64(j)) & _M32
    return x0, x1


class Random:
    def __init__(self, res_x: int, seed: int = 0):
        self.res_x = res_x
        self.key = ((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)

    def dim(self, x, y, s, d: int):
        x, y, s = (np.asarray(a, np.uint64) for a in (x, y, s))
        c = ((y * np.uint64(self.res_x) + x) * np.uint64(16384) + s) & _M32
        kd = threefry(*self.key, 0, d)
        kl = threefry(kd[0], kd[1], 0, c)
        w0, w1 = threefry(kl[0], kl[1], 0, 0)
        u = (w0 ^ w1).astype(np.float32) * np.float32(2.0 ** -32)
        return np.minimum(u, ONE_MINUS_EPS)


def make(name: str, res_x: int, res_y: int):
    if name == "halton":
        return Halton(res_x, res_y)
    if name == "random":
        return Random(res_x)
    raise ValueError(f"Sampler {name!r}")
