"""Low-discrepancy sequence math: primes, radical inverse, scrambling
permutations, and Halton index algebra.

Reference analog: core/lowdiscrepancy.{h,cpp} (the 1000-prime table at
lowdiscrepancy.cpp:40, RadicalInverse/ScrambledRadicalInverse specializations,
ComputeRadicalInversePermutations at :2490) and samplers/halton.cpp:65-135.
Instead of a 1000-way template switch we keep per-dimension (prime, digit
count) tables and evaluate a batched digit loop on device; the permutation
table is generated host-side with the bit-exact PCG32 above.
"""

from __future__ import annotations

import functools

import numpy as np

from tpurt_torch.sampling.rng import PCG32, shuffle_inplace

PRIME_TABLE_SIZE = 1000


def _sieve_first_primes(n: int) -> np.ndarray:
    # Simple sieve sized well past the 1000th prime (7919).
    limit = 8200
    is_p = np.ones(limit, dtype=bool)
    is_p[:2] = False
    for p in range(2, int(limit ** 0.5) + 1):
        if is_p[p]:
            is_p[p * p :: p] = False
    primes = np.flatnonzero(is_p)[:n]
    assert len(primes) == n
    return primes.astype(np.int64)


PRIMES: np.ndarray = _sieve_first_primes(PRIME_TABLE_SIZE)
PRIME_SUMS: np.ndarray = np.concatenate([[0], np.cumsum(PRIMES)[:-1]]).astype(np.int64)

#: float one-minus-epsilon used to clamp [0,1) results (pbrt.h OneMinusEpsilon)
ONE_MINUS_EPSILON = np.float32(1.0) - np.float32(2.0 ** -24)


def radical_inverse_np(base_index: int, a) -> np.ndarray:
    """Reverse the digits of ``a`` in base PRIMES[base_index] about the
    radix point.  Host/numpy reference implementation (float64 accumulation,
    like the reference's double math in lowdiscrepancy.h)."""
    base = int(PRIMES[base_index])
    a = np.asarray(a, dtype=np.uint64)
    inv_base = 1.0 / base
    reversed_digits = np.zeros_like(a)
    inv_base_n = np.ones(a.shape, dtype=np.float64)
    a = a.copy()
    while (a > 0).any():
        next_a = a // base
        digit = a - next_a * base
        active = a > 0
        reversed_digits = np.where(
            active, reversed_digits * np.uint64(base) + digit, reversed_digits
        )
        inv_base_n = np.where(active, inv_base_n * inv_base, inv_base_n)
        a = next_a
    return np.minimum(
        reversed_digits * inv_base_n, np.float64(ONE_MINUS_EPSILON)
    ).astype(np.float64)


def scrambled_radical_inverse_np(base_index: int, a, perm: np.ndarray) -> np.ndarray:
    """Scrambled radical inverse with per-digit permutation ``perm`` of size
    base.  Matches the reference's infinite-tail identity: the scrambled
    digit stream is perm[0],perm[0],... beyond the last significant digit,
    contributing perm[0] / (base-1) * inv_base^n at the tail
    (lowdiscrepancy.cpp ScrambledRadicalInverseSpecialized)."""
    base = int(PRIMES[base_index])
    a = np.asarray(a, dtype=np.uint64).copy()
    inv_base = 1.0 / base
    reversed_digits = np.zeros(a.shape, dtype=np.uint64)
    inv_base_n = np.ones(a.shape, dtype=np.float64)
    while (a > 0).any():
        next_a = a // base
        digit = (a - next_a * base).astype(np.int64)
        active = a > 0
        reversed_digits = np.where(
            active,
            reversed_digits * np.uint64(base) + perm[digit].astype(np.uint64),
            reversed_digits,
        )
        inv_base_n = np.where(active, inv_base_n * inv_base, inv_base_n)
        a = next_a
    tail = inv_base_n * perm[0] / (base - 1.0)
    return np.minimum(
        inv_base_n * reversed_digits + tail, np.float64(ONE_MINUS_EPSILON)
    )


@functools.lru_cache(maxsize=1)
def compute_radical_inverse_permutations() -> np.ndarray:
    """Digit permutations for all 1000 prime bases, flattened with
    PRIME_SUMS offsets; bit-exact with lowdiscrepancy.cpp:2490-2505 under the
    default-seeded PCG32.  The sequential PCG32 consumption makes this a
    host-side scalar loop (~3.7M draws), so the result is cached on disk."""
    import os

    from tpurt_torch.config import BUILD_DIR

    cache_dir = str(BUILD_DIR)
    cache = os.path.join(cache_dir, "halton_perms_v1.npy")
    if os.path.exists(cache):
        perms = np.load(cache)
        if len(perms) == int(PRIMES.sum()):
            return perms
    try:
        from tpurt_torch.native import gen_halton_perms_native

        perms = gen_halton_perms_native(PRIMES)
        if perms is not None:
            try:
                os.makedirs(cache_dir, exist_ok=True)
                np.save(cache, perms)
            except OSError:
                pass
            return perms
    except ImportError:
        pass
    rng = PCG32()
    total = int(PRIMES.sum())
    perms = np.zeros(total, dtype=np.uint16)
    off = 0
    for p in PRIMES:
        p = int(p)
        seg = np.arange(p, dtype=np.uint16)
        shuffle_inplace(seg, rng)
        perms[off : off + p] = seg
        off += p
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(cache, perms)
    except OSError:
        pass
    return perms


def permutation_for_dimension(perms: np.ndarray, dim: int) -> np.ndarray:
    if dim >= PRIME_TABLE_SIZE:
        raise ValueError(f"Can only sample {PRIME_TABLE_SIZE} dimensions")
    return perms[PRIME_SUMS[dim] : PRIME_SUMS[dim] + PRIMES[dim]]


def inverse_radical_inverse(base: int, inverse: int, n_digits: int) -> int:
    """Given the radical inverse digits (as integer ``inverse``), recover the
    index whose first n_digits produce them (halton.cpp uses this to find the
    first sample index landing in a pixel)."""
    index = 0
    for _ in range(n_digits):
        digit = inverse % base
        inverse //= base
        index = index * base + digit
    return index


def multiplicative_inverse(a: int, n: int) -> int:
    return pow(a % n, -1, n)


# ---------------------------------------------------------------------------
# Halton pixel->index algebra (samplers/halton.cpp:74-116)
# ---------------------------------------------------------------------------

K_MAX_RESOLUTION = 128


def halton_geometry(res_x: int, res_y: int):
    """Base scales/exponents + sample stride for a sample raster of the given
    resolution; mirrors the constructor math at halton.cpp:74-91."""
    scales, exps = [], []
    for i, base in enumerate((2, 3)):
        res = (res_x, res_y)[i]
        scale, exp = 1, 0
        while scale < min(res, K_MAX_RESOLUTION):
            scale *= base
            exp += 1
        scales.append(scale)
        exps.append(exp)
    stride = scales[0] * scales[1]
    mult_inv = (
        multiplicative_inverse(scales[1], scales[0]),
        multiplicative_inverse(scales[0], scales[1]),
    )
    return dict(
        base_scales=tuple(scales),
        base_exponents=tuple(exps),
        sample_stride=stride,
        mult_inverse=mult_inv,
    )


def halton_pixel_offsets(geom: dict, px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """First-sample Halton index for each pixel (vectorized over pixels);
    mirrors GetIndexForSample's offsetForCurrentPixel (halton.cpp:95-116)."""
    stride = geom["sample_stride"]
    if stride <= 1:
        return np.zeros(np.shape(px), dtype=np.int64)
    sx, sy = geom["base_scales"]
    ex, ey = geom["base_exponents"]
    mx, my = geom["mult_inverse"]
    pmx = np.mod(px, K_MAX_RESOLUTION).astype(np.int64)
    pmy = np.mod(py, K_MAX_RESOLUTION).astype(np.int64)

    # InverseRadicalInverse vectorized for bases 2 and 3.
    def inv_rad_inv(base, inverse, n_digits):
        inverse = inverse.copy()
        index = np.zeros_like(inverse)
        for _ in range(n_digits):
            digit = inverse % base
            inverse //= base
            index = index * base + digit
        return index

    dim_off_x = inv_rad_inv(2, pmx, ex)
    dim_off_y = inv_rad_inv(3, pmy, ey)
    off = dim_off_x * (stride // sx) * mx + dim_off_y * (stride // sy) * my
    return np.mod(off, stride).astype(np.int64)
