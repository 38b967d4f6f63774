"""Samplers: pure functions (pixel, sample index, dimension) -> uniform
[0,1) float32 (port of tpurt/sampling/samplers.py: Halton with both digit
scrambles, random, stratified, (0,2)-sequence, Sobol' and maxmindist, and
make_sampler as sampler_tables + sampler_from_tables).

The bounce loop is Python here, so every dimension is a Python int and
all per-dimension constants (scramble parameters, threefry keys, Sobol'
matrix rows) are computed on the host, exactly as in tpurt's
static-dimension branches; tpurt's ``dim_dyn`` variants serve its
lax.scan and have no counterpart.  Index math is int64 on the device with
uint32 values masked to 32 bits, so that wrap-around (the random
sampler's lane counter exceeds 2^32 at 700x700) matches uint32
arithmetic.  uint32 -> float32 conversions round to nearest even from
int64, as jnp's ``astype(float32)`` does from uint32.

Each sampler keeps its host tables (``*_tables``) apart from the upload
(``*_from_tables``) so that tpurt_torch.convert can carry a tpurt
sampler across.  The pixel-to-index algebra of Halton comes from the
port's copy of tpurt's ``sampling/lowdiscrepancy.py``, the Sobol'
matrices and the maxmindist search from its copy of ``sampling/sobol.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpurt_torch.sampling import lowdiscrepancy as ld
from tpurt_torch.sampling import threefry as tf

log = logging.getLogger("tpurt_torch.sampling")

ONE_MINUS_EPS = float(np.float32(1.0) - np.float32(2 ** -24))
_M32 = 0xFFFFFFFF


def _bit_reverse32(x):
    """32-bit reversal of int64 lanes holding uint32 values."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _M32) | (x >> 16)


def _u32_to_unit(u):
    """uint32 value (in int64 lanes) -> [0,1) float32, as
    ``min(u.astype(f32) * 2^-32, ONE_MINUS_EPS)``."""
    return torch.clamp(u.to(torch.float32) * (2.0 ** -32), max=ONE_MINUS_EPS)


def _div(x, c: float):
    """x / float32(c) with the divisor on the device: CUDA turns division
    by a host scalar into a multiply by its reciprocal, which rounds
    differently."""
    return x / torch.full((), float(np.float32(c)), dtype=torch.float32,
                          device=x.device)


def _radical_inverse_base2(a):
    """Exact base-2 radical inverse of a 32-bit index."""
    return _u32_to_unit(_bit_reverse32(a & _M32))


def _radical_inverse(a, base: int, max_index: int):
    inv_base = float(np.float32(1.0 / base))
    acc = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    scale = torch.full(a.shape, inv_base, dtype=torch.float32, device=a.device)
    for _ in range(_digits_needed(base, max_index)):
        digit = a % base
        acc = acc + digit.to(torch.float32) * scale
        scale = scale * inv_base
        a = a // base
    return torch.clamp(acc, max=ONE_MINUS_EPS)


def _fmix32(h: int) -> int:
    """murmur3 finalizer on a Python int (wrapped to 32 bits)."""
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def _affine_perm_params(d: int, base: int):
    """Per-dimension digit permutation pi(x) = (m*x + s) mod base: m in
    [1, base) (coprime to the prime base) and s in [0, base)."""
    m = 1 + _fmix32(d * 0x9E3779B1) % (base - 1)
    s = _fmix32(d * 0x85EBCA77 + 0x6A09E667) % base
    return m, s


def _digits_needed(base: int, max_index: int = 1 << 31) -> int:
    n = 0
    v = 1
    while v < max_index:
        v *= base
        n += 1
    return n


def _scrambled_radical_inverse(a, base: int, perm, max_index: int):
    """Radical inverse with a digit-permutation table (the reference's
    PCG32 tables; ``perm`` is this base's (base,) slice on the device)."""
    inv_base = float(np.float32(1.0 / base))
    acc = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    scale = acc + inv_base
    inv_base_n = acc + 1.0
    for _ in range(_digits_needed(base, max_index)):
        digit = a % base
        active = a > 0
        acc = torch.where(active,
                          acc + perm[digit].to(torch.float32) * scale, acc)
        inv_base_n = torch.where(active, inv_base_n * inv_base, inv_base_n)
        scale = scale * inv_base
        a = a // base
    tail = _div(inv_base_n * perm[0].to(torch.float32), base - 1)
    return torch.clamp(acc + tail, max=ONE_MINUS_EPS)


def _fma32(acc, x, y):
    """float32 acc + x * y rounded once, as the fused multiply-add that
    XLA makes of a digit sum inside jitted code on the CPU (a digit times
    a float32 scale is exact in float64)."""
    return (acc.double() + x.double() * y.double()).to(torch.float32)


def _affine_radical_inverse(a, base: int, m: int, s: int, n_digits: int,
                            fma: bool = False):
    """Radical inverse with the affine digit permutation at every digit;
    the zero-digit tail has pbrt's closed form with perm[0] == s.  With
    ``fma`` each digit's term is added as a fused multiply-add."""
    basef = np.float32(base)
    inv_base = float(np.float32(1.0) / basef)
    acc = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    scale = acc + inv_base
    inv_base_n = acc + 1.0
    for _ in range(n_digits):
        digit = a % base
        pdigit = (m * digit + s) % base
        active = a > 0
        pd = pdigit.to(torch.float32)
        acc = torch.where(active, _fma32(acc, pd, scale) if fma
                          else acc + pd * scale, acc)
        inv_base_n = torch.where(active, inv_base_n * inv_base, inv_base_n)
        a = a // base
        scale = scale * inv_base
    tail = _div(inv_base_n * float(np.float32(s)), base - 1)
    return torch.clamp(acc + tail, max=ONE_MINUS_EPS)


@dataclasses.dataclass
class HaltonSampler:
    spp: int
    offsets: torch.Tensor  # (H, W) int64 first-sample index per pixel
    stride: int
    exp_x: int
    scale_y: int
    sample_at_center: bool = False
    # largest sample index any lane can request: bounds the digit loops
    max_index: int = 1 << 31
    # "affine": arithmetic digit permutation (tpurt's default); "pbrt":
    # the reference's PCG32 permutation tables, one gather per digit
    scramble: str = "affine"
    perms: Optional[torch.Tensor] = None  # flat table ("pbrt" mode)
    # affine dims >= 2 add each digit's term as a fused multiply-add, as
    # tpurt's jitted code computes them on the CPU; off, they round the
    # product first, as tpurt's eager functions do (which the other
    # integrators' samplers are held to).  SPPM's sampler sets it.
    fma: bool = False

    name = "halton"

    def lane_ctx(self, px, py, sample_idx):
        """The per-lane Halton index, computed once per wavefront."""
        return self.offsets[py, px] + sample_idx.to(torch.int64) * self.stride

    def dim(self, px, py, sample_idx, d: int, ctx=None):
        """Sample dimension d (HaltonSampler::SampleDimension,
        halton.cpp:118-127)."""
        idx = ctx if ctx is not None else self.lane_ctx(px, py, sample_idx)
        if self.sample_at_center and d in (0, 1):
            return torch.full(idx.shape, 0.5, dtype=torch.float32,
                              device=idx.device)
        if d == 0:
            return _radical_inverse_base2(idx >> self.exp_x)
        if d == 1:
            return _radical_inverse(idx // self.scale_y, 3,
                                    max(2, self.max_index // self.scale_y))
        base = int(ld.PRIMES[d])
        if self.scramble == "pbrt":
            off = int(ld.PRIME_SUMS[d])
            return _scrambled_radical_inverse(
                idx, base, self.perms[off:off + base], self.max_index)
        m, s = _affine_perm_params(d, base)
        return _affine_radical_inverse(idx, base, m, s,
                                       _digits_needed(base, self.max_index),
                                       fma=self.fma)

    def film_offset(self, px, py, sample_idx, ctx=None):
        """Dims 0/1 are the in-pixel offsets (halton.cpp:118-124)."""
        return (self.dim(px, py, sample_idx, 0, ctx),
                self.dim(px, py, sample_idx, 1, ctx))


def halton_tables(spp: int, res_x: int, res_y: int,
                  sample_at_center: bool = False,
                  sample_bounds=None, scramble: str = "affine") -> dict:
    """Host-side Halton constants.  The geometry derives from the sample
    bounds (halton.cpp:74); pixel offsets stay keyed by the absolute
    raster pixel."""
    if sample_bounds is None:
        sample_bounds = (0, res_x, 0, res_y)
    sx0, sx1, sy0, sy1 = sample_bounds
    geom = ld.halton_geometry(sx1 - sx0, sy1 - sy0)
    py, px = np.meshgrid(np.arange(res_y), np.arange(res_x), indexing="ij")
    offsets = ld.halton_pixel_offsets(geom, px.ravel(), py.ravel())
    return dict(
        spp=spp,
        offsets=offsets.reshape(res_y, res_x).astype(np.int64),
        stride=int(geom["sample_stride"]),
        exp_x=int(geom["base_exponents"][0]),
        scale_y=int(geom["base_scales"][1]),
        sample_at_center=bool(sample_at_center),
        max_index=int(offsets.max()) + (spp + 1) * int(geom["sample_stride"]),
        scramble=scramble,
        perms=(ld.compute_radical_inverse_permutations().astype(np.int64)
               if scramble == "pbrt" else None),
    )


def halton_from_tables(tab: dict, device) -> HaltonSampler:
    tab = {k: v for k, v in tab.items() if k != "name"}
    perms = tab.get("perms")
    return HaltonSampler(**dict(
        tab, offsets=torch.tensor(tab["offsets"], device=device),
        perms=None if perms is None else torch.tensor(perms, device=device)))


# ---------------------------------------------------------------------------
# Random (threefry counter-based)
# ---------------------------------------------------------------------------

def _pixel_index(px, py, res_x: int):
    """uint32 ``py * res_x + px`` in int64 lanes."""
    return (py.to(torch.int64) * res_x + px.to(torch.int64)) & _M32


def _lane_counter(px, py, sample_idx, res_x: int):
    """uint32 per-lane counter folding pixel and sample number; wraps at
    2^32 like tpurt's uint32 arithmetic."""
    return (_pixel_index(px, py, res_x) * 16384
            + sample_idx.to(torch.int64)) & _M32


@dataclasses.dataclass
class RandomSampler:
    spp: int
    seed: int
    res_x: int

    name = "random"

    def lane_ctx(self, px, py, sample_idx):
        return _lane_counter(px, py, sample_idx, self.res_x)

    def dim(self, px, py, sample_idx, d: int, ctx=None):
        key = tf.fold_in(tf.key(self.seed), d)
        counter = (ctx if ctx is not None
                   else self.lane_ctx(px, py, sample_idx))
        return _u32_to_unit(tf.bits(tf.fold_in(key, counter)))

    def film_offset(self, px, py, sample_idx, ctx=None):
        return (self.dim(px, py, sample_idx, 0, ctx),
                self.dim(px, py, sample_idx, 1, ctx))


# ---------------------------------------------------------------------------
# Stratified
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StratifiedSampler:
    """Jittered stratification (samplers/stratified.cpp): dims 0-1 use an
    (nx, ny) grid indexed by the sample number; deeper dims use 1D strata
    with a per-(pixel, dim) permutation of the sample-to-stratum
    assignment (the Shuffle analog)."""

    spp: int
    nx: int
    ny: int
    jitter: bool
    seed: int
    res_x: int

    name = "stratified"

    def _u(self, px, py, sample_idx, d: int, salt: int):
        key = tf.fold_in(tf.fold_in(tf.key(self.seed), d), salt)
        counter = _lane_counter(px, py, sample_idx, self.res_x)
        u = tf.bits(tf.fold_in(key, counter))
        return u.to(torch.float32) * (2.0 ** -32)

    def _permuted_index(self, px, py, sample_idx, d: int):
        """Per-(pixel, dim) pseudorandom bijection of sample_idx over
        [0, spp)."""
        key = tf.fold_in(tf.key(self.seed ^ 0x9E3779B9), d)
        r = tf.bits(tf.fold_in(key, _pixel_index(px, py, self.res_x)))
        sidx = sample_idx.to(torch.int64)
        if self.spp & (self.spp - 1) == 0 and self.spp > 0:
            # xor within a power-of-two range is a bijection
            return sidx ^ (r % self.spp)
        return ((sidx + r) & _M32) % max(self.spp, 1)

    def lane_ctx(self, px, py, sample_idx):
        return None

    def dim(self, px, py, sample_idx, d: int, ctx=None):
        if d in (0, 1):
            return self.film_offset(px, py, sample_idx)[d]
        s = self._permuted_index(px, py, sample_idx, d).to(torch.float32)
        j = self._u(px, py, sample_idx, d, 1) if self.jitter else 0.5
        return torch.clamp(_div(s + j, max(self.spp, 1)), max=ONE_MINUS_EPS)

    def film_offset(self, px, py, sample_idx, ctx=None):
        sidx = sample_idx.to(torch.int64)
        sx = (sidx % self.nx).to(torch.float32)
        sy = (sidx // self.nx).to(torch.float32)
        jx = self._u(px, py, sample_idx, 0, 2) if self.jitter else 0.5
        jy = self._u(px, py, sample_idx, 1, 3) if self.jitter else 0.5
        return (torch.clamp(_div(sx + jx, self.nx), max=ONE_MINUS_EPS),
                torch.clamp(_div(sy + jy, self.ny), max=ONE_MINUS_EPS))


# ---------------------------------------------------------------------------
# (0,2)-sequence
# ---------------------------------------------------------------------------

def _sobol2_matrix() -> np.ndarray:
    """Generator columns of the second dimension of the 2D Sobol'
    (0,2)-sequence (the first is bit reversal): v_k = v_{k-1} ^
    (v_{k-1} >> 1)."""
    cols = np.zeros(32, dtype=np.uint32)
    cols[0] = np.uint32(1 << 31)
    for c in range(1, 32):
        cols[c] = cols[c - 1] ^ (cols[c - 1] >> np.uint32(1))
    return cols


_SOBOL2_COLS = _sobol2_matrix()


def _xor_columns(index, cols, n_bits: int):
    """XOR of ``cols[c]`` over the set bits c < n_bits of ``index``
    (bits at or above n_bits must be clear)."""
    v = torch.zeros_like(index)
    for c in range(n_bits):
        v = v ^ (((index >> c) & 1) * int(cols[c]))
    return v


def _sobol_2d(index, scramble_x, scramble_y, n_bits: int = 32):
    """2D Sobol' sample of ``index`` with xor scrambling (Sample02)."""
    x = _bit_reverse32(index) ^ scramble_x
    y = _xor_columns(index, _SOBOL2_COLS, n_bits) ^ scramble_y
    return _u32_to_unit(x), _u32_to_unit(y)


def _index_bits(spp: int) -> int:
    """Bits that a sample index below spp can have set."""
    return max(spp - 1, 1).bit_length()


@dataclasses.dataclass
class ZeroTwoSequenceSampler:
    spp: int  # rounded up to a power of two like the reference
    seed: int
    res_x: int

    name = "02sequence"

    def _scrambles(self, px, py, d: int):
        key = tf.fold_in(tf.key(self.seed), d)
        ks = tf.fold_in(key, _pixel_index(px, py, self.res_x))
        return tf.bits(ks, 0), tf.bits(ks, 1)

    def dim2(self, px, py, sample_idx, d: int):
        sx, sy = self._scrambles(px, py, d)
        return _sobol_2d(sample_idx.to(torch.int64) & _M32, sx, sy,
                         _index_bits(self.spp))

    def lane_ctx(self, px, py, sample_idx):
        return None

    def dim(self, px, py, sample_idx, d: int, ctx=None):
        # consecutive dims pair into one 2D (0,2) lookup
        return self.dim2(px, py, sample_idx, d // 2)[d % 2]

    def film_offset(self, px, py, sample_idx, ctx=None):
        return self.dim2(px, py, sample_idx, 0)


# ---------------------------------------------------------------------------
# Sobol' (global sampler): samplers/sobol.cpp + SobolIntervalToIndex
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SobolSampler:
    spp: int  # power of two (sobol.cpp rounds up)
    m: int  # log2 of the pow2 tiling of the sample-bounds extent
    mats: np.ndarray  # (D, 32) uint32 direction vectors (host constants)
    inv_cols: np.ndarray  # (2m,) uint32: interval-to-index solve
    fmap_cols: np.ndarray  # (F,) uint32
    smin_x: int = 0  # sample-bounds origin (sobol.cpp indexes pixels
    smin_y: int = 0  # relative to sampleBounds.pMin)

    name = "sobol"

    @property
    def _idx_bits(self) -> int:
        return 2 * self.m + _index_bits(self.spp)

    def index(self, px, py, sidx):
        """Global index of pixel (px, py)'s sidx-th sample
        (SobolIntervalToIndex analog)."""
        f = sidx.to(torch.int64) & _M32
        if self.m == 0:
            return f
        m, lm = self.m, 2 * self.m
        pxu = (px.to(torch.int64) - self.smin_x) & _M32
        pyu = (py.to(torch.int64) - self.smin_y) & _M32
        mask = (1 << m) - 1
        y = (pxu & mask) | ((pyu & mask) << m)
        t = y ^ _xor_columns(f, self.fmap_cols,
                             min(_index_bits(self.spp),
                                 int(self.fmap_cols.shape[0])))
        ell = _xor_columns(t, self.inv_cols, lm)
        return ((f << lm) & _M32) | ell

    def lane_ctx(self, px, py, sample_idx):
        return self.index(px, py, sample_idx)

    def dim(self, px, py, sidx, d: int, ctx=None):
        """SobolSampler::SampleDimension (sobol.cpp:46-58): dims 0/1 are
        remapped to in-pixel offsets via the pow2 tiling."""
        idx = ctx if ctx is not None else self.index(px, py, sidx)
        s = _u32_to_unit(_xor_columns(idx, self.mats[d], self._idx_bits))
        if d in (0, 1):
            # s * resolution + sampleBounds.pMin - pixel (sobol.cpp:54-56)
            smin = float(self.smin_x if d == 0 else self.smin_y)
            pix = (px if d == 0 else py).to(torch.float32)
            return torch.clamp(s * float(1 << self.m) + smin - pix,
                               0.0, ONE_MINUS_EPS)
        return s

    def film_offset(self, px, py, sidx, ctx=None):
        return (self.dim(px, py, sidx, 0, ctx),
                self.dim(px, py, sidx, 1, ctx))


def sobol_tables(spp: int, res_x: int, res_y: int, sample_bounds=None
                 ) -> dict:
    from tpurt_torch.sampling import sobol as sb

    # the pow2 tiling covers the sample-bounds extent and pixels are
    # indexed relative to its origin
    if sample_bounds is None:
        sample_bounds = (0, res_x, 0, res_y)
    sx0, sx1, sy0, sy1 = sample_bounds
    m = max(int(np.ceil(np.log2(max(sx1 - sx0, sy1 - sy0, 1)))), 0)
    mats = sb.get_sobol_matrices()
    inv_cols, fmap_cols = sb.build_interval_to_index(m, mats)
    return dict(name="sobol", spp=spp, m=m, mats=np.asarray(mats),
                inv_cols=np.asarray(inv_cols),
                fmap_cols=np.asarray(fmap_cols), smin_x=sx0, smin_y=sy0)


# ---------------------------------------------------------------------------
# MaxMinDist (samplers/maxmin.cpp): the first 2D dimension uses a
# min-distance-optimized generator matrix, every other the (0,2)-sequence
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MaxMinDistSampler:
    spp: int  # power of two
    seed: int
    res_x: int
    cpixel: Tuple[int, ...]  # k uint32 MSB-aligned generator columns

    name = "maxmindist"

    def _base(self):
        return ZeroTwoSequenceSampler(spp=self.spp, seed=self.seed,
                                      res_x=self.res_x)

    def lane_ctx(self, px, py, sample_idx):
        return None

    def _shuffled(self, px, py, sidx):
        """Per-pixel xor bijection of the sample order (the Shuffle at
        maxmin.cpp:45)."""
        key = tf.fold_in(tf.key(self.seed ^ 0x5157), 1)
        r = tf.bits(tf.fold_in(key, _pixel_index(px, py, self.res_x)))
        return (sidx.to(torch.int64) & _M32) ^ (r % max(self.spp, 1))

    def film_offset(self, px, py, sidx, ctx=None):
        j = self._shuffled(px, py, sidx)
        fx = torch.clamp(_div(j.to(torch.float32), self.spp),
                         max=ONE_MINUS_EPS)
        fy = _u32_to_unit(_xor_columns(j, self.cpixel, len(self.cpixel)))
        return fx, fy

    def dim(self, px, py, sidx, d: int, ctx=None):
        if d in (0, 1):
            return self.film_offset(px, py, sidx)[d]
        return self._base().dim(px, py, sidx, d, ctx)


def maxmin_tables(spp: int, res_x: int) -> dict:
    from tpurt_torch.sampling import sobol as sb

    k = _index_bits(spp)
    if (1 << k) != spp:
        k = int(np.ceil(np.log2(max(spp, 1))))
    if k <= 10:
        cols = tuple(int(c) for c in sb.maxmin_dist_matrix(max(k, 1)))
    else:
        log.warning("maxmindist: spp %d too large for the matrix search; "
                    "using the (0,2)-sequence pixel dimension", spp)
        cols = tuple(int(_SOBOL2_COLS[c]) for c in range(k))
    return dict(name="maxmindist", spp=spp, seed=0, res_x=res_x, cpixel=cols)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_PLAIN = {"random": RandomSampler, "stratified": StratifiedSampler,
          "02sequence": ZeroTwoSequenceSampler, "sobol": SobolSampler,
          "maxmindist": MaxMinDistSampler}


def sampler_tables(name: str, params, res_x: int, res_y: int,
                   quick: bool = False, sample_bounds=None) -> dict:
    """CreateSampler dispatch (api.cpp MakeSampler :817-837) with the
    reference defaults, as host tables: a dict with the sampler's
    ``name`` and its constructor fields.  sample_bounds =
    Film::GetSampleBounds as (x0, x1, y0, y1); the halton and sobol
    geometry depends on it under crop windows."""
    if name == "halton":
        spp = 1 if quick else params.find_one_int("pixelsamples", 16)
        # TPURT_HALTON_SCRAMBLE=pbrt selects the reference's
        # digit-permutation tables; the default affine scramble is
        # statistically equivalent
        scramble = os.environ.get("TPURT_HALTON_SCRAMBLE", "affine")
        return dict(halton_tables(
            spp, res_x, res_y,
            params.find_one_bool("samplepixelcenter", False),
            sample_bounds=sample_bounds, scramble=scramble), name="halton")
    if name == "random":
        spp = params.find_one_int("pixelsamples", 4)
        return dict(name="random", spp=1 if quick else spp, seed=0,
                    res_x=res_x)
    if name == "stratified":
        nx = params.find_one_int("xsamples", 4)
        ny = params.find_one_int("ysamples", 4)
        if quick:
            nx = ny = 1
        return dict(name="stratified", spp=nx * ny, nx=nx, ny=ny,
                    jitter=params.find_one_bool("jitter", True), seed=0,
                    res_x=res_x)
    if name in ("lowdiscrepancy", "02sequence", "maxmindist", "sobol"):
        spp = 1 if quick else params.find_one_int("pixelsamples", 16)
        pow2 = 1 << max(0, int(np.ceil(np.log2(max(spp, 1)))))
        if pow2 != spp:
            log.warning("sampler %s: rounding %d samples to pow2 %d", name,
                        spp, pow2)
        if name == "sobol":
            return sobol_tables(pow2, res_x, res_y,
                                sample_bounds=sample_bounds)
        if name == "maxmindist":
            return maxmin_tables(pow2, res_x)
        return dict(name="02sequence", spp=pow2, seed=0, res_x=res_x)
    raise NotImplementedError(f'Sampler "{name}"')


def sampler_from_tables(tab: dict, device):
    """Build the sampler of host tables ``tab`` for ``device``.  Only
    Halton keeps tensors (pixel offsets, permutation table); the others
    are host constants."""
    name = tab.get("name", "halton")
    if name == "halton":
        return halton_from_tables(tab, device)
    return _PLAIN[name](**{k: v for k, v in tab.items() if k != "name"})
