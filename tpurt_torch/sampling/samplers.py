"""Halton sampler, affine scramble (port of tpurt/sampling/samplers.py:
HaltonSampler and make_halton, as halton_tables + halton_from_tables, in
tpurt's default ``affine`` mode).

Sample values are pure functions of (pixel, sample index, dimension).
The bounce loop is Python here, so every dimension is a Python int and the
per-dimension scramble parameters are computed on the host, exactly as in
tpurt's static-dimension branch.  Index math is int64 on the device.
The pixel-to-index algebra comes from the port's copy of tpurt's
``sampling/lowdiscrepancy.py``; the PCG32 permutation tables of the
``pbrt`` scramble mode are never built here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpurt_torch.sampling import lowdiscrepancy as ld

ONE_MINUS_EPS = float(np.float32(1.0) - np.float32(2 ** -24))
_M32 = 0xFFFFFFFF


def _bit_reverse32(x):
    """32-bit reversal of int64 lanes holding uint32 values."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _M32) | (x >> 16)


def _radical_inverse_base2(a):
    """Exact base-2 radical inverse of a 32-bit index."""
    rev = _bit_reverse32(a & _M32)
    return torch.clamp(rev.to(torch.float32) * (2.0 ** -32), max=ONE_MINUS_EPS)


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


def _affine_radical_inverse(a, base: int, m: int, s: int, n_digits: int):
    """Radical inverse with the affine digit permutation at every digit;
    the zero-digit tail has pbrt's closed form with perm[0] == s."""
    basef = np.float32(base)
    inv_base = float(np.float32(1.0) / basef)
    acc = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    scale = acc + inv_base
    inv_base_n = acc + 1.0
    for _ in range(n_digits):
        digit = a % base
        pdigit = (m * digit + s) % base
        active = a > 0
        acc = torch.where(active, acc + pdigit.to(torch.float32) * scale, acc)
        inv_base_n = torch.where(active, inv_base_n * inv_base, inv_base_n)
        a = a // base
        scale = scale * inv_base
    # divide by a device scalar: CUDA turns division by a host scalar into
    # a multiply by its reciprocal, which rounds differently
    den = torch.full((), float(basef - np.float32(1.0)), dtype=torch.float32,
                     device=a.device)
    tail = inv_base_n * float(np.float32(s)) / den
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
        m, s = _affine_perm_params(d, base)
        return _affine_radical_inverse(idx, base, m, s,
                                       _digits_needed(base, self.max_index))

    def film_offset(self, px, py, sample_idx, ctx=None):
        """Dims 0/1 are the in-pixel offsets (halton.cpp:118-124)."""
        return (self.dim(px, py, sample_idx, 0, ctx),
                self.dim(px, py, sample_idx, 1, ctx))


def halton_tables(spp: int, res_x: int, res_y: int,
                  sample_at_center: bool = False,
                  sample_bounds=None) -> dict:
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
    )


def halton_from_tables(tab: dict, device) -> HaltonSampler:
    return HaltonSampler(**dict(tab, offsets=torch.tensor(
        tab["offsets"], device=device)))

