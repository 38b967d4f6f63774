"""Sobol' sequence: generator matrices + the pixel -> global-index solve.

Reference analog: core/lowdiscrepancy.{h,cpp} (SobolSample,
SobolIntervalToIndex) + core/sobolmatrices.cpp and samplers/sobol.cpp.
The reference ships 27 kLoC of pregenerated tables (NumSobolDimensions =
1024, 52-bit matrices, plus VdCSobolMatrices/Inv for the interval-to-index
solve).  This module ships the published Joe-Kuo direction numbers as a
32 KB npy (sampling/data/, truncated to the 256 dims x 32 index bits the
samplers consume) and computes the rest when a sampler is built:

* The SobolIntervalToIndex pixel->global-index mapping is obtained by
  directly inverting the GF(2) linear system "low 2m index bits -> top m
  output bits of dims 0/1" per film resolution, replacing the reference's
  pregenerated VdCSobolMatrices.
* The MaxMinDist generator matrices come from a deterministic search,
  cached under config.BUILD_DIR.

The port's own copy of what it calls in tpurt/sampling/sobol.py; tpurt's
other sources of direction numbers (extraction from a reference source
tree, a self-generated construction for table shapes the package does not
ship) are not carried over: the packaged table is the only source.
"""

from __future__ import annotations

import os

import numpy as np


def _cache_dir() -> str:
    from tpurt_torch.config import BUILD_DIR

    return str(BUILD_DIR)

N_DIMS = 256
N_BITS = 32

_PACKAGED_TABLE = os.path.join(os.path.dirname(__file__), "data",
                               f"sobol_matrices_{N_DIMS}x{N_BITS}.npy")


def get_sobol_matrices() -> np.ndarray:
    """(N_DIMS, N_BITS) uint32 direction vectors, MSB-aligned: sample =
    XOR of matrices[dim][k] over set bits k of the index, / 2^32.  The
    packaged Joe-Kuo table (the published new-joe-kuo-6 direction numbers,
    so per-sample Sobol' parity with pbrt-v3 holds)."""
    return np.load(_PACKAGED_TABLE)


# ---------------------------------------------------------------------------
# pixel -> global index (SobolIntervalToIndex analog)
# ---------------------------------------------------------------------------

def build_interval_to_index(m: int, mats: np.ndarray):
    """For a 2^m x 2^m pixel tiling, the global Sobol' index of the
    frame-th sample landing in pixel (px, py) is

        i = (frame << 2m) | L,   L = INV @ (y XOR FMAP @ frame_bits)

    over GF(2), where y = [bits of px, bits of py] are the top-m output
    bits of dims 0/1.  Returns (inv_cols, fmap_cols): uint32 column
    tables s.t. L = xor of inv_cols[b] over set bits b of t, with
    t = y ^ xor of fmap_cols[b] over set bits of frame.

    Replaces VdCSobolMatrices/Inv (sobolmatrices.cpp) with a direct
    GF(2) inversion at build time."""
    if m == 0:
        return (np.zeros(1, np.uint32), np.zeros(max(1, N_BITS), np.uint32))
    lm = 2 * m
    # y bits: for pixel px = floor(out0 * 2^m): bit j of px (MSB-first
    # weight) is output bit 31-j ... define y = [px bits m-1..0, py bits
    # m-1..0] with px bit q = output0 bit (32 - m + q).
    def out_bits(dim, idx_bit):
        col = int(mats[dim, idx_bit])
        return [(col >> (32 - m + q)) & 1 for q in range(m)]

    # A_L: lm x lm, columns = index low bits
    a_l = np.zeros((lm, lm), np.uint8)
    for b in range(lm):
        a_l[0:m, b] = out_bits(0, b)
        a_l[m:lm, b] = out_bits(1, b)
    # invert over GF(2)
    aug = np.concatenate([a_l, np.eye(lm, dtype=np.uint8)], axis=1)
    for col in range(lm):
        piv = None
        for r in range(col, lm):
            if aug[r, col]:
                piv = r
                break
        if piv is None:
            raise ValueError("Sobol interval matrix is singular")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        for r in range(lm):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    inv = aug[:, lm:]
    # pack: inv_cols[b] = integer whose bit j is inv[j, b] (L bit j)
    inv_cols = np.zeros(lm, np.uint32)
    for b in range(lm):
        val = 0
        for j in range(lm):
            if inv[j, b]:
                val |= 1 << j
        inv_cols[b] = val
    # frame map: index bit (2m + b) contributes out bits -> y bits
    n_f = N_BITS - lm
    fmap_cols = np.zeros(max(1, n_f), np.uint32)
    for b in range(n_f):
        y0 = out_bits(0, lm + b)
        y1 = out_bits(1, lm + b)
        val = 0
        for q in range(m):
            if y0[q]:
                val |= 1 << q
            if y1[q]:
                val |= 1 << (m + q)
        fmap_cols[b] = val
    return inv_cols, fmap_cols


def _gf2_invertible(cols: np.ndarray, k: int) -> bool:
    rows = list(cols.astype(np.uint64))
    rank = 0
    for bit in range(k):
        piv = None
        for i in range(rank, len(rows)):
            if (rows[i] >> bit) & 1:
                piv = i
                break
        if piv is None:
            continue
        rows[rank], rows[piv] = rows[piv], rows[rank]
        for i in range(len(rows)):
            if i != rank and (rows[i] >> bit) & 1:
                rows[i] ^= rows[rank]
        rank += 1
    return rank == k


def maxmin_dist_matrix(k: int) -> np.ndarray:
    """Generator matrix (k uint32 columns, MSB-aligned) for the pixel
    dimension of the MaxMinDist sampler: the 2^k points (i/n, C.i) should
    maximize toroidal minimum distance.

    Reference analog: the 17 pregenerated CMaxMinDist matrices
    (lowdiscrepancy.cpp, samplers/maxmin.cpp:42).  Rather than copying the
    table, a deterministic random search over invertible GF(2) matrices is
    run once per k and cached; the resulting minimum distance is close to
    (not always equal to) the published optima — documented deviation."""
    cache_dir = _cache_dir()
    path = os.path.join(cache_dir, f"maxmin_c_v1_{k}.npy")
    if os.path.exists(path):
        return np.load(path)
    n = 1 << k
    rng = np.random.default_rng(k * 7919 + 13)
    i_arr = np.arange(n)
    xs = i_arr.astype(np.float64) / n
    best, best_d = None, -1.0
    iters = int(max(128, min(4000, 400000 // max(n, 1))))
    for _ in range(iters):
        cols = rng.integers(1, 1 << k, size=k, dtype=np.uint32)
        if not _gf2_invertible(cols, k):
            continue
        ys = np.zeros(n, np.uint32)
        for c in range(k):
            ys ^= np.where((i_arr >> c) & 1, cols[c], 0).astype(np.uint32)
        ysf = ys.astype(np.float64) / n
        dx = np.abs(xs[:, None] - xs[None, :])
        dx = np.minimum(dx, 1.0 - dx)
        dy = np.abs(ysf[:, None] - ysf[None, :])
        dy = np.minimum(dy, 1.0 - dy)
        d2 = dx * dx + dy * dy
        np.fill_diagonal(d2, 9.0)
        md = float(d2.min())
        if md > best_d:
            best_d, best = md, cols
    out = (best.astype(np.uint64) << np.uint64(32 - k)).astype(np.uint32)
    os.makedirs(cache_dir, exist_ok=True)
    np.save(path, out)
    return out
