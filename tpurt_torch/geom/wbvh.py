"""Collapse the binary SAH BVH into an 8-wide BVH with fused triangle
leaf bundles, packed as one (M, 128) f32 record table for the device.

Why wide: on this TPU, a random row gather costs the same wall-clock for a
4-byte row as for a 512-byte row (measured: jnp.take is ~13 ns/lane/step
at 2^17 lanes for widths 16..128 f32).  Traversal cost is therefore
step-count-bound, so the tree is collapsed to branching factor 8 with up
to 12 triangles fused per leaf record: each step consumes ONE 512-byte
gather and tests either 8 child boxes or 12 triangles.

Reference analog: accelerators/bvh.cpp:223 flattens to 32-byte binary
LinearBVHNodes for cache-line efficiency on CPUs; the TPU-native analog
optimizes for gather-round count instead.

Record layout (128 f32 per row, both kinds in ONE table):
  interior (slot 126 == 0):
    [0:8]   child bounds lo.x (8 children; absent children = NaN boxes,
            which fail every slab comparison and can never be hit)
    [8:16]  lo.y   [16:24] lo.z
    [24:32] hi.x   [32:40] hi.y   [40:48] hi.z
    [48:56] child row index, bitcast int32
  leaf (slot 126 == 1):
    [0:12]   v0.x of 12 triangles (pads = NaN, never hit)
    [12:24]  v0.y  [24:36] v0.z
    [36:48]  v1.x  [48:60] v1.y  [60:72] v1.z
    [72:84]  v2.x  [84:96] v2.y  [96:108] v2.z
    [108:120] primitive row, bitcast int32 (pads = -1)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpurt_torch.geom.bvh import LinearBVH

import os as _os

# Record geometry.  The default 8-wide/12-leaf/128-slot layout is the
# measured sweet spot; TPURT_BVH_WIDTH=16 selects a 16-wide/24-leaf
# /256-slot layout (1 KB gathered rows) for A/B experiments.
# MEASURED (round 2, killeroo 2^17 shuffled lanes, one v5e chip):
#   width 8 : closest 67.3 ms (1.95 Mrays/s), any-hit 37.9 ms
#   width 16: closest 72.8 ms (1.80 Mrays/s), any-hit 44.7 ms
# 1 KB rows do NOT stay flat in gather cost; fewer steps did not pay for
# the wider row.  8-wide stays the default.
WIDTH = int(_os.environ.get("TPURT_BVH_WIDTH", "8"))
LEAF_K = {8: 12, 16: 24}[WIDTH]   # triangles per leaf bundle
REC = {8: 128, 16: 256}[WIDTH]    # f32 slots per record

SLOT_KIND = REC - 2


def _collapse_tree(bvh: LinearBVH, leaf_k: int):
    """Collapse a binary BVH (1-prim leaves, prims in leaf order) into
    WIDTH-ary rows.  Returns (rows, max_depth) where rows[i] is either
    ('leaf', first_prim, count) or ('interior', [bin node ids], [row ids]).
    Shared by the triangle and curve table builders."""
    m = bvh.n_nodes
    n_prims = bvh.n_prims
    right = bvh.right_child
    is_leaf = n_prims > 0

    cnt = np.zeros(m, np.int64)
    first = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        if is_leaf[i]:
            cnt[i] = n_prims[i]
            first[i] = bvh.prim_offset[i]
        else:
            cnt[i] = cnt[i + 1] + cnt[right[i]]
            first[i] = first[i + 1]

    rows: list = []

    def alloc() -> int:
        rows.append(None)
        return len(rows) - 1

    max_depth = 0
    stack = [(0, alloc(), 0)]
    while stack:
        b, row, d = stack.pop()
        max_depth = max(max_depth, d)
        if cnt[b] <= leaf_k or is_leaf[b]:
            rows[row] = ("leaf", int(first[b]), int(cnt[b]))
            continue
        children = [b + 1, int(right[b])]
        while len(children) < WIDTH:
            cand = [c for c in children if not is_leaf[c] and cnt[c] > leaf_k]
            if not cand:
                break
            c = max(cand, key=lambda x: cnt[x])
            children.remove(c)
            children.extend([c + 1, int(right[c])])
        child_rows = [alloc() for _ in children]
        rows[row] = ("interior", children, child_rows)
        for c, cr in zip(children, child_rows):
            stack.append((c, cr, d + 1))
    return rows, max_depth


def _pack_interior(rec: np.ndarray, bvh: LinearBVH, children, child_rows):
    lo = np.full((3, WIDTH), np.nan, np.float32)
    hi = np.full((3, WIDTH), np.nan, np.float32)
    cref = np.zeros(WIDTH, np.int32)
    for k, (c, cr) in enumerate(zip(children, child_rows)):
        lo[:, k] = bvh.bounds_lo[c]
        hi[:, k] = bvh.bounds_hi[c]
        cref[k] = cr
    rec[0:3 * WIDTH] = lo.reshape(-1)
    rec[3 * WIDTH:6 * WIDTH] = hi.reshape(-1)
    rec[6 * WIDTH:7 * WIDTH] = cref.view(np.float32)
    rec[SLOT_KIND] = 0.0


def build_curve_table(bvh: LinearBVH, cp: np.ndarray, w: np.ndarray,
                      aux: np.ndarray, prim_base: int, ribbons: bool
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack the curve-span BVH into the wide record table.

    Leaf record (WIDTH curve spans fused; W = WIDTH, K = 12 cp coords):
      [0:12W]     control points, coordinate-major SoA: slot c*W + k is
                  coordinate c (point i*3+axis) of span k; pads NaN
      [12W:13W]   span-start width   [13W:14W] span-end width
      [14W:15W]   absolute prim row, bitcast int32 (pads -1)
      [SLOT_KIND] 1.0
    Interior records share the triangle-table layout, so the device
    traversal reuses the same box test and stack machinery.  For ribbon
    scenes a parallel aux table holds per-leaf-slot [n0(3W) n1(3W)
    angle(W) invSin(W)] for the width-projection test (curve.cpp:313-321).

    Returns (table, aux_table_or_None, depth)."""
    rows, max_depth = _collapse_tree(bvh, WIDTH)
    mw = len(rows)
    cap = 64
    while cap < mw:
        cap *= 2
    tab = np.zeros((cap, REC), np.float32)
    tab[:, 0:6 * WIDTH] = np.nan
    aux_tab = np.zeros((cap, 8 * WIDTH), np.float32) if ribbons else None

    cp = cp.reshape(len(cp), 12)
    for row, r in enumerate(rows):
        rec = np.zeros(REC, np.float32)
        if r[0] == "leaf":
            _, lo, n = r
            n = min(n, WIDTH)
            cps = np.full((12, WIDTH), np.nan, np.float32)
            w0 = np.zeros(WIDTH, np.float32)
            w1 = np.zeros(WIDTH, np.float32)
            prim = np.full(WIDTH, -1, np.int32)
            sl = slice(lo, lo + n)
            cps[:, :n] = cp[sl].T
            w0[:n] = w[sl, 0]
            w1[:n] = w[sl, 1]
            prim[:n] = np.arange(prim_base + lo, prim_base + lo + n,
                                 dtype=np.int32)
            rec[0:12 * WIDTH] = cps.reshape(-1)
            rec[12 * WIDTH:13 * WIDTH] = w0
            rec[13 * WIDTH:14 * WIDTH] = w1
            rec[14 * WIDTH:15 * WIDTH] = prim.view(np.float32)
            rec[SLOT_KIND] = 1.0
            if ribbons:
                a = np.zeros((8, WIDTH), np.float32)
                a[0:6, :n] = aux[sl, 0:6].T
                a[6, :n] = aux[sl, 6]
                a[7, :n] = aux[sl, 7]
                aux_tab[row] = a.reshape(-1)
        else:
            _, children, child_rows = r
            _pack_interior(rec, bvh, children, child_rows)
        tab[row] = rec
    return tab, aux_tab, max_depth + 1


def build_wide_table(bvh: LinearBVH, tri_v0: np.ndarray, tri_v1: np.ndarray,
                     tri_v2: np.ndarray, tri_e0: np.ndarray = None,
                     tri_e1: np.ndarray = None, tri_e2: np.ndarray = None
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Collapse ``bvh`` (binary, 1-prim leaves over triangles already in
    leaf order) into the packed wide table.

    Returns (table (M, 128) f32 padded to a power-of-two row count,
    delta_table_or_None, max wide-tree depth) — the depth sizes the
    device traversal stack.  When end-transform verts are given (motion
    blur), delta_table mirrors the leaf layout with per-slot vertex
    DELTAS (end - start; pads 0): the traversal lerps leaf verts by the
    ray's time with one extra gather, while interior boxes — built over
    motion-union bounds by the caller — need no delta.
    """
    motion = tri_e0 is not None
    # Subtree prim counts/offsets and the WIDTH-ary collapse are shared
    # with the curve table builder (_collapse_tree).
    rows, max_depth = _collapse_tree(bvh, LEAF_K)
    mw = len(rows)
    cap = 64
    while cap < mw:
        cap *= 2
    tab = np.zeros((cap, REC), np.float32)
    tab_delta = np.zeros((cap, REC), np.float32) if motion else None
    # Unreferenced pad rows and missing children use NaN boxes: every
    # slab-test comparison on NaN is false, so they can never be hit
    # (+/-inf boxes would false-hit rays whose direction is negative on
    # all axes: min/max slab arithmetic yields t_near=-inf, t_far=+inf).
    tab[:, 0:6 * WIDTH] = np.nan

    for row, r in enumerate(rows):
        if r[0] == "leaf":
            _, lo, n = r
            n = min(n, LEAF_K)
            rec = np.zeros(REC, np.float32)
            verts = np.full((9, LEAF_K), np.nan, np.float32)
            prim = np.full(LEAF_K, -1, np.int32)
            sl = slice(lo, lo + n)
            verts[0, :n], verts[1, :n], verts[2, :n] = tri_v0[sl].T
            verts[3, :n], verts[4, :n], verts[5, :n] = tri_v1[sl].T
            verts[6, :n], verts[7, :n], verts[8, :n] = tri_v2[sl].T
            prim[:n] = np.arange(lo, lo + n, dtype=np.int32)
            rec[0:9 * LEAF_K] = verts.reshape(-1)
            rec[9 * LEAF_K:10 * LEAF_K] = prim.view(np.float32)
            rec[SLOT_KIND] = 1.0
            tab[row] = rec
            if motion:
                dv = np.zeros((9, LEAF_K), np.float32)
                dv[0, :n], dv[1, :n], dv[2, :n] = (tri_e0[sl] - tri_v0[sl]).T
                dv[3, :n], dv[4, :n], dv[5, :n] = (tri_e1[sl] - tri_v1[sl]).T
                dv[6, :n], dv[7, :n], dv[8, :n] = (tri_e2[sl] - tri_v2[sl]).T
                tab_delta[row, 0:9 * LEAF_K] = dv.reshape(-1)
        else:
            _, children, child_rows = r
            rec = np.zeros(REC, np.float32)
            _pack_interior(rec, bvh, children, child_rows)
            tab[row] = rec
    return tab, tab_delta, max_depth + 1
