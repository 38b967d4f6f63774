"""SAH kd-tree accelerator: host build + packed device table (the port's
copy of tpurt/geom/kdtree.py; only import paths changed).

Reference analog: accelerators/kdtreeaccel.cpp:44-349 — per-axis
edge-event SAH sweep (isectCost 80, traversalCost 1, emptyBonus 0.5),
bad-refine retries, prims duplicated across the leaves they straddle.
The build runs in the native helper (csrc/tpurt_native.cpp, ~100x the
Python fallback below) and packs to the SAME (M, REC) f32 record table
the wide BVH uses, so the device traversal shares the fused-triangle
leaf test:

  interior (slot REC-2 == 0):
    [REC-8] split position        [REC-7] axis, bitcast int32
    [REC-6] below row, bitcast    [REC-5] above row, bitcast
  leaf (slot REC-2 == 1): identical to the BVH leaf layout
    (wbvh.build_wide_table: LEAF_K fused triangles + prim rows), plus
    [REC-4] continuation row, bitcast int32 (-1 = end) — kd leaves
    can exceed LEAF_K prims at the depth cap, so oversized leaves
    chain across rows and the traversal walks the chain before popping.

TPU-first deviations (vs kdtreeaccel.h's 8-byte nodes): rows are
gather-cost-flat up to 512 B on the TPU, so leaves inline whole
triangle bundles like the BVH table, and maxPrims defaults to LEAF_K
(12) instead of 1 — the reference's 1-prim leaves would make every
traversal step a near-empty gather.  Scene files can still force
"integer maxprims" via the Accelerator directive.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tpurt_torch.geom.wbvh import LEAF_K, REC, SLOT_KIND

SLOT_SPLIT = REC - 8
SLOT_AXIS = REC - 7
SLOT_BELOW = REC - 6
SLOT_ABOVE = REC - 5
SLOT_CONT = REC - 4


def _build_python(lo, hi, isect_cost, trav_cost, empty_bonus, max_prims,
                  max_depth):
    """Pure-Python mirror of the native builder (same splits, ~100x
    slower); keeps kd-tree scenes working without a toolchain."""
    n = len(lo)
    split_l, axis_l, above_l, off_l, cnt_l = [], [], [], [], []
    indices: list = []

    def make_leaf(prims):
        node = len(split_l)
        split_l.append(0.0)
        axis_l.append(3)
        above_l.append(-1)
        off_l.append(len(indices))
        cnt_l.append(len(prims))
        indices.extend(int(p) for p in prims)
        return node

    def build(bounds, prims, depth, bad_refines):
        if len(prims) <= max_prims or depth == 0:
            return make_leaf(prims)
        d = bounds[1] - bounds[0]
        best_axis, best_edge, best_cost = -1, -1, np.inf
        old_cost = isect_cost * len(prims)
        inv_sa = 1.0 / max(2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]),
                           1e-300)
        edges_kept = None
        for retry in range(3):
            ax = (int(np.argmax(d)) + retry) % 3
            # events sorted by (t, start-before-end on ties)
            t = np.concatenate([lo[prims, ax], hi[prims, ax]])
            is_start = np.concatenate([np.ones(len(prims), bool),
                                       np.zeros(len(prims), bool)])
            ev_prim = np.concatenate([prims, prims])
            order = np.lexsort((~is_start, t))
            t, is_start, ev_prim = t[order], is_start[order], ev_prim[order]
            n_above = len(prims) - np.cumsum(~is_start)
            n_below = np.concatenate([[0], np.cumsum(is_start)[:-1]])
            o1, o2 = (ax + 1) % 3, (ax + 2) % 3
            in_range = (t > bounds[0, ax]) & (t < bounds[1, ax])
            bsa = 2.0 * (d[o1] * d[o2] + (t - bounds[0, ax]) * (d[o1] + d[o2]))
            asa = 2.0 * (d[o1] * d[o2] + (bounds[1, ax] - t) * (d[o1] + d[o2]))
            eb = np.where((n_above == 0) | (n_below == 0), empty_bonus, 0.0)
            cost = trav_cost + isect_cost * (1.0 - eb) * (
                bsa * inv_sa * n_below + asa * inv_sa * n_above)
            cost = np.where(in_range, cost, np.inf)
            i = int(np.argmin(cost))
            if np.isfinite(cost[i]):
                best_axis, best_edge, best_cost = ax, i, float(cost[i])
                edges_kept = (t, is_start, ev_prim)
                break
        if best_cost > old_cost:
            bad_refines += 1
        if ((best_cost > 4 * old_cost and len(prims) < 16)
                or best_axis == -1 or bad_refines == 3):
            return make_leaf(prims)
        t, is_start, ev_prim = edges_kept
        below = ev_prim[:best_edge][is_start[:best_edge]]
        above = ev_prim[best_edge + 1:][~is_start[best_edge + 1:]]
        tsplit = float(t[best_edge])
        node = len(split_l)
        split_l.append(tsplit)
        axis_l.append(best_axis)
        above_l.append(-1)
        off_l.append(0)
        cnt_l.append(0)
        b0, b1 = bounds.copy(), bounds.copy()
        b0[1, best_axis] = tsplit
        b1[0, best_axis] = tsplit
        build(b0, below, depth - 1, bad_refines)
        above_l[node] = build(b1, above, depth - 1, bad_refines)
        return node

    bounds = np.stack([lo.min(0), hi.max(0)]).astype(np.float64)
    build(bounds, np.arange(n), max_depth, 0)
    return (np.asarray(split_l, np.float32), np.asarray(axis_l, np.int32),
            np.asarray(above_l, np.int32), np.asarray(off_l, np.int32),
            np.asarray(cnt_l, np.int32), np.asarray(indices, np.int32),
            bounds.astype(np.float32))


def build_kd_table(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                   e0=None, e1=None, e2=None,
                   isect_cost: int = 80, trav_cost: int = 1,
                   empty_bonus: float = 0.5, max_prims: Optional[int] = None,
                   max_depth: int = -1
                   ) -> Tuple[np.ndarray, Optional[np.ndarray],
                              np.ndarray, int]:
    """Build the kd-tree over triangles (already in final prim order —
    kd leaves reference absolute rows, so no reordering happens here,
    unlike the BVH whose leaf order IS the prim order) and pack the
    device table.  With end-transform verts (motion blur) the tree is
    built over union bounds and a delta table mirrors the leaf layout.

    Returns (table, delta_table_or_None, scene_bounds (2,3) f32,
    max stack depth for the device traversal)."""
    from tpurt_torch.native import build_kdtree_native

    n = len(v0)
    if max_prims is None:
        max_prims = LEAF_K
    if max_depth <= 0:
        max_depth = int(round(8 + 1.3 * np.log2(max(n, 2))))
    motion = e0 is not None
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    if motion:
        lo = np.minimum(lo, np.minimum(np.minimum(e0, e1), e2))
        hi = np.maximum(hi, np.maximum(np.maximum(e0, e1), e2))
    # NaN pad rows (curve-free degenerate placeholder) get empty bounds
    bad = ~np.isfinite(lo).all(1) | ~np.isfinite(hi).all(1)
    lo = np.where(bad[:, None], np.float32(np.inf), lo).astype(np.float32)
    hi = np.where(bad[:, None], np.float32(-np.inf), hi).astype(np.float32)
    lo = np.nextafter(lo, -np.inf).astype(np.float32)
    hi = np.nextafter(hi, np.inf).astype(np.float32)

    out = build_kdtree_native(lo, hi, isect_cost, trav_cost, empty_bonus,
                              int(max_prims), int(max_depth))
    if out is None:
        out = _build_python(lo.astype(np.float64), hi.astype(np.float64),
                            isect_cost, trav_cost, empty_bonus,
                            int(max_prims), int(max_depth))
    split, axis, above, prim_off, n_prims, indices, bounds = out

    m = len(split)
    is_leaf = axis == 3
    # row layout: node i occupies rows row0[i] .. row0[i]+nrows[i]-1
    # (leaf chains are contiguous); interiors are single rows
    nrows = np.where(is_leaf, np.maximum((n_prims + LEAF_K - 1) // LEAF_K, 1),
                     1).astype(np.int64)
    row0 = np.concatenate([[0], np.cumsum(nrows)[:-1]])
    total = int(nrows.sum())
    cap = 64
    while cap < total:
        cap *= 2
    tab = np.zeros((cap, REC), np.float32)
    tab_delta = np.zeros((cap, REC), np.float32) if motion else None
    tab[:, 0:9 * LEAF_K] = np.nan  # pad rows / pad slots never hit
    tab[:, SLOT_CONT] = np.float32(np.int32(-1).view(np.float32))
    tab[:, SLOT_KIND] = 1.0  # pad rows parse as empty leaves

    dv0 = dv1 = dv2 = None
    if motion:
        dv0, dv1, dv2 = e0 - v0, e1 - v1, e2 - v2

    for i in range(m):
        r = int(row0[i])
        if not is_leaf[i]:
            rec = np.zeros(REC, np.float32)
            rec[0:9 * LEAF_K] = np.nan
            rec[SLOT_SPLIT] = split[i]
            rec[SLOT_AXIS] = np.int32(axis[i]).view(np.float32)
            rec[SLOT_BELOW] = np.int32(row0[i + 1]).view(np.float32)
            rec[SLOT_ABOVE] = np.int32(row0[above[i]]).view(np.float32)
            rec[SLOT_CONT] = np.int32(-1).view(np.float32)
            rec[SLOT_KIND] = 0.0
            tab[r] = rec
            continue
        prims = indices[prim_off[i]:prim_off[i] + n_prims[i]]
        nr = int(nrows[i])
        for j in range(nr):
            chunk = prims[j * LEAF_K:(j + 1) * LEAF_K]
            k = len(chunk)
            rec = np.zeros(REC, np.float32)
            verts = np.full((9, LEAF_K), np.nan, np.float32)
            prow = np.full(LEAF_K, -1, np.int32)
            if k:
                verts[0, :k], verts[1, :k], verts[2, :k] = v0[chunk].T
                verts[3, :k], verts[4, :k], verts[5, :k] = v1[chunk].T
                verts[6, :k], verts[7, :k], verts[8, :k] = v2[chunk].T
                prow[:k] = chunk
            rec[0:9 * LEAF_K] = verts.reshape(-1)
            rec[9 * LEAF_K:10 * LEAF_K] = prow.view(np.float32)
            rec[SLOT_CONT] = np.int32(r + j + 1 if j + 1 < nr
                                      else -1).view(np.float32)
            rec[SLOT_KIND] = 1.0
            tab[r + j] = rec
            if motion and k:
                dv = np.zeros((9, LEAF_K), np.float32)
                dv[0, :k], dv[1, :k], dv[2, :k] = dv0[chunk].T
                dv[3, :k], dv[4, :k], dv[5, :k] = dv1[chunk].T
                dv[6, :k], dv[7, :k], dv[8, :k] = dv2[chunk].T
                tab_delta[r + j, 0:9 * LEAF_K] = dv.reshape(-1)

    # stack: binary descent pushes at most one entry per level
    return tab, tab_delta, np.asarray(bounds, np.float32), max_depth + 2
