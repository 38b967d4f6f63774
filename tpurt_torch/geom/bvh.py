"""Host-side SAH BVH build, flattened to SoA arrays for device traversal.

Reference analog: accelerators/bvh.{h,cpp} — BVHPrimitiveInfo (:50),
recursive SAH build with 12 buckets (:236-402), depth-first flattening to
LinearBVHNode (:95-107, :223) with the first child adjacent to its parent
and the second child referenced by offset; maxPrimsInNode default 4
(CreateBVHAccelerator :758).

The build stays on host (numpy; optional C++ fast path in tpurt.native) —
it is pre-render work.  Traversal runs on device over these arrays
(tpurt.render.intersect / tpurt.kernels).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_SAH_BUCKETS = 12
_TRAVERSAL_COST_RATIO = 8.0  # pbrt: leaf cost 1 per prim, traversal cost 1/8th


@dataclasses.dataclass
class LinearBVH:
    """Flattened BVH in structure-of-arrays form.

    nodes are in depth-first order; for interior nodes child0 = node + 1 and
    child1 = ``right_child``; ``n_prims`` == 0 marks interior nodes.  Leaf
    nodes reference ``prim_order[prim_offset : prim_offset + n_prims]``.
    """

    bounds_lo: np.ndarray  # (M, 3) f32
    bounds_hi: np.ndarray  # (M, 3) f32
    right_child: np.ndarray  # (M,) i32 — second child for interior, 0 for leaf
    prim_offset: np.ndarray  # (M,) i32 — first prim for leaf, 0 for interior
    n_prims: np.ndarray  # (M,) i32 — 0 for interior
    axis: np.ndarray  # (M,) i32 — split axis for interior
    prim_order: np.ndarray  # (P,) i32 — primitive permutation

    @property
    def n_nodes(self) -> int:
        return len(self.right_child)

    def max_depth(self) -> int:
        """Actual tree depth (for sizing traversal stacks)."""
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        maxd = 0
        for i in range(self.n_nodes):
            d = depth[i]
            maxd = max(maxd, int(d))
            if self.n_prims[i] == 0:
                depth[i + 1] = d + 1
                depth[self.right_child[i]] = d + 1
        return maxd + 1


def build_bvh(bounds_lo: np.ndarray, bounds_hi: np.ndarray,
              max_prims_per_leaf: int = 4, split_method: str = "sah",
              use_native: bool = True) -> LinearBVH:
    """Build from per-primitive world bounds.  Returns the flattened tree.

    Uses the C++ builder (tpurt.native, ~50x faster on large meshes) when
    available; the numpy path below is the reference implementation."""
    n = len(bounds_lo)
    if use_native and split_method == "sah" and n > 0:
        from tpurt_torch.native import build_bvh_native

        nat = build_bvh_native(np.asarray(bounds_lo, np.float32),
                               np.asarray(bounds_hi, np.float32),
                               max_prims_per_leaf)
        if nat is not None:
            nb_lo, nb_hi, right, prim_off, n_prims, axis, order = nat
            return LinearBVH(bounds_lo=nb_lo, bounds_hi=nb_hi,
                             right_child=right, prim_offset=prim_off,
                             n_prims=n_prims, axis=axis, prim_order=order)
    if n == 0:
        return LinearBVH(
            bounds_lo=np.zeros((1, 3), np.float32),
            bounds_hi=np.full((1, 3), -np.inf, np.float32),
            right_child=np.zeros(1, np.int32),
            prim_offset=np.zeros(1, np.int32),
            n_prims=np.zeros(1, np.int32),
            axis=np.zeros(1, np.int32),
            prim_order=np.zeros(0, np.int32),
        )
    lo = np.asarray(bounds_lo, dtype=np.float64)
    hi = np.asarray(bounds_hi, dtype=np.float64)
    centroids = 0.5 * (lo + hi)

    # Node storage grows geometrically; 2n is the upper bound for a binary
    # tree over n leaves of >=1 prim.
    cap = max(2 * n, 8)
    nb_lo = np.empty((cap, 3), np.float64)
    nb_hi = np.empty((cap, 3), np.float64)
    n_right = np.zeros(cap, np.int32)
    n_poff = np.zeros(cap, np.int32)
    n_np = np.zeros(cap, np.int32)
    n_axis = np.zeros(cap, np.int32)
    order: list = []
    next_node = [0]

    def alloc() -> int:
        i = next_node[0]
        next_node[0] += 1
        return i

    # Iterative recursion (explicit stack) to survive deep trees.
    # Each entry: (node_idx, prim_indices) with the node pre-allocated so
    # depth-first order is preserved: we allocate a node, then fully build
    # its left subtree before its right (pbrt's flattenBVHTree layout).
    def build_range(prims: np.ndarray) -> int:
        node = alloc()
        b_lo = lo[prims].min(axis=0)
        b_hi = hi[prims].max(axis=0)
        nb_lo[node], nb_hi[node] = b_lo, b_hi

        def make_leaf():
            n_poff[node] = len(order_flat)
            n_np[node] = len(prims)
            order_flat.extend(prims.tolist())

        if len(prims) == 1:
            make_leaf()
            return node
        c = centroids[prims]
        c_lo, c_hi = c.min(axis=0), c.max(axis=0)
        dim = int(np.argmax(c_hi - c_lo))
        if c_hi[dim] == c_lo[dim]:
            if len(prims) <= max_prims_per_leaf:
                make_leaf()
                return node
            # degenerate (coincident centroids) but the leaf cap forces a
            # split: halve arbitrarily — both children share the bounds
            mid = len(prims) // 2
            n_axis[node] = dim
            n_np[node] = 0
            build_range(prims[:mid])
            n_right[node] = build_range(prims[mid:])
            return node

        if split_method == "middle":
            mid_val = 0.5 * (c_lo[dim] + c_hi[dim])
            mask = c[:, dim] < mid_val
            if not mask.any() or mask.all():
                mask = np.argsort(c[:, dim]) < len(prims) // 2
        elif split_method == "equal":
            mask = np.argsort(np.argsort(c[:, dim])) < len(prims) // 2
        else:  # SAH with 12 buckets
            if len(prims) <= 2:
                mask = np.argsort(np.argsort(c[:, dim])) < len(prims) // 2
            else:
                scaled = (c[:, dim] - c_lo[dim]) / (c_hi[dim] - c_lo[dim])
                b = np.minimum((_SAH_BUCKETS * scaled).astype(np.int32),
                               _SAH_BUCKETS - 1)
                # per-bucket counts and bounds
                counts = np.bincount(b, minlength=_SAH_BUCKETS)
                blo = np.full((_SAH_BUCKETS, 3), np.inf)
                bhi = np.full((_SAH_BUCKETS, 3), -np.inf)
                for k in range(3):
                    np.minimum.at(blo[:, k], b, lo[prims][:, k])
                    np.maximum.at(bhi[:, k], b, hi[prims][:, k])
                # prefix/suffix sweep for SAH cost of the 11 candidate splits
                def area(l, h):
                    d = np.maximum(h - l, 0)
                    return 2 * (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2]
                                + d[:, 1] * d[:, 2])

                pre_lo = np.minimum.accumulate(blo, axis=0)
                pre_hi = np.maximum.accumulate(bhi, axis=0)
                suf_lo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
                suf_hi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
                cnt_pre = np.cumsum(counts)
                cnt_suf = np.cumsum(counts[::-1])[::-1]
                costs = (
                    1.0 / _TRAVERSAL_COST_RATIO
                    + (cnt_pre[:-1] * area(pre_lo[:-1], pre_hi[:-1])
                       + cnt_suf[1:] * area(suf_lo[1:], suf_hi[1:]))
                    / max(area(b_lo[None], b_hi[None])[0], 1e-30)
                )
                best = int(np.argmin(costs))
                leaf_cost = float(len(prims))
                if len(prims) > max_prims_per_leaf or costs[best] < leaf_cost:
                    mask = b <= best
                else:
                    make_leaf()
                    return node

        left = prims[mask]
        right = prims[~mask]
        if len(left) == 0 or len(right) == 0:  # degenerate; force median
            mask = np.argsort(np.argsort(c[:, dim])) < len(prims) // 2
            left, right = prims[mask], prims[~mask]
        n_axis[node] = dim
        n_np[node] = 0
        build_range(left)
        n_right[node] = build_range(right)
        return node

    order_flat: list = []
    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * int(np.log2(n + 1)) * 64))
    try:
        build_range(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)

    m = next_node[0]
    return LinearBVH(
        bounds_lo=nb_lo[:m].astype(np.float32),
        bounds_hi=nb_hi[:m].astype(np.float32),
        right_child=n_right[:m].copy(),
        prim_offset=n_poff[:m].copy(),
        n_prims=n_np[:m].copy(),
        axis=n_axis[:m].copy(),
        prim_order=np.asarray(order_flat, dtype=np.int32),
    )
