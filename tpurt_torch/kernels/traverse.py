"""Wide-BVH traversal: the CUDA kernel (csrc/traverse.cu), its wrapper and
its plain PyTorch twin.

Replaces tpurt's Pallas kernel ``tpurt/kernels/traverse.py:_kernel``
(reached by ``traverse_closest_pallas``) with the semantics tpurt renders
with, ``_traverse_wide`` (``tpurt/render/intersect.py``): the watertight
leaf test, the ``_BOX_T_SCALE`` far-scale, and an any-hit mode for shadow
rays.  The source note in traverse.cu says what bounds the kernel on
Hopper and what its design does about it.

``traverse_wide`` is the entry point.  On a CPU tensor it runs
``traverse_wide_reference``, the lockstep twin of ``_wide_step_fns``; on a
CUDA tensor it launches the kernel or raises.  The kernel library is built
by ``kernels.build`` (nvcc, from the sources in this checkout, at first
use, into ``build/tpurt_torch/``) and bound with ctypes.  The twin reads
the host record table ``geo.wnodes``; the kernel reads the tables derived
from it at upload (``geo.inodes``, ``geo.leaves``, ``geo.root_ref``:
``render.intersect.derive_traversal_tables``).

The walk has three leaf bodies, each its own instantiation of the kernel
(``LEAF_KINDS``): K1, static triangles; K1m, triangles lerped to each
ray's time by the per-leaf delta rows (``time`` and ``geo.leaves_delta``;
tpurt's ``_tri_bundle_test(drec, time)``), behind a cull of each group of
4 triangles by its box at the ray's time (``geo.leaves_box``; plain copy
``render.intersect.motion_group_cull``); K1c, the curve-span tree
(``tree="curve"``: ``geo.cinodes``, ``geo.cleaves``, ribbons from
``geo.cleaves_aux``; tpurt's ``_curve_bundle_test``).  A frame without
motion or curves launches only K1.

Under ``Accelerator "kdtree"`` (``geo.accel``) the triangle rays walk the
kd-tree instead (tpurt's ``_kd_step_fns`` / ``_kd_init_state``,
intersect.py:1038-1162): K1k over static triangles, K1km with the motion
delta rows, both instantiations of the kd walk in traverse.cu, which
shares K1's scheduler and leaf test and reads the kd tables derived at
upload (``render.intersect.derive_kd_tables``: ``geo.kinodes``,
``geo.kleaves``); ``traverse_kd_reference`` is their plain twin, over the
record table ``geo.knodes``.  Curves keep K1c.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpurt_torch.geom.wbvh import LEAF_K, REC, SLOT_KIND, WIDTH
from tpurt_torch.kernels import build
from tpurt_torch.render.intersect import (
    _BOX_T_SCALE, CHILD_LO, CURVE_AUX, CURVE_PRIM_LO, GROUP_BOX, GROUPS, INF,
    INTERIOR_REC, MOTION_BOX, PRIM_LO, SORT8, _box8_test, _curve_bundle_test,
    _tri_bundle_test, curve_span_cull, motion_group_boxes, motion_group_cull,
    safe_inv_dir)

SOURCE = "traverse.cu"
# IEEE rounding of every op, in the twin's order: no FMA contraction
EXTRA_FLAGS = ("-fmad=false",)
# must equal TPURT_STACK_MAX in traverse.cu: the largest stack depth
# DeviceGeometry.host_tables produces (the 192 cap rounded up to a power
# of two)
STACK_MAX = 256
# the leaf bodies, by the code the C entry takes (TPURT_LEAF_* in
# traverse.cu) and the name chip_smoke.py reports; "kd" and "kd_motion"
# are the kd walk's (tpurt_traverse_kd)
LEAF_KINDS = {"tri": (0, "K1"), "motion": (1, "K1m"), "curve": (2, "K1c"),
              "kd": (0, "K1k"), "kd_motion": (1, "K1km")}
# must equal TPURT_KD_STACK_MAX in traverse.cu: the deepest interval stack
# the kd walk holds (tpurt's kstack_depth is the tree's depth cap + 2)
KD_STACK_MAX = 128


@functools.lru_cache(maxsize=None)
def load_library() -> build.KernelLibrary:
    """Build (once per source version) and bind the kernel library."""
    lib = build.load_library(SOURCE, EXTRA_FLAGS)
    _bind(lib.cdll)
    return lib


def _bind(cdll) -> None:
    fn = cdll.tpurt_traverse_wide
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, ci, vp, ci, vp, vp, vp, ci, ci, vp, vp, vp,
                   ci, ci, ci, ctypes.c_float, vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    fn = cdll.tpurt_traverse_kd
    fn.argtypes = [ci, vp, ci, vp, ci, vp, vp, vp, vp, ci, ci, vp, vp, vp,
                   ci, ci, ci, ctypes.c_float, vp, vp, vp, vp, vp, vp]
    fn.restype = ci


def leaf_kind(geo, time, tree: str) -> str:
    """The leaf body a walk runs: "curve" for the curve tree; for the
    triangles "kd" or "kd_motion" under the kd-tree, else "tri" or
    "motion" (an animated mesh with ray times)."""
    if tree == "curve":
        return "curve"
    if tree != "tri":
        raise ValueError(f"tree {tree!r}")
    if geo.accel == "kdtree":
        return ("kd" if time is None or geo.knodes_delta is None
                else "kd_motion")
    return "tri" if time is None or geo.wnodes_delta is None else "motion"


def _launch_kd(geo, o, d, t_max, any_hit: bool, time, kind: str):
    """Check the inputs and launch the kd walk (K1k, or K1km with the
    delta rows and ray times) on the current stream over the tables
    derived at upload (``geo.kinodes``, ``geo.kleaves``); returns (t,
    prim, b0, b1)."""
    n = o.shape[0]
    dev = o.device
    mi, ml = geo.kinodes.shape[0], geo.kleaves.shape[0]
    motion = kind == "kd_motion"
    build.check_tensor("kinodes", geo.kinodes, torch.float32, (mi, 4), dev)
    build.check_tensor("kleaves", geo.kleaves, torch.float32, (ml, REC), dev)
    build.check_tensor("kbounds", geo.kbounds, torch.float32, (2, 3), dev)
    if motion:
        build.check_tensor("kleaves_delta", geo.kleaves_delta, torch.float32,
                           (ml, REC), dev)
        build.check_tensor("kleaves_box", geo.kleaves_box, torch.float32,
                           (ml, MOTION_BOX), dev)
        build.check_tensor("time", time, torch.float32, (n,), dev)
    build.check_tensor("o", o, torch.float32, (n, 3), dev)
    build.check_tensor("d", d, torch.float32, (n, 3), dev)
    build.check_tensor("t_max", t_max, torch.float32, (n,), dev)
    if not 1 <= geo.kstack_depth <= KD_STACK_MAX:
        raise ValueError(f"kd stack depth {geo.kstack_depth} outside the "
                         f"kernel's compiled range 1..{KD_STACK_MAX}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b0 = torch.empty(n, dtype=torch.float32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, b0, b1
    counter = torch.empty(1, dtype=torch.int32, device=dev)  # ray fetch
    with torch.cuda.device(dev):
        err = load_library().cdll.tpurt_traverse_kd(
            LEAF_KINDS[kind][0], geo.kinodes.data_ptr(), mi,
            geo.kleaves.data_ptr(), ml,
            geo.kleaves_delta.data_ptr() if motion else 0,
            geo.kleaves_box.data_ptr() if motion else 0,
            time.data_ptr() if motion else 0, geo.kbounds.data_ptr(),
            geo.kroot_ref, geo.knodes.shape[0], o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), n, geo.kstack_depth, int(bool(any_hit)),
            _BOX_T_SCALE, t.data_ptr(), prim.data_ptr(), b0.data_ptr(),
            b1.data_ptr(), counter.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error(f"traverse_kd_kernel ({LEAF_KINDS[kind][1]})", err)
    return t, prim, b0, b1


def _launch(geo, o, d, t_max, any_hit: bool, time, kind: str):
    """Check the inputs and launch the traversal kernel with the leaf
    body ``kind`` on the current stream; returns (t, prim, b0, b1)."""
    if kind in ("kd", "kd_motion"):
        return _launch_kd(geo, o, d, t_max, any_hit, time, kind)
    n = o.shape[0]
    dev = o.device
    curve = kind == "curve"
    inodes = geo.cinodes if curve else geo.inodes
    leaves = geo.cleaves if curve else geo.leaves
    depth = geo.cstack_depth if curve else geo.wstack_depth
    mi, ml = inodes.shape[0], leaves.shape[0]
    build.check_tensor("inodes", inodes, torch.float32, (mi, INTERIOR_REC),
                       dev)
    build.check_tensor("leaves", leaves, torch.float32, (ml, REC), dev)
    side = None  # per-leaf rows beside `leaves`: deltas or ribbons
    if kind == "motion":
        side = geo.leaves_delta
        build.check_tensor("leaves_delta", side, torch.float32, (ml, REC),
                           dev)
        build.check_tensor("leaves_box", geo.leaves_box, torch.float32,
                           (ml, MOTION_BOX), dev)
        build.check_tensor("time", time, torch.float32, (n,), dev)
    elif curve and geo.cleaves_aux is not None:
        side = geo.cleaves_aux
        build.check_tensor("cleaves_aux", side, torch.float32,
                           (ml, CURVE_AUX), dev)
    build.check_tensor("o", o, torch.float32, (n, 3), dev)
    build.check_tensor("d", d, torch.float32, (n, 3), dev)
    build.check_tensor("t_max", t_max, torch.float32, (n,), dev)
    if not 1 <= depth <= STACK_MAX:
        raise ValueError(f"stack depth {depth} outside the kernel's "
                         f"compiled range 1..{STACK_MAX}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b0 = torch.empty(n, dtype=torch.float32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, b0, b1
    counter = torch.empty(1, dtype=torch.int32, device=dev)  # ray fetch
    nodes = geo.cnodes if curve else geo.wnodes
    with torch.cuda.device(dev):
        err = load_library().cdll.tpurt_traverse_wide(
            LEAF_KINDS[kind][0], inodes.data_ptr(), mi, leaves.data_ptr(),
            ml, 0 if side is None else side.data_ptr(),
            geo.leaves_box.data_ptr() if kind == "motion" else 0,
            time.data_ptr() if kind == "motion" else 0,
            geo.croot_ref if curve else geo.root_ref, nodes.shape[0],
            o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, depth,
            int(bool(any_hit)), _BOX_T_SCALE, t.data_ptr(), prim.data_ptr(),
            b0.data_ptr(), b1.data_ptr(), counter.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error(f"traverse_wide_kernel ({LEAF_KINDS[kind][1]})",
                         err)
    return t, prim, b0, b1


def traverse_wide(geo, o, d, t_max, any_hit: bool, time=None,
                  tree: str = "tri"):
    """Wide-BVH traversal of (N,) rays: returns (t, prim, b0, b1) like
    tpurt's ``_traverse_wide(..., time, tree)``.  o, d: (N, 3) f32;
    t_max: (N,) f32; lanes with t_max <= 0 start dead.  any_hit stops a
    lane at its first hit (shadow rays).  time (N,) f32: each ray's
    shutter time, read by the motion body when the mesh is animated.
    tree "curve" walks the curve-span tree (b0, b1 = span-local s, width
    v).  Under the kd-tree (``geo.accel``) the triangle rays take the kd
    walk (K1k, K1km)."""
    kind = leaf_kind(geo, time, tree)
    if o.device.type == "cpu":
        return traverse_reference(geo, o, d, t_max, any_hit, time=time,
                                  tree=tree)
    if o.device.type != "cuda":
        raise NotImplementedError(f"traversal on {o.device}")
    out = _launch(geo, o, d, t_max, any_hit, time, kind)
    if o.shape[0]:
        traverse_wide.launches += 1
        traverse_wide.kernel_launches[LEAF_KINDS[kind][1]] += 1
        traverse_wide.any_hit_launches += bool(any_hit)
    return out


def reset_launches() -> None:
    """Zero the wrapper's launch counts (the total, the any-hit ones and
    by body)."""
    traverse_wide.launches = 0
    traverse_wide.any_hit_launches = 0
    traverse_wide.kernel_launches = {name: 0 for _c, name in
                                     LEAF_KINDS.values()}


reset_launches()


def traverse_wide_reference(geo, o, d, t_max, any_hit: bool, time=None,
                            tree: str = "tri", stats=None):
    """Plain PyTorch twin of tpurt's ``_wide_step_fns`` traversal, for
    each leaf body: the watertight triangle bundle, lerped to ``time``
    when the mesh moves (K1m's plain version), or the curve bundle of
    the curve-span tree (``tree="curve"``, K1c's).

    Lockstep over the live lanes: each step gathers one record per lane,
    runs the leaf test on leaf lanes and the 8-box test + ``SORT8``
    near-first ordering on interior lanes, pushes the other hit children
    far-to-near and descends into the nearest.  Dead lanes drop out of
    the working set between steps (a boolean index), which changes no
    lane's result.  Stack slots at or past ``geo.wstack_depth`` are
    dropped on push and read as 0 on pop, exactly as tpurt's one-hot
    stack behaves.  A lane takes at most one step per record of the table
    plus one, the kernel's guard: a tree never needs more, and a stack
    that overflowed (a pop that reads row 0 restarts at the root) cannot
    run on for ever.

    ``stats``, a dict, receives the work a traversal of these rays has to
    do: "interior_steps" and "leaf_steps" (records read, by kind),
    "children" and "triangles" (present child boxes and non-pad triangles,
    or curve spans, tested in them), "sorts" (interior reads with two or
    more children hit, where an order is needed), and the distinct records
    read: "interior_records", "leaf_records", and "hit_leaves", the leaves
    in which some lane found a closer hit (whose prim rows are then
    read).  On the curve tree "spans_near" counts the spans that pass
    ``curve_span_cull`` (the only ones whose sub-segments K1c tests).  On
    a moving mesh (K1m) "groups" counts the live groups of 4 triangles of
    the leaves read, "groups_near" those that pass ``motion_group_cull``
    (the only ones K1m lerps and tests) and "near_group_records" the
    distinct (leaf, group) pairs among them, whose vertex and delta rows
    are then read."""
    traverse_wide_reference.calls += 1
    kind = leaf_kind(geo, time, tree)
    curve = kind == "curve"
    dev = o.device
    n = o.shape[0]
    S = geo.cstack_depth if curve else geo.wstack_depth
    nodes = geo.cnodes if curve else geo.wnodes
    aux = geo.cnodes_aux if curve else None
    delta = geo.wnodes_delta if kind == "motion" else None
    leaf_k, prim_lo = (WIDTH, CURVE_PRIM_LO) if curve else (LEAF_K, PRIM_LO)
    inv_d = safe_inv_dir(d)
    t_best = t_max.to(torch.float32).clone()
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b0_best = torch.zeros(n, dtype=torch.float32, device=dev)
    b1_best = torch.zeros(n, dtype=torch.float32, device=dev)
    cur = torch.where(t_best > 0, 0, -1).to(torch.int64)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, S), dtype=torch.int32, device=dev)
    live = torch.nonzero(cur >= 0).squeeze(1)
    if stats is not None:
        seen = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
        seen_hit = torch.zeros_like(seen)
        seen_near = torch.zeros((nodes.shape[0], GROUPS), dtype=torch.int32,
                                device=dev)
        stats.update(leaf_steps=0, interior_steps=0, children=0,
                     triangles=0, sorts=0, spans_near=0, groups=0,
                     groups_near=0)
    steps = 0
    while live.numel() and steps <= nodes.shape[0]:
        steps += 1
        rec = nodes[cur[live]]  # (m, 128): one record per live lane
        is_leaf = rec[:, SLOT_KIND] > 0
        m = live.numel()
        if stats is not None:
            seen[cur[live]] = True
            n_leaf = int(is_leaf.sum())
            stats["leaf_steps"] += n_leaf
            stats["interior_steps"] += m - n_leaf
        descend = torch.zeros(m, dtype=torch.bool, device=dev)
        first = torch.zeros(m, dtype=torch.int64, device=dev)

        # --- leaf lanes: the fused bundle, keep the closest ---
        lpos = torch.nonzero(is_leaf).squeeze(1)
        if lpos.numel():
            lanes = live[lpos]
            lrec = rec[lpos]
            rows = cur[lanes]
            if curve:
                h, t, b0, b1 = _curve_bundle_test(
                    o[lanes], d[lanes], t_best[lanes], lrec,
                    None if aux is None else aux[rows])
            elif delta is not None:
                h, t, b0, b1 = _tri_bundle_test(
                    o[lanes], d[lanes], t_best[lanes], lrec, delta[rows],
                    time[lanes])
            else:
                h, t, b0, b1 = _tri_bundle_test(o[lanes], d[lanes],
                                                t_best[lanes], lrec)
            tk = torch.where(h, t, INF)
            kbest = torch.argmin(tk, dim=1, keepdim=True)  # first minimum
            t_min = tk.gather(1, kbest)[:, 0]
            better = t_min < t_best[lanes]
            if stats is not None:
                stats["triangles"] += int(
                    (~torch.isnan(lrec[:, :leaf_k])).sum())
                seen_hit[cur[lanes[better]]] = True
                if curve:
                    stats["spans_near"] += int(curve_span_cull(
                        o[lanes], d[lanes], t_best[lanes], lrec,
                        None if aux is None else aux[rows]).sum())
                elif delta is not None:
                    _group_stats(stats, seen_near, rows, o[lanes], d[lanes],
                                 t_best[lanes], time[lanes], lrec,
                                 delta[rows])
            bl = lanes[better]
            kb = kbest[better]
            t_best[bl] = t_min[better]
            prim_rows = lrec[better][:, prim_lo:prim_lo + leaf_k].contiguous()
            prim_best[bl] = prim_rows.view(torch.int32).gather(1, kb)[:, 0]
            b0_best[bl] = b0[better].gather(1, kb)[:, 0]
            b1_best[bl] = b1[better].gather(1, kb)[:, 0]

        # --- interior lanes: box tests + near-first ordering ---
        ipos = torch.nonzero(~is_leaf).squeeze(1)
        if ipos.numel():
            lanes = live[ipos]
            irec = rec[ipos]
            hit8, t_near = _box8_test(irec, o[lanes], inv_d[lanes],
                                      t_best[lanes])
            meta = irec[:, CHILD_LO:CHILD_LO + WIDTH].contiguous().view(
                torch.int32).to(torch.int64)
            keys = [torch.where(hit8[:, k], t_near[:, k], INF)
                    for k in range(WIDTH)]
            vals = [meta[:, k] for k in range(WIDTH)]
            for i, j in SORT8:
                swap = keys[i] > keys[j]
                keys[i], keys[j] = (torch.where(swap, keys[j], keys[i]),
                                    torch.where(swap, keys[i], keys[j]))
                vals[i], vals[j] = (torch.where(swap, vals[j], vals[i]),
                                    torch.where(swap, vals[i], vals[j]))
            n_hit = hit8.sum(dim=1)
            if stats is not None:
                stats["children"] += int(
                    (~torch.isnan(irec[:, :WIDTH])).sum())
                stats["sorts"] += int((n_hit >= 2).sum())
            dsc = n_hit > 0
            sp_i = sp[lanes]
            # push hit children 1..n_hit-1 far-to-near above the old top
            for k in range(1, WIDTH):
                pos = sp_i + n_hit - 1 - k
                w = dsc & (k < n_hit) & (pos < S)
                stack[lanes[w], pos[w]] = vals[k][w].to(torch.int32)
            sp[lanes] = torch.where(dsc, sp_i + (n_hit - 1).clamp(min=0),
                                    sp_i)
            descend[ipos] = dsc
            first[ipos] = vals[0]

        # --- next node: nearest hit child, else pop, else done ---
        sp_l = sp[live]
        pop = ~descend & (sp_l > 0)
        top_slot = (sp_l - 1).clamp(min=0)
        top = stack[live, top_slot.clamp(max=S - 1)].to(torch.int64)
        top = torch.where(top_slot < S, top, 0)
        nxt = torch.where(descend, first, torch.where(pop, top, -1))
        if any_hit:
            nxt = torch.where(prim_best[live] >= 0, -1, nxt)
        sp[live] = torch.where(pop, sp_l - 1, sp_l)
        cur[live] = nxt
        live = live[nxt >= 0]
    if stats is not None:
        leaf_rows = nodes[:, SLOT_KIND] > 0
        stats.update(interior_records=int((seen & ~leaf_rows).sum()),
                     leaf_records=int((seen & leaf_rows).sum()),
                     hit_leaves=int(seen_hit.sum()),
                     near_group_records=int((seen_near > 0).sum()))
    return t_best, prim_best, b0_best, b1_best


traverse_wide_reference.calls = 0


def _group_stats(stats, seen_near, rows, o, d, t_best, time, lrec, drec):
    """Add the motion leaves' live groups and those that pass
    ``motion_group_cull`` at the leaf's t_best to ``stats`` ("groups",
    "groups_near"), and mark the near (row, group) pairs in
    ``seen_near``."""
    box = motion_group_boxes(lrec, drec)
    near = motion_group_cull(o, d, t_best, time, box)
    stats["groups"] += int((~torch.isnan(box[:, 0:GROUPS * GROUP_BOX:
                                             GROUP_BOX])).sum())
    stats["groups_near"] += int(near.sum())
    seen_near.index_add_(0, rows, near.to(torch.int32))


def traverse_kd_reference(geo, o, d, t_max, any_hit: bool, time=None,
                          stats=None):
    """Plain PyTorch twin of tpurt's kd walk (``_kd_init_state`` and
    ``_kd_step_fns``, intersect.py:1038-1162), K1k's and K1km's plain
    version: the root-bounds clip (the far t scaled by ``_BOX_T_SCALE``),
    then binary descent with a per-lane (node, tmin, tmax) interval stack
    of ``geo.kstack_depth`` slots.  An interior record sends the lane to
    its near child (below first when ``o < split``, or ``o == split`` and
    ``d <= 0``) and pushes the far one with (tplane, tmax) when the ray
    crosses the plane inside its interval; a cell whose tmin lies past
    the best hit pops; a leaf runs the 12-triangle bundle (lerped to
    ``time`` when the mesh moves), then walks its continuation row before
    popping.  any_hit stops a lane at its first hit.

    Lockstep over the live lanes, dead lanes dropped between steps; stack
    slots past the depth are dropped on push and read as (0, 0, 0) on
    pop, as tpurt's one-hot stack does.  A lane takes at most one step
    per table row plus one.  ``stats`` (a dict) receives the work these
    rays need: "interior_steps", "leaf_steps", "triangles" (non-pad
    triangles tested), and the distinct rows read, "interior_records",
    "leaf_records" and "hit_leaves" (leaf rows in which some lane found a
    closer hit, whose prim rows are then read); with the motion rows
    (K1km) "groups", "groups_near" and "near_group_records" as
    ``traverse_wide_reference`` counts them."""
    traverse_kd_reference.calls += 1
    from tpurt_torch.geom.kdtree import (SLOT_ABOVE, SLOT_AXIS, SLOT_BELOW,
                                         SLOT_CONT, SLOT_SPLIT)

    dev = o.device
    n = o.shape[0]
    S = geo.kstack_depth
    nodes = geo.knodes
    delta = geo.knodes_delta if time is not None else None
    inv_d = safe_inv_dir(d)
    t_max = t_max.to(torch.float32)
    # root clip (Bounds3::IntersectP); min / max propagate NaN as jnp's
    t0 = (geo.kbounds[0][None, :] - o) * inv_d
    t1 = (geo.kbounds[1][None, :] - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(dim=1)
    tfar = torch.maximum(t0, t1).amin(dim=1) * _BOX_T_SCALE
    tmin = torch.maximum(tnear, torch.zeros_like(tnear))
    tmax = torch.minimum(tfar, t_max)
    cur = torch.where((t_max > 0) & (tmin <= tmax), 0, -1).to(torch.int64)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    st_node = torch.zeros((n, S), dtype=torch.int64, device=dev)
    st_tmin = torch.zeros((n, S), dtype=torch.float32, device=dev)
    st_tmax = torch.zeros((n, S), dtype=torch.float32, device=dev)
    t_best = t_max.clone()
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b0_best = torch.zeros(n, dtype=torch.float32, device=dev)
    b1_best = torch.zeros(n, dtype=torch.float32, device=dev)
    live = torch.nonzero(cur >= 0).squeeze(1)
    if stats is not None:
        seen = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
        seen_hit = torch.zeros_like(seen)
        seen_near = torch.zeros((nodes.shape[0], GROUPS), dtype=torch.int32,
                                device=dev)
        stats.update(interior_steps=0, leaf_steps=0, triangles=0, groups=0,
                     groups_near=0)
    steps = 0
    while live.numel() and steps <= nodes.shape[0]:
        steps += 1
        rows = cur[live]
        rec = nodes[rows]
        is_leaf = rec[:, SLOT_KIND] > 0
        m = live.numel()
        if stats is not None:
            seen[rows] = True
            n_leaf = int(is_leaf.sum())
            stats["leaf_steps"] += n_leaf
            stats["interior_steps"] += m - n_leaf
        nxt = torch.full((m,), -1, dtype=torch.int64, device=dev)
        pop = torch.zeros(m, dtype=torch.bool, device=dev)

        # --- leaf lanes: the triangle bundle, then the continuation ---
        lpos = torch.nonzero(is_leaf).squeeze(1)
        if lpos.numel():
            lanes = live[lpos]
            lrec = rec[lpos]
            if delta is not None:
                h, t, b0, b1 = _tri_bundle_test(
                    o[lanes], d[lanes], t_best[lanes], lrec,
                    delta[rows[lpos]], time[lanes])
            else:
                h, t, b0, b1 = _tri_bundle_test(o[lanes], d[lanes],
                                                t_best[lanes], lrec)
            tk = torch.where(h, t, INF)
            kbest = torch.argmin(tk, dim=1, keepdim=True)  # first minimum
            t_min = tk.gather(1, kbest)[:, 0]
            better = t_min < t_best[lanes]
            if stats is not None:
                stats["triangles"] += int((~torch.isnan(lrec[:, :LEAF_K]))
                                          .sum())
                seen_hit[rows[lpos][better]] = True
                if delta is not None:
                    _group_stats(stats, seen_near, rows[lpos], o[lanes],
                                 d[lanes], t_best[lanes], time[lanes], lrec,
                                 delta[rows[lpos]])
            bl = lanes[better]
            kb = kbest[better]
            t_best[bl] = t_min[better]
            prim_rows = lrec[better][:, PRIM_LO:PRIM_LO + LEAF_K].contiguous()
            prim_best[bl] = prim_rows.view(torch.int32).gather(1, kb)[:, 0]
            b0_best[bl] = b0[better].gather(1, kb)[:, 0]
            b1_best[bl] = b1[better].gather(1, kb)[:, 0]
            cont = lrec[:, SLOT_CONT:SLOT_CONT + 1].contiguous().view(
                torch.int32)[:, 0].to(torch.int64)
            nxt[lpos] = cont
            pop[lpos] = cont < 0

        # --- interior lanes: the split plane against the interval ---
        ipos = torch.nonzero(~is_leaf).squeeze(1)
        if ipos.numel():
            lanes = live[ipos]
            irec = rec[ipos]
            split = irec[:, SLOT_SPLIT]
            meta = irec[:, SLOT_AXIS:SLOT_ABOVE + 1].contiguous().view(
                torch.int32).to(torch.int64)
            axis, below, above = (meta[:, 0:1], meta[:, SLOT_BELOW - SLOT_AXIS],
                                  meta[:, SLOT_ABOVE - SLOT_AXIS])
            o_a = o[lanes].gather(1, axis)[:, 0]
            d_a = d[lanes].gather(1, axis)[:, 0]
            inv_a = inv_d[lanes].gather(1, axis)[:, 0]
            tplane = (split - o_a) * inv_a
            below_first = (o_a < split) | ((o_a == split) & (d_a <= 0))
            near = torch.where(below_first, below, above)
            far = torch.where(below_first, above, below)
            tmin_l, tmax_l = tmin[lanes], tmax[lanes]
            dead = tmin_l > t_best[lanes]
            no_far = (tplane > tmax_l) | (tplane <= 0)
            no_near = tplane < tmin_l
            push = ~dead & ~no_far & ~no_near
            nxt[ipos] = torch.where(dead, -1,
                                    torch.where(no_far | ~no_near, near, far))
            pop[ipos] = dead
            # push the far child's (node, tplane, tmax) interval
            pl, pp = lanes[push], sp[lanes[push]]
            w = pp < S
            st_node[pl[w], pp[w]] = far[push][w]
            st_tmin[pl[w], pp[w]] = tplane[push][w]
            st_tmax[pl[w], pp[w]] = tmax_l[push][w]
            sp[pl] = pp + 1
            tmax[pl] = tplane[push]

        # --- pop: the top interval, (0, 0, 0) past the stack's depth ---
        sp_l = sp[live]
        can_pop = pop & (sp_l > 0)
        cl = live[can_pop]
        top = sp[cl] - 1
        ok = top < S
        slot = top.clamp(max=S - 1)
        nxt[can_pop] = torch.where(ok, st_node[cl, slot], 0)
        tmin[cl] = torch.where(ok, st_tmin[cl, slot], 0.0)
        tmax[cl] = torch.where(ok, st_tmax[cl, slot], 0.0)
        sp[cl] = top
        if any_hit:
            nxt = torch.where(prim_best[live] >= 0, -1, nxt)
        cur[live] = nxt
        live = live[nxt >= 0]
    if stats is not None:
        leaf_rows = nodes[:, SLOT_KIND] > 0
        stats.update(interior_records=int((seen & ~leaf_rows).sum()),
                     leaf_records=int((seen & leaf_rows).sum()),
                     hit_leaves=int(seen_hit.sum()),
                     near_group_records=int((seen_near > 0).sum()))
    return t_best, prim_best, b0_best, b1_best


traverse_kd_reference.calls = 0


def traverse_reference(geo, o, d, t_max, any_hit: bool, time=None,
                       tree: str = "tri", stats=None):
    """The plain version of whichever body ``traverse_wide`` launches for
    these arguments: the kd twin under the kd-tree, the wide-BVH twin
    otherwise."""
    if leaf_kind(geo, time, tree) in ("kd", "kd_motion"):
        return traverse_kd_reference(geo, o, d, t_max, any_hit, time=time,
                                     stats=stats)
    return traverse_wide_reference(geo, o, d, t_max, any_hit, time=time,
                                   tree=tree, stats=stats)
