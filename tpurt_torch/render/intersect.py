"""Geometry upload and ray queries (port of tpurt/render/intersect.py:
triangles, the six quadrics and ray-traced curves, static or moving over
the shutter).

The wide-BVH record table, the fused shading rows and the quadric tables
are built on the host exactly as tpurt builds them (the port's copies of
``build_wide_table`` and ``build_curve_table`` over the copied
``geometry_build`` flattening), then uploaded.  Triangles are found by
BVH traversal (``tpurt_torch.kernels.traverse``: a CUDA kernel on CUDA
tensors, its plain twin on CPU tensors); an animated mesh adds the
per-leaf vertex deltas, which the walk lerps to each ray's time.  Curve
spans have a second wide tree, walked by the same traversal with the
curve leaf test.  Quadrics (sphere, cylinder, disk, cone, paraboloid,
hyperboloid) are tested outside the tree in one vectorized pass per
quadric, as in tpurt, each by the test of its kind, which the host knows;
an animated quadric interpolates its transform per lane.

The traversal is an explicit argument of ``intersect_closest`` and
``intersect_any`` so a caller can run the whole renderer through either
implementation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.geom.wbvh import (LEAF_K, SLOT_KIND, WIDTH,
                                   build_curve_table, build_wide_table)
from tpurt_torch.render.geometry_build import (CURVE_LEAF_SUBDIV,
                                              FLAG_HAS_TANGENTS, PT_CONE,
                                              PT_CURVE, PT_CYLINDER, PT_DISK,
                                              PT_HYPERBOLOID, PT_PARABOLOID,
                                              PT_SPHERE, PT_TRIANGLE,
                                              GeometryArrays)
from tpurt_torch.render.sampling_warps import matvec_lanes, slerp_rotation

INF = float("inf")

# machine gamma for conservative box tests (pbrt gamma(3)), as in tpurt
_GAMMA3 = 3.0 * np.finfo(np.float32).eps * 0.5 / (1 - 3 * np.finfo(np.float32).eps * 0.5)
_BOX_T_SCALE = float(np.float32(1.0 + 2.0 * _GAMMA3))

# interior-record child slots and leaf-record prim slots (wbvh.py layout);
# a curve leaf holds WIDTH spans, its prim rows after 12 control-point
# coordinates and 2 widths of each
CHILD_LO = 6 * WIDTH
PRIM_LO = 9 * LEAF_K
CURVE_PRIM_LO = 14 * WIDTH
# floats per row of the ribbon aux table: [n0 (3W) n1 (3W) angle (W)
# invSin (W)]
CURVE_AUX = 8 * WIDTH
# floats per row of the traversal kernel's packed interior table: the 56
# live slots of an interior record (48 bounds + 8 child references),
# padded to 256 B
INTERIOR_REC = 64
# a motion leaf's triangles in groups of 4 (a float4 of each vertex row);
# the group box table (motion_group_boxes) holds 12 floats a group, min v
# xyz, max v xyz, min dv xyz, max dv xyz, in a row of 64 floats a leaf
GROUPS = LEAF_K // 4
GROUP_BOX = 12
MOTION_BOX = 64


def derive_traversal_tables(wnodes: np.ndarray, leaf_side=()) -> dict:
    """The tables the CUDA traversal kernel reads, from the host record
    table ``wnodes`` (M, 128), which stays what the plain twin reads.
    ``leaf_side`` lists tables that mirror ``wnodes`` row for row (the
    motion delta table, the ribbon aux table); each comes back in ``side``
    restricted to the leaves, in ``lrow`` order, so that a leaf's side row
    is its row in ``leaves``.

    The rows reachable from row 0 are split by kind, in row order:
      inodes (Mi, 64) f32: an interior record's 48 child bounds and its
          8 child references, rewritten;
      leaves (Ml, 128) f32: the leaf records as they are.
    A reference is ``2 * row + kind``: ``row`` in ``inodes`` (kind 0) or
    in ``leaves`` (kind 1), so the kernel knows a record's kind before it
    fetches it.  References of absent children (NaN boxes, never hit) are
    0.  ``root_ref`` is row 0's reference; ``irow`` / ``lrow`` (int32) give
    each packed row's row in ``wnodes``.
    """
    m = wnodes.shape[0]
    is_leaf = wnodes[:, SLOT_KIND] > 0
    cref = np.ascontiguousarray(
        wnodes[:, CHILD_LO:CHILD_LO + WIDTH]).view(np.int32)
    present = ~np.isnan(wnodes[:, 0:WIDTH]) & ~is_leaf[:, None]
    reach = np.zeros(m, bool)
    reach[0] = True
    front = np.array([0]) if not is_leaf[0] else np.array([], np.int64)
    while front.size:
        ch = np.unique(cref[front][present[front]])
        ch = ch[~reach[ch]]
        reach[ch] = True
        front = ch[~is_leaf[ch]]
    irow = np.nonzero(reach & ~is_leaf)[0].astype(np.int32)
    lrow = np.nonzero(reach & is_leaf)[0].astype(np.int32)
    ref = np.zeros(m, np.int32)
    ref[irow] = 2 * np.arange(len(irow), dtype=np.int32)
    ref[lrow] = 2 * np.arange(len(lrow), dtype=np.int32) + 1
    # at least one row each, so the kernel never gets a null table
    inodes = np.zeros((max(len(irow), 1), INTERIOR_REC), np.float32)
    inodes[:, 0:CHILD_LO] = np.nan
    inodes[:len(irow), 0:CHILD_LO] = wnodes[irow, 0:CHILD_LO]
    inodes[:len(irow), CHILD_LO:CHILD_LO + WIDTH] = np.where(
        present[irow], ref[cref[irow]], 0).astype(np.int32).view(np.float32)
    leaves = np.zeros((max(len(lrow), 1), wnodes.shape[1]), np.float32)
    leaves[:, 0:PRIM_LO] = np.nan
    leaves[:len(lrow)] = wnodes[lrow]
    side = []
    for tab in leaf_side:
        t = np.zeros((len(leaves),) + tab.shape[1:], np.float32)
        t[:len(lrow)] = tab[lrow]
        side.append(t)
    return dict(inodes=inodes, leaves=leaves, root_ref=int(ref[0]),
                irow=irow, lrow=lrow, side=side)


def derive_kd_tables(knodes: np.ndarray, delta=None) -> dict:
    """The tables the kd walk's kernel reads (K1k, K1km), from the kd
    record table ``knodes`` (geom/kdtree.py), which stays what the plain
    twin reads.  The rows reachable from row 0 (through child links and
    leaf continuations) are split by kind, each in row order (the
    builder's depth-first order, so a node's below child follows it):
      kinodes (Mi, 4) f32: an interior row's split, axis (i32) and the
          below and above children's references (i32): 16 bytes a node;
      kleaves (Ml, 128) f32: the leaf rows as they are (K1's leaf test
          reads them), slot SLOT_CONT rewritten to the continuation's
          reference (-1: none);
      kleaves_delta (Ml, 128): ``delta``'s rows in kleaves order, or None;
      kleaves_box (Ml, 64): their group boxes (``motion_group_boxes``).
    A reference is ``2 * row + kind``: ``row`` in kinodes (kind 0) or in
    kleaves (kind 1), so the walk knows a node's kind before it reads it;
    ``kroot_ref`` is row 0's.  ``kirow`` / ``klrow`` (int32) give each
    packed row's row in knodes."""
    from tpurt_torch.geom.kdtree import (SLOT_ABOVE, SLOT_AXIS, SLOT_BELOW,
                                         SLOT_CONT, SLOT_SPLIT)

    m = knodes.shape[0]
    is_leaf = knodes[:, SLOT_KIND] > 0
    ints = np.ascontiguousarray(knodes).view(np.int32)
    reach = np.zeros(m, bool)
    reach[0] = True
    front = np.array([0])
    while front.size:
        kids = np.concatenate([
            ints[front[~is_leaf[front]]][:, [SLOT_BELOW, SLOT_ABOVE]].ravel(),
            ints[front[is_leaf[front]], SLOT_CONT]])
        kids = np.unique(kids[(kids >= 0) & (kids < m)])
        front = kids[~reach[kids]]
        reach[front] = True
    irow = np.nonzero(reach & ~is_leaf)[0].astype(np.int32)
    lrow = np.nonzero(reach & is_leaf)[0].astype(np.int32)
    ref = np.full(m, -1, np.int32)
    ref[irow] = 2 * np.arange(len(irow), dtype=np.int32)
    ref[lrow] = 2 * np.arange(len(lrow), dtype=np.int32) + 1

    def ref_of(rows):
        return np.where(rows >= 0, ref[np.clip(rows, 0, m - 1)], -1)

    # at least one row each, so the kernel never gets a null table
    kinodes = np.zeros((max(len(irow), 1), 4), np.float32)
    kinodes[:len(irow), 0] = knodes[irow, SLOT_SPLIT]
    kin = kinodes.view(np.int32)
    kin[:len(irow), 1] = ints[irow, SLOT_AXIS]
    kin[:len(irow), 2] = ref_of(ints[irow, SLOT_BELOW])
    kin[:len(irow), 3] = ref_of(ints[irow, SLOT_ABOVE])
    kleaves = np.zeros((max(len(lrow), 1), knodes.shape[1]), np.float32)
    kleaves[:, 0:PRIM_LO] = np.nan
    kleaves[:, PRIM_LO:PRIM_LO + LEAF_K] = np.int32(-1).view(np.float32)
    kleaves[:, SLOT_KIND] = 1.0
    kleaves[:len(lrow)] = knodes[lrow]
    kleaves.view(np.int32)[:, SLOT_CONT] = -1
    kleaves.view(np.int32)[:len(lrow), SLOT_CONT] = ref_of(
        ints[lrow, SLOT_CONT])
    kdelta = kbox = None
    if delta is not None:
        kdelta = np.zeros(kleaves.shape, np.float32)
        kdelta[:len(lrow)] = delta[lrow]
        kbox = motion_group_boxes(kleaves, kdelta)
    return dict(kinodes=kinodes, kleaves=kleaves, kleaves_delta=kdelta,
                kleaves_box=kbox, kroot_ref=int(ref[0]), kirow=irow,
                klrow=lrow)


def motion_group_boxes(leaves, delta):
    """(M, MOTION_BOX) f32: the box rows of motion leaf records ``leaves``
    (M, 128) with their delta rows ``delta`` (numpy or torch, the same
    kind back), which the motion leaf's group cull reads
    (``motion_group_cull``; K1m and K1km).  Group g (triangles 4g..4g+3)
    fills [12g, 12g + 12): the min and the max over its live triangles'
    9 vertex coordinates, by axis, then the min and the max of their
    deltas; a group of pads only (v NaN) is NaN throughout, the rest of
    the row 0.  Mins and maxes of stored floats: exact."""
    as_np = isinstance(leaves, np.ndarray)
    rec, drec = torch.as_tensor(leaves), torch.as_tensor(delta)
    m = rec.shape[0]
    # (M, vertex, axis, group, triangle of the group)
    v = rec[:, :PRIM_LO].reshape(m, 3, 3, GROUPS, 4)
    dv = drec[:, :PRIM_LO].reshape(m, 3, 3, GROUPS, 4)
    live = ~torch.isnan(v[:, 0:1, 0:1])  # a triangle's v0.x
    v_ok = live & ~torch.isnan(v)
    box = torch.stack([
        torch.where(v_ok, v, INF).amin(dim=(1, 4)),
        torch.where(v_ok, v, -INF).amax(dim=(1, 4)),
        torch.where(live, dv, INF).amin(dim=(1, 4)),
        torch.where(live, dv, -INF).amax(dim=(1, 4))], dim=1)
    # (M, 4, axis, group): NaN where the group holds no live triangle
    box = torch.where(live.any(dim=4).reshape(m, 1, 1, GROUPS), box,
                      float("nan"))
    out = torch.zeros((m, MOTION_BOX), dtype=torch.float32,
                      device=rec.device)
    out[:, :GROUPS * GROUP_BOX] = box.permute(0, 3, 1, 2).reshape(
        m, GROUPS * GROUP_BOX)
    return out.numpy() if as_np else out


def _stack_depth(depth: int) -> int:
    """tpurt's power-of-two stack sizing for a wide tree of ``depth``
    levels: worst-case residency is (W-1) pushes per interior level."""
    need = max(8, (depth - 1) * (WIDTH - 1) + 2)
    sdepth = 8
    while sdepth < min(need, 192):
        sdepth *= 2
    return sdepth


@dataclasses.dataclass
class DeviceGeometry:
    """Device tables of a scene of triangles, quadrics and curves.

    wnodes (M, 128) f32: the wide-BVH record table (tpurt.geom.wbvh
        layout; slot 126 is the kind flag: 0 interior, 1 leaf).
    shade_rows (P, 32) f32: fused per-prim shading record
        [0] flags [1] ptype [2] material_id [3] arealight_id [4] quad_id
        [5] medium_inside [6] medium_outside (bitcast i32);
        triangles [7:16] v0,v1,v2 [16:25] n0,n1,n2 [25:31] uv0,uv1,uv2
        [31] face id (bitcast i32); quadrics [7:19] w2o rows 0..2,
        [19:27] params[0:8]; curves [7:19] span control points,
        [19:21] w0,w1 [21:23] u0,u1 [23] subtype (bitcast i32)
        [24:30] ribbon n0,n1 [30] normal angle [31] 1/sin(angle).
    prim_type, quad_id (P,) i32; quad_w2o (Q, 4, 4), quad_params (Q, 16)
        f32: the quadric tables (padding rows when the scene has none).
    wstack_depth: traversal stack slots (tpurt's power-of-two sizing).
    inodes, leaves, root_ref: the CUDA traversal kernel's tables, derived
        from wnodes at upload (``derive_traversal_tables``).
    quads: (prim type, quad_id) of each quadric prim in prim order, read
        on the host at upload, so each quadric's pass runs its own test.

    Motion blur (None on a static scene, as in tpurt):
    wnodes_delta (M, 128): per-leaf vertex deltas (end - start) in the
        leaf layout of wnodes, pads 0; leaves_delta (Ml, 128) the same
        rows in ``leaves`` order, for the kernel, and leaves_box (Ml, 64)
        their triangle groups' boxes (``motion_group_boxes``), which the
        kernel's group cull reads.
    shade_delta (P, 18): dv0, dv1, dv2, dn0, dn1, dn2 per prim.
    quad_trs (Q, 2, 16): each quadric's endpoint [t (3), quat wxyz (4),
        S (9)]; quad_animated (Q,) bool.
    shade_s (P, 9): per-prim vertex shading tangents, when a mesh carries
        ``"vector S"`` (None otherwise).

    has_tangents: a mesh carries ``"vector S"`` or the scene holds
    curves (the BSDF frame then aligns to the shading tangent).

    Ray-traced curves (None / 0 without them): cnodes (Mc, 128) the
    curve-span tree (wbvh.build_curve_table: interior records as wnodes',
    leaves of WIDTH spans), cnodes_aux (Mc, 64) its ribbon table (None
    without ribbons); cinodes, cleaves, cleaves_aux, croot_ref its kernel
    tables; cstack_depth its stack slots.

    The kd-tree (``Accelerator "kdtree"``; None under the wide BVH, as in
    tpurt): accel "kdtree"; knodes (Mk, 128) the kd record table
    (geom/kdtree.py: interior rows hold split, axis, below and above in
    slots 120-123, leaf rows the BVH leaf's 12-triangle bundle and their
    continuation row in slot 124), which the twin and the kernel both
    read; knodes_delta (Mk, 128) its motion delta rows; kbounds (2, 3)
    the root's clip box; kstack_depth the walk's interval-stack slots;
    kinodes, kleaves, kleaves_delta, kleaves_box, kroot_ref the kernel's
    tables, derived from knodes at upload (``derive_kd_tables``).
    Triangle rays walk it; curves keep their tree and quadrics their
    passes.
    """

    wnodes: torch.Tensor
    shade_rows: torch.Tensor
    prim_type: torch.Tensor
    quad_id: torch.Tensor
    quad_w2o: torch.Tensor
    quad_params: torch.Tensor
    n_tris: int
    n_quads: int
    wstack_depth: int
    inodes: torch.Tensor = None
    leaves: torch.Tensor = None
    root_ref: int = 0
    quads: tuple = ()
    wnodes_delta: torch.Tensor = None
    leaves_delta: torch.Tensor = None
    leaves_box: torch.Tensor = None
    shade_delta: torch.Tensor = None
    quad_trs: torch.Tensor = None
    quad_animated: torch.Tensor = None
    shade_s: torch.Tensor = None
    n_curves: int = 0
    cnodes: torch.Tensor = None
    cnodes_aux: torch.Tensor = None
    cstack_depth: int = 64
    cinodes: torch.Tensor = None
    cleaves: torch.Tensor = None
    cleaves_aux: torch.Tensor = None
    croot_ref: int = 0
    quad_animated_host: tuple = ()
    # a mesh carries shading tangents or the scene holds curves
    has_tangents: bool = False
    accel: str = "bvh"
    knodes: torch.Tensor = None
    knodes_delta: torch.Tensor = None
    kbounds: torch.Tensor = None
    kstack_depth: int = 32
    kinodes: torch.Tensor = None
    kleaves: torch.Tensor = None
    kleaves_delta: torch.Tensor = None
    kleaves_box: torch.Tensor = None
    kroot_ref: int = 0

    @property
    def device(self) -> torch.device:
        return self.wnodes.device

    @staticmethod
    def host_tables(g: GeometryArrays, accel: str = "bvh",
                    accel_params=None) -> dict:
        """numpy tables of the geometry (the host half of tpurt's
        DeviceGeometry.from_host, intersect.py:141-287); from_tables
        uploads them.  ``accel`` "kdtree" adds the kd tables, built over
        the triangles with the Accelerator's intersectcost,
        traversalcost, emptybonus, maxprims and maxdepth
        (``accel_params``, tpurt's :169-189); the wide BVH is built as
        well, as tpurt does."""
        bad = set(np.unique(g.prim_type).tolist()) - {
            PT_TRIANGLE, PT_CURVE, *_QUADRIC_TESTS}
        if bad:
            raise NotImplementedError(f"prim types {sorted(bad)}")
        if not (g.bvh.n_prims <= 1).all():
            raise ValueError("collapse expects 1-prim leaves")
        ends = ((g.tri_e0, g.tri_e1, g.tri_e2) if g.has_motion else ())
        wnodes, wdelta, wdepth = build_wide_table(g.bvh, g.tri_v0, g.tri_v1,
                                                  g.tri_v2, *ends)

        p = len(g.prim_type)
        # each prim's MediumInterface (-1: none) rides in the shade row
        med_in = (g.medium_inside if g.medium_inside is not None
                  else np.full(p, -1, np.int32))
        med_out = (g.medium_outside if g.medium_outside is not None
                   else np.full(p, -1, np.int32))
        ints = np.stack([g.flags, g.prim_type, g.material_id,
                         g.arealight_id, g.quad_id, med_in, med_out],
                        axis=1).astype(np.int32)
        rows = np.zeros((p, 32), np.float32)
        rows[:, 0:7] = ints.view(np.float32)
        nt = g.n_tris
        if nt:
            if g.face_id is not None:
                rows[:nt, 31] = g.face_id[:nt].astype(np.int32).view(
                    np.float32)
            vi = g.tri_vi[:nt]
            rows[:nt, 7:10] = g.tri_v0[:nt]
            rows[:nt, 10:13] = g.tri_v1[:nt]
            rows[:nt, 13:16] = g.tri_v2[:nt]
            if len(g.vert_n):
                rows[:nt, 16:25] = g.vert_n[vi].reshape(nt, 9)
                rows[:nt, 25:31] = g.vert_uv[vi].reshape(nt, 6)
        if g.n_quads:
            nq = nt + g.n_quads
            qi = np.maximum(g.quad_id[nt:nq], 0)
            rows[nt:nq, 7:19] = g.quad_w2o[qi][:, :3, :].reshape(-1, 12)
            rows[nt:nq, 19:27] = g.quad_params[qi][:, :8]
        out = dict(wnodes=wnodes, shade_rows=rows,
                   prim_type=g.prim_type.astype(np.int32),
                   quad_id=g.quad_id.astype(np.int32),
                   quad_w2o=g.quad_w2o.astype(np.float32),
                   quad_params=g.quad_params.astype(np.float32),
                   n_tris=int(g.n_tris), n_quads=int(g.n_quads),
                   wstack_depth=_stack_depth(wdepth),
                   has_tangents=bool((g.flags & FLAG_HAS_TANGENTS).any()
                                     or g.n_curves))
        if g.n_curves:
            base = g.n_tris + g.n_quads
            cnodes, caux, cdepth = build_curve_table(
                g.curve_bvh, g.curve_cp, g.curve_w, g.curve_aux, base,
                g.has_ribbons)
            ce = base + g.n_curves
            rows[base:ce, 7:19] = g.curve_cp
            rows[base:ce, 19:21] = g.curve_w
            rows[base:ce, 21:23] = g.curve_u
            rows[base:ce, 23] = g.curve_subtype.astype(np.int32).view(
                np.float32)
            rows[base:ce, 24:32] = g.curve_aux
            out.update(n_curves=int(g.n_curves), cnodes=cnodes,
                       cnodes_aux=caux, cstack_depth=_stack_depth(cdepth))
        if g.has_motion:
            sd = np.zeros((p, 18), np.float32)
            sd[:, 0:3] = g.tri_e0 - g.tri_v0
            sd[:, 3:6] = g.tri_e1 - g.tri_v1
            sd[:, 6:9] = g.tri_e2 - g.tri_v2
            if nt and len(g.vert_n):
                sd[:nt, 9:18] = (
                    (g.vert_ne - g.vert_n)[g.tri_vi[:nt]].reshape(nt, 9))
            out.update(wnodes_delta=wdelta, shade_delta=sd)
        if g.has_quad_motion:
            out.update(quad_trs=g.quad_trs.astype(np.float32),
                       quad_animated=g.quad_animated.astype(bool))
        if accel == "kdtree":
            out.update(_kd_tables(g, accel_params))
        if nt and len(g.vert_s) and (g.flags & FLAG_HAS_TANGENTS).any():
            ss = np.zeros((p, 9), np.float32)
            ss[:nt] = g.vert_s[g.tri_vi[:nt]].reshape(nt, 9)
            out.update(shade_s=ss)
        return out

    @staticmethod
    def from_tables(tables: dict, device) -> "DeviceGeometry":
        delta = tables.get("wnodes_delta")
        trav = derive_traversal_tables(
            tables["wnodes"], () if delta is None else (delta,))
        nt, nq = tables["n_tris"], tables["n_quads"]
        quads = tuple((int(k), int(q)) for k, q in zip(
            tables["prim_type"][nt:nt + nq], tables["quad_id"][nt:nt + nq]))
        tables = dict(tables, inodes=trav["inodes"], leaves=trav["leaves"],
                      root_ref=trav["root_ref"], quads=quads)
        if tables.get("quad_animated") is not None:
            tables["quad_animated_host"] = tuple(
                bool(a) for a in tables["quad_animated"])
        if delta is not None:
            tables["leaves_delta"] = trav["side"][0]
            tables["leaves_box"] = motion_group_boxes(trav["leaves"],
                                                      trav["side"][0])
        if tables.get("cnodes") is not None:
            aux = tables.get("cnodes_aux")
            ctrav = derive_traversal_tables(
                tables["cnodes"], () if aux is None else (aux,))
            tables.update(cinodes=ctrav["inodes"], cleaves=ctrav["leaves"],
                          croot_ref=ctrav["root_ref"],
                          cleaves_aux=ctrav["side"][0] if aux is not None
                          else None)
        if tables.get("knodes") is not None:
            ktrav = derive_kd_tables(tables["knodes"],
                                     tables.get("knodes_delta"))
            tables.update({k: ktrav[k] for k in (
                "kinodes", "kleaves", "kleaves_delta", "kleaves_box",
                "kroot_ref")})
        kw = {k: (torch.tensor(v, device=device)
                  if isinstance(v, np.ndarray) else v)
              for k, v in tables.items()}
        return DeviceGeometry(**kw)


def _kd_tables(g: GeometryArrays, p) -> dict:
    """The kd-tree tables over the triangles of ``g`` (tpurt's kdtree
    branch of DeviceGeometry.from_host, intersect.py:169-189): the record
    table, its motion delta rows (None on a static mesh), the clip bounds
    and the stack depth."""
    from tpurt_torch.geom.kdtree import build_kd_table

    nt = g.n_tris
    kw = dict(
        isect_cost=p.find_one_int("intersectcost", 80) if p else 80,
        trav_cost=p.find_one_int("traversalcost", 1) if p else 1,
        empty_bonus=p.find_one_float("emptybonus", 0.5) if p else 0.5,
        max_prims=(p.find_one_int("maxprims", 0) or None) if p else None,
        max_depth=p.find_one_int("maxdepth", -1) if p else -1)
    ends = ((g.tri_e0[:nt], g.tri_e1[:nt], g.tri_e2[:nt]) if g.has_motion
            else ())
    knodes, kdelta, kbounds, kdepth = build_kd_table(
        g.tri_v0[:nt], g.tri_v1[:nt], g.tri_v2[:nt], *ends, **kw)
    out = dict(accel="kdtree", knodes=knodes, kbounds=kbounds,
               kstack_depth=int(kdepth))
    if kdelta is not None:
        out["knodes_delta"] = kdelta
    return out


class Hit(NamedTuple):
    """Closest-hit record (SoA over rays)."""

    t: torch.Tensor  # hit distance (inf if miss)
    prim: torch.Tensor  # primitive index (-1 if miss), int32
    b0: torch.Tensor  # triangle barycentric 0 / quadric u
    b1: torch.Tensor  # triangle barycentric 1 / quadric v


# ---------------------------------------------------------------------------
# leaf and interior record tests (shared by the traversal twin)
# ---------------------------------------------------------------------------

def _batcher_network(n: int):
    """Batcher odd-even merge sorting network for n = 2^k elements
    (19 comparators at n=8)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


SORT8 = _batcher_network(WIDTH)


def _tri_bundle_test(o, d, t_max, rec, drec=None, time=None):
    """Watertight test of the LEAF_K triangles fused in a leaf record.
    o, d: (N, 3); t_max: (N,); rec: (N, 128).  Returns (hit, t, b0, b1)
    each (N, LEAF_K); NaN vertex pads never hit.  With drec (the leaf's
    delta rows) and time (N,), motion blur: the vertices are lerped to the
    ray's time first (tpurt's intersect.py:669-725)."""
    K = LEAF_K
    v = [rec[:, i * K:(i + 1) * K] for i in range(9)]  # v0x..v2z, (N, K)
    if drec is not None:
        v = [vi + time[:, None] * drec[:, i * K:(i + 1) * K]
             for i, vi in enumerate(v)]
    ax, ay, az = d[:, 0].abs(), d[:, 1].abs(), d[:, 2].abs()
    use2 = ((az >= ax) & (az >= ay))[:, None]  # kz=2 -> (x,y,z)
    use1 = (~use2) & (ay >= ax)[:, None]       # kz=1 -> (z,x,y)
    # else kz=0 -> (y,z,x)

    def permute(x, y, z):
        px = torch.where(use2, x, torch.where(use1, z, y))
        py = torch.where(use2, y, torch.where(use1, x, z))
        pz = torch.where(use2, z, torch.where(use1, y, x))
        return px, py, pz

    dpx, dpy, dpz = permute(d[:, 0:1], d[:, 1:2], d[:, 2:3])  # (N, 1)
    p0x, p0y, p0z = permute(v[0] - o[:, 0:1], v[1] - o[:, 1:2],
                            v[2] - o[:, 2:3])
    p1x, p1y, p1z = permute(v[3] - o[:, 0:1], v[4] - o[:, 1:2],
                            v[5] - o[:, 2:3])
    p2x, p2y, p2z = permute(v[6] - o[:, 0:1], v[7] - o[:, 1:2],
                            v[8] - o[:, 2:3])
    sx = -dpx / dpz
    sy = -dpy / dpz
    sz = 1.0 / dpz
    x0 = p0x + sx * p0z
    y0 = p0y + sy * p0z
    x1 = p1x + sx * p1z
    y1 = p1y + sy * p1z
    x2 = p2x + sx * p2z
    y2 = p2y + sy * p2z
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
        (e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2
    t_scaled = (e0 * p0z + e1 * p1z + e2 * p2z) * sz
    tm = t_max[:, None]
    t_ok = torch.where(det < 0,
                       (t_scaled <= 0) & (t_scaled > tm * det),
                       (t_scaled >= 0) & (t_scaled < tm * det))
    hit = same_sign & (det != 0) & t_ok
    inv_det = torch.where(det != 0, 1.0 / det, 0.0)
    return (hit, torch.where(hit, t_scaled * inv_det, INF),
            e0 * inv_det, e1 * inv_det)


def _curve_blossom_weights() -> np.ndarray:
    """Constant (2^CURVE_LEAF_SUBDIV, 4, 4) blossom weights turning a
    span's 4 control points into each uniform sub-segment's 4 control
    points (BlossomBezier over [j/K, (j+1)/K]; curve.cpp:43-53; tpurt's
    intersect.py:727-749)."""
    k = 1 << CURVE_LEAF_SUBDIV

    def bw(u1, u2, u3):
        e1 = u1 + u2 + u3
        e2 = u1 * u2 + u1 * u3 + u2 * u3
        e3 = u1 * u2 * u3
        return [1 - e1 + e2 - e3, e1 - 2 * e2 + 3 * e3, e2 - 3 * e3, e3]

    out = np.zeros((k, 4, 4), np.float64)
    for j in range(k):
        a, b = j / k, (j + 1) / k
        out[j] = [bw(a, a, a), bw(a, a, b), bw(a, b, b), bw(b, b, b)]
    return out


CURVE_W = _curve_blossom_weights()


def _sqrt_ieee(x):
    """The correctly rounded float32 square root, on every device: torch's
    CPU sqrt is not (it differs from IEEE on ~0.7% of random inputs, while
    XLA's and CUDA's sqrtf are exact); the float64 root rounded once to
    float32 is."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _curve_project(o, d, rec):
    """Each (lane, span)'s 4 control points in the lane's ray frame
    (LookAt basis, curve.cpp:162-174), as tpurt's _curve_bundle_test
    computes them: returns (rx, ry, rz) (lists of 4 (N, WIDTH) tensors)
    and (dl, dxx, dyy, dzz), |d| and d's columns (N, 1)."""
    W_ = WIDTH
    c = [rec[:, i * W_:(i + 1) * W_] for i in range(12)]  # (N, W) each

    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dxx, dyy, dzz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    dl = _sqrt_ieee(dxx * dxx + dyy * dyy + dzz * dzz)
    hx, hy, hz = dxx / dl, dyy / dl, dzz / dl

    # "up" = cross(d, cp3 - cp0); degenerate -> CoordinateSystem(d)
    v30x = c[9] - c[0]
    v30y = c[10] - c[1]
    v30z = c[11] - c[2]
    ux = dyy * v30z - dzz * v30y
    uy = dzz * v30x - dxx * v30z
    uz = dxx * v30y - dyy * v30x
    deg = (ux * ux + uy * uy + uz * uz) < 1e-18
    pick = dxx.abs() > dyy.abs()
    zero = torch.zeros_like(dzz)
    ux = torch.where(deg, torch.where(pick, -dzz, zero), ux)
    uy = torch.where(deg, torch.where(pick, zero, dzz), uy)
    uz = torch.where(deg, torch.where(pick, dxx, -dyy), uz)
    # x = normalize(cross(up, dhat)); y = cross(dhat, x)
    xx = uy * hz - uz * hy
    xy = uz * hx - ux * hz
    xz = ux * hy - uy * hx
    xl = torch.clamp(_sqrt_ieee(xx * xx + xy * xy + xz * xz), min=1e-20)
    xx, xy, xz = xx / xl, xy / xl, xz / xl
    yx = hy * xz - hz * xy
    yy = hz * xx - hx * xz
    yz = hx * xy - hy * xx

    rx, ry, rz = [], [], []
    for i in range(4):
        qx = c[3 * i] - ox
        qy = c[3 * i + 1] - oy
        qz = c[3 * i + 2] - oz
        rx.append(qx * xx + qy * xy + qz * xz)
        ry.append(qx * yx + qy * yy + qz * yz)
        rz.append(qx * hx + qy * hy + qz * hz)
    return rx, ry, rz, (dl, dxx, dyy, dzz)


def _curve_bundle_test(o, d, t_max, rec, aux=None):
    """Test the WIDTH curve spans fused in a curve leaf record (tpurt's
    _curve_bundle_test, intersect.py:751-897; curve.cpp:139-374).

    Each span's 4 control points are projected into the per-(lane, span)
    ray frame (LookAt basis, curve.cpp:162-174), split into
    2^CURVE_LEAF_SUBDIV sub-segments by constant blossom weights, and
    each sub-segment runs the depth-0 width test (curve.cpp:289-373).
    o, d: (N, 3); t_max: (N,); rec: (N, 128); aux: (N, 64) ribbon rows or
    None.  Returns (hit, t, s, v) each (N, WIDTH): s is the span-local
    curve parameter, v the width coordinate.  NaN control-point pads
    never pass a comparison.  tpurt's documented deviation is kept:
    within one span the closest sub-segment hit wins (the reference keeps
    the last in u order)."""
    W_ = WIDTH
    w0 = rec[:, 12 * W_:13 * W_]
    w1 = rec[:, 13 * W_:14 * W_]
    rx, ry, rz, (dl, dxx, dyy, dzz) = _curve_project(o, d, rec)

    z_lim = dl * t_max[:, None]
    if aux is not None:
        n0x, n0y, n0z = aux[:, 0:W_], aux[:, W_:2 * W_], aux[:, 2 * W_:3 * W_]
        n1x, n1y, n1z = (aux[:, 3 * W_:4 * W_], aux[:, 4 * W_:5 * W_],
                         aux[:, 5 * W_:6 * W_])
        ang = aux[:, 6 * W_:7 * W_]
        inv_sin = aux[:, 7 * W_:8 * W_]
        has_n = (n0x * n0x + n0y * n0y + n0z * n0z) > 0.5

    t_best = torch.full_like(w0, INF)
    s_best = torch.zeros_like(w0)
    v_best = torch.zeros_like(w0)
    n_sub = CURVE_W.shape[0]
    for j in range(n_sub):
        wj = CURVE_W[j]
        a, b = j / n_sub, (j + 1) / n_sub
        sx = [sum(float(wj[k, m]) * rx[m] for m in range(4)) for k in range(4)]
        sy = [sum(float(wj[k, m]) * ry[m] for m in range(4)) for k in range(4)]
        sz = [sum(float(wj[k, m]) * rz[m] for m in range(4)) for k in range(4)]

        # endpoint tangent-perpendicular culling (curve.cpp:294-301)
        e_ok0 = (sy[1] - sy[0]) * (-sy[0]) + sx[0] * (sx[0] - sx[1]) >= 0
        e_ok1 = (sy[2] - sy[3]) * (-sy[3]) + sx[3] * (sx[3] - sx[2]) >= 0
        # closest-point parameter on the chord (curve.cpp:303-307)
        cdx = sx[3] - sx[0]
        cdy = sy[3] - sy[0]
        denom = cdx * cdx + cdy * cdy
        den_ok = denom > 0
        wp = -(sx[0] * cdx + sy[0] * cdy) / torch.where(den_ok, denom, 1.0)
        s = torch.clamp(a + (b - a) * wp, a, b)  # span-local u (clamped)
        hw = w0 + (w1 - w0) * s
        if aux is not None:
            # ribbon: width scaled by the slerped normal's projection on
            # the ray (curve.cpp:313-321)
            small = ang < 1e-4
            s0 = torch.where(small, 1.0 - s,
                             torch.sin((1.0 - s) * ang) * inv_sin)
            s1 = torch.where(small, s, torch.sin(s * ang) * inv_sin)
            nhx = s0 * n0x + s1 * n1x
            nhy = s0 * n0y + s1 * n1y
            nhz = s0 * n0z + s1 * n1z
            proj = (nhx * dxx + nhy * dyy + nhz * dzz).abs() / dl
            hw = torch.where(has_n, hw * proj, hw)

        # the sub-segment at clamp(wp, 0, 1), with its derivative
        ww = torch.clamp(wp, 0.0, 1.0)
        c1x = [sx[i] + ww * (sx[i + 1] - sx[i]) for i in range(3)]
        c1y = [sy[i] + ww * (sy[i + 1] - sy[i]) for i in range(3)]
        c1z = [sz[i] + ww * (sz[i + 1] - sz[i]) for i in range(3)]
        c2x = [c1x[i] + ww * (c1x[i + 1] - c1x[i]) for i in range(2)]
        c2y = [c1y[i] + ww * (c1y[i + 1] - c1y[i]) for i in range(2)]
        c2z = [c1z[i] + ww * (c1z[i + 1] - c1z[i]) for i in range(2)]
        pcx = c2x[0] + ww * (c2x[1] - c2x[0])
        pcy = c2y[0] + ww * (c2y[1] - c2y[0])
        pcz = c2z[0] + ww * (c2z[1] - c2z[0])
        dvx = c2x[1] - c2x[0]
        dvy = c2y[1] - c2y[0]
        dv0 = (dvx * dvx + dvy * dvy) == 0  # EvalBezier fallback (:71-77)
        dvx = torch.where(dv0, sx[3] - sx[0], dvx)
        dvy = torch.where(dv0, sy[3] - sy[0], dvy)

        dist2 = pcx * pcx + pcy * pcy
        ok = (e_ok0 & e_ok1 & den_ok & (dist2 <= hw * hw * 0.25)
              & (pcz > 0) & (pcz < z_lim))
        t_j = pcz / dl
        dist = _sqrt_ieee(dist2)
        edge_f = dvx * (-pcy) + pcx * dvy
        hwc = torch.clamp(hw, min=1e-20)
        v_j = torch.where(edge_f > 0, 0.5 + dist / hwc, 0.5 - dist / hwc)
        better = ok & (t_j < t_best)
        t_best = torch.where(better, t_j, t_best)
        s_best = torch.where(better, s, s_best)
        v_best = torch.where(better, v_j, v_best)
    return torch.isfinite(t_best), t_best, s_best, v_best


# the span cull's pads (curve_span_cull): the hull's, 2^6 ulps of the
# span's largest |coordinate| (2^-18) plus an absolute 2^-140 against
# subnormal sums; the radius's, a relative 2^-16 plus an absolute 2^-61
# against squares that underflow
CULL_HULL_REL = 2.0 ** -18
CULL_HULL_ABS = 2.0 ** -140
CULL_R_REL = 1.0 + 2.0 ** -16
CULL_R_ABS = 2.0 ** -61


def curve_span_cull(o, d, t_max, rec, aux=None):
    """(N, WIDTH) bool: the curve spans of each lane's leaf record that
    may hold a hit below t_max; _curve_bundle_test can hit no other.  The
    plain copy of the traversal kernel's span cull (K1c, traverse.cu:
    ``span_near``), op for op, and the test pbrt's recursiveIntersect makes
    before its depth-0 branch (curve.cpp): the hull of the span's 4
    projected control points against the disc the width can reach and
    against (0, z_lim).

    Why it never drops a hit: blossom weights are non-negative and sum to
    1, so each sub-segment's control points and the evaluated point pc lie
    in that hull; rounding moves pc out by at most ~20 ulps of the span's
    largest |coordinate| (4 products summed, 3 levels of lerps), and the
    hull is padded by 64.  The half-width is w0 + (w1 - w0) s with s in
    [0, 1], at most max(|w0|, |w1|) / 2 a few ulps over; a ribbon scales it
    by |nh . d| / |d| <= |s0| |n0| + |s1| |n1|, where |s0|, |s1| <= 1 on
    the linear branch (angle < 1e-4) and <= |1/sin(angle)| on the slerp.
    The radius is padded by 2^-16 relative and 2^-61 absolute, which covers
    dist^2 <= hw^2 / 4 rounding or underflowing.  pcz > 0 and pcz < z_lim
    cannot hold when the padded z range lies outside (0, z_lim).  A NaN
    anywhere (pad slots) fails every comparison: such a span never hits."""
    W_ = WIDTH
    w0 = rec[:, 12 * W_:13 * W_]
    w1 = rec[:, 13 * W_:14 * W_]
    rx, ry, rz, (dl, dxx, dyy, dzz) = _curve_project(o, d, rec)
    z_lim = dl * t_max[:, None]
    big = rx[0].abs()
    for v in rx[1:] + ry + rz:
        big = torch.maximum(big, v.abs())
    pad = big * CULL_HULL_REL + CULL_HULL_ABS

    def lo_hi(r):
        lo = torch.minimum(torch.minimum(r[0], r[1]),
                           torch.minimum(r[2], r[3]))
        hi = torch.maximum(torch.maximum(r[0], r[1]),
                           torch.maximum(r[2], r[3]))
        return lo - pad, hi + pad

    xlo, xhi = lo_hi(rx)
    ylo, yhi = lo_hi(ry)
    zlo, zhi = lo_hi(rz)
    zero = torch.zeros_like(xlo)
    gx = torch.maximum(torch.maximum(xlo, -xhi), zero)
    gy = torch.maximum(torch.maximum(ylo, -yhi), zero)
    half = torch.maximum(w0.abs(), w1.abs()) * 0.5
    if aux is not None:
        n0x, n0y, n0z = aux[:, 0:W_], aux[:, W_:2 * W_], aux[:, 2 * W_:3 * W_]
        n1x, n1y, n1z = (aux[:, 3 * W_:4 * W_], aux[:, 4 * W_:5 * W_],
                         aux[:, 5 * W_:6 * W_])
        ang = aux[:, 6 * W_:7 * W_]
        inv_sin = aux[:, 7 * W_:8 * W_]
        n0 = n0x * n0x + n0y * n0y + n0z * n0z
        n1 = n1x * n1x + n1y * n1y + n1z * n1z
        slerp = torch.where(ang < 1e-4, 1.0,
                            torch.maximum(inv_sin.abs(),
                                          torch.ones_like(inv_sin)))
        rib = (_sqrt_ieee(n0) + _sqrt_ieee(n1)) * slerp
        half = torch.where(n0 > 0.5, half * rib, half)
    rad = half * CULL_R_REL + CULL_R_ABS
    return ((gx <= rad) & (gy <= rad) & (gx * gx + gy * gy <= rad * rad)
            & (zhi > 0) & (zlo < z_lim))


# the motion group cull's pads (motion_group_cull): the box's, 2^12 ulps
# of the largest |coordinate| of the box and of the ray's origin, plus an
# absolute 2^-100 against zero and subnormal sums; its t limits' relative
# 2^-16 against the slab test's own rounding
MCULL_REL = 2.0 ** -12
MCULL_ABS = 2.0 ** -100
MCULL_T = 1.0 + 2.0 ** -16


def motion_group_cull(o, d, t_max, time, box):
    """(N, GROUPS) bool: the triangle groups of each lane's motion leaf
    that may hold a hit below t_max at the lane's time; the lerped
    _tri_bundle_test(..., drec, time) can hit in no other.  ``box``: the
    lanes' leaf box rows (N, MOTION_BOX) (``motion_group_boxes``).  The
    plain copy of the traversal kernel's group cull (K1m and K1km,
    traverse.cu: ``group_near``), op for op: the group's box lerped to
    the ray's time, padded, against the ray over (0, t_max].

    Why it never drops a group the twin hits:
      - the lerp: the box at time tau is lo = min v + min(tau min dv,
        tau max dv) (hi to match), rounded as the twin rounds v + tau dv.
        Rounding to nearest is monotone, so every lerped vertex the twin
        computes lies in [lo, hi] exactly, at any tau, inside [0, 1] or
        not (tpurt lerps by the raw shutter time);
      - the watertight test: it accepts a ray that passes at most a few
        ulps of |v - o| outside the triangle (the permuted vertices'
        differences and shear round once each, the edge functions'
        products and differences once more), and its t, which it keeps
        below t_max, lies the same few ulps of |v - o| along the ray from
        the point it meets.  |v - o| <= B, the largest |coordinate| of
        the lerped box plus that of o.  The pad, 2^12 ulps of B, covers
        both with a wide margin, so the point of the ray at the twin's t,
        or at t_max when that t rounds below it, lies inside the padded
        box; its slab interval then meets (0, t_max];
      - the slab test: each slab t rounds three times (the difference,
        1/d, the product), within gamma(3) of exact, and keeps the sign
        of the exact value; the far limit and t_max are scaled by
        1 + 2^-16 against it, and a ray that leaves the box at t = 0
        (t_far = 0) is kept;
      - a NaN (0 * inf of a zero direction component in the plane of a
        face) fails the comparisons that drop a group, so it keeps it.
    Groups of pads (NaN boxes) come back False; the kernel skips them
    before the cull, as the twin's NaN vertices never hit."""
    inv_d = safe_inv_dir(d)
    big_o = torch.maximum(torch.maximum(o[:, 0].abs(), o[:, 1].abs()),
                          o[:, 2].abs())
    tau = time[:, None]
    out = []
    for g in range(GROUPS):
        b = box[:, GROUP_BOX * g:GROUP_BOX * (g + 1)]
        t_lo, t_hi = tau * b[:, 6:9], tau * b[:, 9:12]
        lo = b[:, 0:3] + torch.minimum(t_lo, t_hi)
        hi = b[:, 3:6] + torch.maximum(t_lo, t_hi)
        big = torch.maximum(lo.abs().amax(dim=1), hi.abs().amax(dim=1))
        pad = ((big + big_o) * MCULL_REL + MCULL_ABS)[:, None]
        t0 = ((lo - pad) - o) * inv_d
        t1 = ((hi + pad) - o) * inv_d
        near = torch.minimum(t0, t1)
        far = torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                               near[:, 2])
        t_far = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                              far[:, 2])
        keep = ~((t_near > t_far * MCULL_T) | (t_far < 0)
                 | (t_near > t_max * MCULL_T))
        out.append(keep & ~torch.isnan(b[:, 0]))
    return torch.stack(out, dim=1)


def _box8_test(rec, o, inv_d, t_max):
    """Slab tests of the 8 child boxes in an interior record.
    Returns (hit, t_near) each (N, 8); NaN boxes (absent children) never
    hit: torch.minimum/maximum propagate NaN like jnp's."""
    W = WIDTH
    b = [rec[:, i * W:(i + 1) * W] for i in range(6)]  # lo xyz, hi xyz
    n = rec.shape[0]
    t_near = torch.full((n, W), -INF, dtype=rec.dtype, device=rec.device)
    t_far = torch.full((n, W), INF, dtype=rec.dtype, device=rec.device)
    for a in range(3):
        t0 = (b[a] - o[:, a:a + 1]) * inv_d[:, a:a + 1]
        t1 = (b[3 + a] - o[:, a:a + 1]) * inv_d[:, a:a + 1]
        t_near = torch.maximum(t_near, torch.minimum(t0, t1))
        t_far = torch.minimum(t_far, torch.maximum(t0, t1))
    t_far = t_far * _BOX_T_SCALE
    hit = (t_near <= t_far) & (t_far > 0) & (t_near < t_max[:, None])
    return hit, t_near


def safe_inv_dir(d):
    """1/d with signed infinities on zero components (intersect.py:1234)."""
    return torch.where(d != 0, 1.0 / d, torch.where(d >= 0, INF, -INF))


# ---------------------------------------------------------------------------
# quadrics (tpurt's ray_quadric)
# ---------------------------------------------------------------------------

def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _xform_point(m, p):
    return torch.stack([
        m[0, 0] * p[:, 0] + m[0, 1] * p[:, 1] + m[0, 2] * p[:, 2] + m[0, 3],
        m[1, 0] * p[:, 0] + m[1, 1] * p[:, 1] + m[1, 2] * p[:, 2] + m[1, 3],
        m[2, 0] * p[:, 0] + m[2, 1] * p[:, 1] + m[2, 2] * p[:, 2] + m[2, 3],
    ], dim=-1)


def _xform_vector(m, v):
    return torch.stack([
        m[0, 0] * v[:, 0] + m[0, 1] * v[:, 1] + m[0, 2] * v[:, 2],
        m[1, 0] * v[:, 0] + m[1, 1] * v[:, 1] + m[1, 2] * v[:, 2],
        m[2, 0] * v[:, 0] + m[2, 1] * v[:, 1] + m[2, 2] * v[:, 2],
    ], dim=-1)


def _veltkamp_split(x):
    """Exact f32 hi/lo split (Dekker): x == hi + lo."""
    c = 4097.0 * x  # 2^12 + 1
    hi = c - (c - x)
    return hi, x - hi


def _two_prod(x, y):
    """(p, e) with p = fl(x*y) and x*y == p + e exactly (Dekker)."""
    p = x * y
    xh, xl = _veltkamp_split(x)
    yh, yl = _veltkamp_split(y)
    e = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, e


def _disc_compensated(a, b, c):
    """b^2 - 4ac in double-float precision (intersect.py:412-431), so
    grazing sphere hits decide like the reference's double discriminant."""
    p1, e1 = _two_prod(b, b)
    p2, e2 = _two_prod(4.0 * a, c)
    s = p1 - p2
    bb = s - p1
    err = (p1 - (s - bb)) + ((-p2) - bb)
    comp = s + (err + (e1 - e2))
    thr = 8.0e34  # the Veltkamp split overflows past ~8.3e34
    huge = (b.abs() > thr) | ((4.0 * a).abs() > thr) | (c.abs() > thr)
    return torch.where(huge, b * b - 4.0 * a * c, comp)


def _quadratic(a, b, c):
    """Numerically stable quadratic; (has_roots, t0, t1), t0 <= t1."""
    return _roots_from_disc(a, b, _disc_compensated(a, b, c))


def _roots_from_disc(a, b, disc):
    ok = disc >= 0
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0, -0.5 * (b - sqrt_d), -0.5 * (b + sqrt_d))
    q = torch.where(q == 0, 1e-20, q)
    t0 = q / a
    t1 = ((b * b - disc) / (4.0 * a)) / q
    return ok, torch.minimum(t0, t1), torch.maximum(t0, t1)


def _phi(p):
    phi = torch.atan2(p[:, 1], p[:, 0])
    return torch.where(phi < 0, phi + 2 * np.pi, phi)


def _pick(has, t0, t1, ok0, ok1, *pairs):
    """The nearer root that passes its test: (hit, t, values...) for the
    (value at t0, value at t1) pairs."""
    use1 = ~ok0 & ok1
    hit = has & (ok0 | ok1)
    t = torch.where(use1, t1, t0)
    return (hit, t) + tuple(
        torch.where(use1[:, None] if a.dim() == 2 else use1, b, a)
        for a, b in pairs)


def _sphere(oo, od, t_max, params):
    radius, zmin, zmax, phimax = params[0], params[1], params[2], params[3]
    a = _dot3(od, od)
    b = 2.0 * _dot3(oo, od)
    c = _dot3(oo, oo) - radius * radius
    has, t0, t1 = _quadratic(a, b, c)
    full = (zmin <= -radius) & (zmax >= radius) & (phimax >= 2 * np.pi - 1e-6)

    def test(t):
        p = oo + t[:, None] * od
        # reproject for precision (pbrt refines pHit to the surface)
        p = p * (radius / torch.sqrt(_dot3(p, p)))[:, None]
        phi = _phi(p)
        ok = full | ((p[:, 2] >= zmin) & (p[:, 2] <= zmax) & (phi <= phimax))
        ok = ok & (t > 1e-7) & (t < t_max)
        return ok, p, phi

    ok0, p0, phi0 = test(t0)
    ok1, p1, phi1 = test(t1)
    hit, t, p, phi = _pick(has, t0, t1, ok0, ok1, (p0, p1), (phi0, phi1))
    u = phi / phimax
    zc = torch.clamp(p[:, 2] / radius, -1.0, 1.0)
    theta = torch.acos(zc)
    theta_min = torch.acos(torch.clamp(zmax / radius, -1, 1))
    theta_max = torch.acos(torch.clamp(zmin / radius, -1, 1))
    v = (theta - theta_min) / torch.clamp(theta_max - theta_min, min=1e-12)
    return hit, t, u, v


def _clip_phi_z(oo, od, t, t_max, zmin, zmax, phimax):
    p = oo + t[:, None] * od
    phi = _phi(p)
    ok = ((phi <= phimax) & (t > 0) & (t < t_max)
          & (p[:, 2] >= zmin) & (p[:, 2] <= zmax))
    return ok, p, phi


def _cylinder(oo, od, t_max, params):
    radius, zmin, zmax, phimax = params[0], params[1], params[2], params[3]
    a = od[:, 0] * od[:, 0] + od[:, 1] * od[:, 1]
    a = torch.where(a == 0, 1e-20, a)
    b = 2.0 * (oo[:, 0] * od[:, 0] + oo[:, 1] * od[:, 1])
    c = oo[:, 0] * oo[:, 0] + oo[:, 1] * oo[:, 1] - radius * radius
    has, t0, t1 = _quadratic(a, b, c)
    ok0, p0, phi0 = _clip_phi_z(oo, od, t0, t_max, zmin, zmax, phimax)
    ok1, p1, phi1 = _clip_phi_z(oo, od, t1, t_max, zmin, zmax, phimax)
    hit, t, p, phi = _pick(has, t0, t1, ok0, ok1, (p0, p1), (phi0, phi1))
    return (hit, t, phi / phimax,
            (p[:, 2] - zmin) / torch.clamp(zmax - zmin, min=1e-12))


def _disk(oo, od, t_max, params):
    radius, phimax = params[0], params[3]
    height, inner_r = params[4], params[5]
    t = (height - oo[:, 2]) / torch.where(od[:, 2] != 0, od[:, 2], 1e-20)
    p = oo + t[:, None] * od
    r2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
    phi = _phi(p)
    hit = ((od[:, 2] != 0) & (t > 1e-7) & (t < t_max)
           & (r2 <= radius * radius) & (r2 >= inner_r * inner_r)
           & (phi <= phimax))
    r_hit = torch.sqrt(torch.clamp(r2, min=0.0))
    return (hit, t, phi / phimax,
            (radius - r_hit) / torch.clamp(radius - inner_r, min=1e-12))


def _cone(oo, od, t_max, params):
    # x^2 + y^2 = ((h - z) r / h)^2, z in [0, h]; zmax holds h
    radius, h, phimax = params[0], params[2], params[3]
    rh = radius / h
    k = rh * rh
    dz = oo[:, 2] - h
    a = od[:, 0] * od[:, 0] + od[:, 1] * od[:, 1] - k * (od[:, 2] * od[:, 2])
    b = 2 * (oo[:, 0] * od[:, 0] + oo[:, 1] * od[:, 1] - k * od[:, 2] * dz)
    c = oo[:, 0] * oo[:, 0] + oo[:, 1] * oo[:, 1] - k * (dz * dz)
    has, t0, t1 = _quadratic(a, b, c)

    def test(t):
        p = oo + t[:, None] * od
        phi = _phi(p)
        ok = ((t > 1e-7) & (t < t_max) & (p[:, 2] >= 0) & (p[:, 2] <= h)
              & (phi <= phimax))
        return ok, p, phi

    ok0, p0, phi0 = test(t0)
    ok1, p1, phi1 = test(t1)
    hit, t, p, phi = _pick(has, t0, t1, ok0, ok1, (p0, p1), (phi0, phi1))
    return hit, t, phi / phimax, p[:, 2] / h


def _paraboloid(oo, od, t_max, params):
    # z = zmax * (x^2 + y^2) / r^2, z in [zmin, zmax]
    radius, zmin, zmax, phimax = params[0], params[1], params[2], params[3]
    k = zmax / (radius * radius)
    a = k * (od[:, 0] * od[:, 0] + od[:, 1] * od[:, 1])
    b = 2 * k * (oo[:, 0] * od[:, 0] + oo[:, 1] * od[:, 1]) - od[:, 2]
    c = k * (oo[:, 0] * oo[:, 0] + oo[:, 1] * oo[:, 1]) - oo[:, 2]
    has, t0, t1 = _quadratic(torch.where(a != 0, a, 1e-20), b, c)
    ok0, p0, phi0 = _clip_phi_z(oo, od, t0, t_max, zmin, zmax, phimax)
    ok1, p1, phi1 = _clip_phi_z(oo, od, t1, t_max, zmin, zmax, phimax)
    hit, t, p, phi = _pick(has, t0, t1, ok0, ok1, (p0, p1), (phi0, phi1))
    return (hit, t, phi / phimax,
            (p[:, 2] - zmin) / torch.clamp(zmax - zmin, min=1e-12))


def _hyperboloid(oo, od, t_max, params):
    # ah (x^2+y^2) - ch z^2 = 1 (hyperboloid.cpp:89-93), phi measured
    # against the z-interpolated profile point (:107-111)
    zmin, zmax, phimax = params[1], params[2], params[3]
    ah, ch = params[6], params[7]
    hp1, hp2 = params[8:11], params[11:14]
    a = (ah * (od[:, 0] * od[:, 0] + od[:, 1] * od[:, 1])
         - ch * (od[:, 2] * od[:, 2]))
    b = 2.0 * (ah * (od[:, 0] * oo[:, 0] + od[:, 1] * oo[:, 1])
               - ch * od[:, 2] * oo[:, 2])
    c = (ah * (oo[:, 0] * oo[:, 0] + oo[:, 1] * oo[:, 1])
         - ch * (oo[:, 2] * oo[:, 2]) - 1.0)
    has, t0, t1 = _quadratic(torch.where(a != 0, a, 1e-20), b, c)
    dz = hp2[2] - hp1[2]
    dz = torch.where(dz.abs() > 1e-12, dz, 1e-12)

    def test(t):
        p = oo + t[:, None] * od
        vv = (p[:, 2] - hp1[2]) / dz
        pr = (1 - vv)[:, None] * hp1 + vv[:, None] * hp2
        phi = torch.atan2(pr[:, 0] * p[:, 1] - p[:, 0] * pr[:, 1],
                          p[:, 0] * pr[:, 0] + p[:, 1] * pr[:, 1])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        ok = ((t > 1e-7) & (t < t_max) & (p[:, 2] >= zmin)
              & (p[:, 2] <= zmax) & (phi <= phimax))
        return ok, phi, vv

    ok0, phi0, v0 = test(t0)
    ok1, phi1, v1 = test(t1)
    hit, t, phi, v = _pick(has, t0, t1, ok0, ok1, (phi0, phi1), (v0, v1))
    return hit, t, phi / phimax, v


_QUADRIC_TESTS = {PT_SPHERE: _sphere, PT_CYLINDER: _cylinder, PT_DISK: _disk,
                  PT_CONE: _cone, PT_PARABOLOID: _paraboloid,
                  PT_HYPERBOLOID: _hyperboloid}


def ray_quadric(o, d, t_max, kind: int, w2o, params):
    """tpurt's ray_quadric (intersect.py:451-617) for one quadric against
    (N,) rays, in its object space: ``kind`` a PT_* code of a quadric;
    w2o (4, 4), params (16,) = [radius, zmin, zmax, phimax, height,
    inner_r, ah, ch, p1 (3), p2 (3), ...].  Returns (hit, t, u, v) with
    t = inf where there is no hit."""
    oo = _xform_point(w2o, o)
    od = _xform_vector(w2o, d)
    hit, t, u, v = _QUADRIC_TESTS[kind](oo, od, t_max, params)
    return hit, torch.where(hit, t, INF), u, v


def interp_quad_transform(trs_pair, dt):
    """A decomposed TRS endpoint pair interpolated at per-lane dt
    (tpurt's interp_quad_transform, intersect.py:1293-1340;
    AnimatedTransform::Interpolate, transform.cpp:467-500).  trs_pair
    (2, 16) shared or (N, 2, 16) per-lane rows of [t (3), quat wxyz (4),
    S (9)]; dt (N,), the shutter time itself (tpurt's mesh-motion
    convention: TransformTimes is not applied).  Returns (o2w, w2o),
    each (N, 4, 4)."""
    dt = torch.clamp(dt, 0.0, 1.0)
    n = dt.shape[0]
    if trs_pair.dim() == 2:
        trs_pair = trs_pair.expand((n,) + tuple(trs_pair.shape))
    t0, t1 = trs_pair[:, 0, 0:3], trs_pair[:, 1, 0:3]
    q0, q1 = trs_pair[:, 0, 3:7], trs_pair[:, 1, 3:7]
    s0 = trs_pair[:, 0, 7:16].reshape(-1, 3, 3)
    s1 = trs_pair[:, 1, 7:16].reshape(-1, 3, 3)
    trans = (1 - dt)[:, None] * t0 + dt[:, None] * t1
    smat = (1 - dt)[:, None, None] * s0 + dt[:, None, None] * s1
    cos_t = (q0 * q1).sum(dim=-1)
    q1 = torch.where(cos_t[:, None] < 0, -q1, q1)
    r = slerp_rotation(q0, q1, cos_t.abs(), dt)
    rs = torch.einsum("nij,njk->nik", r, smat)
    o2w = torch.cat([rs, trans[:, :, None]], dim=-1)  # (N, 3, 4)
    # inverse: x_obj = S^-1 R^T (x - T)
    inv_rs = torch.einsum("nij,njk->nik", torch.linalg.inv(smat),
                          r.transpose(-1, -2))
    inv_t = -torch.einsum("nij,nj->ni", inv_rs, trans)
    w2o = torch.cat([inv_rs, inv_t[:, :, None]], dim=-1)
    pad = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=o2w.dtype,
                       device=o2w.device).expand(n, 1, 4)
    return torch.cat([o2w, pad], dim=1), torch.cat([w2o, pad], dim=1)


def _quadric_pass(geo: DeviceGeometry, o, d, t, prim, b0, b1, time=None):
    """Test every quadric against the whole wavefront (tpurt's
    _quadric_pass, intersect.py:1342-1381): one vectorized pass per
    quadric, outside the tree, by its kind.  An animated quadric
    (``geo.quad_animated``) is tested in its transform at each lane's
    ``time``; the host knows which quadrics move, so a static one pays
    nothing."""
    for q, (kind, qi) in enumerate(geo.quads):
        params = geo.quad_params[qi]
        if time is not None and geo.quad_trs is not None and (
                geo.quad_animated_host[qi]):
            _, w2o_t = interp_quad_transform(geo.quad_trs[qi], time)
            oo = matvec_lanes(w2o_t, o) + w2o_t[:, :3, 3]
            od = matvec_lanes(w2o_t, d)
            h, tq, u, v = _QUADRIC_TESTS[kind](oo, od, t, params)
            tq = torch.where(h, tq, INF)
        else:
            h, tq, u, v = ray_quadric(o, d, t, kind, geo.quad_w2o[qi],
                                      params)
        better = h & (tq < t)
        t = torch.where(better, tq, t)
        prim = torch.where(better, geo.n_tris + q, prim)
        b0 = torch.where(better, u, b0)
        b1 = torch.where(better, v, b1)
    return t, prim, b0, b1


def _curve_pass(geo: DeviceGeometry, o, d, t, prim, b0, b1, traverse):
    """The walk of the curve-span tree (tpurt's _curve_pass,
    intersect.py:1400-1408): the best t so far is its entry t_max, so
    farther subtrees are culled.  A curve hit's b0/b1 are (span-local s,
    width v)."""
    tc, pc, sc, vc = traverse(geo, o, d, t, any_hit=False, tree="curve")
    better = (pc >= 0) & (tc < t)
    return (torch.where(better, tc, t), torch.where(better, pc, prim),
            torch.where(better, sc, b0), torch.where(better, vc, b1))


def _lanes(t_max, o):
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    return t_max.expand(o.shape[0]).contiguous()


def intersect_closest(geo: DeviceGeometry, o, d, t_max, traverse,
                      time=None) -> Hit:
    """Closest hit for a wavefront: o, d (N, 3); t_max scalar or (N,).
    traverse is the BVH traversal (kernels.traverse.traverse_wide or its
    plain twin).  time (N,): each ray's shutter time, on scenes with
    motion (None on a static frame)."""
    o, d, t_max = o.contiguous(), d.contiguous(), _lanes(t_max, o)
    t, prim, b0, b1 = traverse(geo, o, d, t_max, any_hit=False, time=time)
    if geo.n_quads:
        t, prim, b0, b1 = _quadric_pass(geo, o, d, t, prim, b0, b1, time)
    if geo.n_curves:
        t, prim, b0, b1 = _curve_pass(geo, o, d, t, prim, b0, b1, traverse)
    return Hit(t=t, prim=torch.where(torch.isfinite(t), prim, -1), b0=b0,
               b1=b1)


def intersect_any(geo: DeviceGeometry, o, d, t_max, traverse, time=None):
    """Shadow-ray predicate: does anything lie along the ray before
    t_max?  (tpurt's intersect_any, intersect.py:1432-1450)"""
    o, d, t_max = o.contiguous(), d.contiguous(), _lanes(t_max, o)
    n = o.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    if geo.n_quads:
        inf = torch.full((n,), INF, dtype=torch.float32, device=o.device)
        zero = torch.zeros(n, dtype=torch.float32, device=o.device)
        tq, pq, _, _ = _quadric_pass(
            geo, o, d, inf,
            torch.full((n,), -1, dtype=torch.int32, device=o.device),
            zero, zero, time)
        occ = (pq >= 0) & (tq < t_max)
        # already-occluded lanes skip the tree walk (t_max = 0)
        t_max = torch.where(occ, 0.0, t_max)
    _, prim, _, _ = traverse(geo, o, d, t_max, any_hit=True, time=time)
    occ = occ | (prim >= 0)
    if geo.n_curves:
        t_max = torch.where(occ, 0.0, t_max)
        _, primc, _, _ = traverse(geo, o, d, t_max, any_hit=True,
                                  tree="curve")
        occ = occ | (primc >= 0)
    return occ
