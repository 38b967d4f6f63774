"""Flatten a SceneDescription's primitives into device SoA tensors + BVH.

This replaces the reference's Primitive/Aggregate object graph
(core/primitive.h:51-119, scene.h:50) with flat tables: one unified
primitive array (triangles + quadrics) reordered by the BVH build so leaf
references are contiguous, plus vertex-attribute pools for shading.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from tpurt_torch.geom.bvh import LinearBVH, build_bvh
from tpurt_torch.scene.records import (
    CurveRecord,
    PrimitiveRecord,
    QuadricRecord,
    SceneDescription,
    TriangleMeshRecord,
)

# primitive type codes
PT_TRIANGLE = 0
PT_SPHERE = 1
PT_CYLINDER = 2
PT_DISK = 3
PT_CONE = 4
PT_PARABOLOID = 5
PT_HYPERBOLOID = 6
PT_CURVE = 7

# Fixed subdivision depth of the device curve leaf test: each stored
# curve span is tested as 2^CURVE_LEAF_SUBDIV linear segments (the
# reference's depth-0 test, curve.cpp:289-373).  Build-time pre-splitting
# (geom/shapes._curve_records) guarantees every span's residual
# refinement depth fits this unroll, so total refinement >= the
# reference's width/20 criterion (curve.cpp:204-225).
CURVE_LEAF_SUBDIV = 3

# curve subtypes (CurveType, curve.h:51)
CURVE_FLAT = 0
CURVE_CYLINDER = 1
CURVE_RIBBON = 2
_QUADRIC_CODES = {
    "sphere": PT_SPHERE,
    "cylinder": PT_CYLINDER,
    "disk": PT_DISK,
    "cone": PT_CONE,
    "paraboloid": PT_PARABOLOID,
    "hyperboloid": PT_HYPERBOLOID,
}

# per-prim flag bits
FLAG_REVERSE_ORIENTATION = 1
FLAG_XFORM_SWAPS_HANDEDNESS = 2
FLAG_HAS_NORMALS = 4
FLAG_HAS_UV = 8
FLAG_HAS_TANGENTS = 16


@dataclasses.dataclass
class GeometryArrays:
    """Host numpy arrays describing all scene geometry.

    Primitive rows are ordered [triangles in BVH-leaf order, quadrics];
    the BVH (1 triangle per leaf) covers rows [0, n_tris)."""

    # BVH (SoA)
    bvh: LinearBVH
    # unified primitive table, already permuted into BVH leaf order
    prim_type: np.ndarray  # (P,) i32
    material_id: np.ndarray  # (P,) i32 (-1 = none)
    arealight_id: np.ndarray  # (P,) i32 (-1 = none)
    flags: np.ndarray  # (P,) i32
    # triangles: gathered vertices for intersection + attr indices for shading
    tri_v0: np.ndarray  # (P, 3) f32 (zeros for non-triangles)
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_vi: np.ndarray  # (P, 3) i32 into vertex pools
    vert_n: np.ndarray  # (V, 3) f32
    vert_uv: np.ndarray  # (V, 2) f32
    vert_s: np.ndarray  # (V, 3) f32 shading tangents
    # quadrics
    quad_id: np.ndarray  # (P,) i32 index into quadric tables (-1 for tris)
    quad_w2o: np.ndarray  # (Q, 4, 4) f32
    quad_o2w: np.ndarray  # (Q, 4, 4) f32
    quad_params: np.ndarray  # (Q, 16) f32: radius zmin zmax phimax height
    # inner_r ah ch p1(xyz) p2(xyz) pad pad (slots 6+ are hyperboloid-only)
    # world bounds
    world_lo: np.ndarray
    world_hi: np.ndarray
    # prim row layout
    n_tris: int = 0
    n_quads: int = 0
    # media interface per prim (-1 = vacuum)
    medium_inside: np.ndarray = None  # (P,) i32
    medium_outside: np.ndarray = None  # (P,) i32
    # per-triangle ptex face ids (triangle.cpp faceIndices; 0 default)
    face_id: np.ndarray = None  # (P,) i32
    # animated meshes (TransformedPrimitive analog): end-transform verts
    # and normals; equal to the start arrays for static prims
    tri_e0: np.ndarray = None  # (P, 3)
    tri_e1: np.ndarray = None
    tri_e2: np.ndarray = None
    vert_ne: np.ndarray = None  # (V, 3)
    has_motion: bool = False
    # animated quadrics (TransformedPrimitive over a quadric): start/end
    # o2w decomposed as T(3)+quat(4)+S(3x3 row-major 9) = 16 floats per
    # endpoint; None when no quadric animates
    quad_trs: np.ndarray = None  # (Q, 2, 16) f32
    quad_animated: np.ndarray = None  # (Q,) bool
    has_quad_motion: bool = False
    # ray-traced curve spans (prim rows [n_tris+n_quads, +n_curves), in
    # curve-BVH leaf order; table index = prim_row - n_tris - n_quads)
    n_curves: int = 0
    curve_cp: np.ndarray = None  # (C, 12) f32 world control points
    curve_w: np.ndarray = None  # (C, 2) f32 span-end widths
    curve_u: np.ndarray = None  # (C, 2) f32 span u-range in its segment
    curve_aux: np.ndarray = None  # (C, 8) f32 n0(3) n1(3) angle invSin
    curve_subtype: np.ndarray = None  # (C,) i32 CURVE_FLAT/CYLINDER/RIBBON
    curve_bvh: "LinearBVH" = None
    has_ribbons: bool = False

    @property
    def n_prims(self) -> int:
        return len(self.prim_type)


def quadric_bounds(q: QuadricRecord) -> Tuple[np.ndarray, np.ndarray]:
    """World-space bounds of a quadric: object bound corners through o2w
    (conservative, like shape.h WorldBound default)."""
    r = q.radius
    if q.kind == "sphere":
        ob_lo = np.array([-r, -r, q.z_min])
        ob_hi = np.array([r, r, q.z_max])
    elif q.kind == "cylinder":
        ob_lo = np.array([-r, -r, q.z_min])
        ob_hi = np.array([r, r, q.z_max])
    elif q.kind == "disk":
        ob_lo = np.array([-r, -r, q.height - 1e-4])
        ob_hi = np.array([r, r, q.height + 1e-4])
    elif q.kind == "cone":
        ob_lo = np.array([-r, -r, 0.0])
        ob_hi = np.array([r, r, q.z_max])
    elif q.kind == "paraboloid":
        ob_lo = np.array([-r, -r, q.z_min])
        ob_hi = np.array([r, r, q.z_max])
    elif q.kind == "hyperboloid":
        p1, p2 = q.p1, q.p2
        rr = max(np.hypot(*p1[:2]), np.hypot(*p2[:2]))
        ob_lo = np.array([-rr, -rr, min(p1[2], p2[2])])
        ob_hi = np.array([rr, rr, max(p1[2], p2[2])])
    else:
        raise ValueError(q.kind)
    corners = np.array([[ob_lo[i] if (k >> i) & 1 == 0 else ob_hi[i]
                         for i in range(3)] for k in range(8)])
    wc = q.object_to_world.apply_point(corners)
    return wc.min(axis=0), wc.max(axis=0)


def flatten_geometry(
    prims: List[PrimitiveRecord],
    material_index,  # callable: MaterialRecord|None -> int
    arealight_index,  # callable: (PrimitiveRecord, local_index) -> int
    max_prims_per_leaf: int = 4,
    split_method: str = "sah",
    medium_index=None,  # callable: medium name -> int (-1 vacuum)
) -> GeometryArrays:
    if medium_index is None:
        medium_index = lambda name: -1
    tri_v0, tri_v1, tri_v2, tri_vi = [], [], [], []
    tri_e0, tri_e1, tri_e2 = [], [], []  # end-transform verts (motion)
    prim_type, mat_id, al_id, flags, quad_id = [], [], [], [], []
    med_in, med_out, face_id = [], [], []
    vert_n, vert_uv, vert_s, vert_ne = [], [], [], []
    quads_w2o, quads_o2w, quads_params = [], [], []
    quads_trs, quads_anim = [], []
    curves_cp, curves_w, curves_u, curves_aux, curves_sub = [], [], [], [], []
    has_quad_motion = False
    blo, bhi = [], []
    vert_base = 0
    has_motion = False

    for prim in prims:
        m = material_index(prim.material)
        base_flags = (
            (FLAG_REVERSE_ORIENTATION if prim.reverse_orientation else 0)
            | (FLAG_XFORM_SWAPS_HANDEDNESS if prim.transform_swaps_handedness else 0)
        )
        mi_in = medium_index(prim.medium_inside)
        mi_out = medium_index(prim.medium_outside)
        shape = prim.shape
        if isinstance(shape, TriangleMeshRecord):
            V = shape.vertices
            I = shape.indices
            f = base_flags
            if shape.normals is not None:
                f |= FLAG_HAS_NORMALS
            if shape.uvs is not None:
                f |= FLAG_HAS_UV
            if shape.tangents is not None:
                f |= FLAG_HAS_TANGENTS
            v0, v1, v2 = V[I[:, 0]], V[I[:, 1]], V[I[:, 2]]
            tri_v0.append(v0)
            tri_v1.append(v1)
            tri_v2.append(v2)
            tri_vi.append(I + vert_base)
            n_tri = len(I)
            a = arealight_index(prim, None)
            # animated mesh: end-transform verts; bounds = motion union
            se = prim.shape_end
            if isinstance(se, TriangleMeshRecord):
                has_motion = True
                Ve = se.vertices
                e0, e1, e2 = Ve[I[:, 0]], Ve[I[:, 1]], Ve[I[:, 2]]
                ne = (se.normals if se.normals is not None
                      else np.zeros_like(Ve))
                if a >= 0:
                    import logging

                    logging.getLogger("tpurt.render").warning(
                        "area light on an animated shape samples the "
                        "start position only")
            else:
                e0, e1, e2 = v0, v1, v2
                ne = (shape.normals if shape.normals is not None
                      else np.zeros_like(V))
            tri_e0.append(e0)
            tri_e1.append(e1)
            tri_e2.append(e2)
            vert_ne.append(ne)
            prim_type.append(np.full(n_tri, PT_TRIANGLE, np.int32))
            mat_id.append(np.full(n_tri, m, np.int32))
            al_id.append(np.full(n_tri, a, np.int32))
            flags.append(np.full(n_tri, f, np.int32))
            quad_id.append(np.full(n_tri, -1, np.int32))
            med_in.append(np.full(n_tri, mi_in, np.int32))
            med_out.append(np.full(n_tri, mi_out, np.int32))
            face_id.append(shape.face_indices.astype(np.int32)
                           if shape.face_indices is not None
                           else np.zeros(n_tri, np.int32))
            lo0 = np.minimum(np.minimum(v0, v1), v2)
            hi0 = np.maximum(np.maximum(v0, v1), v2)
            lo1 = np.minimum(np.minimum(e0, e1), e2)
            hi1 = np.maximum(np.maximum(e0, e1), e2)
            blo.append(np.minimum(lo0, lo1))
            bhi.append(np.maximum(hi0, hi1))
            vert_n.append(shape.normals if shape.normals is not None
                          else np.zeros_like(V))
            vert_uv.append(shape.uvs if shape.uvs is not None
                           else np.zeros((len(V), 2), np.float32))
            vert_s.append(shape.tangents if shape.tangents is not None
                          else np.zeros_like(V))
            vert_base += len(V)
        elif isinstance(shape, QuadricRecord):
            qi = len(quads_w2o)
            quads_w2o.append(shape.object_to_world.m_inv.astype(np.float32))
            quads_o2w.append(shape.object_to_world.m.astype(np.float32))
            # animated quadric: decompose both endpoint transforms
            # (AnimatedTransform::Decompose, transform.cpp:412+); device
            # interpolation happens per lane at ray time
            from tpurt_torch.geom.transform import decompose_trs

            se_q = prim.shape_end
            if (isinstance(se_q, QuadricRecord) and not np.allclose(
                    se_q.object_to_world.m, shape.object_to_world.m)):
                has_quad_motion = True
                quads_anim.append(True)
                pair = []
                for tr in (shape.object_to_world.m,
                           se_q.object_to_world.m):
                    tt, qq, ss = decompose_trs(tr)
                    pair.append(np.concatenate(
                        [tt, qq, ss.reshape(-1)]).astype(np.float32))
                quads_trs.append(np.stack(pair))
                if arealight_index(prim, None) >= 0:
                    import logging

                    logging.getLogger("tpurt.render").warning(
                        "area light on an animated shape: the reference "
                        "ignores it (api.cpp:1371); sampling the start "
                        "position")
            else:
                quads_anim.append(False)
                tt, qq, ss = decompose_trs(shape.object_to_world.m)
                one = np.concatenate([tt, qq, ss.reshape(-1)]).astype(
                    np.float32)
                quads_trs.append(np.stack([one, one]))
            r = shape.radius
            zmin, zmax = min(shape.z_min, shape.z_max), max(shape.z_min, shape.z_max)
            if shape.kind == "sphere":
                zmin, zmax = np.clip([zmin, zmax], -r, r)
            params = np.zeros(16, np.float32)
            params[3] = np.deg2rad(np.clip(shape.phi_max, 0, 360))
            params[4] = shape.height
            params[5] = shape.inner_radius
            if shape.kind == "hyperboloid":
                # implicit coefficients ah, ch (hyperboloid.cpp:55-67)
                p1 = np.asarray(shape.p1, np.float64)
                p2 = np.asarray(shape.p2, np.float64)
                if p2[2] == 0.0:
                    p1, p2 = p2, p1
                pp = p1.copy()
                ah = np.inf
                for _ in range(64):
                    pp = pp + 2.0 * (p2 - p1)
                    xy1 = pp[0] ** 2 + pp[1] ** 2
                    xy2 = p2[0] ** 2 + p2[1] ** 2
                    den = 1 - (xy2 * pp[2] ** 2) / (xy1 * p2[2] ** 2)
                    ah = ((1.0 / xy1 - (pp[2] ** 2) / (xy1 * p2[2] ** 2))
                          / den if den != 0 else np.inf)
                    if np.isfinite(ah):
                        break
                ch = (ah * xy2 - 1) / (p2[2] ** 2)
                r = max(np.hypot(p1[0], p1[1]), np.hypot(p2[0], p2[1]))
                zmin, zmax = min(p1[2], p2[2]), max(p1[2], p2[2])
                params[6] = ah
                params[7] = ch
                params[8:11] = p1
                params[11:14] = p2
            params[0] = r
            params[1] = zmin
            params[2] = zmax
            quads_params.append(params)
            prim_type.append(np.array([_QUADRIC_CODES[shape.kind]], np.int32))
            mat_id.append(np.array([m], np.int32))
            al_id.append(np.array([arealight_index(prim, None)], np.int32))
            flags.append(np.array([base_flags], np.int32))
            quad_id.append(np.array([qi], np.int32))
            med_in.append(np.array([mi_in], np.int32))
            med_out.append(np.array([mi_out], np.int32))
            face_id.append(np.zeros(1, np.int32))
            tri_v0.append(np.full((1, 3), np.nan, np.float32))
            tri_v1.append(np.full((1, 3), np.nan, np.float32))
            tri_v2.append(np.full((1, 3), np.nan, np.float32))
            tri_e0.append(np.full((1, 3), np.nan, np.float32))
            tri_e1.append(np.full((1, 3), np.nan, np.float32))
            tri_e2.append(np.full((1, 3), np.nan, np.float32))
            tri_vi.append(np.zeros((1, 3), np.int64))
            qlo, qhi = quadric_bounds(shape)
            blo.append(qlo[None])
            bhi.append(qhi[None])
        elif isinstance(shape, CurveRecord):
            s = len(shape.cp)
            cp = shape.cp.astype(np.float32)  # (S, 4, 3)
            w = shape.width.astype(np.float32)  # (S, 2)
            curves_cp.append(cp.reshape(s, 12))
            curves_w.append(w)
            curves_u.append(shape.u.astype(np.float32))
            aux = np.zeros((s, 8), np.float32)
            sub = {"flat": CURVE_FLAT, "cylinder": CURVE_CYLINDER,
                   "ribbon": CURVE_RIBBON}[shape.ctype]
            if shape.ctype == "ribbon" and shape.normals is not None:
                n0 = shape.normals[:, 0]
                n1 = shape.normals[:, 1]
                aux[:, 0:3] = n0
                aux[:, 3:6] = n1
                cosang = np.clip(np.sum(n0 * n1, axis=-1), 0.0, 1.0)
                ang = np.arccos(cosang)
                aux[:, 6] = ang
                aux[:, 7] = 1.0 / np.maximum(np.sin(ang), 1e-8)
            curves_aux.append(aux)
            curves_sub.append(np.full(s, sub, np.int32))
            if prim.shape_end is not None:
                import logging

                logging.getLogger("tpurt.render").warning(
                    "animated transform on a ray-traced curve is not "
                    "supported; using the start transform")
            a = arealight_index(prim, None)
            if a >= 0:
                import logging

                logging.getLogger("tpurt.render").warning(
                    "area light on a curve shape is not sampled")
            prim_type.append(np.full(s, PT_CURVE, np.int32))
            mat_id.append(np.full(s, m, np.int32))
            al_id.append(np.full(s, -1, np.int32))
            flags.append(np.full(s, base_flags, np.int32))
            quad_id.append(np.full(s, -1, np.int32))
            med_in.append(np.full(s, mi_in, np.int32))
            med_out.append(np.full(s, mi_out, np.int32))
            face_id.append(np.zeros(s, np.int32))
            for tarr in (tri_v0, tri_v1, tri_v2, tri_e0, tri_e1, tri_e2):
                tarr.append(np.full((s, 3), np.nan, np.float32))
            tri_vi.append(np.zeros((s, 3), np.int64))
            # span bounds: cp hull expanded by max(width)/2
            # (Curve::ObjectBound, curve.cpp:124-136)
            half = 0.5 * w.max(axis=1)[:, None]
            blo.append(cp.min(axis=1) - half)
            bhi.append(cp.max(axis=1) + half)
        else:
            raise TypeError(f"unknown shape record {type(shape)}")

    if not prims:
        # Pad with one degenerate triangle (never hits: zero-area, and the
        # root node's bounds are impossible) so device gathers are never
        # taken from zero-sized arrays.
        prim_type.append(np.array([PT_TRIANGLE], np.int32))
        mat_id.append(np.array([-1], np.int32))
        al_id.append(np.array([-1], np.int32))
        flags.append(np.array([0], np.int32))
        quad_id.append(np.array([-1], np.int32))
        med_in.append(np.array([-1], np.int32))
        med_out.append(np.array([-1], np.int32))
        face_id.append(np.zeros(1, np.int32))
        for t in (tri_v0, tri_v1, tri_v2, tri_e0, tri_e1, tri_e2):
            t.append(np.full((1, 3), np.nan, np.float32))
        tri_vi.append(np.zeros((1, 3), np.int64))
        vert_n.append(np.zeros((1, 3), np.float32))
        vert_ne.append(np.zeros((1, 3), np.float32))
        vert_uv.append(np.zeros((1, 2), np.float32))
        vert_s.append(np.zeros((1, 3), np.float32))
        blo.append(np.zeros((1, 3)))
        bhi.append(np.zeros((1, 3)))

    cat = lambda xs, dt, shape2: (
        np.concatenate(xs).astype(dt) if xs else np.zeros(shape2, dt))
    prim_type = cat(prim_type, np.int32, (0,))
    mat_id = cat(mat_id, np.int32, (0,))
    al_id = cat(al_id, np.int32, (0,))
    flags = cat(flags, np.int32, (0,))
    quad_idx = cat(quad_id, np.int32, (0,))
    med_in = cat(med_in, np.int32, (0,))
    med_out = cat(med_out, np.int32, (0,))
    face_id = cat(face_id, np.int32, (0,))
    tri_v0 = cat(tri_v0, np.float32, (0, 3))
    tri_v1 = cat(tri_v1, np.float32, (0, 3))
    tri_v2 = cat(tri_v2, np.float32, (0, 3))
    tri_e0 = cat(tri_e0, np.float32, (0, 3))
    tri_e1 = cat(tri_e1, np.float32, (0, 3))
    tri_e2 = cat(tri_e2, np.float32, (0, 3))
    tri_vi = cat(tri_vi, np.int32, (0, 3))
    blo = cat(blo, np.float64, (0, 3))
    bhi = cat(bhi, np.float64, (0, 3))

    def _bucket(n: int, lo: int = 64) -> int:
        """Round up to a power of two (min ``lo``) so differently-sized
        scenes share array shapes — and therefore share XLA executables in
        the persistent compilation cache."""
        b = lo
        while b < n:
            b *= 2
        return b

    # The BVH covers TRIANGLES only, with exactly one prim per leaf (the
    # leaf triangle is fused into its node record for one-gather traversal
    # steps; intersect.py).  Quadrics are few and analytic: they are tested
    # in a vectorized gather-free pass outside the tree, as prim rows
    # appended after the triangles.
    all_rows = np.arange(len(prim_type))
    tri_rows = all_rows[prim_type == PT_TRIANGLE]
    quad_rows = all_rows[(prim_type != PT_TRIANGLE)
                         & (prim_type != PT_CURVE)]
    curve_rows = all_rows[prim_type == PT_CURVE]
    if len(tri_rows) == 0:
        # always have at least the degenerate triangle so the BVH exists
        prim_type = np.concatenate([prim_type, [PT_TRIANGLE]]).astype(np.int32)
        mat_id = np.concatenate([mat_id, [-1]]).astype(np.int32)
        al_id = np.concatenate([al_id, [-1]]).astype(np.int32)
        flags = np.concatenate([flags, [0]]).astype(np.int32)
        quad_idx = np.concatenate([quad_idx, [-1]]).astype(np.int32)
        med_in = np.concatenate([med_in, [-1]]).astype(np.int32)
        med_out = np.concatenate([med_out, [-1]]).astype(np.int32)
        face_id = np.concatenate([face_id, [0]]).astype(np.int32)
        tri_v0 = np.concatenate([tri_v0, np.full((1, 3), np.nan, np.float32)])
        tri_v1 = np.concatenate([tri_v1, np.full((1, 3), np.nan, np.float32)])
        tri_v2 = np.concatenate([tri_v2, np.full((1, 3), np.nan, np.float32)])
        tri_e0 = np.concatenate([tri_e0, np.full((1, 3), np.nan, np.float32)])
        tri_e1 = np.concatenate([tri_e1, np.full((1, 3), np.nan, np.float32)])
        tri_e2 = np.concatenate([tri_e2, np.full((1, 3), np.nan, np.float32)])
        tri_vi = np.concatenate([tri_vi, np.zeros((1, 3), np.int32)])
        blo = np.concatenate([blo, np.zeros((1, 3))])
        bhi = np.concatenate([bhi, np.zeros((1, 3))])
        tri_rows = np.array([len(prim_type) - 1])

    bvh = build_bvh(blo[tri_rows], bhi[tri_rows], 1, split_method)
    # Conservative f32 rounding so the flattened bounds always contain the
    # f64 build bounds.
    bvh.bounds_lo = np.nextafter(bvh.bounds_lo, -np.inf).astype(np.float32)
    bvh.bounds_hi = np.nextafter(bvh.bounds_hi, np.inf).astype(np.float32)

    # curve BVH over the curve spans (separate tree with its own packed
    # wide table; intersect.py runs it as a statically-gated second pass)
    n_curves = len(curve_rows)
    curve_bvh = None
    c_cp = c_w = c_u = c_aux = c_sub = None
    has_ribbons = False
    if n_curves:
        curve_bvh = build_bvh(blo[curve_rows], bhi[curve_rows], 1,
                              split_method)
        curve_bvh.bounds_lo = np.nextafter(
            curve_bvh.bounds_lo, -np.inf).astype(np.float32)
        curve_bvh.bounds_hi = np.nextafter(
            curve_bvh.bounds_hi, np.inf).astype(np.float32)
        corder = curve_bvh.prim_order
        c_cp = np.concatenate(curves_cp)[corder]
        c_w = np.concatenate(curves_w)[corder]
        c_u = np.concatenate(curves_u)[corder]
        c_aux = np.concatenate(curves_aux)[corder]
        c_sub = np.concatenate(curves_sub)[corder]
        has_ribbons = bool((c_sub == CURVE_RIBBON).any())
        curve_rows = curve_rows[corder]

    # final prim order: triangles in BVH leaf order, then quadrics, then
    # curves in curve-BVH leaf order
    perm = np.concatenate([tri_rows[bvh.prim_order], quad_rows,
                           curve_rows]).astype(np.int64)
    n_tris = len(tri_rows)
    n_quads = len(quad_rows)

    def pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
        if len(a) >= n:
            return a
        pad_shape = (n - len(a),) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])

    p_bucket = _bucket(len(perm))
    v_n = (cat(vert_n, np.float32, (0, 3)) if vert_n
           else np.zeros((1, 3), np.float32))
    v_uv = (cat(vert_uv, np.float32, (0, 2)) if vert_uv
            else np.zeros((1, 2), np.float32))
    v_s = (cat(vert_s, np.float32, (0, 3)) if vert_s
           else np.zeros((1, 3), np.float32))
    v_ne = (cat(vert_ne, np.float32, (0, 3)) if vert_ne
            else np.zeros((1, 3), np.float32))
    v_bucket = _bucket(len(v_n))
    # pad quadric tables with identity entries so gathers in the
    # (select-executed) quadric branch never index a zero-sized axis
    q_w2o = (np.stack(quads_w2o) if quads_w2o
             else np.eye(4, dtype=np.float32)[None])
    q_o2w = (np.stack(quads_o2w) if quads_o2w
             else np.eye(4, dtype=np.float32)[None])
    q_par = (np.stack(quads_params) if quads_params
             else np.ones((1, 16), np.float32))
    q_bucket = _bucket(len(q_w2o), lo=8)
    q_trs = (np.stack(quads_trs) if quads_trs
             else np.zeros((0, 2, 16), np.float32))
    q_anim = (np.asarray(quads_anim, bool) if quads_anim
              else np.zeros(0, bool))
    m_bucket = _bucket(bvh.n_nodes)
    # pad BVH with unreachable leaf nodes (nothing points at them)
    bvh.bounds_lo = pad_rows(bvh.bounds_lo, m_bucket)
    bvh.bounds_hi = pad_rows(bvh.bounds_hi, m_bucket, -1.0)
    bvh.right_child = pad_rows(bvh.right_child, m_bucket)
    bvh.prim_offset = pad_rows(bvh.prim_offset, m_bucket)
    bvh.n_prims = pad_rows(bvh.n_prims, m_bucket, 1)
    bvh.axis = pad_rows(bvh.axis, m_bucket)

    geo = GeometryArrays(
        bvh=bvh,
        prim_type=pad_rows(prim_type[perm], p_bucket, PT_TRIANGLE),
        material_id=pad_rows(mat_id[perm], p_bucket, -1),
        arealight_id=pad_rows(al_id[perm], p_bucket, -1),
        flags=pad_rows(flags[perm], p_bucket),
        tri_v0=pad_rows(tri_v0[perm], p_bucket, np.nan),
        tri_v1=pad_rows(tri_v1[perm], p_bucket, np.nan),
        tri_v2=pad_rows(tri_v2[perm], p_bucket, np.nan),
        tri_vi=pad_rows(tri_vi[perm], p_bucket),
        vert_n=pad_rows(v_n, v_bucket),
        vert_uv=pad_rows(v_uv, v_bucket),
        vert_s=pad_rows(v_s, v_bucket),
        vert_ne=pad_rows(v_ne, v_bucket),
        tri_e0=pad_rows(tri_e0[perm], p_bucket, np.nan),
        tri_e1=pad_rows(tri_e1[perm], p_bucket, np.nan),
        tri_e2=pad_rows(tri_e2[perm], p_bucket, np.nan),
        has_motion=has_motion,
        medium_inside=pad_rows(med_in[perm], p_bucket, -1),
        medium_outside=pad_rows(med_out[perm], p_bucket, -1),
        face_id=pad_rows(face_id[perm], p_bucket),
        quad_id=pad_rows(quad_idx[perm], p_bucket, -1),
        quad_w2o=pad_rows(q_w2o, q_bucket),
        quad_o2w=pad_rows(q_o2w, q_bucket),
        quad_params=pad_rows(q_par, q_bucket, 1.0),
        quad_trs=pad_rows(q_trs, q_bucket) if has_quad_motion else None,
        quad_animated=(pad_rows(q_anim, q_bucket)
                       if has_quad_motion else None),
        has_quad_motion=has_quad_motion,
        world_lo=(blo.min(axis=0) if len(blo) else np.zeros(3)),
        world_hi=(bhi.max(axis=0) if len(bhi) else np.zeros(3)),
        n_tris=n_tris,
        n_quads=n_quads,
        n_curves=n_curves,
        curve_cp=c_cp,
        curve_w=c_w,
        curve_u=c_u,
        curve_aux=c_aux,
        curve_subtype=c_sub,
        curve_bvh=curve_bvh,
        has_ribbons=has_ribbons,
    )
    return geo
