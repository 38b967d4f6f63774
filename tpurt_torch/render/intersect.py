"""Geometry upload and ray queries (port of tpurt/render/intersect.py,
restricted to static scenes of triangles and the six quadrics).

The wide-BVH record table, the fused shading rows and the quadric tables
are built on the host exactly as tpurt builds them (the unchanged
``tpurt.geom.wbvh.build_wide_table`` over the unchanged
``tpurt.render.geometry_build`` flattening), then uploaded.  Triangles
are found by BVH traversal (``tpurt_torch.kernels.traverse``: a CUDA
kernel on CUDA tensors, its plain twin on CPU tensors); quadrics (sphere,
cylinder, disk, cone, paraboloid, hyperboloid) are tested outside the
tree in one vectorized pass per quadric, as in tpurt, each by the test of
its kind, which the host knows.

The traversal is an explicit argument of ``intersect_closest`` and
``intersect_any`` so a caller can run the whole renderer through either
implementation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.geom.wbvh import LEAF_K, SLOT_KIND, WIDTH, build_wide_table
from tpurt_torch.render.geometry_build import (PT_CONE, PT_CYLINDER, PT_DISK,
                                              PT_HYPERBOLOID, PT_PARABOLOID,
                                              PT_SPHERE, PT_TRIANGLE,
                                              GeometryArrays)

INF = float("inf")

# machine gamma for conservative box tests (pbrt gamma(3)), as in tpurt
_GAMMA3 = 3.0 * np.finfo(np.float32).eps * 0.5 / (1 - 3 * np.finfo(np.float32).eps * 0.5)
_BOX_T_SCALE = float(np.float32(1.0 + 2.0 * _GAMMA3))

# interior-record child slots and leaf-record prim slots (wbvh.py layout)
CHILD_LO = 6 * WIDTH
PRIM_LO = 9 * LEAF_K
# floats per row of the traversal kernel's packed interior table: the 56
# live slots of an interior record (48 bounds + 8 child references),
# padded to 256 B
INTERIOR_REC = 64


def derive_traversal_tables(wnodes: np.ndarray) -> dict:
    """The tables the CUDA traversal kernel reads, from the host record
    table ``wnodes`` (M, 128), which stays what the plain twin reads.

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
    return dict(inodes=inodes, leaves=leaves, root_ref=int(ref[0]),
                irow=irow, lrow=lrow)


@dataclasses.dataclass
class DeviceGeometry:
    """Device tables of a static scene of triangles and quadrics.

    wnodes (M, 128) f32: the wide-BVH record table (tpurt.geom.wbvh
        layout; slot 126 is the kind flag: 0 interior, 1 leaf).
    shade_rows (P, 32) f32: fused per-prim shading record
        [0] flags [1] ptype [2] material_id [3] arealight_id [4] quad_id
        [5] medium_inside [6] medium_outside (bitcast i32);
        triangles [7:16] v0,v1,v2 [16:25] n0,n1,n2 [25:31] uv0,uv1,uv2
        [31] face id (bitcast i32); quadrics [7:19] w2o rows 0..2,
        [19:27] params[0:8].
    prim_type, quad_id (P,) i32; quad_w2o (Q, 4, 4), quad_params (Q, 16)
        f32: the quadric tables (padding rows when the scene has none).
    wstack_depth: traversal stack slots (tpurt's power-of-two sizing).
    inodes, leaves, root_ref: the CUDA traversal kernel's tables, derived
        from wnodes at upload (``derive_traversal_tables``).
    quads: (prim type, quad_id) of each quadric prim in prim order, read
        on the host at upload, so each quadric's pass runs its own test.
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

    @property
    def device(self) -> torch.device:
        return self.wnodes.device

    @staticmethod
    def host_tables(g: GeometryArrays) -> dict:
        """numpy tables of the geometry (the host half of tpurt's
        DeviceGeometry.from_host, intersect.py:141-287); from_tables
        uploads them."""
        if g.has_motion or g.has_quad_motion:
            raise NotImplementedError("motion blur (animated shapes)")
        if g.n_curves:
            raise NotImplementedError('Shape "curve"')
        bad = set(np.unique(g.prim_type).tolist()) - {PT_TRIANGLE,
                                                      *_QUADRIC_TESTS}
        if bad:
            raise NotImplementedError(f"prim types {sorted(bad)}")
        if (g.medium_inside is not None and (g.medium_inside >= 0).any()) or (
                g.medium_outside is not None and (g.medium_outside >= 0).any()):
            raise NotImplementedError("MediumInterface (participating media)")
        if not (g.bvh.n_prims <= 1).all():
            raise ValueError("collapse expects 1-prim leaves")
        wnodes, _, wdepth = build_wide_table(g.bvh, g.tri_v0, g.tri_v1,
                                             g.tri_v2)
        # worst-case stack residency: (W-1) pushes per interior level
        need = max(8, (wdepth - 1) * (WIDTH - 1) + 2)
        sdepth = 8
        while sdepth < min(need, 192):
            sdepth *= 2

        p = len(g.prim_type)
        med = np.full(p, -1, np.int32)
        ints = np.stack([g.flags, g.prim_type, g.material_id,
                         g.arealight_id, g.quad_id, med, med],
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
        return dict(wnodes=wnodes, shade_rows=rows,
                    prim_type=g.prim_type.astype(np.int32),
                    quad_id=g.quad_id.astype(np.int32),
                    quad_w2o=g.quad_w2o.astype(np.float32),
                    quad_params=g.quad_params.astype(np.float32),
                    n_tris=int(g.n_tris), n_quads=int(g.n_quads),
                    wstack_depth=sdepth)

    @staticmethod
    def from_tables(tables: dict, device) -> "DeviceGeometry":
        trav = derive_traversal_tables(tables["wnodes"])
        nt, nq = tables["n_tris"], tables["n_quads"]
        quads = tuple((int(k), int(q)) for k, q in zip(
            tables["prim_type"][nt:nt + nq], tables["quad_id"][nt:nt + nq]))
        tables = dict(tables, inodes=trav["inodes"], leaves=trav["leaves"],
                      root_ref=trav["root_ref"], quads=quads)
        kw = {k: (torch.tensor(v, device=device)
                  if isinstance(v, np.ndarray) else v)
              for k, v in tables.items()}
        return DeviceGeometry(**kw)


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


def _tri_bundle_test(o, d, t_max, rec):
    """Watertight test of the LEAF_K triangles fused in a leaf record.
    o, d: (N, 3); t_max: (N,); rec: (N, 128).  Returns (hit, t, b0, b1)
    each (N, LEAF_K); NaN vertex pads never hit."""
    K = LEAF_K
    v = [rec[:, i * K:(i + 1) * K] for i in range(9)]  # v0x..v2z, (N, K)
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


def _quadric_pass(geo: DeviceGeometry, o, d, t, prim, b0, b1):
    """Test every quadric against the whole wavefront (tpurt's
    _quadric_pass, intersect.py:1342-1381): one vectorized pass per
    quadric, outside the tree, by its kind."""
    for q, (kind, qi) in enumerate(geo.quads):
        h, tq, u, v = ray_quadric(o, d, t, kind, geo.quad_w2o[qi],
                                  geo.quad_params[qi])
        better = h & (tq < t)
        t = torch.where(better, tq, t)
        prim = torch.where(better, geo.n_tris + q, prim)
        b0 = torch.where(better, u, b0)
        b1 = torch.where(better, v, b1)
    return t, prim, b0, b1


def _lanes(t_max, o):
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    return t_max.expand(o.shape[0]).contiguous()


def intersect_closest(geo: DeviceGeometry, o, d, t_max, traverse) -> Hit:
    """Closest hit for a wavefront: o, d (N, 3); t_max scalar or (N,).
    traverse is the BVH traversal (kernels.traverse.traverse_wide or its
    plain twin)."""
    o, d, t_max = o.contiguous(), d.contiguous(), _lanes(t_max, o)
    t, prim, b0, b1 = traverse(geo, o, d, t_max, any_hit=False)
    if geo.n_quads:
        t, prim, b0, b1 = _quadric_pass(geo, o, d, t, prim, b0, b1)
    return Hit(t=t, prim=torch.where(torch.isfinite(t), prim, -1), b0=b0,
               b1=b1)


def intersect_any(geo: DeviceGeometry, o, d, t_max, traverse):
    """Shadow-ray predicate: does anything lie along the ray before t_max?"""
    o, d, t_max = o.contiguous(), d.contiguous(), _lanes(t_max, o)
    n = o.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    if geo.n_quads:
        inf = torch.full((n,), INF, dtype=torch.float32, device=o.device)
        zero = torch.zeros(n, dtype=torch.float32, device=o.device)
        tq, pq, _, _ = _quadric_pass(
            geo, o, d, inf,
            torch.full((n,), -1, dtype=torch.int32, device=o.device),
            zero, zero)
        occ = (pq >= 0) & (tq < t_max)
        # already-occluded lanes skip the tree walk (t_max = 0)
        t_max = torch.where(occ, 0.0, t_max)
    _, prim, _, _ = traverse(geo, o, d, t_max, any_hit=True)
    return occ | (prim >= 0)
