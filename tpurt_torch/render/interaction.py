"""Surface interactions for triangles and quadrics (port of
tpurt/render/interaction.py: compute_interaction, offset_ray_origin).

One fused shading-row gather per lane; triangle and quadric attributes
are both computed and a select picks the live one, as in tpurt.  A
quadric's normal is its object-space gradient: only the gradients of the
quadric kinds the scene holds are computed.  With
``dpduv=True`` the interaction also carries the uv-parameterization
derivatives that bump mapping and texture filtering need; the
``tex_*`` fields are filled in by the integrator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpurt_torch.render.geometry_build import (
    FLAG_HAS_NORMALS,
    FLAG_HAS_UV,
    FLAG_REVERSE_ORIENTATION,
    FLAG_XFORM_SWAPS_HANDEDNESS,
    PT_CONE,
    PT_CYLINDER,
    PT_DISK,
    PT_HYPERBOLOID,
    PT_PARABOLOID,
    PT_SPHERE,
    PT_TRIANGLE,
)
from tpurt_torch.render.intersect import DeviceGeometry, Hit
from tpurt_torch.render.sampling_warps import (build_onb, cross, dot,
                                               face_forward, norm, normalize)

F32_EPS = float(np.float32(1e-12))


class SurfaceInteraction(NamedTuple):
    """(N,) SoA surface interaction."""

    p: torch.Tensor  # (N,3) hit point
    ng: torch.Tensor  # (N,3) geometric normal (oriented per pbrt rules)
    ns: torch.Tensor  # (N,3) shading normal
    uv: torch.Tensor  # (N,2)
    wo: torch.Tensor  # (N,3)
    material_id: torch.Tensor  # (N,) i32
    arealight_id: torch.Tensor  # (N,) i32
    prim: torch.Tensor  # (N,) i32
    valid: torch.Tensor  # (N,) bool
    # uv-parameterization derivatives (triangle.cpp:160-190); None unless
    # the scene needs them (bump mapping / texture filtering)
    dpdu: Optional[torch.Tensor] = None  # (N,3)
    dpdv: Optional[torch.Tensor] = None  # (N,3)
    # uv-space ray-footprint widths for MIP selection (None = top level)
    tex_wu: Optional[torch.Tensor] = None  # (N,)
    tex_wv: Optional[torch.Tensor] = None  # (N,)
    # uv-space screen-derivative vectors (du/dx, dv/dx) and (du/dy, dv/dy)
    # from camera ray differentials; imagemap lookups then use EWA
    tex_dst0: Optional[torch.Tensor] = None  # (N,2)
    tex_dst1: Optional[torch.Tensor] = None  # (N,2)


def compute_interaction(geo: DeviceGeometry, hit: Hit, o, d,
                        dpduv: bool = False) -> SurfaceInteraction:
    """Shading data for each lane from its Hit.  Invalid lanes get benign
    values (ns=+z) and valid=False."""
    n = hit.t.shape[0]
    prim = hit.prim.clamp(min=0).long()
    valid = hit.prim >= 0
    t = torch.where(valid, hit.t, 1.0)
    p_ray = o + t[:, None] * d

    rows = geo.shade_rows[prim]  # (N, 32): ONE fused row gather
    ints = rows[:, 0:7].contiguous().view(torch.int32)
    flags = ints[:, 0]
    ptype = ints[:, 1]
    material_id = ints[:, 2]
    arealight_id = ints[:, 3]
    is_tri = ptype == PT_TRIANGLE

    # --- triangle attributes ---
    v0 = rows[:, 7:10]
    v1 = rows[:, 10:13]
    v2 = rows[:, 13:16]
    n0 = rows[:, 16:19]
    n1 = rows[:, 19:22]
    n2 = rows[:, 22:25]
    b0 = hit.b0
    b1 = hit.b1
    b2 = 1.0 - b0 - b1
    p_tri = b0[:, None] * v0 + b1[:, None] * v1 + b2[:, None] * v2
    # geometric normal from the winding (triangle.cpp: dp02 x dp12)
    ng_tri = normalize(cross(v0 - v2, v1 - v2))
    has_n = (flags & FLAG_HAS_NORMALS) != 0
    ns_interp = b0[:, None] * n0 + b1[:, None] * n1 + b2[:, None] * n2
    ns_len = norm(ns_interp, keepdim=True)
    ns_ok = has_n & (ns_len[:, 0] > F32_EPS)
    ns_tri = torch.where(ns_ok[:, None],
                         ns_interp / torch.clamp(ns_len, min=F32_EPS), ng_tri)
    # orient ng toward ns when shading normals exist (triangle.cpp:438)
    ng_tri = torch.where(ns_ok[:, None], face_forward(ng_tri, ns_tri), ng_tri)
    has_uv = (flags & FLAG_HAS_UV) != 0
    uv0 = rows[:, 25:27]
    uv1 = rows[:, 27:29]
    uv2 = rows[:, 29:31]
    # default uvs (0,0),(1,0),(1,1) (triangle.cpp GetUVs)
    duv = torch.stack([b1 + b2, b2], dim=-1)
    uv_tri = torch.where(
        has_uv[:, None],
        b0[:, None] * uv0 + b1[:, None] * uv1 + b2[:, None] * uv2,
        duv,
    )

    # --- quadric attributes: normal from the object-space gradient
    # (interaction.py:151-208) ---
    w2o = rows[:, 7:19].reshape(n, 3, 4)
    x, y, z = p_ray[:, 0], p_ray[:, 1], p_ray[:, 2]
    p_obj = torch.stack([
        w2o[:, 0, 0] * x + w2o[:, 0, 1] * y + w2o[:, 0, 2] * z + w2o[:, 0, 3],
        w2o[:, 1, 0] * x + w2o[:, 1, 1] * y + w2o[:, 1, 2] * z + w2o[:, 1, 3],
        w2o[:, 2, 0] * x + w2o[:, 2, 1] * y + w2o[:, 2, 2] * z + w2o[:, 2, 3],
    ], dim=-1)
    gx, gy, gz = _quadric_gradient(
        p_obj, rows[:, 19:27], ptype,
        sorted({k for k, _q in geo.quads}) or [PT_SPHERE])
    # normals transform by the inverse transpose: n' = n @ w2o
    ng_sph = normalize(torch.stack([
        w2o[:, 0, 0] * gx + w2o[:, 1, 0] * gy + w2o[:, 2, 0] * gz,
        w2o[:, 0, 1] * gx + w2o[:, 1, 1] * gy + w2o[:, 2, 1] * gz,
        w2o[:, 0, 2] * gx + w2o[:, 1, 2] * gy + w2o[:, 2, 2] * gz,
    ], dim=-1))
    uv_sph = torch.stack([hit.b0, hit.b1], dim=-1)

    p = torch.where(is_tri[:, None], p_tri, p_ray)
    ng = torch.where(is_tri[:, None], ng_tri, ng_sph)
    ns = torch.where(is_tri[:, None], ns_tri, ng_sph)
    uv = torch.where(is_tri[:, None], uv_tri, uv_sph)

    # reverse orientation ^ transform swaps handedness flips both normals
    ro = (flags & FLAG_REVERSE_ORIENTATION) != 0
    sh = (flags & FLAG_XFORM_SWAPS_HANDEDNESS) != 0
    flip = (ro ^ sh)[:, None]
    ng = torch.where(flip, -ng, ng)
    ns = torch.where(flip, -ns, ns)

    wo = normalize(-d)
    safe = valid[:, None]
    up = torch.zeros_like(ng)
    up[:, 2] = 1.0
    dpdu = dpdv = None
    if dpduv:
        # triangle uv-parameterization derivatives (triangle.cpp:160-190);
        # the default uvs are (0,0),(1,0),(1,1)
        one = torch.ones_like(b0)
        duv02 = torch.where(has_uv[:, None], uv0 - uv2,
                            torch.stack([-one, -one], dim=-1))
        duv12 = torch.where(has_uv[:, None], uv1 - uv2,
                            torch.stack([0.0 * one, -one], dim=-1))
        dp02 = v0 - v2
        dp12 = v1 - v2
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        degen = det.abs() < 1e-9
        inv = 1.0 / torch.where(degen, 1.0, det)
        dpdu_t = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv[:, None]
        dpdv_t = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * inv[:, None]
        t_f, b_f = build_onb(ns)
        dpdu_t = torch.where(degen[:, None], t_f, dpdu_t)
        dpdv_t = torch.where(degen[:, None], b_f, dpdv_t)
        # quadrics: ONB tangents scaled by the local size so bump
        # displacement-to-size ratios stay sane (sphere dpdu ~ 2 pi r)
        r_q = torch.clamp(rows[:, 19], min=1e-3)
        dpdu_q = t_f * (2 * np.pi * r_q)[:, None]
        dpdv_q = b_f * (np.pi * r_q)[:, None]
        dpdu = torch.where(is_tri[:, None], dpdu_t, dpdu_q)
        dpdv = torch.where(is_tri[:, None], dpdv_t, dpdv_q)
    return SurfaceInteraction(
        p=torch.where(safe, p, 0.0),
        ng=torch.where(safe, ng, up),
        ns=torch.where(safe, ns, up),
        uv=torch.where(safe, uv, 0.0),
        wo=wo,
        material_id=torch.where(valid, material_id, -1),
        arealight_id=torch.where(valid, arealight_id, -1),
        prim=hit.prim,
        valid=valid,
        dpdu=dpdu,
        dpdv=dpdv,
    )


def _quadric_gradient(p_obj, params, ptype, kinds):
    """Object-space gradient (gx, gy, gz) of each lane's quadric, for the
    quadric kinds in ``kinds`` (interaction.py:182-206); a lane of another
    kind takes the last kind's."""
    px, py, pz = p_obj[:, 0], p_obj[:, 1], p_obj[:, 2]
    radius, zmax = params[:, 0], params[:, 2]

    def grad(kind):
        if kind == PT_SPHERE:
            return px, py, pz
        if kind == PT_CYLINDER:
            return px, py, torch.zeros_like(px)
        if kind == PT_DISK:
            zero = torch.zeros_like(px)
            return zero, zero, torch.ones_like(px)
        if kind == PT_CONE:
            h = torch.clamp(zmax, min=F32_EPS)
            rh = radius / h
            return px, py, (rh * rh) * (h - pz)
        if kind == PT_PARABOLOID:
            k2 = 2 * (zmax / torch.clamp(radius * radius, min=F32_EPS))
            return k2 * px, k2 * py, -torch.ones_like(px)
        assert kind == PT_HYPERBOLOID, kind
        ah2 = 2 * params[:, 6]
        return ah2 * px, ah2 * py, -2 * params[:, 7] * pz

    g = grad(kinds[-1])
    for kind in kinds[-2::-1]:
        m = ptype == kind
        g = tuple(torch.where(m, a, b) for a, b in zip(grad(kind), g))
    return g


def offset_ray_origin(p, ng, w):
    """Offset a spawned ray's origin along the geometric normal to escape
    self-intersection (magnitude-relative epsilon, as in tpurt)."""
    scale = torch.clamp(p.abs().amax(dim=-1), min=1.0)
    eps = (2e-4 * scale)[:, None]
    sign = torch.where(dot(ng, w)[:, None] >= 0, 1.0, -1.0)
    return p + sign * eps * ng
