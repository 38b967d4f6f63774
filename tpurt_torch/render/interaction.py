"""Surface interactions for triangles, quadrics and curves (port of
tpurt/render/interaction.py: compute_interaction, _curve_shading,
offset_ray_origin).

One fused shading-row gather per lane; triangle, quadric and curve
attributes are computed and a select picks the live one, as in tpurt.  A
quadric's normal is its object-space gradient: only the gradients of the
quadric kinds the scene holds are computed.  On a scene with motion the
triangle's vertices and normals are lerped to the ray's time and an
animated quadric's frame is interpolated; the curve terms run only on a
scene with curves.  With ``tangents=True`` the interaction carries the
shading tangent ``ss`` (mesh ``"vector S"`` or a curve's dpdu) that the
BSDF frame aligns to; with ``dpduv=True`` the uv-parameterization
derivatives that bump mapping and texture filtering need; with
``faces=True`` the triangle's Ptex face index.  The ``tex_*`` fields are
filled in by the integrator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpurt_torch.render.geometry_build import (
    CURVE_CYLINDER,
    CURVE_RIBBON,
    FLAG_HAS_NORMALS,
    FLAG_HAS_TANGENTS,
    FLAG_HAS_UV,
    FLAG_REVERSE_ORIENTATION,
    FLAG_XFORM_SWAPS_HANDEDNESS,
    PT_CONE,
    PT_CURVE,
    PT_CYLINDER,
    PT_DISK,
    PT_HYPERBOLOID,
    PT_PARABOLOID,
    PT_SPHERE,
    PT_TRIANGLE,
)
from tpurt_torch.render.intersect import (DeviceGeometry, Hit,
                                          interp_quad_transform)
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
    # shading tangent (dpdu analog): None unless the scene carries mesh
    # tangents or curves; the BSDF frame then aligns to it
    ss: Optional[torch.Tensor] = None  # (N,3)
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
    # the hit prim's MediumInterface (-1: none) from the shade row; None
    # unless asked for (compute_interaction's ``media``)
    med_in: Optional[torch.Tensor] = None  # (N,) i32
    med_out: Optional[torch.Tensor] = None  # (N,) i32
    # per-lane spawn-offset floor: a curve hit sits on the span's axis
    # plane with pError = 2 * hitWidth (curve.cpp:342); None without
    # curves
    p_eps: Optional[torch.Tensor] = None  # (N,)
    # the Ptex face of a triangle hit (triangle.cpp faceIndices; 0 on
    # other lanes); None unless asked for (compute_interaction's faces)
    face_index: Optional[torch.Tensor] = None  # (N,) i32


def compute_interaction(geo: DeviceGeometry, hit: Hit, o, d,
                        tangents: bool = False, dpduv: bool = False,
                        time=None, media: bool = False,
                        faces: bool = False) -> SurfaceInteraction:
    """Shading data for each lane from its Hit (tpurt's
    compute_interaction, interaction.py:77-310).  Invalid lanes get
    benign values (ns=+z) and valid=False.  time (N,): the rays' shutter
    times on a scene with motion, else None.  With ``media`` the
    interaction carries the prim's medium ids ``med_in`` and ``med_out``
    (-1 where the hit is invalid; tpurt's interaction.py:98-99, :306-307),
    which only a scene with media reads.  With ``faces`` it carries the
    triangle's face index, the bits of shade-row slot 31 (where a curve
    keeps its 1/sin; tpurt's interaction.py:101-104), which only a scene
    with a ptex texture reads."""
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
    if time is not None and geo.shade_delta is not None:
        drows = geo.shade_delta[prim]  # (N, 18)
        tt = time[:, None]
        v0 = v0 + tt * drows[:, 0:3]
        v1 = v1 + tt * drows[:, 3:6]
        v2 = v2 + tt * drows[:, 6:9]
        n0 = n0 + tt * drows[:, 9:12]
        n1 = n1 + tt * drows[:, 12:15]
        n2 = n2 + tt * drows[:, 15:18]
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
    if time is not None and geo.quad_trs is not None:
        qi = ints[:, 4].clamp(min=0).long()
        _, w2o_t = interp_quad_transform(geo.quad_trs[qi], time)
        w2o = torch.where(geo.quad_animated[qi][:, None, None],
                          w2o_t[:, :3, :], w2o)
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
    curve = p_eps = None
    if geo.n_curves:
        curve = _curve_shading(rows, hit, d)
        is_crv = ptype == PT_CURVE
        ng = torch.where(is_crv[:, None], curve["n"], ng)
        ns = torch.where(is_crv[:, None], curve["n"], ns)
        uv = torch.where(is_crv[:, None], curve["uv"], uv)
        p_eps = torch.where(is_crv & valid, curve["p_eps"], 0.0)

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
    ss = None
    if tangents:
        t_def, _ = build_onb(ns)
        ss = t_def
        if geo.shade_s is not None:
            has_s = (flags & FLAG_HAS_TANGENTS) != 0
            srow = geo.shade_s[prim]  # (N, 9) vi-resolved tangents
            s_interp = (b0[:, None] * srow[:, 0:3] + b1[:, None] * srow[:, 3:6]
                        + b2[:, None] * srow[:, 6:9])
            # orthogonalized against the shading normal
            s_perp = s_interp - (s_interp * ns).sum(dim=-1, keepdim=True) * ns
            s_len = norm(s_perp, keepdim=True)
            s_ok = has_s & is_tri & (s_len[:, 0] > 1e-6) & valid
            ss = torch.where(s_ok[:, None],
                             s_perp / torch.clamp(s_len, min=F32_EPS), t_def)
        if curve is not None:
            # curve lanes: the fiber tangent dpdu, orthogonalized vs ns
            ct = curve["dpdu"]
            ct = ct - (ct * ns).sum(dim=-1, keepdim=True) * ns
            ctl = norm(ct, keepdim=True)
            c_ok = is_crv & valid & (ctl[:, 0] > 1e-9)
            ss = torch.where(c_ok[:, None],
                             ct / torch.clamp(ctl, min=F32_EPS), ss)
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
        if curve is not None:
            dpdu = torch.where(is_crv[:, None], curve["dpdu"], dpdu)
            dpdv = torch.where(is_crv[:, None], curve["dpdv"], dpdv)
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
        ss=ss,
        dpdu=dpdu,
        dpdv=dpdv,
        p_eps=p_eps,
        med_in=torch.where(valid, ints[:, 5], -1) if media else None,
        med_out=torch.where(valid, ints[:, 6], -1) if media else None,
        face_index=(torch.where(is_tri & valid,
                                rows[:, 31].contiguous().view(torch.int32), 0)
                    if faces else None),
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


def _curve_shading(rows, hit, d):
    """Curve shading from the fused shade row and (s, v) = (hit.b0,
    hit.b1), the span-local parameter and width coordinate (tpurt's
    _curve_shading, interaction.py:316-414; the tail of
    Curve::recursiveIntersect, curve.cpp:309-369): dpdu from the Bezier
    derivative, dpdv by subtype, the normal normalize(dpdu x dpdv), uv and
    the spawn-offset floor.  The ray frame is rebuilt as the leaf test
    builds it."""
    n = rows.shape[0]
    s = hit.b0
    v = hit.b1
    cp = rows[:, 7:19].reshape(n, 4, 3)
    w0, w1 = rows[:, 19], rows[:, 20]
    u0, u1 = rows[:, 21], rows[:, 22]
    sub = rows[:, 23].contiguous().view(torch.int32)
    u_global = u0 + s * (u1 - u0)
    hw = w0 + (w1 - w0) * s

    # span Bezier derivative at s; EvalBezier's degenerate fallback
    ss_ = s[:, None]
    c1 = [cp[:, i] + ss_ * (cp[:, i + 1] - cp[:, i]) for i in range(3)]
    c2 = [c1[i] + ss_ * (c1[i + 1] - c1[i]) for i in range(2)]
    deriv = 3.0 * (c2[1] - c2[0])
    degen = (deriv * deriv).sum(dim=-1, keepdim=True) <= 0
    v30 = cp[:, 3] - cp[:, 0]
    deriv = torch.where(degen, v30, deriv)
    dpdu = deriv / torch.clamp(u1 - u0, min=1e-9)[:, None]

    # ray-plane frame (LookAt basis, curve.cpp:162-174)
    dhat = normalize(d)
    up = cross(d, v30)
    deg_up = (up * up).sum(dim=-1, keepdim=True) < 1e-18
    pick = (d[:, 0].abs() > d[:, 1].abs())[:, None]
    zeros = torch.zeros_like(d[:, 0:1])
    alt = torch.where(pick,
                      torch.cat([-d[:, 2:3], zeros, d[:, 0:1]], -1),
                      torch.cat([zeros, d[:, 2:3], -d[:, 1:2]], -1))
    up = torch.where(deg_up, alt, up)
    x_axis = normalize(cross(up, dhat))
    y_axis = cross(dhat, x_axis)

    # ribbon: the slerped frame normal scales the width and sets dpdv
    # (curve.cpp:313-321, :351-352)
    n0 = rows[:, 24:27]
    n1 = rows[:, 27:30]
    ang = rows[:, 30][:, None]
    inv_sin = rows[:, 31][:, None]
    small = ang < 1e-4
    s0 = torch.where(small, (1.0 - s)[:, None],
                     torch.sin((1.0 - s)[:, None] * ang) * inv_sin)
    s1 = torch.where(small, s[:, None],
                     torch.sin(s[:, None] * ang) * inv_sin)
    nhit = s0 * n0 + s1 * n1
    hw_rib = hw * (nhit * dhat).sum(dim=-1).abs()
    dpdv_rib = normalize(cross(nhit, dpdu)) * hw_rib[:, None]

    # flat / cylinder: dpdv perpendicular to dpdu in the ray plane, rotated
    # for the cylinder's appearance (curve.cpp:354-365)
    dpu_x = (dpdu * x_axis).sum(dim=-1)
    dpu_y = (dpdu * y_axis).sum(dim=-1)
    dpu_z = (dpdu * dhat).sum(dim=-1)
    pl = torch.clamp(torch.sqrt(dpu_x * dpu_x + dpu_y * dpu_y), min=1e-12)
    dvx = -dpu_y / pl * hw
    dvy = dpu_x / pl * hw
    dvz = torch.zeros_like(dvx)
    # cylinder: Rodrigues rotation of (dvx, dvy, 0) about dpdu by -theta,
    # theta = Lerp(v, -90, 90) degrees (curve.cpp:359-363)
    theta = torch.deg2rad(-90.0 + v * 180.0)
    phi = -theta
    al = torch.clamp(torch.sqrt(dpu_x ** 2 + dpu_y ** 2 + dpu_z ** 2),
                     min=1e-12)
    ax, ay, az = dpu_x / al, dpu_y / al, dpu_z / al
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    adw = ax * dvx + ay * dvy  # a . w (dvz = 0)
    rx = dvx * cphi + (ay * dvz - az * dvy) * sphi + ax * adw * (1 - cphi)
    ry = dvy * cphi + (az * dvx - ax * dvz) * sphi + ay * adw * (1 - cphi)
    rz = dvz * cphi + (ax * dvy - ay * dvx) * sphi + az * adw * (1 - cphi)
    is_cyl = sub == CURVE_CYLINDER
    pvx = torch.where(is_cyl, rx, dvx)
    pvy = torch.where(is_cyl, ry, dvy)
    pvz = torch.where(is_cyl, rz, dvz)
    dpdv_fc = (pvx[:, None] * x_axis + pvy[:, None] * y_axis
               + pvz[:, None] * dhat)
    is_rib = sub == CURVE_RIBBON
    dpdv = torch.where(is_rib[:, None], dpdv_rib, dpdv_fc)
    nrm = normalize(cross(dpdu, dpdv))
    # spawn-offset magnitude: OffsetRayOrigin's Dot(Abs(n), pError) with
    # pError = (2 * hitWidth,) * 3 (interaction.h:51, curve.cpp:342);
    # ribbons use the projected width
    hw_eff = torch.where(is_rib, hw_rib, hw)
    p_eps = 2.0 * hw_eff * nrm.abs().sum(dim=-1)
    return dict(n=nrm, uv=torch.stack([u_global, v], dim=-1), dpdu=dpdu,
                dpdv=dpdv, p_eps=p_eps)


def offset_ray_origin(p, ng, w, eps_min=None):
    """Offset a spawned ray's origin along the geometric normal to escape
    self-intersection (magnitude-relative epsilon, as in tpurt).
    eps_min (N,), when given, floors the offset: a curve hit sits on the
    span's axis plane and needs pError = 2 * hitWidth (si.p_eps)."""
    scale = torch.clamp(p.abs().amax(dim=-1), min=1.0)
    eps = (2e-4 * scale)[:, None]
    if eps_min is not None:
        eps = torch.maximum(eps, eps_min[:, None])
    sign = torch.where(dot(ng, w)[:, None] >= 0, 1.0, -1.0)
    return p + sign * eps * ng
