"""Lights: point, spot and distant lights and sphere/triangle area lights
(port of tpurt/render/lights.py: the host half of build_light_table, the spatial
light distribution, choose_light, sample_li and pdf_li_from_hit).

Like the reference (api.cpp:1330-1400), every emissive primitive is its
own area light.  Per-lane lookups read ONE fused light row:
  [0] kind, [1:4] L, [4:7] p0, [7:10] p1, [10:14] params
  (cosTotal, cosFalloff, radius, two_sided), [14:23] tri v0/v1/v2,
  [23] prim  (kind/prim as exact small-int f32).
Spot lights keep their axis in p1 and (cosTotal, cosFalloff) in params;
distant lights keep their direction in p0.  Infinite, projection and
goniometric lights raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from tpurt_torch.render.geometry_build import PT_SPHERE, PT_TRIANGLE, GeometryArrays
from tpurt_torch.scene.records import LightRecord
from tpurt_torch.render.sampling_warps import (
    build_onb, cross, dot, norm, normalize, to_world, uniform_cone_pdf,
    uniform_sample_cone, uniform_sample_sphere, uniform_sample_triangle)

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA_TRI = 3
LIGHT_AREA_SPHERE = 4


@dataclasses.dataclass
class LightTable:
    rows: torch.Tensor  # (L, 24) fused per-light rows (layout above)
    prim_to_light: torch.Tensor  # (P,) i32: light row per primitive (-1)
    power_pmf: torch.Tensor  # (L,) light-choice pmf ("power" strategy)
    power_cdf: torch.Tensor  # (L,)
    spat_cdf: torch.Tensor  # (V, L+1) per-voxel light CDFs (V=1: off)
    spat_pmf: torch.Tensor  # (V, L)
    spat_lo: torch.Tensor  # (3,) world bounds for the voxel lookup
    spat_inv_extent: torch.Tensor  # (3,)
    spat_res: int  # voxels per axis (1 = fall back to the power pmf)
    n_lights: int
    world_radius: float  # scene bound radius (distant-light shadow rays)


def light_tables(scene_lights: List[LightRecord], geo: GeometryArrays,
                 area_records: List) -> dict:
    """Host tables of the light set: explicit point lights + one area
    light per emissive primitive (BVH order).  area_records is indexed by
    arealight_id: (L(3,), scale(3,), two_sided)."""
    kinds, Ls, p0s, p1s, params, tv0, tv1, tv2, prim_ids = (
        [] for _ in range(9))
    center = 0.5 * (geo.world_lo + geo.world_hi)
    world_radius = float(np.linalg.norm(geo.world_hi - center)) or 1.0

    def add(kind, L, p0=(0, 0, 0), p1=(0, 0, 1), par=(0, 0, 0, 0),
            v0=(0, 0, 0), v1=(0, 0, 0), v2=(0, 0, 0), prim=-1):
        kinds.append(kind)
        Ls.append(np.asarray(L, np.float64) * np.ones(3))
        p0s.append(np.asarray(p0, np.float64))
        p1s.append(np.asarray(p1, np.float64))
        params.append(np.asarray(par, np.float64))
        tv0.append(np.asarray(v0, np.float64))
        tv1.append(np.asarray(v1, np.float64))
        tv2.append(np.asarray(v2, np.float64))
        prim_ids.append(prim)

    for lr in scene_lights:
        ps = lr.params
        l2w = lr.light_to_world
        scale = ps.find_one_spectrum("scale", 1.0)
        if lr.kind == "point":
            intensity = ps.find_one_spectrum("I", 1.0) * scale
            frm = l2w.apply_point(ps.find_one_point3("from", [0, 0, 0]))
            add(LIGHT_POINT, intensity, p0=frm)
        elif lr.kind == "spot":
            intensity = ps.find_one_spectrum("I", 1.0) * scale
            cone = ps.find_one_float("coneangle", 30.0)
            delta = ps.find_one_float("conedeltaangle", 5.0)
            wfrm = l2w.apply_point(ps.find_one_point3("from", [0, 0, 0]))
            wto = l2w.apply_point(ps.find_one_point3("to", [0, 0, 1]))
            axis = wto - wfrm
            axis = axis / np.linalg.norm(axis)
            add(LIGHT_SPOT, intensity, p0=wfrm, p1=axis,
                par=(np.cos(np.deg2rad(cone)),
                     np.cos(np.deg2rad(cone - delta)), 0, 0))
        elif lr.kind == "distant":
            L = ps.find_one_spectrum("L", 1.0) * scale
            frm = l2w.apply_point(ps.find_one_point3("from", [0, 0, 0]))
            to = l2w.apply_point(ps.find_one_point3("to", [0, 0, 1]))
            w = frm - to
            add(LIGHT_DISTANT, L, p0=w / np.linalg.norm(w))
        else:
            raise NotImplementedError(f'LightSource "{lr.kind}"')

    prim_to_light = np.full(geo.n_prims, -1, np.int32)
    for row in range(geo.n_prims):
        al = geo.arealight_id[row]
        if al < 0:
            continue
        L = np.asarray(area_records[al][0]) * np.asarray(area_records[al][1])
        two_sided = float(area_records[al][2])
        if geo.prim_type[row] == PT_TRIANGLE:
            add(LIGHT_AREA_TRI, L,
                v0=geo.tri_v0[row], v1=geo.tri_v1[row], v2=geo.tri_v2[row],
                par=(0, 0, 0, two_sided), prim=row)
        elif geo.prim_type[row] == PT_SPHERE:
            qi = geo.quad_id[row]
            add(LIGHT_AREA_SPHERE, L, p0=geo.quad_o2w[qi][:3, 3],
                par=(0, 0, geo.quad_params[qi][0], two_sided), prim=row)
        else:
            raise NotImplementedError(
                f"area light on shape type {int(geo.prim_type[row])}")
        prim_to_light[row] = len(kinds) - 1

    n = len(kinds)
    if n == 0:
        add(LIGHT_POINT, [0.0, 0.0, 0.0])
        n = 1

    kind_a = np.asarray(kinds, np.int32)
    L_a = np.stack(Ls).astype(np.float32)
    # power pmf (lightdistrib "power"): ~ luminance * area factor
    power = L_a.mean(axis=-1).astype(np.float64).copy()
    for i in range(n):
        if kind_a[i] == LIGHT_AREA_TRI:
            e1 = tv1[i] - tv0[i]
            e2 = tv2[i] - tv0[i]
            power[i] *= 0.5 * np.linalg.norm(np.cross(e1, e2)) * np.pi
        elif kind_a[i] == LIGHT_AREA_SPHERE:
            power[i] *= 4 * np.pi * params[i][2] ** 2 * np.pi
    total = power.sum()
    pmf = (power / total) if total > 0 else np.full(n, 1.0 / n)
    spat = _spatial_distribution(kind_a, np.stack(p0s), power,
                                 np.asarray(geo.world_lo),
                                 np.asarray(geo.world_hi))
    rows = np.concatenate([
        kind_a.astype(np.float32)[:, None],
        L_a,
        np.stack(p0s).astype(np.float32),
        np.stack(p1s).astype(np.float32),
        np.stack(params).astype(np.float32)[:, :4],
        np.stack(tv0).astype(np.float32),
        np.stack(tv1).astype(np.float32),
        np.stack(tv2).astype(np.float32),
        np.asarray(prim_ids, np.float32)[:, None],
    ], axis=1)
    return dict(rows=rows, prim_to_light=prim_to_light,
                power_pmf=pmf.astype(np.float32),
                power_cdf=np.cumsum(pmf).astype(np.float32),
                spat_cdf=spat[0], spat_pmf=spat[1], spat_lo=spat[2],
                spat_inv_extent=spat[3], spat_res=spat[4], n_lights=n,
                world_radius=float(np.float32(world_radius)))


def light_table_from_tables(tab: dict, device) -> LightTable:
    return LightTable(**{k: (torch.tensor(v, device=device)
                             if isinstance(v, np.ndarray) else v)
                         for k, v in tab.items()})


def _spatial_distribution(kinds, positions, power, world_lo, world_hi,
                          res: int = 8, max_table: int = 1 << 22):
    """Per-voxel light-choice distributions over a res^3 grid
    (SpatialLightDistribution; tpurt's analytic power/distance^2 weight
    from the voxel center)."""
    n = len(kinds)
    if n <= 1 or n * res ** 3 > max_table:
        return (np.zeros((1, n + 1), np.float32), np.zeros((1, n), np.float32),
                np.zeros(3, np.float32), np.ones(3, np.float32), 1)
    lo = np.asarray(world_lo, np.float64)
    hi = np.asarray(world_hi, np.float64)
    extent = np.maximum(hi - lo, 1e-6)
    ax = (np.arange(res) + 0.5) / res
    cz, cy, cx = np.meshgrid(ax, ax, ax, indexing="ij")
    centers = np.stack([cx, cy, cz], -1).reshape(-1, 3) * extent + lo
    voxel_r2 = float(np.sum((extent / res / 2) ** 2))
    positional = np.isin(kinds, (LIGHT_POINT, LIGHT_SPOT, LIGHT_AREA_TRI,
                                 LIGHT_AREA_SPHERE))
    d2 = np.sum((centers[:, None, :] - positions[None, :, :]) ** 2, -1)
    w = np.where(positional[None, :],
                 power[None, :] / np.maximum(d2, voxel_r2),
                 power[None, :] / max(np.sum(extent ** 2), 1e-6))
    w = np.maximum(w, 0.0)
    tot = w.sum(axis=1, keepdims=True)
    pmf = np.where(tot > 0, w / np.where(tot == 0, 1, tot), 1.0 / n)
    cdf = np.zeros((len(centers), n + 1))
    cdf[:, 1:] = np.cumsum(pmf, axis=1)
    return (cdf.astype(np.float32), pmf.astype(np.float32),
            lo.astype(np.float32), (1.0 / extent).astype(np.float32), res)


def _voxel(lt: LightTable, p):
    res = lt.spat_res
    v = torch.clamp(((p - lt.spat_lo) * lt.spat_inv_extent * res)
                    .to(torch.int64), 0, res - 1)
    return (v[:, 2] * res + v[:, 1]) * res + v[:, 0]


def choose_light(lt: LightTable, u, strategy: str = "uniform", p=None):
    """Light selection (lightdistrib.h strategies uniform / power /
    spatial).  Returns (idx (N,) int64, pmf (N,))."""
    n = lt.n_lights
    if strategy == "uniform" or n == 1:
        idx = torch.clamp((u * n).to(torch.int64), max=n - 1)
        return idx, torch.full(u.shape, 1.0 / n, dtype=torch.float32,
                               device=u.device)
    if strategy == "spatial" and lt.spat_res > 1 and p is not None:
        vox = _voxel(lt, p)
        rows_cdf = lt.spat_cdf[vox]  # (N, L+1)
        idx = torch.searchsorted(rows_cdf, u[:, None].contiguous(),
                                 right=True)[:, 0] - 1
        idx = torch.clamp(idx, 0, n - 1)
        return idx, lt.spat_pmf[vox, idx]
    # power: CDF inversion
    idx = torch.clamp(torch.searchsorted(lt.power_cdf, u.contiguous(),
                                         right=True), max=n - 1)
    return idx, lt.power_pmf[idx]


def choice_pmf_at(lt: LightTable, lrow, strategy: str, n: int, ref_p=None):
    """pmf of having chosen light row lrow from ref_p (the integrator's
    _choice_pmf_at)."""
    if strategy == "spatial" and lt.spat_res > 1 and ref_p is not None:
        return lt.spat_pmf[_voxel(lt, ref_p), lrow]
    if strategy in ("power", "spatial"):
        return lt.power_pmf[lrow]
    return torch.full((n,), 1.0 / lt.n_lights, dtype=torch.float32,
                      device=lt.rows.device)


class LightSample(NamedTuple):
    wi: torch.Tensor  # (N,3)
    li: torch.Tensor  # (N,3) incident radiance (no visibility)
    pdf: torch.Tensor  # (N,) solid-angle pdf w.r.t. the chosen light
    p_light: torch.Tensor  # (N,3) point on light (for the shadow ray)
    is_delta: torch.Tensor  # (N,) bool


def sample_li(lt: LightTable, idx, ref_p, u2) -> LightSample:
    """Batched Sample_Li for the chosen lights (masked over types)."""
    row = lt.rows[idx]  # ONE fused row gather
    kind = row[:, 0].to(torch.int32)
    L = row[:, 1:4]
    p0 = row[:, 4:7]
    p1 = row[:, 7:10]
    par = row[:, 10:14]
    u, v = u2[:, 0], u2[:, 1]

    # --- point / spot ---
    to_l = p0 - ref_p
    dist2 = torch.clamp(dot(to_l, to_l), min=1e-12)
    wi_point = to_l / torch.sqrt(dist2)[:, None]
    li_point = L / dist2[:, None]
    # spot falloff (spot.cpp Falloff)
    cos_t = dot(-wi_point, p1)
    cos_total, cos_fall = par[:, 0], par[:, 1]
    delta = torch.clamp((cos_t - cos_total)
                        / torch.clamp(cos_fall - cos_total, min=1e-6),
                        0.0, 1.0)
    d2 = delta * delta
    falloff = torch.where(cos_t < cos_total, 0.0,
                          torch.where(cos_t > cos_fall, 1.0, d2 * d2))
    li_spot = li_point * falloff[:, None]

    # --- distant (the shadow ray ends outside the scene bound) ---
    wi_dist = p0
    p_dist = ref_p + wi_dist * (2.0 * lt.world_radius)

    # --- area triangle (uniform by area; triangle.cpp Sample) ---
    b0, b1 = uniform_sample_triangle(u, v)
    tv0, tv1, tv2 = row[:, 14:17], row[:, 17:20], row[:, 20:23]
    p_tri = (b0[:, None] * tv0 + b1[:, None] * tv1
             + (1 - b0 - b1)[:, None] * tv2)
    n_tri = cross(tv1 - tv0, tv2 - tv0)
    area_tri = 0.5 * norm(n_tri)
    n_tri = normalize(n_tri)
    to_tri = p_tri - ref_p
    d2_tri = torch.clamp(dot(to_tri, to_tri), min=1e-12)
    wi_tri = to_tri / torch.sqrt(d2_tri)[:, None]
    cos_l_tri = dot(n_tri, -wi_tri).abs()
    pdf_tri = d2_tri / torch.clamp(cos_l_tri * area_tri, min=1e-12)
    two_sided = par[:, 3] > 0
    emits_tri = two_sided | (dot(n_tri, -wi_tri) > 0)
    li_tri = torch.where(emits_tri[:, None], L, 0.0)

    # --- area sphere (cone sampling outside; sphere.cpp Sample(ref)) ---
    c = p0
    r = par[:, 2]
    to_c = c - ref_p
    dc2 = torch.clamp(dot(to_c, to_c), min=1e-12)
    dc = torch.sqrt(dc2)
    outside = dc2 > r * r * (1.0 + 1e-4)
    wz = to_c / dc[:, None]
    tx, ty = build_onb(wz)
    sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
    wi_cone_local = uniform_sample_cone(u, v, cos_max)
    wi_sph = to_world(tx, ty, wz, wi_cone_local)
    cos_theta = wi_cone_local[:, 2]
    ds = dc * cos_theta - torch.sqrt(torch.clamp(
        r * r - dc2 * (1.0 - cos_theta * cos_theta), min=0.0))
    p_sph = ref_p + ds[:, None] * wi_sph
    p_sph = c + r[:, None] * normalize(p_sph - c)  # snap to the surface
    pdf_sph_out = uniform_cone_pdf(cos_max)
    # inside: uniform over the sphere's area
    dir_in = uniform_sample_sphere(u, v)
    p_in = c + r[:, None] * dir_in
    to_in = p_in - ref_p
    d2_in = torch.clamp(dot(to_in, to_in), min=1e-12)
    wi_in = to_in / torch.sqrt(d2_in)[:, None]
    cos_in = dot(dir_in, -wi_in).abs()
    pdf_in = d2_in / torch.clamp(cos_in * 4 * np.pi * r * r, min=1e-12)
    wi_sphere = torch.where(outside[:, None], wi_sph, wi_in)
    p_sphere = torch.where(outside[:, None], p_sph, p_in)
    pdf_sphere = torch.where(outside, pdf_sph_out, pdf_in)
    n_sphere = normalize(p_sphere - c)
    emits_sph = (par[:, 3] > 0) | (dot(n_sphere, -wi_sphere) > 0)
    li_sphere = torch.where(emits_sph[:, None], L, 0.0)

    is_spot = (kind == LIGHT_SPOT)[:, None]
    is_pt = (kind == LIGHT_POINT)[:, None] | is_spot
    is_dist = (kind == LIGHT_DISTANT)[:, None]
    is_tri = (kind == LIGHT_AREA_TRI)[:, None]
    wi = torch.where(is_pt, wi_point, torch.where(
        is_dist, wi_dist, torch.where(is_tri, wi_tri, wi_sphere)))
    li = torch.where(is_spot, li_spot, torch.where(
        is_pt, li_point, torch.where(
            is_dist, L, torch.where(is_tri, li_tri, li_sphere))))
    pdf = torch.where(kind == LIGHT_AREA_TRI, pdf_tri,
                      torch.where(kind == LIGHT_AREA_SPHERE, pdf_sphere, 1.0))
    p_light = torch.where(is_pt, p0, torch.where(
        is_dist, p_dist, torch.where(is_tri, p_tri, p_sphere)))
    return LightSample(wi=wi, li=li, pdf=pdf, p_light=p_light,
                       is_delta=(is_pt | is_dist)[:, 0])


def pdf_li_from_hit(lt: LightTable, light_idx, ref_p, wi, p_hit, ng_hit):
    """Solid-angle pdf that Sample_Li would have generated wi from ref_p,
    for the MIS weight when a BSDF-sampled ray lands on a light."""
    row = lt.rows[light_idx]
    kind = row[:, 0].to(torch.int32)
    par = row[:, 10:14]
    to_hit = p_hit - ref_p
    d2 = torch.clamp(dot(to_hit, to_hit), min=1e-12)
    cos_l = dot(ng_hit, -wi).abs()
    # triangle: area pdf -> solid angle
    tv0, tv1, tv2 = row[:, 14:17], row[:, 17:20], row[:, 20:23]
    area_tri = 0.5 * norm(cross(tv1 - tv0, tv2 - tv0))
    pdf_tri = d2 / torch.clamp(cos_l * area_tri, min=1e-12)
    # sphere: cone pdf from ref (outside) or area pdf (inside)
    c = row[:, 4:7]
    r = par[:, 2]
    to_c = c - ref_p
    dc2 = torch.clamp(dot(to_c, to_c), min=1e-12)
    outside = dc2 > r * r * (1.0 + 1e-4)
    sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
    pdf_sph = torch.where(
        outside, uniform_cone_pdf(cos_max),
        d2 / torch.clamp(cos_l * 4 * np.pi * r * r, min=1e-12))
    return torch.where(kind == LIGHT_AREA_TRI, pdf_tri,
                       torch.where(kind == LIGHT_AREA_SPHERE, pdf_sph, 0.0))
