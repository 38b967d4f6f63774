"""Lights: point, spot, distant, infinite (constant or environment-mapped),
projection and goniometric lights and sphere/triangle area lights (port
of tpurt/render/lights.py: the host half of build_light_table with the
environment distribution and the pooled light maps, the spatial light
distribution, choose_light, sample_li, pdf_li_from_hit and the
environment map's env_sample / env_pdf / env_le).

Like the reference (api.cpp:1330-1400), every emissive primitive is its
own area light.  Per-lane lookups read ONE fused light row:
  [0] kind, [1:4] L, [4:7] p0, [7:10] p1, [10:14] params
  (cosTotal, cosFalloff, radius, two_sided), [14:23] tri v0/v1/v2,
  [23] prim  (kind/prim as exact small-int f32).
Spot lights keep their axis in p1 and (cosTotal, cosFalloff) in params;
distant lights keep their direction in p0; projection and goniometric
lights keep their position in p0, their world-to-light matrix in ``w2l``
and their image in the flat ``img_pool``.  As in tpurt, one infinite light
with a map is importance-sampled (the first); a second map is rendered as
its mean radiance.  The terms of a light kind the scene lacks are not
computed (``has_infinite``, ``has_projection``, ``has_gonio``).

Emission sampling for the bidirectional integrators (tpurt's LeSample,
sample_le, pdf_le and light_normal_at, lights.py:806-983): tpurt's
sample_le has no branch of its own for projection and goniometric lights,
so their origin, direction and normal fall into the infinite light's
branch and their direction pdf into the area lights' cosine one.  The
port copies that on purpose (ROADMAP, Queue 3); it is not pbrt's
behaviour.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, NamedTuple

import numpy as np
import torch

from tpurt_torch.io.image import read_image
from tpurt_torch.render.geometry_build import PT_SPHERE, PT_TRIANGLE, GeometryArrays
from tpurt_torch.scene.records import LightRecord
from tpurt_torch.render.sampling_warps import (
    build_onb, concentric_sample_disk, cosine_sample_hemisphere, cross, dot,
    norm, normalize, to_world, uniform_cone_pdf, uniform_sample_cone,
    uniform_sample_sphere, uniform_sample_triangle)

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA_TRI = 3
LIGHT_AREA_SPHERE = 4
LIGHT_INFINITE = 5
LIGHT_PROJECTION = 6
LIGHT_GONIO = 7

log = logging.getLogger("tpurt_torch.render")


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
    world_center: torch.Tensor  # (3,) scene bound centre (Sample_Le disks)
    # environment map of ONE infinite light (infinite.cpp): equirect
    # radiance and the 2D luminance * sin(theta) sampling distribution
    # (a 1x1 black map when absent)
    env_map: torch.Tensor  # (He, We, 3)
    env_cond_cdf: torch.Tensor  # (He, We+1) conditional CDFs over u
    env_cond_int: torch.Tensor  # (He,) row integrals
    env_marg_cdf: torch.Tensor  # (He+1,) marginal CDF over v
    env_w2l: torch.Tensor  # (4,4) world-to-light
    env_l2w: torch.Tensor  # (4,4)
    # projection / goniometric lights: pooled image pixels, per-light
    # offset and size, world-to-light matrix, projection constants
    img_pool: torch.Tensor  # (D,3)
    img_off: torch.Tensor  # (L,) i32 offset into img_pool
    img_wh: torch.Tensor  # (L,2) i32 (w, h); (0, 0) = no image
    w2l: torch.Tensor  # (L,4,4)
    proj: torch.Tensor  # (L,8) x0,y0,x1,y1,invTanAng,hither,cosTotal,_
    has_infinite: bool = False
    env_light_row: int = -1  # row of the importance-sampled infinite light
    # derived at upload (light_table_from_tables):
    has_projection: bool = False  # some light is a projection light
    has_gonio: bool = False  # some light is a goniometric light
    # the conditional CDFs as one sorted int64 key (_row_search): one
    # searchsorted over it inverts every lane's own row
    env_cdf_key: torch.Tensor = None  # (He * (We+1),) i64
    inf_L: torch.Tensor = None  # (3,) constant radiance of infinite lights
    inf_power_pmf: float = 0.0  # power pmf summed over the infinite lights


def light_tables(scene_lights: List[LightRecord], geo: GeometryArrays,
                 area_records: List) -> dict:
    """Host tables of the light set (tpurt's build_light_table,
    lights.py:123-377): explicit lights + one area light per emissive
    primitive (BVH order).  area_records is indexed by arealight_id:
    (L(3,), scale(3,), two_sided)."""
    kinds, Ls, p0s, p1s, params, tv0, tv1, tv2, prim_ids = (
        [] for _ in range(9))
    w2l_rows, proj_rows, img_rows = [], [], []
    center = 0.5 * (geo.world_lo + geo.world_hi)
    world_radius = float(np.linalg.norm(geo.world_hi - center)) or 1.0

    def add(kind, L, p0=(0, 0, 0), p1=(0, 0, 1), par=(0, 0, 0, 0),
            v0=(0, 0, 0), v1=(0, 0, 0), v2=(0, 0, 0), prim=-1, w2l=None,
            projp=None, img=None):
        kinds.append(kind)
        Ls.append(np.asarray(L, np.float64) * np.ones(3))
        p0s.append(np.asarray(p0, np.float64))
        p1s.append(np.asarray(p1, np.float64))
        params.append(np.asarray(par, np.float64))
        tv0.append(np.asarray(v0, np.float64))
        tv1.append(np.asarray(v1, np.float64))
        tv2.append(np.asarray(v2, np.float64))
        prim_ids.append(prim)
        w2l_rows.append(np.eye(4, dtype=np.float32) if w2l is None else w2l)
        proj_rows.append(np.zeros(8, np.float32) if projp is None
                         else np.asarray(projp, np.float32))
        img_rows.append(img)

    env_img = None
    env_w2l = np.eye(4, dtype=np.float32)
    env_l2w = np.eye(4, dtype=np.float32)
    env_row = -1
    has_infinite = False
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
        elif lr.kind in ("infinite", "exinfinite"):
            L = ps.find_one_spectrum("L", 1.0) * scale
            mapname = ps.find_one_filename("mapname", "")
            if mapname and env_img is None:
                try:
                    env_img = (read_image(mapname).astype(np.float64)
                               * L.reshape(1, 1, 3)).astype(np.float32)
                    env_w2l = l2w.m_inv.astype(np.float32)
                    env_l2w = l2w.m.astype(np.float32)
                    env_row = len(kinds)
                    L = env_img.reshape(-1, 3).mean(axis=0)  # for power pmf
                except (OSError, ValueError) as e:
                    log.error("infinite light map %s unreadable: %s",
                              mapname, e)
            elif mapname:
                log.warning("only one environment-mapped infinite light is "
                            "importance-sampled; %s uses its mean", mapname)
            add(LIGHT_INFINITE, L)
            has_infinite = True
        elif lr.kind in ("projection", "goniometric"):
            intensity = ps.find_one_spectrum("I", 1.0) * scale
            frm = l2w.apply_point([0, 0, 0])
            mapname = ps.find_one_filename("mapname", "")
            img = None
            if mapname:
                try:
                    img = np.asarray(read_image(mapname), np.float32)[..., :3]
                except (OSError, ValueError) as e:
                    log.error('%s light map "%s" unreadable: %s', lr.kind,
                              mapname, e)
            w2l_m = l2w.inverse().m.astype(np.float32)
            if lr.kind == "projection":
                # screen window + cone from the image aspect + fov
                # (projection.cpp:59-74)
                fov = ps.find_one_float("fov", 45.0)
                aspect = (img.shape[1] / img.shape[0] if img is not None
                          else 1.0)
                if aspect > 1:
                    x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
                else:
                    x0, x1, y0, y1 = -1.0, 1.0, -1 / aspect, 1 / aspect
                inv_tan = 1.0 / np.tan(np.deg2rad(fov) / 2)
                cos_total = 1.0 / np.sqrt((x1 / inv_tan) ** 2
                                          + (y1 / inv_tan) ** 2 + 1.0)
                add(LIGHT_PROJECTION, intensity, p0=frm, w2l=w2l_m, img=img,
                    projp=(x0, y0, x1, y1, inv_tan, 1e-3, cos_total, 0.0))
            else:
                add(LIGHT_GONIO, intensity, p0=frm, w2l=w2l_m, img=img)
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
        elif kind_a[i] == LIGHT_INFINITE:
            power[i] *= np.pi * world_radius ** 2
        elif kind_a[i] == LIGHT_PROJECTION:
            # I * avg(map) * 2pi(1 - cosTotalWidth) (projection.cpp Power)
            avg = img_rows[i].mean() if img_rows[i] is not None else 1.0
            power[i] *= avg * 2 * np.pi * (1.0 - proj_rows[i][6])
        elif kind_a[i] == LIGHT_GONIO:
            avg = img_rows[i].mean() if img_rows[i] is not None else 1.0
            power[i] *= avg * 4 * np.pi
    total = power.sum()
    pmf = (power / total) if total > 0 else np.full(n, 1.0 / n)

    if env_img is None:
        env_img = np.zeros((1, 1, 3), np.float32)
    cond_cdf, cond_int, marg_cdf = _build_env_distribution(env_img)
    # pool the projection / goniometric images into one flat pixel array
    img_off = np.zeros(n, np.int32)
    img_wh = np.zeros((n, 2), np.int32)
    pool_parts = []
    off = 0
    for i, im in enumerate(img_rows):
        if im is None:
            continue
        h, w = im.shape[:2]
        img_off[i] = off
        img_wh[i] = (w, h)
        pool_parts.append(im.reshape(-1, 3))
        off += h * w
    img_pool = (np.concatenate(pool_parts).astype(np.float32) if pool_parts
                else np.zeros((1, 3), np.float32))

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
                world_radius=float(np.float32(world_radius)),
                world_center=np.asarray(center, np.float32),
                env_map=env_img, env_cond_cdf=cond_cdf,
                env_cond_int=cond_int, env_marg_cdf=marg_cdf,
                env_w2l=env_w2l, env_l2w=env_l2w,
                img_pool=img_pool, img_off=img_off, img_wh=img_wh,
                w2l=np.stack(w2l_rows), proj=np.stack(proj_rows),
                has_infinite=has_infinite, env_light_row=env_row)


def light_table_from_tables(tab: dict, device) -> LightTable:
    """Upload the host tables, with what the device side derives from
    them: the environment CDF search key, the infinite lights' constant
    radiance (tpurt's _infinite_L, integrator.py:204-211, without the
    mapped light), their summed power pmf (the escaped-ray MIS pmf) and
    which image-lit kinds the table holds."""
    he = tab["env_cond_cdf"].shape[0]
    key = (np.arange(he, dtype=np.int64)[:, None] * (1 << 32)
           + _f32_key(tab["env_cond_cdf"])).reshape(-1)
    kind = tab["rows"][:, 0].astype(np.int32)
    inf_mask = kind == LIGHT_INFINITE
    if tab["env_light_row"] >= 0:
        inf_mask = inf_mask & (np.arange(len(kind)) != tab["env_light_row"])
    inf_L = np.where(inf_mask[:, None], tab["rows"][:, 1:4],
                     np.float32(0)).sum(axis=0, dtype=np.float32)
    inf_pmf = np.where(kind == LIGHT_INFINITE, tab["power_pmf"],
                       np.float32(0)).sum(dtype=np.float32)
    extra = dict(env_cdf_key=key, inf_L=inf_L, inf_power_pmf=float(inf_pmf),
                 has_projection=bool((kind == LIGHT_PROJECTION).any()),
                 has_gonio=bool((kind == LIGHT_GONIO).any()))
    return LightTable(**{k: (torch.tensor(v, device=device)
                             if isinstance(v, np.ndarray) else v)
                         for k, v in dict(tab, **extra).items()})


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


def _build_env_distribution(img: np.ndarray):
    """Distribution2D over luminance * sin(theta) (tpurt's
    _build_env_distribution, lights.py:413-435; infinite.cpp ctor +
    core/sampling.h Distribution2D)."""
    he, we = img.shape[:2]
    lum = (0.212671 * img[..., 0] + 0.715160 * img[..., 1]
           + 0.072169 * img[..., 2]).astype(np.float64)
    sin_t = np.sin(np.pi * (np.arange(he) + 0.5) / he)
    f = lum * sin_t[:, None]
    cond_int = f.sum(axis=1) / we
    cond_cdf = np.zeros((he, we + 1))
    cond_cdf[:, 1:] = np.cumsum(f, axis=1) / we
    safe = np.where(cond_int > 0, cond_int, 1.0)[:, None]
    cond_cdf = np.where(cond_int[:, None] > 0, cond_cdf / safe,
                        np.linspace(0, 1, we + 1)[None, :])
    marg_int = cond_int.sum() / he
    marg_cdf = np.zeros(he + 1)
    marg_cdf[1:] = np.cumsum(cond_int) / he
    marg_cdf = (marg_cdf / marg_int if marg_int > 0
                else np.linspace(0, 1, he + 1))
    return (cond_cdf.astype(np.float32), cond_int.astype(np.float32),
            marg_cdf.astype(np.float32))


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


def _pool_lookup(lt: LightTable, idx, s, t, valid):
    """Bilinear lookup of each lane's light image in the pooled pixels at
    (s, t) in [0,1]^2; 1 where the light has no image, 0 where not
    ``valid`` (lights.py:507-531)."""
    wh = lt.img_wh[idx]
    has_img = wh[:, 0] > 0
    fx = torch.clamp(s, 0.0, 1.0) * (wh[:, 0] - 1).to(torch.float32)
    fy = torch.clamp(t, 0.0, 1.0) * (wh[:, 1] - 1).to(torch.float32)
    x0 = torch.minimum(torch.clamp(fx.to(torch.int32), min=0),
                       torch.clamp(wh[:, 0] - 2, min=0))
    y0 = torch.minimum(torch.clamp(fy.to(torch.int32), min=0),
                       torch.clamp(wh[:, 1] - 2, min=0))
    dx = fx - x0
    dy = fy - y0
    base = lt.img_off[idx]

    def px(xx, yy):
        i = (base + torch.minimum(yy, wh[:, 1] - 1) * wh[:, 0]
             + torch.minimum(xx, wh[:, 0] - 1))
        return lt.img_pool[torch.clamp(i, 0, lt.img_pool.shape[0] - 1).long()]

    v = ((1 - dx)[:, None] * ((1 - dy)[:, None] * px(x0, y0)
                              + dy[:, None] * px(x0, y0 + 1))
         + dx[:, None] * ((1 - dy)[:, None] * px(x0 + 1, y0)
                          + dy[:, None] * px(x0 + 1, y0 + 1)))
    v = torch.where(has_img[:, None], v, 1.0)
    return torch.where(valid[:, None], v, 0.0)


def _lightmap_factor(lt: LightTable, idx, kind, wi_point):
    """Direction-dependent intensity scale of projection and goniometric
    lights toward -wi_point (projection.cpp Projection, goniometric.h
    Scale; lights.py:498-555); only the kinds the table holds."""
    w2l = lt.w2l[idx]
    w = -wi_point  # direction FROM the light
    wl = torch.einsum("nij,nj->ni", w2l[:, :3, :3], w)
    if not lt.has_gonio:
        return _projection_factor(lt, idx, wl)
    if not lt.has_projection:
        return _gonio_factor(lt, idx, wl)
    return torch.where((kind == LIGHT_PROJECTION)[:, None],
                       _projection_factor(lt, idx, wl),
                       _gonio_factor(lt, idx, wl))


def _projection_factor(lt: LightTable, idx, wl):
    """Projection light: perspective-project the light-space direction wl
    onto the screen window and look up the slide (projection.cpp)."""
    pr = lt.proj[idx]
    zc = torch.clamp(wl[:, 2], min=1e-12)
    sx = wl[:, 0] * pr[:, 4] / zc
    sy = wl[:, 1] * pr[:, 4] / zc
    in_front = wl[:, 2] >= pr[:, 5]
    inside = ((sx >= pr[:, 0]) & (sx <= pr[:, 2])
              & (sy >= pr[:, 1]) & (sy <= pr[:, 3]))
    s_p = (sx - pr[:, 0]) / torch.clamp(pr[:, 2] - pr[:, 0], min=1e-9)
    t_p = (sy - pr[:, 1]) / torch.clamp(pr[:, 3] - pr[:, 1], min=1e-9)
    return _pool_lookup(lt, idx, s_p, t_p, in_front & inside)


def _gonio_factor(lt: LightTable, idx, wl):
    """Goniometric light: spherical lookup of the light-space direction wl
    with the reference's y/z swap (goniometric.h Scale)."""
    wn = wl / torch.clamp(norm(wl, keepdim=True), min=1e-12)
    wx, wy, wz = wn[:, 0], wn[:, 2], wn[:, 1]
    theta = torch.acos(torch.clamp(wz, -1.0, 1.0))
    phi = torch.atan2(wy, wx)
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    return _pool_lookup(lt, idx, phi / (2 * np.pi), theta / np.pi,
                        torch.ones_like(phi, dtype=torch.bool))


def sample_li(lt: LightTable, idx, ref_p, u2) -> LightSample:
    """Batched Sample_Li for the chosen lights (masked over types;
    lights.py:472-653)."""
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
    is_spot = (kind == LIGHT_SPOT)[:, None]
    is_pt = (kind == LIGHT_POINT)[:, None] | is_spot
    if lt.has_projection or lt.has_gonio:
        # projection / goniometric: a delta position whose intensity
        # depends on the direction
        pg = (kind == LIGHT_PROJECTION)[:, None] | (kind == LIGHT_GONIO)[:, None]
        li_point = torch.where(
            pg, li_point * _lightmap_factor(lt, idx, kind, wi_point),
            li_point)
        is_pt = is_pt | pg

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
    pdf_rest = 1.0

    if lt.has_infinite:
        # --- infinite: the environment map's 2D-CDF importance sampling
        # when a map exists, else the uniform sphere over the constant
        # radiance (infinite.cpp Sample_Li) ---
        if lt.env_light_row >= 0:
            wi_inf, li_inf, pdf_inf = env_sample(lt, u, v)
        else:
            wi_inf = uniform_sample_sphere(u, v)
            pdf_inf = torch.full_like(u, 1.0 / (4 * np.pi))
            li_inf = L
        p_inf = ref_p + wi_inf * (2.0 * lt.world_radius)
        is_sph = (kind == LIGHT_AREA_SPHERE)[:, None]
        wi_sphere = torch.where(is_sph, wi_sphere, wi_inf)
        li_sphere = torch.where(is_sph, li_sphere, li_inf)
        p_sphere = torch.where(is_sph, p_sphere, p_inf)
        pdf_rest = torch.where(kind == LIGHT_INFINITE, pdf_inf, 1.0)

    is_dist = (kind == LIGHT_DISTANT)[:, None]
    is_tri = (kind == LIGHT_AREA_TRI)[:, None]
    wi = torch.where(is_pt, wi_point, torch.where(
        is_dist, wi_dist, torch.where(is_tri, wi_tri, wi_sphere)))
    li = torch.where(is_spot, li_spot, torch.where(
        is_pt, li_point, torch.where(
            is_dist, L, torch.where(is_tri, li_tri, li_sphere))))
    pdf = torch.where(kind == LIGHT_AREA_TRI, pdf_tri,
                      torch.where(kind == LIGHT_AREA_SPHERE, pdf_sphere,
                                  pdf_rest))
    p_light = torch.where(is_pt, p0, torch.where(
        is_dist, p_dist, torch.where(is_tri, p_tri, p_sphere)))
    return LightSample(wi=wi, li=li, pdf=pdf, p_light=p_light,
                       is_delta=(is_pt | is_dist)[:, 0])


def pdf_li_from_hit(lt: LightTable, light_idx, ref_p, wi, p_hit, ng_hit):
    """Solid-angle pdf that Sample_Li would have generated wi from ref_p,
    for the MIS weight when a BSDF-sampled ray lands on a light
    (lights.py:656-696)."""
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
    pdf_rest = 0.0
    if lt.has_infinite:
        pdf_inf = (env_pdf(lt, wi) if lt.env_light_row >= 0
                   else torch.full_like(d2, 1.0 / (4 * np.pi)))
        pdf_rest = torch.where(kind == LIGHT_INFINITE, pdf_inf, 0.0)
    return torch.where(kind == LIGHT_AREA_TRI, pdf_tri,
                       torch.where(kind == LIGHT_AREA_SPHERE, pdf_sph,
                                   pdf_rest))


# ---------------------------------------------------------------------------
# environment map (infinite.cpp): direction <-> (u,v), sampling, pdf, Le
# (lights.py:703-800)
# ---------------------------------------------------------------------------

def _env_dir_to_uv(lt: LightTable, d):
    m = lt.env_w2l
    x = m[0, 0] * d[:, 0] + m[0, 1] * d[:, 1] + m[0, 2] * d[:, 2]
    y = m[1, 0] * d[:, 0] + m[1, 1] * d[:, 1] + m[1, 2] * d[:, 2]
    z = m[2, 0] * d[:, 0] + m[2, 1] * d[:, 1] + m[2, 2] * d[:, 2]
    theta = torch.acos(torch.clamp(z, -1.0, 1.0))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    return phi * (0.5 / np.pi), theta * (1.0 / np.pi), theta


def _cdf_invert(cdf, u):
    """Continuous inversion of a (n+1,) CDF: (index, fraction, pdf) like
    Distribution1D::SampleContinuous.  torch.searchsorted(right=True) is
    jnp.searchsorted(side="right"): ties break to the same side."""
    n = cdf.shape[0] - 1
    i = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True) - 1,
                    0, n - 1)
    lo = cdf[i]
    hi = cdf[i + 1]
    du = torch.where(hi > lo, (u - lo) / torch.clamp(hi - lo, min=1e-20), 0.0)
    return i, du, (hi - lo) * n


def _f32_key(x):
    """A non-negative float32 array's values as int64 keys in the same
    order: the bit pattern of a float >= 0 (+0 for -0) grows with it."""
    if isinstance(x, np.ndarray):
        return (x.astype(np.float32) + np.float32(0)).view(np.int32).astype(
            np.int64)
    return (x.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)


def _row_search(lt: LightTable, vi, u):
    """For each lane, jnp.searchsorted(env_cond_cdf[vi], u, side="right")
    without gathering the lane's row: the key holds row r's entries as
    r * 2^32 + their float bits, so one search over it counts the rows
    before vi and the entries of row vi that are <= u, exactly."""
    we1 = lt.env_cond_cdf.shape[1]
    q = vi.to(torch.int64) * (1 << 32) + _f32_key(u)
    return torch.searchsorted(lt.env_cdf_key, q.contiguous(),
                              right=True) - vi * we1


def env_sample(lt: LightTable, u1, u2):
    """Sample the environment map: returns (wi, Li, solid-angle pdf)."""
    he, we = lt.env_map.shape[:2]
    vi, dv, pdf_v = _cdf_invert(lt.env_marg_cdf, u2)
    ui = torch.clamp(_row_search(lt, vi, u1) - 1, 0, we - 1)
    flat = lt.env_cond_cdf.reshape(-1)
    base = vi * (we + 1) + ui
    lo = flat[base]
    hi = flat[base + 1]
    du = torch.where(hi > lo, (u1 - lo) / torch.clamp(hi - lo, min=1e-20),
                     0.0)
    pdf_u = (hi - lo) * we
    uu = (ui.to(torch.float32) + du) / we
    vv = (vi.to(torch.float32) + dv) / he
    theta = vv * np.pi
    phi = uu * 2 * np.pi
    sin_t = torch.sin(theta)
    wl = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                      torch.cos(theta)], dim=-1)
    m = lt.env_l2w
    wi = torch.stack([
        m[0, 0] * wl[:, 0] + m[0, 1] * wl[:, 1] + m[0, 2] * wl[:, 2],
        m[1, 0] * wl[:, 0] + m[1, 1] * wl[:, 1] + m[1, 2] * wl[:, 2],
        m[2, 0] * wl[:, 0] + m[2, 1] * wl[:, 1] + m[2, 2] * wl[:, 2],
    ], dim=-1)
    li = lt.env_map[torch.clamp(vi, 0, he - 1), torch.clamp(ui, 0, we - 1)]
    pdf = torch.where(sin_t > 1e-7,
                      pdf_u * pdf_v / (2.0 * np.pi * np.pi * sin_t), 0.0)
    return wi, li, pdf


def env_pdf(lt: LightTable, wi):
    """Solid-angle pdf of env_sample producing wi (infinite.cpp Pdf_Li)."""
    he, we = lt.env_map.shape[:2]
    uu, vv, theta = _env_dir_to_uv(lt, wi)
    ui = torch.clamp((uu * we).to(torch.int64), 0, we - 1)
    vi = torch.clamp((vv * he).to(torch.int64), 0, he - 1)
    pdf_v = (lt.env_marg_cdf[vi + 1] - lt.env_marg_cdf[vi]) * he
    flat = lt.env_cond_cdf.reshape(-1)
    base = vi * (we + 1) + ui
    pdf_u = (flat[base + 1] - flat[base]) * we
    sin_t = torch.sin(theta)
    return torch.where(sin_t > 1e-7,
                       pdf_u * pdf_v / (2.0 * np.pi * np.pi * sin_t), 0.0)


def env_le(lt: LightTable, d):
    """Escaped-ray radiance from the environment map (infinite.cpp Le),
    bilinear-filtered."""
    he, we = lt.env_map.shape[:2]
    uu, vv, _ = _env_dir_to_uv(lt, d)
    x = uu * we - 0.5
    y = vv * he - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def fetch(xi, yi):
        return lt.env_map[torch.clamp(yi, 0, he - 1), torch.remainder(xi, we)]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


# ---------------------------------------------------------------------------
# emission sampling (Sample_Le / Pdf_Le) for bdpt and mlt (tpurt's
# lights.py:806-983; light.h:75 and point.cpp:58, spot.cpp:87,
# distant.cpp:55, diffuse.cpp:92, infinite.cpp:129)
# ---------------------------------------------------------------------------

class LeSample(NamedTuple):
    p: torch.Tensor  # (N,3) point on the light (ray origin)
    n: torch.Tensor  # (N,3) light normal at p (emission side)
    d: torch.Tensor  # (N,3) emitted ray direction
    le: torch.Tensor  # (N,3) emitted radiance / intensity
    pdf_pos: torch.Tensor  # (N,) area pdf of p
    pdf_dir: torch.Tensor  # (N,) solid-angle pdf of d (given p)
    is_delta_pos: torch.Tensor  # (N,) point-like light (pdf_pos a delta)
    is_infinite: torch.Tensor  # (N,)


def sample_le(lt: LightTable, idx, u1, u2, u3, u4) -> LeSample:
    """Batched Sample_Le for the chosen light rows; (u1, u2) sample the
    position, (u3, u4) the direction.  Projection and goniometric rows
    take the infinite branch's p, d and n, as in tpurt."""
    row = lt.rows[idx]  # one fused row gather
    kind = row[:, 0].to(torch.int32)
    L = row[:, 1:4]
    p0 = row[:, 4:7]
    p1 = row[:, 7:10]
    par = row[:, 10:14]
    wr = lt.world_radius
    wc = lt.world_center
    n_lanes = idx.shape[0]
    two_sided = par[:, 3] > 0

    def full(v):
        return torch.full((n_lanes,), v, dtype=torch.float32,
                          device=row.device)

    # point: uniform sphere direction
    d_sph = uniform_sample_sphere(u3, u4)
    # spot: uniform cone about the axis, with the falloff
    cos_total = par[:, 0]
    tx, ty = build_onb(p1)
    d_spot = to_world(tx, ty, p1, uniform_sample_cone(u3, u4, cos_total))
    cos_t = dot(d_spot, p1)
    cos_fall = par[:, 1]
    delta_f = torch.clamp((cos_t - cos_total)
                          / torch.clamp(cos_fall - cos_total, min=1e-6),
                          0.0, 1.0)
    falloff = torch.where(cos_t < cos_total, 0.0,
                          torch.where(cos_t > cos_fall, 1.0,
                                      (delta_f ** 2) ** 2))
    # distant: a disk of world radius across the direction; p0 points
    # toward the light, emission goes along -p0
    d_dist = -p0
    txd, tyd = build_onb(d_dist)
    cdx, cdy = concentric_sample_disk(u1, u2)
    p_disk = (wc + wr * (cdx[:, None] * txd + cdy[:, None] * tyd)
              - wr * d_dist)
    # area triangle: uniform by area, cosine hemisphere; a two-sided light
    # picks its side with u3 and remaps it (diffuse.cpp:100-110)
    b0, b1 = uniform_sample_triangle(u1, u2)
    tv0, tv1, tv2 = row[:, 14:17], row[:, 17:20], row[:, 20:23]
    p_tri = (b0[:, None] * tv0 + b1[:, None] * tv1
             + (1 - b0 - b1)[:, None] * tv2)
    n_cross = cross(tv1 - tv0, tv2 - tv0)
    area_tri = 0.5 * norm(n_cross)
    n_tri = normalize(n_cross)
    u3_t = torch.where(two_sided,
                       torch.remainder(torch.clamp(u3 * 2.0, max=0.9999994),
                                       1.0), u3)
    flip = two_sided & (u3 >= 0.5)
    w_local = cosine_sample_hemisphere(u3_t, u4)
    pdfdir_cos = torch.clamp(w_local[:, 2], min=0.0) / np.pi
    pdfdir_cos = torch.where(two_sided, 0.5 * pdfdir_cos, pdfdir_cos)
    ttx, tty = build_onb(n_tri)
    d_tri = to_world(ttx, tty, n_tri, w_local)
    d_tri = torch.where(flip[:, None], -d_tri, d_tri)
    n_emit_tri = torch.where(flip[:, None], -n_tri, n_tri)
    # area sphere: uniform area, cosine hemisphere
    r = par[:, 2]
    n_sph = uniform_sample_sphere(u1, u2)
    p_sph = p0 + r[:, None] * n_sph
    stx, sty = build_onb(n_sph)
    d_sphl = to_world(stx, sty, n_sph, w_local)
    d_sphl = torch.where(flip[:, None], -d_sphl, d_sphl)
    n_emit_sph = torch.where(flip[:, None], -n_sph, n_sph)
    # infinite: a direction from the map's distribution (or uniform), the
    # origin on a world-radius disk behind it
    if lt.env_light_row >= 0:
        wi_env, le_inf, pdfdir_inf = env_sample(lt, u3, u4)
        d_inf = -wi_env
    else:
        d_inf = -uniform_sample_sphere(u3, u4)
        le_inf = L
        pdfdir_inf = full(1.0 / (4 * np.pi))
    txi, tyi = build_onb(d_inf)
    p_inf = (wc + wr * (cdx[:, None] * txi + cdy[:, None] * tyi)
             - wr * d_inf)

    def sel(k):
        return (kind == k)[:, None]

    is_point = (kind == LIGHT_POINT) | (kind == LIGHT_SPOT)
    p = torch.where(is_point[:, None], p0,
        torch.where(sel(LIGHT_DISTANT), p_disk,
        torch.where(sel(LIGHT_AREA_TRI), p_tri,
        torch.where(sel(LIGHT_AREA_SPHERE), p_sph, p_inf))))
    d = torch.where(sel(LIGHT_POINT), d_sph,
        torch.where(sel(LIGHT_SPOT), d_spot,
        torch.where(sel(LIGHT_DISTANT), d_dist,
        torch.where(sel(LIGHT_AREA_TRI), d_tri,
        torch.where(sel(LIGHT_AREA_SPHERE), d_sphl, d_inf)))))
    n = torch.where(sel(LIGHT_AREA_TRI), n_emit_tri,
        torch.where(sel(LIGHT_AREA_SPHERE), n_emit_sph, d))
    le = torch.where(sel(LIGHT_SPOT), L * falloff[:, None],
         torch.where(sel(LIGHT_INFINITE), le_inf, L))
    pdf_pos = torch.where(is_point, 1.0,
              torch.where(kind == LIGHT_AREA_TRI,
                          1.0 / torch.clamp(area_tri, min=1e-12),
              torch.where(kind == LIGHT_AREA_SPHERE,
                          1.0 / torch.clamp(4 * np.pi * r * r, min=1e-12),
                          full(1.0 / (np.pi * wr * wr)))))
    pdf_dir = torch.where(kind == LIGHT_POINT, 1.0 / (4 * np.pi),
              torch.where(kind == LIGHT_SPOT, uniform_cone_pdf(cos_total),
              torch.where(kind == LIGHT_DISTANT, 1.0,
              torch.where(kind == LIGHT_INFINITE, pdfdir_inf, pdfdir_cos))))
    return LeSample(p=p, n=n, d=d, le=le, pdf_pos=pdf_pos, pdf_dir=pdf_dir,
                    is_delta_pos=is_point | (kind == LIGHT_DISTANT),
                    is_infinite=kind == LIGHT_INFINITE)


def pdf_le(lt: LightTable, idx, p, n, d):
    """(pdf_pos, pdf_dir) that Sample_Le would give for an emitted ray
    (p, d) with light normal n at p (Pdf_Le per kind; tpurt :935)."""
    row = lt.rows[idx]  # one fused row gather
    kind = row[:, 0].to(torch.int32)
    par = row[:, 10:14]
    wr = lt.world_radius
    r = par[:, 2]
    two_sided = par[:, 3] > 0
    tv0, tv1, tv2 = row[:, 14:17], row[:, 17:20], row[:, 20:23]
    area_tri = 0.5 * norm(cross(tv1 - tv0, tv2 - tv0))
    cosl = dot(n, d)
    pdfdir_cos = torch.where(two_sided, 0.5 * cosl.abs() / np.pi,
                             torch.clamp(cosl, min=0.0) / np.pi)
    cos_total = par[:, 0]
    pdf_pos = torch.where(
        kind == LIGHT_AREA_TRI, 1.0 / torch.clamp(area_tri, min=1e-12),
        torch.where(kind == LIGHT_AREA_SPHERE,
                    1.0 / torch.clamp(4 * np.pi * r * r, min=1e-12),
                    torch.where((kind == LIGHT_DISTANT)
                                | (kind == LIGHT_INFINITE),
                                1.0 / (np.pi * wr * wr), 1.0)))
    if lt.env_light_row >= 0:
        pdfdir_inf = env_pdf(lt, -d)
    else:
        pdfdir_inf = torch.full_like(cosl, 1.0 / (4 * np.pi))
    pdf_dir = torch.where(kind == LIGHT_POINT, 1.0 / (4 * np.pi),
              torch.where(kind == LIGHT_SPOT, uniform_cone_pdf(cos_total),
              torch.where(kind == LIGHT_DISTANT, 1.0,
              torch.where(kind == LIGHT_INFINITE, pdfdir_inf, pdfdir_cos))))
    return pdf_pos, pdf_dir


def light_normal_at(lt: LightTable, idx, p):
    """Geometric normal of the light's surface at a point p on it (area
    lights; the other rows get +z, which their emission pdfs never read;
    tpurt :968)."""
    row = lt.rows[idx]  # one fused row gather
    kind = row[:, 0].to(torch.int32)
    tv0, tv1, tv2 = row[:, 14:17], row[:, 17:20], row[:, 20:23]
    n_tri = normalize(cross(tv1 - tv0, tv2 - tv0))
    n_sph = normalize(p - row[:, 4:7])
    is_tri = (kind == LIGHT_AREA_TRI)[:, None]
    is_sph = (kind == LIGHT_AREA_SPHERE)[:, None]
    z = torch.zeros_like(p)
    z[:, 2] = 1.0
    return torch.where(is_tri, n_tri, torch.where(is_sph, n_sph, z))
