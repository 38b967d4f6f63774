"""Wavefront integrators, RGB: path, directlighting, whitted and ao (port
of tpurt/render/integrator.py: path_bounce_init / path_bounce_step with
their helpers _camera_setup, _emitted, _escape_radiance, _escape_pdf,
the shading context (ShadeCtx, shade_f, shade_sample), _nee_prepare,
_nee_resolve, the texture footprints and camera ray differentials,
Russian roulette and the RPF feature capture; the non-fused trace
branch; ao_radiance).  volpath's step, which shares the shading context
and the carried interaction, is render/volpath.py.  directlighting and
whitted are the same bounce step with ``cfg.specular_only``: emitted
light and next-event estimation at every vertex, continued only through
specular lobes.
Escaped rays take the infinite lights' radiance with its MIS weight
(only in scenes that hold an infinite light).

A frame with motion (an animated camera, mesh or quadric) draws dim 2
as each lane's shutter time and carries it in the lane state to every
ray query and interaction; a static frame draws none and passes None.
Hair lanes replace the lobe mixture's f, pdf and sample by the hair
BSDF (render/hair.py), in the frame of the fiber's tangent, and fourier
lanes by their tabulated BSDF (render/fourier.py, one table a .bsdf
file); meshes with ``"vector S"`` and curves align the BSDF frame to
their tangent.

Per bounce: shade the hit carried from the previous bounce (emitted light
with the folded MIS weight, next-event estimation, BSDF sampling, the
subsurface hop, Russian roulette), then trace this bounce's shadow ray
(any-hit) and the next bounce's closest ray.  The dimension schedule is
tpurt's: camera dims 0-4, then 7 dims per bounce (light choice,
uLight.xy, lobe choice, uBSDF.xy, RR), each a Python int; a scene with a
BSSRDF strides BSS_DIMS more a bounce (the hop's 8), under every
integrator of this step, directlighting and whitted included, which
never take the hop (tpurt's integrator.py:986-987, :1053).

The subsurface hop (tpurt's _bssrdf_hop, path.cpp:153-174): after a
sample of a subsurface material's transmitting lobe, an exit point is
sampled by Sample_Sp's probe scheme, each probe chain a run of
_BSS_PROBE_K bounded closest-hit calls through the step's traversal,
then one light sample at the exit point (an any-hit call) and a
cosine-sampled continuation.  It runs on the gated lanes only, taken
out by index and put back.

Scenes with image-map textures carry the camera rays offset one pixel in
x and in y through the lane state (and so through the render loop's
boolean-index compaction) to take uv screen derivatives at the camera
hit; deeper bounces use the isotropic footprint ``fp_base + t*fp_slope``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from tpurt_torch.render.bsdf import (ALL_SLOTS, SLOT_FS, SLOT_MIRROR,
                                     LobeParams, LobeSet, bsdf_f, bsdf_pdf,
                                     bsdf_sample)
from tpurt_torch.render.bssrdf import (BSSTables, bss_pdf_sr,
                                       bss_sample_sr, bss_sr, bss_sw)
from tpurt_torch.render.fourier import (fourier_f, fourier_pdf,
                                        fourier_sample)
from tpurt_torch.render.hair import HairParams, hair_f, hair_pdf, hair_sample
from tpurt_torch.render.interaction import (SurfaceInteraction,
                                            compute_interaction,
                                            offset_ray_origin)
from tpurt_torch.render.intersect import (DeviceGeometry, Hit, intersect_any,
                                          intersect_closest)
from tpurt_torch.render.lights import (LightTable, choice_pmf_at,
                                       choose_light, env_le, env_pdf,
                                       pdf_li_from_hit, sample_li)
from tpurt_torch.render.materials_build import (C_FTIX, C_HAIR0, C_KIND,
                                                MAT_HAIR, fetch_lobes)
from tpurt_torch.render.sampling_warps import (build_onb,
                                               cosine_sample_hemisphere,
                                               cross, dot, norm,
                                               power_heuristic, to_local,
                                               to_world)
from tpurt_torch.spectrum_sampled import (N_BINS, lift_illum, lift_refl,
                                          lift_refl_raw, to_rgb)
from tpurt_torch.utils.stats import BSS_OVERFLOW, TRACK_STATS

INF = float("inf")
SHADOW_EPS = 1e-4  # pbrt ShadowEpsilon (pbrt.h:195)
DIMS_PER_BOUNCE = 7
CAMERA_DIMS = 5
BSS_DIMS = 8  # extra sampler dims a bounce when the scene has a BSSRDF
# closest-hit steps of a probe chain (tpurt's _BSS_PROBE_K,
# integrator.py:560-568; bssrdf.cpp:294-325 marches unboundedly): lanes
# with chord left after the last one are counted under BSS_OVERFLOW
_BSS_PROBE_K = 8


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    # path | volpath | rpf | directlighting | whitted | ao
    name: str = "path"
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "spatial"  # spatial | power | uniform
    capture_features: bool = False  # RPF per-sample feature capture
    # ao: occlusion rays a camera hit, cosine-weighted or uniform
    ao_samples: int = 64
    ao_cos_sample: bool = True
    # sampled-spectrum mode: colours carry 60 bins (spectrum_sampled.py)
    spectral: bool = False

    @property
    def nch(self) -> int:
        """Colour channels of the lane state: 60 bins or RGB's 3."""
        return N_BINS if self.spectral else 3

    @property
    def specular_only(self) -> bool:
        """directlighting and whitted continue only through specular
        lobes."""
        return self.name in ("directlighting", "whitted")


@dataclasses.dataclass
class SceneData:
    geo: DeviceGeometry
    lights: LightTable
    mt_table: torch.Tensor  # (M, 53) fused material rows
    # any material carries a bump texture -> interactions compute dpdu/dpdv
    has_bump: bool = False
    # any imagemap texture -> footprint-based MIP filtering (EWA)
    has_texfilter: bool = False
    # the lobe slots the scene's materials can activate
    # (materials_build.lobe_slots); the BSDF skips the others
    lobe_slots: LobeSet = ALL_SLOTS
    # participating media (tpurt's SceneData :89-102): per-medium
    # sigma_t, sigma_s (M, 3) and HG g (M,); grid media's concatenated
    # density lattices (D,) with each medium's offset, (nx, ny, nz),
    # world-to-medium (M, 4, 4), 1 / max density and grid flag
    med_sigma_t: torch.Tensor = None
    med_sigma_s: torch.Tensor = None
    med_g: torch.Tensor = None
    camera_medium: int = -1
    has_media: bool = False
    med_density: torch.Tensor = None
    med_grid_off: torch.Tensor = None
    med_grid_dims: torch.Tensor = None
    med_w2m: torch.Tensor = None
    med_inv_maxd: torch.Tensor = None
    med_is_grid: torch.Tensor = None
    has_grid_media: bool = False
    # a Material "none" prim carries a MediumInterface: volpath's shadow
    # rays walk the boundaries (VisibilityTester::Tr)
    has_null_boundaries: bool = False
    # fourier tabulated BSDFs (tpurt's SceneData :119-124): the baked
    # tables of the scene's .bsdf files (FourierTableDev) and each one's
    # eta; a fourier row holds its table's index in C_FTIX
    fr_tables: tuple = ()
    fr_etas: tuple = ()
    # a ptex texture: the interactions carry the triangle face index
    has_ptex: bool = False
    # the tabulated BSSRDF (tpurt's SceneData :103-117): each material
    # row's [sigma_t rgb, rho rgb, eta] (M, 7) and diffusion-table index
    # (M,) (-1: none), and the tables of the scene's distinct (g, eta)
    mt_bss: torch.Tensor = None
    mt_bss_tix: torch.Tensor = None
    bss: BSSTables = None

    @property
    def has_tangents(self) -> bool:
        """A mesh carries shading tangents or the scene holds curves: the
        BSDF frame aligns to the tangent (tpurt's has_tangents)."""
        return self.geo.has_tangents

    @property
    def has_bssrdf(self) -> bool:
        """A subsurface or kdsubsurface material: the path step takes the
        hop and strides BSS_DIMS more a bounce."""
        return self.bss is not None

    @property
    def n_bss_tables(self) -> int:
        return 0 if self.bss is None else self.bss.profile.shape[0]

    @property
    def dims_per_bounce(self) -> int:
        """The path step's sampler dims a bounce (integrator.py:986-987)."""
        return DIMS_PER_BOUNCE + (BSS_DIMS if self.has_bssrdf else 0)

    @property
    def has_motion(self) -> bool:
        """An animated mesh or quadric: rays carry their shutter time."""
        return (self.geo.wnodes_delta is not None
                or self.geo.quad_trs is not None)


def lift_illum_maybe(L, nch: int):
    """RGB light radiance as ``nch`` channels: through the illuminant
    basis when rendering spectrally (tpurt's _lift_illum_maybe,
    integrator.py:146-155; light and area-light colours and env-map texels
    promote as illuminants)."""
    return L if nch == 3 else lift_illum(L)


def lift_f_maybe(f, nch: int):
    """A BSDF value evaluated in 3 channels (the hair and fourier models)
    as ``nch`` channels, without the 0.94 reflectance scale
    (integrator.py:158)."""
    return f if nch == 3 else lift_refl_raw(f)


def lift_refl_maybe(v, nch: int):
    """An RGB scene parameter (a medium's sigmas) as ``nch`` channels
    through the reflectance basis with its 0.94 scale
    (integrator.py:169)."""
    return v if nch == 3 else lift_refl(v)


def to_rgb_maybe(L):
    """Radiance of 60 bins as RGB, at the integrator's exit; the film
    stays 3-channel (tpurt's _to_rgb_maybe, integrator.py:180-187)."""
    return L if L.shape[-1] == 3 else to_rgb(L)


def _shading_frame(si: SurfaceInteraction):
    """The BSDF's local frame (t, b): the shading tangent when the scene
    carries one, else the branchless ONB (integrator.py:247-254)."""
    if si.ss is not None:
        return si.ss, cross(si.ns, si.ss)
    return build_onb(si.ns)


def _hair_ctx(scene: SceneData, si: SurfaceInteraction, mrow):
    """(is_hair, HairParams) of the hair lanes, or None when the scene has
    no hair, so a frame without hair computes none of it (tpurt's
    _hair_ctx, integrator.py:257-277).  mrow: the lanes' fused material
    rows."""
    if not scene.lobe_slots.hair:
        return None
    kind = torch.where(si.material_id >= 0, mrow[:, C_KIND].to(torch.int32),
                       0)
    is_hair = (kind == MAT_HAIR) & si.valid
    row = mrow[:, C_HAIR0:C_HAIR0 + 7]
    # offset across the fiber width from the curve's v (hair.cpp:165)
    h = torch.clamp(-1.0 + 2.0 * si.uv[:, 1], -1.0, 1.0)
    return is_hair, HairParams(h=h, eta=row[:, 3], sigma_a=row[:, 0:3],
                               beta_m=row[:, 4], beta_n=row[:, 5],
                               alpha=row[:, 6])


def _emitted(scene: SceneData, si: SurfaceInteraction):
    """Area-light radiance toward wo at a hit (DiffuseAreaLight::L,
    diffuse.h:58: twoSided || dot(n, w) > 0)."""
    prim_row = scene.lights.prim_to_light[si.prim.clamp(min=0).long()]
    lrow = torch.where(si.valid, prim_row, -1).long()
    has = lrow >= 0
    row = scene.lights.rows[lrow.clamp(min=0)]  # one fused row gather
    emits = has & ((row[:, 13] > 0) | (dot(si.ng, si.wo) > 0))
    return torch.where(emits[:, None], row[:, 1:4], 0.0), lrow


def _escape_radiance(lights: LightTable, d):
    """Infinite-light radiance for escaped rays along d: the constant
    lights' sum plus the mapped light's lookup (integrator.py:204-221).
    The sum is ``LightTable.inf_L``, the same sum as tpurt's _infinite_L
    (integrator.py:204), taken once at upload."""
    L = lights.inf_L.expand(d.shape[0], 3)
    if lights.env_light_row >= 0:
        L = L + env_le(lights, d)
    return L


def _escape_pdf(lights: LightTable, d):
    """Sample_Li's solid-angle pdf for escaped directions, for the MIS
    weight: the map's importance pdf, else the uniform sphere's
    (integrator.py:224-231)."""
    if lights.env_light_row >= 0:
        return env_pdf(lights, d)
    return torch.full((d.shape[0],), 1.0 / (4 * np.pi), dtype=torch.float32,
                      device=d.device)


def _fourier_ctx(scene: SceneData, si: SurfaceInteraction, mrow):
    """(is_fourier, table index) of the fourier lanes, or None when the
    scene has no fourier table (tpurt's _fourier_ctx,
    integrator.py:280-291)."""
    if not scene.fr_tables:
        return None
    tix = torch.where(si.material_id >= 0, mrow[:, C_FTIX].to(torch.int32),
                      -1)
    return (tix >= 0) & si.valid, tix


def _fourier_f_pdf_multi(scene: SceneData, tix, wo_l, wi_l):
    """(f (N, 3), pdf) of each lane's fourier table, 0 elsewhere (tpurt's
    _fourier_f_pdf_multi, integrator.py:294-306)."""
    f = torch.zeros((wo_l.shape[0], 3), dtype=torch.float32,
                    device=wo_l.device)
    pdf = torch.zeros(wo_l.shape[0], dtype=torch.float32, device=wo_l.device)
    for k, tbl in enumerate(scene.fr_tables):
        m = tix == k
        f = torch.where(m[:, None], fourier_f(tbl, scene.fr_etas[k], wo_l,
                                              wi_l), f)
        pdf = torch.where(m, fourier_pdf(tbl, wo_l, wi_l), pdf)
    return f, pdf


class ShadeCtx(NamedTuple):
    """The surface-shading context of a vertex (tpurt's ShadeCtx,
    integrator.py:310-324): the lobe mixture, the BSDF's local frame, the
    hair lanes' (is_hair, HairParams), None on a scene without hair, and
    the fourier lanes' (is_fourier, table index), None on a scene
    without a fourier table."""

    lobes: LobeParams
    t: torch.Tensor  # (N, 3) shading tangent
    b: torch.Tensor  # (N, 3) shading bitangent
    hair: Optional[tuple] = None
    fourier: Optional[tuple] = None

    @property
    def special(self):
        """The lanes whose BSDF replaces the lobe mixture (hair and
        fourier), or None when the scene has neither."""
        masks = [c[0] for c in (self.hair, self.fourier) if c is not None]
        if not masks:
            return None
        return masks[0] if len(masks) == 1 else masks[0] | masks[1]


def make_shade_ctx(scene: SceneData, si: SurfaceInteraction,
                   texture_eval=None, channels: int = 3) -> ShadeCtx:
    overrides = texture_eval(si) if texture_eval is not None else None
    lobes = fetch_lobes(scene.mt_table, si.material_id, overrides,
                        scene.lobe_slots, channels=channels)
    t, b = _shading_frame(si)
    mrow = None
    if scene.lobe_slots.hair or scene.fr_tables:
        # one fused row gather serves both contexts
        mrow = scene.mt_table[si.material_id.clamp(min=0).long()]
    return ShadeCtx(lobes=lobes, t=t, b=b, hair=_hair_ctx(scene, si, mrow),
                    fourier=_fourier_ctx(scene, si, mrow))


def zero_shade_ctx(scene: SceneData, n: int, device,
                   channels: int = 3) -> ShadeCtx:
    """An all-dark context of the same structure as make_shade_ctx's on
    this scene, hair included (tpurt's zero_shade_ctx, integrator.py:347):
    bdpt's endpoint vertices.  Its lobes are those of a lane with no
    material, in ``channels`` colour channels."""
    lobes = fetch_lobes(scene.mt_table,
                        torch.full((n,), -1, dtype=torch.int32,
                                   device=device), None, scene.lobe_slots,
                        channels=channels)
    t = torch.zeros((n, 3), dtype=torch.float32, device=device)
    b = torch.zeros_like(t)
    t[:, 0] = 1.0
    b[:, 1] = 1.0
    hair = fourier = None
    if scene.lobe_slots.hair:
        z = torch.zeros(n, dtype=torch.float32, device=device)
        hair = (torch.zeros(n, dtype=torch.bool, device=device),
                HairParams(h=z, eta=z + 1.55, sigma_a=torch.zeros_like(t),
                           beta_m=z + 0.3, beta_n=z + 0.3, alpha=z))
    if scene.fr_tables:
        fourier = (torch.zeros(n, dtype=torch.bool, device=device),
                   torch.full((n,), -1, dtype=torch.int32, device=device))
    return ShadeCtx(lobes=lobes, t=t, b=b, hair=hair, fourier=fourier)


def shade_f(scene: SceneData, ctx: ShadeCtx, ns, w_out, w_in):
    """(f, pdf) of the vertex's BSDF for world directions, hair and
    fourier lanes blended in, without the cosine (tpurt's shade_f,
    integrator.py:378)."""
    wo_l = to_local(ctx.t, ctx.b, ns, w_out)
    wi_l = to_local(ctx.t, ctx.b, ns, w_in)
    f = bsdf_f(ctx.lobes, wo_l, wi_l, scene.lobe_slots)
    pdf = bsdf_pdf(ctx.lobes, wo_l, wi_l, scene.lobe_slots)
    if ctx.hair is not None:
        is_hair, hp = ctx.hair
        f = torch.where(is_hair[:, None],
                        lift_f_maybe(hair_f(hp, wo_l, wi_l), f.shape[-1]), f)
        pdf = torch.where(is_hair, hair_pdf(hp, wo_l, wi_l), pdf)
    if ctx.fourier is not None:
        is_f, tix = ctx.fourier
        ff, fpdf = _fourier_f_pdf_multi(scene, tix, wo_l, wi_l)
        f = torch.where(is_f[:, None], lift_f_maybe(ff, f.shape[-1]), f)
        pdf = torch.where(is_f, fpdf, pdf)
    return f, pdf


def shade_sample(scene: SceneData, ctx: ShadeCtx, ns, w_out, u_lobe, u1,
                 u2):
    """A continuation direction at the vertex, hair and fourier lanes
    blended in (tpurt's shade_sample, integrator.py:402; the path step's
    :1000-1030): (wi world, f, pdf, is_spec, is_trans).  A fourier lane
    transmits where wi and wo lie on opposite sides."""
    wo_l = to_local(ctx.t, ctx.b, ns, w_out)
    wi_l, f, pdf, is_spec, is_trans = bsdf_sample(ctx.lobes, wo_l, u_lobe,
                                                  u1, u2, scene.lobe_slots)
    if ctx.hair is not None:
        is_hair, hp = ctx.hair
        wi_h, f_h, pdf_h = hair_sample(hp, wo_l, u1, u2)
        wi_l = torch.where(is_hair[:, None], wi_h, wi_l)
        f = torch.where(is_hair[:, None], lift_f_maybe(f_h, f.shape[-1]), f)
        pdf = torch.where(is_hair, pdf_h, pdf)
        is_spec = is_spec & ~is_hair
        is_trans = is_trans & ~is_hair
    if ctx.fourier is not None:
        is_f, tix = ctx.fourier
        wi_f = torch.zeros_like(wi_l)
        f_f = torch.zeros((wi_l.shape[0], 3), dtype=torch.float32,
                          device=wi_l.device)
        pdf_f = torch.zeros_like(pdf)
        for k, tbl in enumerate(scene.fr_tables):
            mk = tix == k
            wi_k, fk, pk = fourier_sample(tbl, scene.fr_etas[k], wo_l, u1,
                                          u2)
            wi_f = torch.where(mk[:, None], wi_k, wi_f)
            f_f = torch.where(mk[:, None], fk, f_f)
            pdf_f = torch.where(mk, pk, pdf_f)
        wi_l = torch.where(is_f[:, None], wi_f, wi_l)
        f = torch.where(is_f[:, None], lift_f_maybe(f_f, f.shape[-1]), f)
        pdf = torch.where(is_f, pdf_f, pdf)
        is_spec = is_spec & ~is_f
        is_trans = torch.where(is_f, wi_l[:, 2] * wo_l[:, 2] < 0, is_trans)
    return to_world(ctx.t, ctx.b, ns, wi_l), f, pdf, is_spec, is_trans


def shadow_t_max(ls, dist, usable):
    """A shadow ray's extent to the light sample at ``dist``: shortened
    by ShadowEpsilon and a magnitude-relative margin, 0 where unusable
    (integrator.py:470-473, :1540-1543)."""
    t_max = torch.where(
        usable, dist * (1.0 - SHADOW_EPS) - 2e-3
        * torch.clamp(ls.p_light.abs().amax(dim=-1), min=1.0), 0.0)
    return torch.clamp(t_max, min=0.0)


def _nee_prepare(scene: SceneData, si: SurfaceInteraction, ctx: ShadeCtx,
                 u_choice, u_light, strategy: str, alive):
    """Light-sampling half of next-event estimation: everything except
    the occlusion trace.  Returns (contrib, o_sh, wi_sh, t_sh, usable)."""
    lt = scene.lights
    lidx, pmf = choose_light(lt, u_choice, strategy, p=si.p)
    ls = sample_li(lt, lidx, si.p, u_light)
    f, scatter_pdf = shade_f(scene, ctx, si.ns, si.wo, ls.wi)
    f = f * dot(ls.wi, si.ns).abs()[:, None]
    usable = (alive & si.valid & (ls.pdf > 0)
              & (ls.li > 0).any(dim=-1) & (f > 0).any(dim=-1))
    # shadow ray: offset endpoints, shortened by ShadowEpsilon
    o_sh = offset_ray_origin(si.p, si.ng, ls.wi, si.p_eps)
    w = torch.where(ls.is_delta, 1.0,
                    power_heuristic(1.0, ls.pdf, 1.0, scatter_pdf))
    contrib = (f * lift_illum_maybe(ls.li, f.shape[-1])
               * (w / torch.clamp(ls.pdf * pmf, min=1e-20))[:, None])
    return (contrib, o_sh, ls.wi,
            shadow_t_max(ls, norm(ls.p_light - o_sh), usable), usable)


def _nee_resolve(contrib, usable, occluded):
    return torch.where((usable & ~occluded)[:, None], contrib, 0.0)


def _tex_footprint(si: SurfaceInteraction, hit_t, camera):
    """uv-space MIP filter widths from the isotropic ray-footprint model
    (world width ~= fp_base + t*fp_slope), the per-segment cone used for
    non-camera bounces; camera hits get ray differentials."""
    w_world = (camera.fp_base
               + torch.where(si.valid, hit_t, 0.0) * camera.fp_slope)
    return si._replace(
        tex_wu=w_world / torch.clamp(norm(si.dpdu), min=1e-9),
        tex_wv=w_world / torch.clamp(norm(si.dpdv), min=1e-9))


def camera_ray_differentials(camera, p_film, p_lens, o, d, spp: int,
                             time=None):
    """Camera rays offset one pixel in x and in y from the ray (o, d) of
    p_film (Camera::GenerateRayDifferential's default, camera.cpp:46-66),
    scaled by SamplerIntegrator's ScaleDifferentials(1/sqrt(spp))
    (integrator.cpp:285)."""
    dx = torch.tensor([1.0, 0.0], dtype=torch.float32, device=p_film.device)
    dy = torch.tensor([0.0, 1.0], dtype=torch.float32, device=p_film.device)
    rx_o, rx_d, _ = camera.generate_rays(p_film + dx, p_lens, time)
    ry_o, ry_d, _ = camera.generate_rays(p_film + dy, p_lens, time)
    s = float(1.0 / np.sqrt(max(spp, 1)))
    return (o + (rx_o - o) * s, d + (rx_d - d) * s,
            o + (ry_o - o) * s, d + (ry_d - d) * s)


def _tex_differentials(si: SurfaceInteraction, rx_o, rx_d, ry_o, ry_d):
    """SurfaceInteraction::ComputeDifferentials (interaction.cpp:125-160):
    intersect the differential rays with the tangent plane at p, then
    solve [dpdu dpdv] (du, dv) = dpd{x,y} for the uv screen derivatives by
    the least-squares Gram-matrix solve.  Returns (dst0, dst1, ok) with
    dst0 = (du/dx, dv/dx)."""
    n = si.ng
    d_plane = dot(n, si.p)

    def plane_hit(ro, rd):
        denom = dot(n, rd)
        t = (d_plane - dot(n, ro)) / torch.where(denom == 0, 1e-9, denom)
        return ro + t[:, None] * rd, denom.abs() > 1e-9

    px, okx = plane_hit(rx_o, rx_d)
    py, oky = plane_hit(ry_o, ry_d)
    g11 = dot(si.dpdu, si.dpdu)
    g12 = dot(si.dpdu, si.dpdv)
    g22 = dot(si.dpdv, si.dpdv)
    det = g11 * g22 - g12 * g12
    ok = okx & oky & (det.abs() > 1e-18) & si.valid
    inv_det = 1.0 / torch.where(det.abs() > 1e-18, det, 1.0)

    def solve(dp):
        b1 = dot(dp, si.dpdu)
        b2 = dot(dp, si.dpdv)
        return torch.stack([(g22 * b1 - g12 * b2) * inv_det,
                            (g11 * b2 - g12 * b1) * inv_det], dim=-1)

    return solve(px - si.p), solve(py - si.p), ok


def _camera_setup(sampler, camera, px, py, sidx, crop_xy,
                  draw_time: bool = False):
    """Film and lens samples and the camera rays (integrator.py:824-841).
    With ``draw_time`` dim 2 becomes each lane's shutter time (camera.h:72
    CameraSample); a static frame draws none (time None).  The samplers
    are stateless per dimension, so drawing it moves no other one."""
    sctx = sampler.lane_ctx(px, py, sidx)
    fx, fy = sampler.film_offset(px, py, sidx, sctx)
    p_film = torch.stack([px.to(torch.float32) + fx,
                          py.to(torch.float32) + fy], dim=-1)
    time = None
    if draw_time:
        u_time = sampler.dim(px, py, sidx, 2, sctx)
        time = (camera.shutter_open
                + u_time * (camera.shutter_close - camera.shutter_open))
    p_lens = torch.stack([sampler.dim(px, py, sidx, 3, sctx),
                          sampler.dim(px, py, sidx, 4, sctx)], dim=-1)
    o, d, ray_w = camera.generate_rays(p_film, p_lens, time)
    p_film_crop = p_film - torch.tensor(crop_xy, dtype=torch.float32,
                                        device=p_film.device)
    return p_film, p_film_crop, p_lens, o, d, ray_w, sctx, time


def path_bounce_init(scene: SceneData, sampler, camera, px, py, sidx,
                     cfg: IntegratorConfig, traverse, crop_xy=(0, 0)
                     ) -> Dict[str, Any]:
    """Per-lane wavefront state: camera setup + the bounce-0 closest hit.
    Every value has leading axis N, so a driver may compact the wavefront
    between bounces with a boolean index."""
    p_film, p_film_crop, p_lens, o, d, ray_w, sctx, time = _camera_setup(
        sampler, camera, px, py, sidx, crop_xy,
        draw_time=camera.animated or scene.has_motion)
    n = px.shape[0]
    hit0 = intersect_closest(scene.geo, o, d, INF, traverse, time=time)
    z1 = torch.zeros(n, dtype=torch.float32, device=o.device)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    zc = torch.zeros((n, cfg.nch), dtype=torch.float32, device=o.device)
    st = dict(
        px=px, py=py, sidx=sidx, sctx=sctx, time=time,
        p_film_crop=p_film_crop,
        p_lens=p_lens, ray_w=ray_w, o=o, d=d, hit_t=hit0.t,
        hit_prim=hit0.prim, hit_b0=hit0.b0, hit_b1=hit0.b1,
        beta=zc + 1.0, L=zc, alive=torch.ones_like(px, dtype=torch.bool),
        prev_pdf=z1 + 1.0, prev_p=o,
        specular=torch.zeros_like(px, dtype=torch.bool), eta_scale=z1 + 1.0)
    if scene.has_texfilter:
        st["rx_o"], st["rx_d"], st["ry_o"], st["ry_d"] = (
            camera_ray_differentials(camera, p_film, p_lens, o, d,
                                     sampler.spp, time))
    if cfg.capture_features:
        st.update(n0=z3.clone(), p0=z3.clone(), n1=z3.clone(), p1=z3.clone())
    return st


def carried_interaction(scene: SceneData, state: Dict[str, Any],
                        bounce: int, camera=None, texture_eval=None,
                        media: bool = False) -> SurfaceInteraction:
    """The surface interaction of the hit a lane state carries, with the
    texture footprints (ray differentials at bounce 0, the isotropic
    cone deeper) and the bump map applied, as every bounce step shades
    it.  ``media``: carry the prim's medium ids."""
    hit = Hit(t=state["hit_t"], prim=state["hit_prim"], b0=state["hit_b0"],
              b1=state["hit_b1"])
    si = compute_interaction(scene.geo, hit, state["o"], state["d"],
                             tangents=scene.has_tangents,
                             dpduv=scene.has_bump or scene.has_texfilter,
                             time=state.get("time"), media=media,
                             faces=scene.has_ptex)
    if scene.has_texfilter:
        si = _tex_footprint(si, hit.t, camera)
        # camera hits: ray differentials -> anisotropic EWA derivative
        # vectors; deeper bounces keep the isotropic cone
        zw = torch.zeros_like(si.tex_wu)
        dst0 = torch.stack([si.tex_wu, zw], -1)
        dst1 = torch.stack([zw, si.tex_wv], -1)
        if bounce == 0:
            dd0, dd1, okd = _tex_differentials(
                si, state["rx_o"], state["rx_d"], state["ry_o"],
                state["ry_d"])
            dst0 = torch.where(okd[:, None], dd0, dst0)
            dst1 = torch.where(okd[:, None], dd1, dst1)
        si = si._replace(tex_dst0=dst0, tex_dst1=dst1)
    if scene.has_bump and getattr(texture_eval, "bump", None) is not None:
        si = texture_eval.bump(si)
    return si


def path_bounce_step(scene: SceneData, sampler, cfg: IntegratorConfig,
                     state: Dict[str, Any], bounce: int, traverse,
                     camera=None, texture_eval=None) -> Dict[str, Any]:
    """One shade-then-trace bounce over the lane-state dict.  ``camera``
    is read only on scenes with image-map textures (its footprint
    constants); ``texture_eval`` is the job's TexEval or None."""
    px, py, sidx, sctx = (state["px"], state["py"], state["sidx"],
                          state["sctx"])
    n = px.shape[0]
    o, d = state["o"], state["d"]
    beta, L, alive = state["beta"], state["L"], state["alive"]
    prev_pdf, prev_p = state["prev_pdf"], state["prev_p"]
    time = state.get("time")
    out = dict(state)

    si = carried_interaction(scene, state, bounce, camera, texture_eval)

    if cfg.capture_features:
        # RPF captures the GEOMETRIC normal + hit point at bounces 0/1
        # (rpf.cpp:851-857 uses isect.n/isect.p)
        if bounce in (0, 1):
            m = (alive & si.valid)[:, None]
            kn, kp = ("n0", "p0") if bounce == 0 else ("n1", "p1")
            out[kn] = torch.where(m, si.ng, state[kn])
            out[kp] = torch.where(m, si.p, state[kp])

    # ---- emitted light (MIS weight folded into the BSDF-sampled hit) ----
    Le, lrow = _emitted(scene, si)
    if bounce == 0:
        w_emit = torch.ones(n, dtype=torch.float32, device=o.device)
    else:
        lrow_c = lrow.clamp(min=0)
        light_pdf = pdf_li_from_hit(scene.lights, lrow_c, prev_p, d, si.p,
                                    si.ng)
        pmf = choice_pmf_at(scene.lights, lrow_c, cfg.light_strategy, n,
                            prev_p)
        w_emit = power_heuristic(1.0, prev_pdf, 1.0, light_pdf * pmf)
        if SLOT_MIRROR in scene.lobe_slots or SLOT_FS in scene.lobe_slots:
            w_emit = torch.where(state["specular"], 1.0, w_emit)
    L = L + torch.where((alive & si.valid)[:, None],
                        beta * lift_illum_maybe(Le, cfg.nch)
                        * w_emit[:, None], 0.0)

    # escaped rays -> infinite lights (integrator.py:951-964)
    lt = scene.lights
    if lt.has_infinite:
        if cfg.light_strategy in ("power", "spatial"):
            pmf_inf = lt.inf_power_pmf
        else:
            pmf_inf = 1.0 / lt.n_lights
        if bounce == 0:
            w_inf = torch.ones(n, dtype=torch.float32, device=o.device)
        else:
            w_inf = power_heuristic(1.0, prev_pdf, 1.0,
                                    _escape_pdf(lt, d) * pmf_inf)
            w_inf = torch.where(state["specular"], 1.0, w_inf)
        L = L + torch.where((alive & ~si.valid)[:, None],
                            beta * lift_illum_maybe(_escape_radiance(lt, d),
                                                    cfg.nch)
                            * w_inf[:, None], 0.0)

    alive = alive & si.valid & (bounce < cfg.max_depth)
    ctx = make_shade_ctx(scene, si, texture_eval, channels=cfg.nch)
    lobes = ctx.lobes
    any_lobe = lobes.active.any(dim=-1)
    has_smooth = lobes.active[:, 0] | lobes.active[:, 1]
    special = ctx.special
    if special is not None:
        any_lobe = any_lobe | special
        has_smooth = has_smooth | special
    alive = alive & any_lobe

    # ---- NEE ----
    d0 = CAMERA_DIMS + bounce * scene.dims_per_bounce
    u_choice = sampler.dim(px, py, sidx, d0, sctx)
    u_light = torch.stack([sampler.dim(px, py, sidx, d0 + 1, sctx),
                           sampler.dim(px, py, sidx, d0 + 2, sctx)], dim=-1)
    nee_c, o_sh, wi_sh, t_sh, nee_ok = _nee_prepare(
        scene, si, ctx, u_choice, u_light, cfg.light_strategy,
        alive & has_smooth)
    beta_nee = beta  # pre-continuation throughput scales the NEE term

    # ---- BSDF sampling ----
    u_lobe = sampler.dim(px, py, sidx, d0 + 3, sctx)
    u1 = sampler.dim(px, py, sidx, d0 + 4, sctx)
    u2 = sampler.dim(px, py, sidx, d0 + 5, sctx)
    wi, f, pdf, is_spec, is_trans = shade_sample(scene, ctx, si.ns, si.wo,
                                                 u_lobe, u1, u2)
    ok = alive & (pdf > 0) & (f > 0).any(dim=-1)
    if cfg.specular_only:
        ok = ok & is_spec
    beta = torch.where(ok[:, None],
                       beta * f * (dot(wi, si.ns).abs()
                                   / torch.clamp(pdf, min=1e-20))[:, None],
                       beta)
    eta_scale = state["eta_scale"]
    if SLOT_FS in scene.lobe_slots:
        # refraction radiance scaling bookkeeping (path.cpp etaScale);
        # only the fresnel-specular slot transmits specularly
        eta_sq = lobes.eta * lobes.eta
        eta2 = torch.where(dot(si.wo, si.ng) > 0, eta_sq,
                           1.0 / torch.clamp(eta_sq, min=1e-9))
        eta_scale = torch.where(ok & is_spec & is_trans, eta_scale * eta2,
                                eta_scale)
    alive = ok
    specular = is_spec
    prev_pdf = torch.clamp(pdf, min=1e-20)
    prev_p = si.p
    o = offset_ray_origin(si.p, si.ng, wi, si.p_eps)
    d = wi

    # ---- subsurface hop (path.cpp:153-174; integrator.py:1052-1058) ----
    if scene.has_bssrdf and not cfg.specular_only:
        o, d, beta, L, alive, specular, prev_pdf, prev_p = _bssrdf_hop(
            scene, si, ctx, o, d, beta, L, alive, specular, prev_pdf,
            prev_p, is_spec, is_trans, sampler, (px, py, sidx, sctx), d0,
            cfg, traverse, time)

    # ---- Russian roulette (path.cpp: bounces > 3) ----
    if bounce > 3:
        u_rr = sampler.dim(px, py, sidx, d0 + 6, sctx)
        rr_beta = beta.amax(dim=-1) * eta_scale
        q = torch.clamp(1.0 - rr_beta, min=0.05)
        do_rr = (rr_beta < cfg.rr_threshold) & alive
        killed = do_rr & (u_rr < q)
        alive = alive & ~killed
        beta = torch.where((do_rr & ~killed)[:, None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                           beta)

    # ---- trace: this bounce's shadow ray + the next bounce's closest ----
    occluded = intersect_any(scene.geo, o_sh, wi_sh, t_sh, traverse, time)
    hit_next = intersect_closest(scene.geo, o, d,
                                 torch.where(alive, INF, 0.0), traverse,
                                 time)
    L = L + beta_nee * _nee_resolve(nee_c, nee_ok, occluded)
    out.update(o=o, d=d, hit_t=hit_next.t, hit_prim=hit_next.prim,
               hit_b0=hit_next.b0, hit_b1=hit_next.b1, beta=beta, L=L,
               alive=alive, prev_pdf=prev_pdf, prev_p=prev_p,
               specular=specular, eta_scale=eta_scale)
    return out


def _prim_material(geo: DeviceGeometry, prim):
    """The material id of each lane's prim (shade-row slot 2's int32
    bits; tpurt's geo.material_id[prim]), for prim >= 0."""
    rows = geo.shade_rows[prim.clamp(min=0).long(), 2]
    return rows.contiguous().view(torch.int32)


def _bssrdf_hop(scene: SceneData, si: SurfaceInteraction, ctx: ShadeCtx,
                o, d, beta, L, alive, specular, prev_pdf, prev_p, is_spec,
                is_trans, sampler, lanes, d0: int, cfg: IntegratorConfig,
                traverse, time):
    """The path integrator's subsurface hop (tpurt's _bssrdf_hop,
    integrator.py:571-749; path.cpp:153-174).  A lane is gated when its
    BSDF sample carried transmission on a BSSRDF material (for smooth
    subsurface the FresnelSpecular lobe carries it on both branches).  On
    the gated lanes, taken out by index: Sample_Sp picks a probe axis (1/2
    the normal, 1/4 each tangent; dim d0+7) and a channel, samples a
    radius r and r_max = Sample_Sr(0.999) (d0+8) and an angle (d0+9), and
    marches the probe chord through _BSS_PROBE_K bounded closest-hit calls
    (IntersectionChain, bssrdf.cpp:294-325: every hit stepped past by a
    magnitude-relative epsilon, the same-material crossings collected);
    one crossing is chosen uniformly, the pdf divided by their number.
    The throughput takes Sp / Pdf_Sp (all three axes and channels,
    bssrdf.cpp:327-348); the exit point adds one light sample through the
    Sw lobe (d0+10..12) behind an any-hit call, and the path continues in
    a cosine-sampled direction (d0+13, 14).  Lanes still holding chord
    after the last step count under BSS_OVERFLOW (only the last step's,
    as tpurt counts).  ``lanes``: (px, py, sidx, sctx) of the step.
    Returns (o, d, beta, L, alive, specular, prev_pdf, prev_p), the gated
    lanes' specular flag cleared."""
    idx = si.material_id.clamp(min=0).long()
    tix_all = torch.where(si.material_id >= 0, scene.mt_bss_tix[idx], -1)
    gate = alive & (tix_all >= 0) & (
        is_trans | (is_spec & ctx.lobes.active[:, SLOT_FS]))
    sel = torch.nonzero(gate).squeeze(1)
    if sel.numel() == 0:
        return o, d, beta, L, alive, specular, prev_pdf, prev_p
    px, py, sidx, sctx = lanes
    sctx = None if sctx is None else sctx[sel]
    lane = (px[sel], py[sel], sidx[sel])
    time_g = None if time is None else time[sel]

    def dim(k):
        return sampler.dim(*lane, d0 + k, sctx)

    n = sel.shape[0]
    dev = beta.device
    tbl = scene.bss
    tix = tix_all[sel].long()
    mat = si.material_id[sel]
    p, ns, t, b = si.p[sel], si.ns[sel], ctx.t[sel], ctx.b[sel]
    row = scene.mt_bss[idx[sel]]
    sigma_t, rho3, eta = row[:, 0:3], row[:, 3:6], row[:, 6]
    u1, u2a, u2b = dim(7), dim(8), dim(9)

    # the probe axis (Sample_Sp: 1/2 ns, 1/4 ss, 1/4 ts) and the channel
    c1 = (u1 < 0.5)[:, None]
    c2 = ((u1 >= 0.5) & (u1 < 0.75))[:, None]
    vx = torch.where(c1, t, torch.where(c2, b, ns))
    vy = torch.where(c1, b, torch.where(c2, ns, t))
    vz = torch.where(c1, ns, torch.where(c2, t, b))
    u1r = torch.where(u1 < 0.5, u1 * 2,
                      torch.where(u1 < 0.75, (u1 - 0.5) * 4,
                                  (u1 - 0.75) * 4))
    ch = torch.clamp((u1r * 3).to(torch.int32), 0, 2).long()
    sig_ch = torch.gather(sigma_t, 1, ch[:, None])[:, 0]
    rho_ch = torch.gather(rho3, 1, ch[:, None])[:, 0]
    # r and r_max in one call over 2n lanes
    rr = bss_sample_sr(tbl, tix.repeat(2), sig_ch.repeat(2),
                       rho_ch.repeat(2),
                       torch.cat([u2a, torch.full_like(u2a, 0.999)]))
    r, r_max = rr[:n], rr[n:]
    ok = (r >= 0) & (r < r_max) & (sig_ch > 0)
    ell = 2.0 * torch.sqrt(torch.clamp(r_max * r_max - r * r, min=0.0))
    phi = 2.0 * np.pi * u2b
    base = (p + r[:, None] * (vx * torch.cos(phi)[:, None]
                              + vy * torch.sin(phi)[:, None])
            - 0.5 * ell[:, None] * vz)

    # IntersectionChain: march the whole chord, collecting every
    # same-material crossing (other hits are stepped through)
    u_sel = u1r * 3.0 - ch.to(torch.float32)  # pbrt's thrice-remapped u1
    o_cur = base
    rem = torch.where(ok, ell, 0.0)
    t_off = torch.zeros(n, dtype=torch.float32, device=dev)
    cand_t, cand_prim, cand_b0, cand_b1, cand_ok = [], [], [], [], []
    for _k in range(_BSS_PROBE_K):
        h = intersect_closest(scene.geo, o_cur, vz, rem, traverse, time_g)
        valid = h.prim >= 0
        cand_t.append(torch.where(valid, t_off + h.t, INF))
        cand_prim.append(torch.where(valid, h.prim, -1))
        cand_b0.append(h.b0)
        cand_b1.append(h.b1)
        cand_ok.append(valid & (_prim_material(scene.geo, h.prim) == mat))
        # step past the hit (SpawnRayTo; a magnitude-relative epsilon
        # along the probe direction)
        p_k = o_cur + h.t[:, None] * vz
        eps = 1e-4 * torch.clamp(p_k.abs().amax(dim=-1), min=1.0)
        adv = torch.where(valid, h.t + eps, rem)
        rem = torch.clamp(rem - adv, min=0.0)
        t_off = t_off + torch.where(valid, adv, 0.0)
        o_cur = torch.where(valid[:, None], p_k + eps[:, None] * vz, o_cur)
        exhausted = valid & (rem > 0)
    TRACK_STATS.add(BSS_OVERFLOW, exhausted.sum())
    match = torch.stack(cand_ok)  # (K, n)
    n_found = match.sum(dim=0).to(torch.int32)
    ok = ok & (n_found > 0)
    pick_i = torch.minimum(
        torch.clamp((u_sel * n_found.to(torch.float32)).to(torch.int32),
                    min=0), torch.clamp(n_found - 1, min=0))
    rank = torch.cumsum(match.to(torch.int32), dim=0) - 1
    pick = match & (rank == pick_i[None])  # (K, n) one-hot
    picked = pick.any(dim=0)

    def choose(stk, fill):
        v = torch.where(pick, torch.stack(stk), 0).sum(dim=0)
        return (v + torch.where(picked, 0, fill)).to(stk[0].dtype)

    hit = Hit(t=choose(cand_t, INF), prim=choose(cand_prim, -1),
              b0=choose(cand_b0, 0.0), b1=choose(cand_b1, 0.0))
    pi_si = compute_interaction(scene.geo, hit, base, vz,
                                tangents=scene.has_tangents, time=time_g)
    ok = ok & pi_si.valid & (pi_si.material_id == mat)

    # Pdf_Sp: three axes x three channels, in one call over 9n lanes,
    # summed in tpurt's order
    dvec = p - pi_si.p
    dl = to_local(t, b, ns, dvec)
    nl = to_local(t, b, ns, pi_si.ng)
    rproj = (torch.sqrt(dl[:, 1] ** 2 + dl[:, 2] ** 2),
             torch.sqrt(dl[:, 2] ** 2 + dl[:, 0] ** 2),
             torch.sqrt(dl[:, 0] ** 2 + dl[:, 1] ** 2))
    terms = [(ax, axp, c) for ax, axp in ((0, 0.25), (1, 0.25), (2, 0.5))
             for c in range(3)]
    pdfs = bss_pdf_sr(tbl, tix.repeat(len(terms)),
                      torch.cat([sigma_t[:, c] for _a, _p, c in terms]),
                      torch.cat([rho3[:, c] for _a, _p, c in terms]),
                      torch.cat([rproj[a] for a, _p, _c in terms])
                      ).reshape(len(terms), n)
    pdf_sp = torch.zeros(n, dtype=torch.float32, device=dev)
    for k, (ax, axp, _c) in enumerate(terms):
        pdf_sp = pdf_sp + pdfs[k] * nl[:, ax].abs() * (axp / 3.0)
    pdf_sp = pdf_sp / torch.clamp(n_found, min=1).to(torch.float32)
    sp = bss_sr(tbl, tix, sigma_t, rho3, norm(dvec))
    ok = ok & (pdf_sp > 0) & (sp > 0).any(dim=-1)
    beta_g = beta[sel]
    beta_b = beta_g * sp / torch.clamp(pdf_sp, min=1e-20)[:, None]

    # one light sample at the exit point through the Sw lobe (path.cpp:163)
    lt = scene.lights
    lidx, pmf = choose_light(lt, dim(10), cfg.light_strategy, p=pi_si.p)
    ls = sample_li(lt, lidx, pi_si.p, torch.stack([dim(11), dim(12)], -1))
    cos_wi = dot(ls.wi, pi_si.ns)
    f_sw = bss_sw(eta, cos_wi) * eta * eta * cos_wi.abs()
    refl_ok = dot(ls.wi, pi_si.ng) * dot(pi_si.ns, pi_si.ng) > 0
    usable = (ok & refl_ok & (ls.pdf > 0) & (f_sw > 0)
              & (ls.li > 0).any(dim=-1))
    o_sh = offset_ray_origin(pi_si.p, pi_si.ng, ls.wi)
    occ = intersect_any(scene.geo, o_sh, ls.wi,
                        shadow_t_max(ls, norm(ls.p_light - o_sh), usable),
                        traverse, time_g)
    sc_pdf = torch.clamp(cos_wi, min=0.0) / np.pi
    w_mis = torch.where(ls.is_delta, 1.0,
                        power_heuristic(1.0, ls.pdf, 1.0, sc_pdf))
    ld = ((f_sw * w_mis / torch.clamp(ls.pdf * pmf, min=1e-20))[:, None]
          * ls.li)
    L = L.index_put((sel,), L[sel] + torch.where(
        (usable & ~occ)[:, None], beta_b * ld, 0.0))

    # the continuation: cosine-sample the Sw lobe (path.cpp:167)
    wi_l = cosine_sample_hemisphere(dim(13), dim(14))
    tp, bp = _shading_frame(pi_si)
    wi_w = to_world(tp, bp, pi_si.ns, wi_l)
    cos_c = torch.clamp(wi_l[:, 2], min=0.0)
    ok = ok & (cos_c > 1e-7)
    # f |cos| / pdf with pdf = cos / pi: Sw eta^2 pi
    beta_b = beta_b * (bss_sw(eta, cos_c) * eta * eta * np.pi)[:, None]

    okc = ok[:, None]
    beta = beta.index_put((sel,), torch.where(okc, beta_b, beta_g))
    o = o.index_put((sel,), torch.where(
        okc, offset_ray_origin(pi_si.p, pi_si.ng, wi_w), o[sel]))
    d = d.index_put((sel,), torch.where(okc, wi_w, d[sel]))
    prev_pdf = prev_pdf.index_put((sel,), torch.where(
        ok, torch.clamp(cos_c / np.pi, min=1e-20), prev_pdf[sel]))
    prev_p = prev_p.index_put((sel,), torch.where(okc, pi_si.p, prev_p[sel]))
    alive = alive.index_put((sel,), ok)
    specular = specular & ~gate
    return o, d, beta, L, alive, specular, prev_pdf, prev_p


def ao_radiance(scene: SceneData, sampler, camera, px, py, sidx,
                cfg: IntegratorConfig, traverse, crop_xy=(0, 0)
                ) -> Dict[str, Any]:
    """AOIntegrator (integrators/ao.cpp; tpurt's ao_radiance,
    integrator.py:1148-1181): a closest hit, then ``cfg.ao_samples``
    any-hit rays out to 1e8 from each camera hit, cosine-weighted or
    uniform over the hemisphere of the normal faced toward the ray (dims
    5 + 2k and 6 + 2k), averaged.  As in tpurt the rays carry no shutter
    time: on a moving scene they see the geometry at time 0.  Only the
    lanes with a camera hit trace occlusion rays (the others add 0).
    Returns the lanes' p_film_crop, L and ray_w."""
    p_film, p_film_crop, p_lens, o, d, ray_w, sctx, _ = _camera_setup(
        sampler, camera, px, py, sidx, crop_xy, draw_time=camera.animated)
    n = px.shape[0]
    si = compute_interaction(scene.geo,
                             intersect_closest(scene.geo, o, d, INF,
                                               traverse), o, d)
    sel = torch.nonzero(si.valid).squeeze(1)
    # the normal faced toward the ray (ao.cpp Faceforward(n, -ray.d))
    ns = si.ns[sel]
    ns = torch.where(dot(ns, si.wo[sel])[:, None] < 0, -ns, ns)
    t, b = build_onb(ns)
    p, ng = si.p[sel], si.ng[sel]
    p_eps = None if si.p_eps is None else si.p_eps[sel]
    lanes = (px[sel], py[sel], sidx[sel])
    ctx = None if sctx is None else sctx[sel]
    acc = torch.zeros(sel.shape[0], dtype=torch.float32, device=o.device)
    for k in range(cfg.ao_samples):
        u1 = sampler.dim(*lanes, 5 + 2 * k, ctx)
        u2 = sampler.dim(*lanes, 6 + 2 * k, ctx)
        if cfg.ao_cos_sample:
            w_l = cosine_sample_hemisphere(u1, u2)
            weight = 1.0
        else:
            z = u1
            r = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
            phi = 2 * np.pi * u2
            w_l = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z],
                              dim=-1)
            weight = 2.0 * w_l[:, 2]
        w = to_world(t, b, ns, w_l)
        occ = intersect_any(scene.geo, offset_ray_origin(p, ng, w, p_eps),
                            w, 1e8, traverse)
        acc = acc + torch.where(~occ, weight, 0.0)
    total = torch.zeros(n, dtype=torch.float32, device=o.device)
    total = total.index_put((sel,), acc)
    L = (total / cfg.ao_samples)[:, None].expand(n, 3).contiguous()
    return dict(p_film_crop=p_film_crop, L=L, ray_w=ray_w)
