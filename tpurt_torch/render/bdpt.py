"""Bidirectional path tracer as a wavefront over per-depth vertex buffers
(port of tpurt/render/bdpt.py: VertexSoA, _convert_density, _vertex_f,
_random_walk_pair, _assemble, _remap0, _pdf_light_origin, _pdf_light and
bdpt_radiance with its debug and MLT arguments).

Reference analog: integrators/bdpt.{h,cpp}: Vertex (bdpt.h:128), the
camera and light subpaths through RandomWalk (bdpt.cpp:69-160),
ConnectBDPT over the (s, t) strategies (:302-571) and the remap0
pdfFwd/pdfRev MIS weight (:230-300).

Both subpaths walk as ONE 2n-lane batch, camera half then light half, a
Python loop over the steps: each step traces once through K1.  Every
(s, t) strategy is a static level of a Python loop over all lanes; the
t=1 strategies return film splats (Film::AddSplat), which render/driver.py
resolves with splat_scale = 1/spp (bdpt.cpp Render).  Each strategy's
visibility ray is collected and all are traced after the loop as one
connection batch: only the lanes whose strategy is usable (a non-zero
shadow-ray extent) are traced, in slices of CONNECT_SLICE rays, through
K1's any-hit walk (or the shadow walk through null boundaries).

Dimension schedule (static, tpurt's; the MLT primary-sample-space
replay reads it):
  0-4                      camera sample (pFilm, time, pLens)
  5 + dpb*b                camera-walk bounce b: lobe, u1, u2
                           (+ medium channel, distance with media)
  BL = 5+dpb*(maxdepth+1)  light: choice, upos.xy, udir.xy (5 dims)
  BL+5 + dpb*b             light-walk bounce b
  BC = BL+5+dpb*maxdepth   s=1 strategies: 3 dims per camera length t
with dpb = 3 walk dims a bounce without media and 5 with them.

The media code hashes its tracking uniforms by each lane's index in
tpurt's scan: ``track_lane`` (the lane's place in tpurt's chunk of
``track_chunk`` lanes) for the camera half, ``track_chunk + track_lane``
for the light half and ``k * track_chunk + track_lane`` for the k-th
connection strategy collected, as tpurt's 2n-lane walk and concatenated
pending batch number them.

Approximations of tpurt's, copied and not fixed (ROADMAP, Queue 3): the
lights share the camera medium; both subpaths of a lane share one
shutter time; a connection ray's transmittance is its origin medium's
over one segment where the scene has no null boundaries; the light
choice is the power pmf whatever ``lightsamplestrategy`` says.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from tpurt_torch.render.camera import camera_pdf_we, camera_sample_wi
from tpurt_torch.render.integrator import (INF, SHADOW_EPS, IntegratorConfig,
                                           SceneData, ShadeCtx,
                                           _camera_setup, _escape_pdf,
                                           _escape_radiance,
                                           lift_illum_maybe, make_shade_ctx,
                                           shade_f, shade_sample,
                                           to_rgb_maybe, zero_shade_ctx)
from tpurt_torch.render.interaction import (compute_interaction,
                                            offset_ray_origin)
from tpurt_torch.render.intersect import intersect_any, intersect_closest
from tpurt_torch.render.lights import (LIGHT_AREA_SPHERE, LIGHT_AREA_TRI,
                                       LIGHT_INFINITE, LightTable,
                                       choose_light, light_normal_at, pdf_le,
                                       sample_le, sample_li)
from tpurt_torch.render.sampling_warps import dot, norm
from tpurt_torch.render.volpath import (_hg_phase, _hg_sample, _medium_tr,
                                        _sample_medium_distance,
                                        _shadow_tr_walk)

# rays of the connection batch traced a K1 call
CONNECT_SLICE = 1 << 20
# profiler ranges around the walk, the strategy loop and the connection
# batch
WALK_RANGE = "tpurt_torch.bdpt_walk"
STRATEGY_RANGE = "tpurt_torch.bdpt_strategies"
CONNECT_RANGE = "tpurt_torch.bdpt_connect"


class Vertex(NamedTuple):
    """One depth of a subpath, every field (N, ...)."""

    p: torch.Tensor  # position (escaped: the ray direction)
    ng: torch.Tensor
    ns: torch.Tensor
    beta: torch.Tensor  # throughput INTO the vertex
    pdf_fwd: torch.Tensor  # area density, forward
    pdf_rev: torch.Tensor  # area density, reverse
    delta: torch.Tensor  # specular-bounce vertex
    valid: torch.Tensor
    escaped: torch.Tensor  # camera ray escaped to the infinite lights
    lrow: torch.Tensor  # light-table row (-1 none)
    is_medium: torch.Tensor  # phase-function vertex (bdpt.h:197)
    g: torch.Tensor  # HG asymmetry at medium vertices
    med: torch.Tensor  # medium the path ARRIVED in (-1 none)
    p_eps: torch.Tensor  # least spawn offset at the vertex (si.p_eps)
    shade: ShadeCtx  # the full material context of the vertex


class VertexSoA(NamedTuple):
    """A subpath's vertices by depth: every field a list of D per-depth
    tensors (N, ...) (tpurt's depth-stacked (D, N, ...) arrays; a list
    needs no stacking copy)."""

    p: List[torch.Tensor]
    ng: List[torch.Tensor]
    ns: List[torch.Tensor]
    beta: List[torch.Tensor]
    pdf_fwd: List[torch.Tensor]
    pdf_rev: List[torch.Tensor]
    delta: List[torch.Tensor]
    valid: List[torch.Tensor]
    escaped: List[torch.Tensor]
    lrow: List[torch.Tensor]
    is_medium: List[torch.Tensor]
    g: List[torch.Tensor]
    med: List[torch.Tensor]
    p_eps: List[torch.Tensor]
    shade: List[ShadeCtx]


def _v(V: VertexSoA, i: int) -> Vertex:
    """The vertices of depth i."""
    return Vertex(**{f: getattr(V, f)[i] for f in Vertex._fields})


def _dir_to(a_p, b_p):
    w = b_p - a_p
    d2 = torch.clamp(dot(w, w), min=1e-18)
    return w / torch.sqrt(d2)[:, None], d2


def _convert_density(pdf_dir, from_p, to_p, to_ng, to_escaped=None,
                     to_medium=None):
    """Solid-angle pdf at from -> area density at to
    (Vertex::ConvertDensity, bdpt.h:177): infinite vertices keep the
    solid-angle measure, medium vertices drop the |cos| factor."""
    w, d2 = _dir_to(from_p, to_p)
    cos = dot(to_ng, w).abs()
    if to_medium is not None:
        cos = torch.where(to_medium, 1.0, cos)
    area = pdf_dir * cos / d2
    if to_escaped is None:
        return area
    return torch.where(to_escaped, pdf_dir, area)


def _vertex_f(scene: SceneData, v: Vertex, w_out, w_in,
              has_media: bool = False):
    """(f, pdf) of Vertex::f / Vertex::Pdf's directional part
    (bdpt.h:204-234): the full material context at a surface vertex, the
    HG phase function (f == pdf) at a medium vertex.  w_out points toward
    the previous vertex, w_in toward the connection."""
    f, pdf = shade_f(scene, v.shade, v.ns, w_out, w_in)
    if has_media:
        # the propagation direction into the vertex is -w_out
        ph = _hg_phase(dot(-w_out, w_in), v.g)
        f = torch.where(v.is_medium[:, None], ph[:, None], f)
        pdf = torch.where(v.is_medium, ph, pdf)
    return f, pdf


def _random_walk_pair(scene: SceneData, texture_eval, sampler, px, py, sidx,
                      sctx, cam: dict, lit: dict, traverse, time=None,
                      track_lane=None, track_chunk: int = 0):
    """Both subpath walks as ONE 2n-lane batch (tpurt :144-316): the
    camera half ([:n], radiance transport) and the light half ([n:],
    importance transport with the shading-normal correction) share each
    step's closest traversal, interaction and material gathers; each
    half reads its own sampler dims.

    cam / lit: dicts of o, d, beta0, pdf0, alive0, med0, n_steps,
    dim_base.  Returns (cam_walk, lit_walk): per half, a dict of per-step
    lists of vertex fields plus each step's reverse-pdf emission
    (prev_rev_dir, prev_rev_from).

    Media (bdpt.cpp:87-99): each step distance-samples the lane's medium
    along the segment; a scatter makes a MEDIUM vertex whose continuation
    is an HG phase sample (f == pdf).  A null-material boundary is a delta
    pass-through vertex that switches the carried medium (tpurt's
    deviation from RandomWalk's bounces-- retry)."""
    n = px.shape[0]
    dev = px.device
    has_inf = scene.lights.has_infinite
    has_media = scene.has_media
    dpb = 5 if has_media else 3
    is_rad = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                        torch.zeros(n, dtype=torch.bool, device=dev)])
    c_steps, l_steps = cam["n_steps"], lit["n_steps"]
    time2 = None if time is None else torch.cat([time, time])
    lane2 = (None if not has_media else
             torch.cat([track_lane, track_lane + track_chunk]))

    def cat(key):
        return torch.cat([cam[key], lit[key]], dim=0)

    o, d, beta = cat("o"), cat("d"), cat("beta0")
    nch = beta.shape[-1]  # the colour channels the throughputs carry
    pdf_dir, alive, med = cat("pdf0"), cat("alive0"), cat("med0")
    prev_p = o
    steps: List[Dict[str, Any]] = []
    for b in range(max(c_steps, l_steps)):
        # bound each half to its own walk length
        if b >= l_steps:
            alive = alive & is_rad
        if b >= c_steps:
            alive = alive & ~is_rad
        hit = intersect_closest(scene.geo, o, d,
                                torch.where(alive, INF, 0.0), traverse,
                                time2)
        si = compute_interaction(scene.geo, hit, o, d,
                                 tangents=scene.has_tangents, time=time2,
                                 media=has_media, faces=scene.has_ptex)
        dc = cam["dim_base"] + dpb * b
        dl = lit["dim_base"] + dpb * b

        def dim2(off):
            return torch.cat([sampler.dim(px, py, sidx, dc + off, sctx),
                              sampler.dim(px, py, sidx, dl + off, sctx)])

        if has_media:
            t_surf = torch.where(si.valid, hit.t, INF)
            # the dead lanes' results are dropped: they sample no medium
            med_live = torch.where(alive, med, -1)
            scattered, t_min, thru, g_med = _sample_medium_distance(
                scene, med_live, o, d, t_surf, dim2(3), dim2(4), lane2, b,
                nch)
            sampled_med = alive & scattered
            beta = torch.where((alive & (med >= 0))[:, None], beta * thru,
                               beta)
        else:
            sampled_med = torch.zeros_like(alive)
            g_med = torch.zeros(2 * n, dtype=torch.float32, device=dev)

        escaped = (alive & ~si.valid & ~sampled_med & is_rad if has_inf
                   else torch.zeros_like(alive))
        surf_valid = alive & si.valid & ~sampled_med
        vvalid = surf_valid | sampled_med
        if has_media:
            p_v = torch.where(sampled_med[:, None], o + t_min[:, None] * d,
                              si.p)
            pdf_fwd = _convert_density(pdf_dir, prev_p, p_v, si.ng,
                                       to_medium=sampled_med)
        else:
            p_v = si.p
            pdf_fwd = _convert_density(pdf_dir, prev_p, p_v, si.ng)
        pdf_fwd = torch.where(escaped, pdf_dir, pdf_fwd)

        shade = make_shade_ctx(scene, si, texture_eval, channels=nch)
        lrow = torch.where(
            surf_valid,
            scene.lights.prim_to_light[si.prim.clamp(min=0).long()], -1)

        u1, u2 = dim2(1), dim2(2)
        wi_s, f, pdf, is_spec, is_trans = shade_sample(
            scene, shade, si.ns, si.wo, dim2(0), u1, u2)
        _, pdf_rev_dir = shade_f(scene, shade, si.ns, wi_s, si.wo)

        ok_surf = surf_valid & (pdf > 0) & (f > 0).any(dim=-1)
        if has_media:
            any_lobe = shade.lobes.active.any(dim=-1)
            if shade.special is not None:
                any_lobe = any_lobe | shade.special
            null_b = (surf_valid & ~any_lobe
                      & ((si.med_in >= 0) | (si.med_out >= 0)))
            wi_m, ph = _hg_sample(d, g_med, u1, u2)
            wi = torch.where(sampled_med[:, None], wi_m,
                             torch.where(null_b[:, None], d, wi_s))
            pdf_cont = torch.where(sampled_med, ph, pdf)
            prev_rev_dir = torch.where(
                sampled_med, ph,
                torch.where(is_spec | null_b, 0.0, pdf_rev_dir))
            is_delta = (is_spec & surf_valid & ~null_b) | null_b
        else:
            null_b = torch.zeros_like(alive)
            wi = wi_s
            pdf_cont = pdf
            prev_rev_dir = torch.where(is_spec, 0.0, pdf_rev_dir)
            is_delta = is_spec & vvalid

        # the shading-normal correction on the importance half only
        num = (dot(si.wo, si.ns) * dot(wi_s, si.ng)).abs()
        den = (dot(si.wo, si.ng) * dot(wi_s, si.ns)).abs()
        corr_imp = torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                               0.0)
        corr = torch.where(is_rad, 1.0, corr_imp)
        ok_b = ok_surf & ~null_b
        # medium scatter: phase f/pdf == 1; null: unchanged
        beta_next = torch.where(
            ok_b[:, None],
            beta * f * (dot(wi_s, si.ns).abs() * corr
                        / torch.clamp(pdf, min=1e-20))[:, None],
            beta)
        ok = ok_b | sampled_med | null_b
        if has_media:
            # the medium handoff: null pass-through and transmission
            entering = dot(d, si.ng) < 0
            new_med = torch.where(entering, si.med_in, si.med_out)
            crossed = null_b | (ok_b & is_trans)
            med_next = torch.where(crossed, new_med, med)
        else:
            med_next = med

        steps.append(dict(
            p=torch.where(escaped[:, None], d, p_v),
            ng=torch.where(surf_valid[:, None], si.ng, 0.0),
            ns=torch.where(surf_valid[:, None], si.ns, 0.0),
            beta=torch.where((vvalid | escaped)[:, None], beta, 0.0),
            pdf_fwd=torch.where(vvalid | escaped, pdf_fwd, 0.0),
            delta=is_delta, valid=vvalid, escaped=escaped, lrow=lrow,
            is_medium=sampled_med, g=g_med, med=med,
            p_eps=(torch.where(surf_valid, si.p_eps, 0.0)
                   if si.p_eps is not None else torch.zeros_like(hit.t)),
            shade=shade, prev_rev_dir=prev_rev_dir, prev_rev_from=p_v))
        o_next = offset_ray_origin(si.p, si.ng, wi, si.p_eps)
        if has_media:
            o_next = torch.where(sampled_med[:, None], p_v, o_next)
        o, d, beta = o_next, wi, beta_next
        pdf_dir = torch.where(is_delta, 0.0, pdf_cont)
        alive, prev_p, med = ok, p_v, med_next

    def half(lo, hi, n_steps):
        out = {}
        for k in steps[0]:
            if k == "shade":
                out[k] = [ShadeCtx(*[_slice(x, lo, hi) for x in st[k]])
                          for st in steps[:n_steps]]
            else:
                out[k] = [st[k][lo:hi] for st in steps[:n_steps]]
        return out

    return half(0, n, c_steps), half(n, 2 * n, l_steps)


def _slice(x, lo: int, hi: int):
    """Rows [lo, hi) of a tensor, of every tensor of a NamedTuple or tuple,
    None kept."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[lo:hi]
    parts = [_slice(y, lo, hi) for y in x]
    return tuple(parts) if type(x) is tuple else type(x)(*parts)


def _assemble(v0: dict, walk: dict, n_steps: int,
              has_media: bool = False) -> VertexSoA:
    """v0 + the walk's vertices, with pdf_rev wired up: the walk emits at
    step i the solid-angle reverse pdf toward vertex i, converted with
    vertex i's own position and normal (cos dropped at medium
    vertices)."""
    fields = {k: [v0[k]] + walk[k] for k in VertexSoA._fields
              if k != "pdf_rev"}
    p, ng = fields["p"], fields["ng"]
    rev = [torch.zeros_like(fields["pdf_fwd"][0])
           for _ in range(n_steps + 1)]
    for i in range(n_steps):
        to_med = fields["is_medium"][i] if has_media else None
        rev[i] = _convert_density(walk["prev_rev_dir"][i],
                                  walk["prev_rev_from"][i], p[i], ng[i],
                                  to_medium=to_med)
    fields["pdf_rev"] = rev
    return VertexSoA(**fields)


def _remap0(x):
    return torch.where(x == 0, 1.0, x)


def _pdf_light_origin(lt: LightTable, v_lrow, v_escaped, v_p, w_escape,
                      strategy_pmf):
    """Vertex::PdfLightOrigin: area density x light-choice pmf; the
    infinite lights use the directional density (bdpt.h:253)."""
    lrow_c = v_lrow.clamp(min=0).long()
    # pdf_pos from pdf_le with a dummy direction (its position part)
    pdf_pos, _ = pdf_le(lt, lrow_c, v_p, v_p, v_p)
    finite = torch.where(v_lrow >= 0, pdf_pos * strategy_pmf[lrow_c], 0.0)
    if lt.has_infinite:
        inf_density = _escape_pdf(lt, w_escape) * lt.inf_power_pmf
        return torch.where(v_escaped, inf_density, finite)
    return finite


def _pdf_light(lt: LightTable, v_lrow, v_escaped, v_p, v_ng, to_p, to_ng,
               world_r: float, to_medium=None):
    """Vertex::PdfLight: the emission direction's density converted to
    area at the receiver; the infinite lights use 1/(pi r^2)
    (bdpt.h:232); a medium receiver drops the |cos| factor."""
    w, d2 = _dir_to(v_p, to_p)
    _, pdf_dir = pdf_le(lt, v_lrow.clamp(min=0).long(), v_p, v_ng, w)
    cos = dot(to_ng, w).abs()
    if to_medium is not None:
        cos = torch.where(to_medium, 1.0, cos)
    pdf = torch.where(v_lrow >= 0, pdf_dir / d2 * cos, 0.0)
    return torch.where(v_escaped, 1.0 / (np.pi * world_r * world_r), pdf)


def bdpt_radiance(scene: SceneData, sampler, camera, px, py, sidx,
                  cfg: IntegratorConfig, traverse, crop_xy=(0, 0),
                  texture_eval=None, track_lane=None,
                  track_chunk: Optional[int] = None, debug_strategy=None,
                  debug_unweighted: bool = False, depth_select=None,
                  s_select=None) -> Dict[str, Any]:
    """One wavefront of bidirectional estimates (tpurt :385-811).

    Returns p_film_crop, L and ray_w for the film's weighted samples and,
    where a t=1 strategy ran, splat_p / splat_L (one block of n lanes a
    strategy).  ``track_lane`` / ``track_chunk``: each lane's place in
    tpurt's chunk and that chunk's size, read by the media hash (default:
    the lanes' order, one chunk of n).

    debug_strategy=(s, t) keeps one strategy and debug_unweighted=True
    sets its MIS weight to 1 (the per-strategy unbiasedness harness).

    MLT mode (mlt.cpp L(), :100-140): depth_select (int) keeps the
    strategies with s+t-2 == depth; s_select (N,) picks ONE strategy per
    lane, whose contribution is scaled by the strategy count, and
    everything is returned as splats, the t>=2 strategies at the camera
    raster, in tpurt's order: the s=0 strategy first (deposited in the
    loop), then the connection strategies in loop order."""
    n = px.shape[0]
    dev = px.device
    lt = scene.lights
    max_depth = cfg.max_depth
    t_max_v = max_depth + 2  # camera vertices
    s_max_v = max_depth + 1  # light vertices
    has_media = scene.has_media
    dpb = 5 if has_media else 3
    strategy_pmf = lt.power_pmf  # bdpt's default lightsamplestrategy
    if track_lane is None:
        track_lane = torch.arange(n, device=dev)
        track_chunk = n

    p_film, p_film_crop, p_lens, o, d, ray_w, sctx, l_time = _camera_setup(
        sampler, camera, px, py, sidx, crop_xy,
        draw_time=camera.animated or scene.has_motion)
    cam_o, cam_fwd = camera.origin, camera.forward

    def zeros(dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device=dev)

    # ---- the camera subpath's endpoint ----
    # spectral mode: throughputs and emissions carry nch bins, the MIS
    # weights stay scalar, deposit() converts to RGB (tpurt :416-418)
    nch = cfg.nch
    _, cam_pdf_dir = camera_pdf_we(camera, d)
    onesc = torch.ones((n, nch), dtype=torch.float32, device=dev)
    med_cam = torch.full((n,), scene.camera_medium, dtype=torch.int32,
                         device=dev)
    zb, zf = zeros(torch.bool), zeros()
    cam_v0 = dict(
        p=cam_o[None, :].expand(n, 3), ng=cam_fwd[None, :].expand(n, 3),
        ns=cam_fwd[None, :].expand(n, 3), beta=onesc, pdf_fwd=zf + 1.0,
        delta=zb, valid=~zb, escaped=zb, lrow=zeros(torch.int64) - 1,
        is_medium=zb, g=zf, med=med_cam, p_eps=zf,
        shade=zero_shade_ctx(scene, n, dev, channels=nch))
    # ---- the light subpath's endpoint ----
    bl = 5 + dpb * (t_max_v - 1)

    def dim(k):
        return sampler.dim(px, py, sidx, k, sctx)

    lidx, lpmf = choose_light(lt, dim(bl), "power")
    le = sample_le(lt, lidx, dim(bl + 1), dim(bl + 2), dim(bl + 3),
                   dim(bl + 4))
    l_valid = (le.pdf_pos > 0) & (le.pdf_dir > 0) & (le.le > 0).any(dim=-1)
    le_c = lift_illum_maybe(le.le, nch)
    # the lights share the camera medium (tpurt's scope: exact for
    # global-fog scenes)
    lit_v0 = dict(
        p=le.p, ng=le.n, ns=le.n,
        beta=le_c / torch.clamp(le.pdf_pos * lpmf, min=1e-20)[:, None],
        pdf_fwd=le.pdf_pos * lpmf, delta=zb, valid=l_valid, escaped=zb,
        lrow=lidx, is_medium=zb, g=zf, med=med_cam, p_eps=zf,
        shade=zero_shade_ctx(scene, n, dev, channels=nch))
    beta0 = le_c * (dot(le.n, le.d).abs()
                     / torch.clamp(lpmf * le.pdf_pos * le.pdf_dir,
                                   min=1e-20))[:, None]
    o_l = torch.where((le.is_delta_pos | le.is_infinite)[:, None], le.p,
                      offset_ray_origin(le.p, le.n, le.d))
    # ---- both walks as one 2n-lane batch; the light half shares the
    # lane's camera-sampled shutter time ----
    with torch.profiler.record_function(WALK_RANGE):
        cam_walk, lit_walk = _random_walk_pair(
            scene, texture_eval, sampler, px, py, sidx, sctx,
            cam=dict(o=o, d=d, beta0=onesc * ray_w[:, None],
                     pdf0=cam_pdf_dir, alive0=~zb, med0=med_cam,
                     n_steps=t_max_v - 1, dim_base=5),
            lit=dict(o=o_l, d=le.d, beta0=beta0, pdf0=le.pdf_dir,
                     alive0=l_valid, med0=med_cam, n_steps=s_max_v - 1,
                     dim_base=bl + 5),
            traverse=traverse, time=l_time, track_lane=track_lane,
            track_chunk=track_chunk)
    CAM = _assemble(cam_v0, cam_walk, t_max_v - 1, has_media)
    LIT = _assemble(lit_v0, lit_walk, s_max_v - 1, has_media)
    del cam_walk, lit_walk
    lkind = lt.rows[:, 0].to(torch.int32)
    lit_delta_light = ((lkind != LIGHT_AREA_TRI) & (lkind != LIGHT_AREA_SPHERE)
                       & (lkind != LIGHT_INFINITE))[lidx.clamp(min=0)]
    world_r = lt.world_radius

    def mis_weight(s, t, pt_rev, ptm_rev, qs_rev, qsm_rev, qs_pdf_fwd=None,
                   qs_delta_light=None):
        """bdpt.cpp MISWeight with the endpoint pdfRev overrides at
        static indices (tpurt :482-518)."""
        if debug_unweighted or s + t == 2:
            return zf + 1.0
        sum_ri = zeros()
        # the camera side
        ri = zf + 1.0
        for i in range(t - 1, 0, -1):
            rev = (pt_rev if i == t - 1
                   else (ptm_rev if i == t - 2 else CAM.pdf_rev[i]))
            ri = ri * _remap0(rev) / _remap0(CAM.pdf_fwd[i])
            sum_ri = sum_ri + torch.where(~CAM.delta[i] & ~CAM.delta[i - 1],
                                          ri, 0.0)
        # the light side
        ri = zf + 1.0
        for i in range(s - 1, -1, -1):
            if i == s - 1:
                rev = qs_rev
                fwd = (qs_pdf_fwd if (s == 1 and qs_pdf_fwd is not None)
                       else LIT.pdf_fwd[i])
                delta_i = zb if s == 1 else LIT.delta[i]
            elif i == s - 2:
                rev, fwd, delta_i = qsm_rev, LIT.pdf_fwd[i], LIT.delta[i]
            else:
                rev, fwd, delta_i = (LIT.pdf_rev[i], LIT.pdf_fwd[i],
                                     LIT.delta[i])
            ri = ri * _remap0(rev) / _remap0(fwd)
            if i > 0:
                delta_prev = LIT.delta[i - 1]
            else:
                delta_prev = (qs_delta_light if (s == 1 and
                                                 qs_delta_light is not None)
                              else lit_delta_light)
            sum_ri = sum_ri + torch.where(~delta_i & ~delta_prev, ri, 0.0)
        return 1.0 / (1.0 + sum_ri)

    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    crop = torch.tensor(crop_xy, dtype=torch.float32, device=dev)
    splat_p: List[torch.Tensor] = []
    splat_L: List[torch.Tensor] = []
    bc = bl + 5 + dpb * (s_max_v - 1)
    mlt_mode = depth_select is not None
    n_strat = (depth_select + 2) if mlt_mode else 1

    def deposit(s, contrib, p_raster=None):
        """A strategy's weighted contribution: the pixel sample normally,
        per-lane masked splats in MLT mode; spectral contributions become
        RGB here, the film being 3-channel (tpurt :527-533)."""
        nonlocal L
        contrib = to_rgb_maybe(contrib)
        if mlt_mode:
            c = contrib * n_strat
            if s_select is not None:
                c = torch.where((s_select == s)[:, None], c, 0.0)
            splat_p.append(p_raster if p_raster is not None
                           else p_film_crop)
            splat_L.append(c)
        elif p_raster is not None:
            splat_p.append(p_raster)
            splat_L.append(contrib)
        else:
            L = L + contrib

    # every connection strategy's visibility ray is collected and traced
    # after the loop (resolve_pending); val is its full weighted
    # contribution as if unoccluded
    pending = []  # (s, val, o_sh, d_sh, t_sh, med, p_raster, usable)

    def w_to(a, b):
        return _dir_to(a, b)[0]

    def medium_of(v: Vertex):
        return v.is_medium if has_media else None

    with torch.profiler.record_function(STRATEGY_RANGE):
        for t in range(1, t_max_v + 1):
            for s in range(0, s_max_v + 1):
                depth = s + t - 2
                if (s == 1 and t == 1) or depth < 0 or depth > max_depth:
                    continue
                if (debug_strategy is not None
                        and (s, t) != tuple(debug_strategy)):
                    continue
                if mlt_mode and depth != depth_select:
                    continue

                if s == 0:
                    # the camera path alone: vertex t-1 must be emissive
                    pt, ptm = _v(CAM, t - 1), _v(CAM, t - 2)
                    on_light = pt.valid & (pt.lrow >= 0)
                    w_to_prev = w_to(pt.p, ptm.p)
                    lrow_rec = lt.rows[pt.lrow.clamp(min=0).long()]
                    emits = (lrow_rec[:, 13] > 0) | (dot(pt.ng, w_to_prev) > 0)
                    Le_v = torch.where((on_light & emits)[:, None],
                                       lift_illum_maybe(lrow_rec[:, 1:4],
                                                        nch), 0.0)
                    usable = on_light
                    if lt.has_infinite:
                        # p holds the escaped ray's direction
                        Le_v = torch.where(
                            pt.escaped[:, None],
                            lift_illum_maybe(_escape_radiance(lt, pt.p), nch),
                            Le_v)
                        usable = on_light | pt.escaped
                    contrib = pt.beta * Le_v
                    if t == 2:
                        w = zf + 1.0
                    else:
                        pt_rev = _pdf_light_origin(lt, pt.lrow, pt.escaped,
                                                   pt.p, pt.p, strategy_pmf)
                        ptm_rev = _pdf_light(lt, pt.lrow, pt.escaped, pt.p,
                                             pt.ng, ptm.p, ptm.ng, world_r,
                                             to_medium=medium_of(ptm))
                        w = mis_weight(0, t, pt_rev, ptm_rev, None, None)
                    deposit(s, torch.where(usable[:, None],
                                           contrib * w[:, None], 0.0))
                    continue

                qs = _v(LIT, s - 1)
                if t == 1:
                    # the light subpath connected to the camera, splatted
                    # (s >= 2 here); the lens point fixed at the centre
                    ok = qs.valid & ~qs.delta
                    wi, pdf_cam, we, p_raster, p_lens_w, _ = camera_sample_wi(
                        camera, qs.p, torch.full((n, 2), 0.5, device=dev))
                    qsm = _v(LIT, s - 2)
                    w_to_prev = w_to(qs.p, qsm.p)
                    f_qs, _ = _vertex_f(scene, qs, w_to_prev, wi, has_media)
                    # the importance-transport shading-normal correction
                    num = (dot(w_to_prev, qs.ns) * dot(wi, qs.ng)).abs()
                    den = (dot(w_to_prev, qs.ng) * dot(wi, qs.ns)).abs()
                    corr = torch.where(den > 0,
                                       num / torch.clamp(den, min=1e-12), 0.0)
                    # surface: |cos(wi, ns)| x correction; medium: neither
                    amp = dot(wi, qs.ns).abs() * corr
                    if has_media:
                        amp = torch.where(qs.is_medium, 1.0, amp)
                    amp = amp / torch.clamp(pdf_cam, min=1e-20)
                    contrib = qs.beta * f_qs * we[:, None] * amp[:, None]
                    usable = (ok & (pdf_cam > 0) & (we > 0)
                              & (contrib > 0).any(dim=-1))
                    o_sh = offset_ray_origin(qs.p, qs.ng, wi, qs.p_eps)
                    t_sh = torch.where(
                        usable, norm(p_lens_w - o_sh) * (1 - SHADOW_EPS),
                        0.0)
                    # MIS: the camera side has no interior vertices
                    qs_rev = _convert_density(
                        camera_pdf_we(camera, -wi)[1], p_lens_w, qs.p, qs.ng,
                        to_medium=medium_of(qs))
                    qsm_rev = None
                    if s > 1:
                        _, pdf2 = _vertex_f(scene, qs, wi, w_to_prev,
                                            has_media)
                        qsm_rev = _convert_density(pdf2, qs.p, qsm.p, qsm.ng,
                                                   to_medium=medium_of(qsm))
                    w = mis_weight(s, 1, None, None, qs_rev, qsm_rev)
                    pending.append((s, torch.where(usable[:, None],
                                                   contrib * w[:, None], 0.0),
                                    o_sh, wi, t_sh, qs.med, p_raster - crop,
                                    usable))
                    continue

                pt, ptm = _v(CAM, t - 1), _v(CAM, t - 2)
                base_ok = pt.valid & ~pt.delta & ~pt.escaped

                if s == 1:
                    # sample a light from pt (the reference re-samples rather
                    # than use the light subpath's vertex)
                    d0 = bc + 3 * (t - 2)
                    lidx2, pmf2 = choose_light(lt, dim(d0), "power")
                    ls = sample_li(lt, lidx2, pt.p,
                                   torch.stack([dim(d0 + 1), dim(d0 + 2)], -1))
                    w_to_prev = w_to(pt.p, ptm.p)
                    f_pt, _ = _vertex_f(scene, pt, w_to_prev, ls.wi, has_media)
                    amp = dot(ls.wi, pt.ns).abs()
                    if has_media:
                        amp = torch.where(pt.is_medium, 1.0, amp)
                    contrib = (pt.beta * f_pt * lift_illum_maybe(ls.li, nch)
                               * (amp / torch.clamp(ls.pdf * pmf2,
                                                    min=1e-20))[:, None])
                    usable = (base_ok & (ls.pdf > 0)
                              & (contrib > 0).any(dim=-1))
                    o_sh = offset_ray_origin(pt.p, pt.ng, ls.wi, pt.p_eps)
                    t_sh = torch.where(
                        usable, norm(ls.p_light - o_sh) * (1 - SHADOW_EPS)
                        - 2e-3 * torch.clamp(ls.p_light.abs().amax(dim=-1),
                                             min=1.0), 0.0)
                    # the sampled light vertex for MIS: the TRUE surface normal
                    # at the sampled point
                    lrow2 = lidx2.clamp(min=0)
                    n_l = light_normal_at(lt, lrow2, ls.p_light)
                    pdf_pos_s, _ = pdf_le(lt, lrow2, ls.p_light, n_l, -ls.wi)
                    # pt.pdfRev: the density of the light generating pt
                    pt_rev = _pdf_light(lt, lidx2, zb, ls.p_light, n_l, pt.p,
                                        pt.ng, world_r,
                                        to_medium=medium_of(pt))
                    # ptm.pdfRev: the bsdf / phase at pt toward ptm given wi
                    _, pdf_ptm = _vertex_f(scene, pt, ls.wi, w_to_prev,
                                           has_media)
                    ptm_rev = _convert_density(pdf_ptm, pt.p, ptm.p, ptm.ng,
                                               to_medium=medium_of(ptm))
                    # qs.pdfRev: pt generating the light point
                    _, pdf_qs = _vertex_f(scene, pt, w_to_prev, ls.wi,
                                          has_media)
                    qs_rev = _convert_density(pdf_qs, pt.p, ls.p_light, n_l)
                    w = mis_weight(1, t, pt_rev, ptm_rev, qs_rev, None,
                                   qs_pdf_fwd=pdf_pos_s * pmf2,
                                   qs_delta_light=ls.is_delta)
                    pending.append((s, torch.where(usable[:, None],
                                                   contrib * w[:, None], 0.0),
                                    o_sh, ls.wi, t_sh, pt.med, None, usable))
                    continue

                # ---- the general s >= 2, t >= 2 connection ----
                qsm = _v(LIT, s - 2)
                ok = base_ok & qs.valid & ~qs.delta
                # camera vertex -> light vertex
                w_c, d2_c = _dir_to(pt.p, qs.p)
                w_to_prev_c = w_to(pt.p, ptm.p)
                w_to_prev_l = w_to(qs.p, qsm.p)
                f_pt, pdf_c = _vertex_f(scene, pt, w_to_prev_c, w_c, has_media)
                f_qs, pdf_a = _vertex_f(scene, qs, w_to_prev_l, -w_c,
                                        has_media)
                # G(): cos terms only at surface endpoints (bdpt.cpp:247-253)
                cos_pt = dot(pt.ns, w_c).abs()
                cos_qs = dot(qs.ns, w_c).abs()
                if has_media:
                    cos_pt = torch.where(pt.is_medium, 1.0, cos_pt)
                    cos_qs = torch.where(qs.is_medium, 1.0, cos_qs)
                g = cos_pt * cos_qs / d2_c
                contrib = qs.beta * f_qs * f_pt * pt.beta * g[:, None]
                usable = ok & (contrib > 0).any(dim=-1)
                o_sh = offset_ray_origin(pt.p, pt.ng, w_c, pt.p_eps)
                tgt = offset_ray_origin(qs.p, qs.ng, -w_c, qs.p_eps)
                t_sh = torch.where(usable, norm(tgt - o_sh) * (1 - SHADOW_EPS),
                                   0.0)
                # the endpoint pdf overrides
                pt_rev = _convert_density(pdf_a, qs.p, pt.p, pt.ng,
                                          to_medium=medium_of(pt))
                _, pdf_b = _vertex_f(scene, pt, w_c, w_to_prev_c, has_media)
                ptm_rev = _convert_density(pdf_b, pt.p, ptm.p, ptm.ng,
                                           to_medium=medium_of(ptm))
                qs_rev = _convert_density(pdf_c, pt.p, qs.p, qs.ng,
                                          to_medium=medium_of(qs))
                _, pdf_d = _vertex_f(scene, qs, -w_c, w_to_prev_l, has_media)
                qsm_rev = _convert_density(pdf_d, qs.p, qsm.p, qsm.ng,
                                           to_medium=medium_of(qsm))
                w = mis_weight(s, t, pt_rev, ptm_rev, qs_rev, qsm_rev)
                pending.append((s, torch.where(usable[:, None],
                                               contrib * w[:, None], 0.0),
                                o_sh, w_c, t_sh, pt.med, None, usable))

    with torch.profiler.record_function(CONNECT_RANGE):
        occluded, tr = _connect(scene, pending, traverse, l_time,
                                track_lane, track_chunk)
    for k, (s, val, _, _, _, _, p_raster, _) in enumerate(pending):
        if tr is not None:
            val = val * tr[k]
        deposit(s, torch.where(occluded[k][:, None], 0.0, val), p_raster)
    out = dict(p_film_crop=p_film_crop, L=L, ray_w=ray_w)
    if splat_p:
        out["splat_p"] = torch.cat(splat_p, dim=0)
        out["splat_L"] = torch.cat(splat_L, dim=0)
    return out


def _connect(scene: SceneData, pending, traverse, time, track_lane,
             track_chunk: int):
    """Trace the connection batch (tpurt's resolve_pending, :561-590):
    the usable lanes of every collected strategy, concatenated in
    collection order, in slices of CONNECT_SLICE rays through K1's any-hit
    walk, or the shadow walk on a scene with null boundaries; in media,
    each segment's transmittance from its origin's medium.  The media
    hash reads lane k * track_chunk + track_lane for strategy k.  Returns
    per strategy (occluded (n,), transmittance (n, nch) or None)."""
    if not pending:
        return [], None
    n, nch = pending[0][1].shape
    dev = pending[0][1].device
    sel = [torch.nonzero(p[7]).squeeze(1) for p in pending]
    O = torch.cat([p[2][i] for p, i in zip(pending, sel)])
    D = torch.cat([p[3][i] for p, i in zip(pending, sel)])
    T = torch.cat([p[4][i] for p, i in zip(pending, sel)])
    tf = None if time is None else torch.cat([time[i] for i in sel])
    occ = torch.zeros(T.shape[0], dtype=torch.bool, device=dev)
    tr = None
    if scene.has_media:
        MED = torch.cat([p[5][i] for p, i in zip(pending, sel)])
        lanes = torch.cat([k * track_chunk + track_lane[i]
                           for k, i in enumerate(sel)])
        if scene.has_null_boundaries:
            occ, tr = _shadow_tr_walk(scene, O, D, T, MED, lanes, 0,
                                      usable=T > 0, traverse=traverse,
                                      time=tf, channels=nch)
        else:
            occ = _trace_slices(scene, O, D, T, traverse, tf)
            tr = _medium_tr(scene, MED, T, O, D, lanes, 0, live=~occ,
                            channels=nch)
    else:
        occ = _trace_slices(scene, O, D, T, traverse, tf)
    # back to one (n,) row a strategy
    out_occ, out_tr, at = [], [], 0
    for i in sel:
        m = i.shape[0]
        o_k = torch.zeros(n, dtype=torch.bool, device=dev)
        out_occ.append(o_k.index_put((i,), occ[at:at + m]))
        if tr is not None:
            t_k = torch.ones((n, nch), dtype=torch.float32, device=dev)
            out_tr.append(t_k.index_put((i,), tr[at:at + m]))
        at += m
    return out_occ, (out_tr if tr is not None else None)


def _trace_slices(scene: SceneData, o, d, t_max, traverse, time):
    """Any-hit occlusion of the batch, CONNECT_SLICE rays a K1 call."""
    parts = []
    for a in range(0, o.shape[0], CONNECT_SLICE):
        b = a + CONNECT_SLICE
        parts.append(intersect_any(scene.geo, o[a:b], d[a:b], t_max[a:b],
                                   traverse,
                                   None if time is None else time[a:b]))
    if not parts:
        return torch.zeros(0, dtype=torch.bool, device=o.device)
    return torch.cat(parts)
