"""Participating media and the volumetric path tracer (port of
tpurt/render/integrator.py:1187-1719: ``_hg_phase``, ``_hg_sample``,
``_track_u``, ``_grid_density_at``, ``_grid_ray``, ``_grid_sample_medium``,
``_grid_tr``, ``_sample_medium_distance``, ``_medium_tr``, ``_shadow_tr_walk``
and ``volpath_radiance``'s ``bounce_body`` and ``nee_from``).

Homogeneous media sample their free-flight distance in closed form
(homogeneous.cpp); grid media by delta tracking (grid.cpp:60-96) and
their transmittance by ratio tracking with its Russian roulette
(grid.cpp:44-58).  tpurt runs every tracking loop for its whole budget
(``GRID_TRACK_STEPS`` steps, a ``fori_loop``); a lane freezes once it is
done, so the port carries only the lanes not yet done, drops the
finished ones every ``TRACK_CHECK`` steps with a boolean index and stops
when none is left: the same values, in fewer steps.  The tracking
uniforms come from a counter hash of (lane, bounce, step, salt), the
lane being its position in tpurt's scan chunk (``config.tpurt_chunk``),
so that both packages draw the same numbers.

Volpath is a wavefront step over the lane-state dict, like the path step
(``volpath_bounce_init`` / ``volpath_bounce_step``): each step shades the
hit carried from the previous one (medium sampling, emission, the
null-boundary pass-through, next-event estimation from the surface or
the medium vertex, the phase or BSDF continuation, Russian roulette) and
then traces the next closest hit, 9 sampler dims a bounce.  Shadow rays
walk up to ``SHADOW_WALK_STEPS`` null-material boundaries through K1's
closest-hit walk on a scene that has them, else they take one any-hit
ray and one segment's transmittance.

The loops' overflows (lanes that exhaust a budget) and the tracking steps
accumulate on the device in ``TRACK_STATS``, under tpurt's counter names,
and are read once a frame.  tpurt counts an overflow over every lane of
its chunk, the dead and the vacuum ones included, whose results it
drops; the port tracks, and counts, only the lanes whose result is used.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tpurt_torch.config import GRID_TRACK_STEPS, SHADOW_WALK_STEPS
from tpurt_torch.render.integrator import (
    CAMERA_DIMS, INF, IntegratorConfig, SceneData, _emitted, _escape_pdf,
    _escape_radiance, carried_interaction, lift_illum_maybe,
    lift_refl_maybe, make_shade_ctx, path_bounce_init, shade_f,
    shade_sample, shadow_t_max)
from tpurt_torch.render.interaction import (compute_interaction,
                                            offset_ray_origin)
from tpurt_torch.render.intersect import intersect_any, intersect_closest
from tpurt_torch.render.lights import (choice_pmf_at, choose_light,
                                       pdf_li_from_hit, sample_li)
from tpurt_torch.render.materials_build import C_KIND, MAT_NONE
from tpurt_torch.render.sampling_warps import (build_onb, dot, matvec_lanes,
                                               norm, power_heuristic,
                                               to_world)
from tpurt_torch.utils.stats import TRACK_STATS

DIMS_PER_BOUNCE_VOL = 9  # + the medium channel and distance dims
# tracking steps between the checks that drop the lanes done
TRACK_CHECK = 8
GRID_OVERFLOW = "Media/Grid tracking budget exhausted"
WALK_OVERFLOW = "Media/Shadow walk budget exhausted"
_M32 = 0xFFFFFFFF
# profiler ranges around the tracking loops and the shadow walk (the
# walk's own ratio tracking nests inside it)
TRACKING_RANGE = "tpurt_torch.grid_tracking"
WALK_RANGE = "tpurt_torch.shadow_walk"




# ---------------------------------------------------------------------------
# phase function, tracking hash, grid lookups
# ---------------------------------------------------------------------------

def _hg_phase(cos_theta, g):
    """Henyey-Greenstein phase function of the cosine between the
    propagation direction and wi (tpurt's sign convention, :1193)."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * np.pi * denom
                            * torch.sqrt(torch.clamp(denom, min=1e-9)))


def _hg_sample(d, g, u1, u2):
    """A scattered direction about the propagation direction d and its
    phase value (HenyeyGreenstein::Sample_p; tpurt :1203)."""
    small = g.abs() < 1e-3
    g_safe = torch.where(small, 1e-3, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
    cos_hg = (1.0 + g * g - sqr * sqr) / (2.0 * g_safe)
    cos_theta = torch.where(small, 1.0 - 2.0 * u1,
                            torch.clamp(cos_hg, -1.0, 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * np.pi * u2
    t, b = build_onb(d)
    local = torch.stack([sin_theta * torch.cos(phi),
                         sin_theta * torch.sin(phi), cos_theta], dim=-1)
    return to_world(t, b, d, local), _hg_phase(cos_theta, g)


def _u32(x):
    """A uint32 value (Python int or integer tensor) as tpurt's astype
    (uint32) makes it, held in an int64 tensor or a Python int."""
    if isinstance(x, int):
        return x & _M32
    return x.to(torch.int64) & _M32


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a uint32 ``a`` (int64 tensor or int) and a
    constant c < 2^32.  int64 cannot hold the full product, so ``a`` is
    split into 16-bit halves and no intermediate passes 2^48."""
    if isinstance(a, int):
        return (a * c) & _M32
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _track_u(lane, bounce, step, salt: int):
    """The tracking loops' stateless uniform: tpurt's fmix-style uint32
    hash of (lane, bounce, step, salt) (:1219), bit for bit.  Each of
    lane, bounce and step is an integer tensor or a Python int."""
    h = (_mul32(_u32(lane), 0x9E3779B1)
         ^ _mul32((_u32(bounce) + salt) & _M32, 0x85EBCA77)
         ^ _mul32(_u32(step), 0xC2B2AE3D))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * float(2.0 ** -32)


def _grid_density_at(scene: SceneData, med_c, p_med):
    """Trilinear density in medium space, samples outside the lattice 0
    (GridDensityMedium::Density, grid.h:74-107; tpurt :1235).  med_c (N,)
    medium ids >= 0, p_med (N, 3) in [0, 1]^3."""
    dims = scene.med_grid_dims[med_c]  # (N, 3) nx, ny, nz
    off = scene.med_grid_off[med_c]
    dens = scene.med_density
    ps = p_med * dims.to(torch.float32) - 0.5
    pi = torch.floor(ps).to(torch.int32)
    dl = ps - pi.to(torch.float32)
    nx, ny, nz = dims[:, 0], dims[:, 1], dims[:, 2]

    def d_at(ix, iy, iz):
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
               & (iz < nz))
        idx = off + (iz.clamp(min=0) * ny + iy.clamp(min=0)) * nx \
            + ix.clamp(min=0)
        return torch.where(
            inb, dens[idx.clamp(0, dens.shape[0] - 1).long()], 0.0)

    x, y, z = pi[:, 0], pi[:, 1], pi[:, 2]
    dx, dy, dz = dl[:, 0], dl[:, 1], dl[:, 2]
    d00 = d_at(x, y, z) * (1 - dx) + d_at(x + 1, y, z) * dx
    d10 = d_at(x, y + 1, z) * (1 - dx) + d_at(x + 1, y + 1, z) * dx
    d01 = d_at(x, y, z + 1) * (1 - dx) + d_at(x + 1, y, z + 1) * dx
    d11 = d_at(x, y + 1, z + 1) * (1 - dx) + d_at(x + 1, y + 1, z + 1) * dx
    return ((d00 * (1 - dy) + d10 * dy) * (1 - dz)
            + (d01 * (1 - dy) + d11 * dy) * dz)


def _grid_ray(scene: SceneData, med_c, o, d, t_max):
    """A world ray in medium space, clipped to the [0, 1]^3 box (tpurt
    :1262): (o_m, d_m, t0, t1, hit_box).  The per-lane 3x3 products are
    written as elementwise sums (no batched GEMM)."""
    m = scene.med_w2m[med_c]  # (N, 4, 4)
    o_m = matvec_lanes(m, o) + m[:, :3, 3]
    d_m = matvec_lanes(m, d)
    inv = 1.0 / torch.where(d_m.abs() < 1e-12,
                            torch.where(d_m < 0, -1e-12, 1e-12), d_m)
    ta = (0.0 - o_m) * inv
    tb = (1.0 - o_m) * inv
    t0 = torch.clamp(torch.minimum(ta, tb).amax(dim=-1), min=0.0)
    t1 = torch.minimum(torch.maximum(ta, tb).amin(dim=-1), t_max)
    return o_m, d_m, t0, t1, t0 < t1


# ---------------------------------------------------------------------------
# delta and ratio tracking
# ---------------------------------------------------------------------------

@torch.profiler.record_function(TRACKING_RANGE)
def _tracking_loop(body, carry: Dict[str, torch.Tensor],
                   lanes: Dict[str, torch.Tensor]):
    """Run ``carry = body(k, lanes, carry)`` for k < GRID_TRACK_STEPS over
    the lanes whose ``carry["done"]`` is unset: every TRACK_CHECK steps the
    live lanes are written back and the ones done dropped, and the loop
    ends when none is left.  A lane's values freeze once it is done, so
    this gives what tpurt's full-budget loop gives.  ``lanes`` holds
    per-lane constants.  Adds the overflow count and the steps taken to
    TRACK_STATS; returns the carry of every lane."""
    out = dict(carry)
    idx = torch.nonzero(~carry["done"]).squeeze(1)
    n_tracked = idx.shape[0]
    if n_tracked == 0:
        return out
    sub = {k: v[idx] for k, v in carry.items()}
    cst = {k: v[idx] for k, v in lanes.items()}
    steps = torch.zeros(n_tracked, dtype=torch.int32, device=idx.device)
    steps_sum = steps_max = torch.zeros((), dtype=torch.int64,
                                        device=idx.device)

    def write_back(leaving):
        """Write the live lanes back; count the steps of ``leaving``."""
        nonlocal steps_sum, steps_max
        for name, v in sub.items():
            out[name] = out[name].index_put((idx,), v)
        st = torch.where(leaving, steps, 0)
        steps_sum = steps_sum + st.sum()
        steps_max = torch.maximum(steps_max, st.amax())

    for k in range(GRID_TRACK_STEPS):
        if k and k % TRACK_CHECK == 0:
            write_back(sub["done"])
            keep = ~sub["done"]
            idx, steps = idx[keep], steps[keep]
            if idx.numel() == 0:
                break
            sub = {name: v[keep] for name, v in sub.items()}
            cst = {name: v[keep] for name, v in cst.items()}
        steps = steps + (~sub["done"]).to(torch.int32)
        sub = body(k, cst, sub)
    else:
        write_back(torch.ones_like(sub["done"]))
    TRACK_STATS.add(GRID_OVERFLOW, (~out["done"]).sum())
    TRACK_STATS.add("Media/Grid tracking steps", steps_sum)
    TRACK_STATS.add("Media/Grid tracked lanes", n_tracked)
    TRACK_STATS.add("Media/Grid tracking steps (max)", steps_max, op="max")
    return out


def _grid_sample_medium(scene: SceneData, med, lane, bounce, o, d, t_surf,
                        salt: int):
    """Delta tracking (GridDensityMedium::Sample, grid.cpp:60-96; tpurt
    :1300).  Returns (scattered, t_scatter in world units, weight3)."""
    med_c = med.clamp(min=0).long()
    sig_t = scene.med_sigma_t[med_c][:, 0]  # spectrally uniform (grid.h)
    sig_s3 = scene.med_sigma_s[med_c]
    inv_maxd = scene.med_inv_maxd[med_c]
    o_m, d_m, t0, t1, hit = _grid_ray(scene, med_c, o, d, t_surf)

    def body(k, c, v):
        t, done, scattered = v["t"], v["done"], v["scattered"]
        u1 = _track_u(c["lane"], bounce, k, salt)
        u2 = _track_u(c["lane"], bounce, k, salt + 0x1234)
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-20)) \
            * c["inv_maxd"] / torch.clamp(c["sig_t"], min=1e-20)
        exited = t_new >= c["t1"]
        p = c["o_m"] + t_new[:, None] * c["d_m"]
        real = _grid_density_at(scene, c["med_c"], p) * c["inv_maxd"] > u2
        scattered = scattered | (~done & ~exited & real)
        # a lane already done keeps its collision distance; an exit keeps
        # the last one
        t = torch.where(done | exited, t, t_new)
        return dict(t=t, done=done | exited | real, scattered=scattered)

    out = _tracking_loop(
        body, dict(t=t0, done=~hit, scattered=torch.zeros_like(hit)),
        dict(lane=lane, inv_maxd=inv_maxd, sig_t=sig_t, t1=t1, o_m=o_m,
             d_m=d_m, med_c=med_c))
    w3 = torch.where(out["scattered"][:, None],
                     sig_s3 / torch.clamp(sig_t, min=1e-20)[:, None], 1.0)
    return out["scattered"], out["t"], w3


def _grid_tr(scene: SceneData, med, lane, bounce, o, d, dist, salt: int):
    """Ratio tracking with the reference's low-Tr Russian roulette
    (GridDensityMedium::Tr, grid.cpp:44-58; tpurt :1337)."""
    med_c = med.clamp(min=0).long()
    sig_t = scene.med_sigma_t[med_c][:, 0]
    inv_maxd = scene.med_inv_maxd[med_c]
    o_m, d_m, t0, t1, hit = _grid_ray(scene, med_c, o, d, dist)

    def body(k, c, v):
        t, tr, done = v["t"], v["tr"], v["done"]
        u1 = _track_u(c["lane"], bounce, k, salt)
        u2 = _track_u(c["lane"], bounce, k, salt + 0x77)
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-20)) \
            * c["inv_maxd"] / torch.clamp(c["sig_t"], min=1e-20)
        exited = t_new >= c["t1"]
        p = c["o_m"] + t_new[:, None] * c["d_m"]
        dens = _grid_density_at(scene, c["med_c"], p)
        tr_new = tr * (1.0 - torch.clamp(dens * c["inv_maxd"], min=0.0))
        # Russian roulette once Tr gets small (grid.cpp:49-55)
        small = tr_new < 1e-3
        killed = small & (u2 < 0.75)
        tr_new = torch.where(small & ~killed, tr_new / 0.25, tr_new)
        tr = torch.where(done | exited, tr, torch.where(killed, 0.0, tr_new))
        done = done | exited | killed
        return dict(t=torch.where(done, t, t_new), tr=tr, done=done)

    out = _tracking_loop(
        body, dict(t=t0, tr=torch.ones_like(t0), done=~hit),
        dict(lane=lane, inv_maxd=inv_maxd, sig_t=sig_t, t1=t1, o_m=o_m,
             d_m=d_m, med_c=med_c))
    return out["tr"]


def _sample_medium_distance(scene: SceneData, med, o, d, t_surf, u_ch,
                            u_dist, lane, bounce, nch: int = 3,
                            salt: int = 0x6A1D):
    """Distance-sample each lane's medium along [0, t_surf) (tpurt :1371):
    homogeneous media in closed form on a channel chosen by u_ch
    (homogeneous.cpp Sample), grid media by delta tracking, run on the
    grid lanes only (the other lanes' tracking results are dropped).

    Returns (scattered, t_min, thru, g_med): ``scattered`` without any
    aliveness mask, ``t_min`` the vertex distance (scatter point or
    surface, capped at 3.4e37), ``thru`` the throughput factor of the
    lanes in a medium, ``g_med`` the HG asymmetry of the lane's medium.
    With ``nch`` 60 the sigmas are promoted to bins, the channel is drawn
    over all of them (homogeneous.cpp picks one of Spectrum::nSamples),
    the pdf is the mean over the bins and a grid's albedo is the ratio
    of the promoted sigmas, bin by bin (tpurt :1384-1412)."""
    in_med = med >= 0
    med_c = med.clamp(min=0).long()
    sig_t = lift_refl_maybe(scene.med_sigma_t[med_c], nch)
    sig_s = lift_refl_maybe(scene.med_sigma_s[med_c], nch)
    g_med = scene.med_g[med_c]
    ch = torch.clamp((u_ch * nch).to(torch.int32), max=nch - 1)
    sig_ch = torch.gather(sig_t, 1, ch[:, None].long())[:, 0]
    dist = -torch.log(torch.clamp(1.0 - u_dist, min=1e-20)) \
        / torch.clamp(sig_ch, min=1e-20)
    scattered = in_med & (dist < t_surf) & (sig_ch > 0)
    t_min = torch.clamp(torch.minimum(dist, t_surf), max=3.4e37)
    tr = torch.exp(-sig_t * t_min[:, None])
    dens = torch.where(scattered[:, None], sig_t * tr, tr)
    pdf_m = torch.clamp(dens.mean(dim=-1), min=1e-20)
    thru = torch.where(scattered[:, None], tr * sig_s, tr) / pdf_m[:, None]
    if scene.has_grid_media:
        grid_lane = in_med & scene.med_is_grid[med_c]
        sel = torch.nonzero(grid_lane).squeeze(1)
        scat_g = torch.zeros_like(grid_lane)
        t_g = torch.zeros_like(t_surf)
        if sel.numel():
            s_g, tt_g, _ = _grid_sample_medium(
                scene, med[sel], lane[sel], bounce, o[sel], d[sel],
                t_surf[sel], salt)
            scat_g = scat_g.index_put((sel,), s_g)
            t_g = t_g.index_put((sel,), tt_g)
        scattered = torch.where(grid_lane, scat_g, scattered)
        t_min = torch.where(grid_lane,
                            torch.where(scat_g, t_g,
                                        torch.clamp(t_surf, max=3.4e37)),
                            t_min)
        albedo = sig_s / torch.clamp(sig_t, min=1e-20)
        thru = torch.where(grid_lane[:, None],
                           torch.where(scat_g[:, None], albedo, 1.0), thru)
    return scattered, t_min, thru, g_med


def _medium_tr(scene: SceneData, med, dist, o=None, d=None, lane=None,
               bounce=None, live=None, channels: int = 3):
    """Transmittance through each lane's medium over dist (tpurt :1416):
    Beer-Lambert for homogeneous media (homogeneous.cpp Tr), ratio
    tracking for grid media, 1 in vacuum.  Grid lanes outside ``live``
    (when given) are not tracked and read their Beer-Lambert value: the
    caller drops them.  ``channels`` 60: sigma_t promoted to bins; a
    grid's scalar ratio-tracking value fills every bin."""
    in_med = med >= 0
    med_c = med.clamp(min=0).long()
    tr = torch.exp(-lift_refl_maybe(scene.med_sigma_t[med_c], channels)
                   * torch.clamp(dist, max=3.4e37)[:, None])
    if scene.has_grid_media and o is not None:
        want = in_med & scene.med_is_grid[med_c]
        if live is not None:
            want = want & live
        sel = torch.nonzero(want).squeeze(1)
        if sel.numel():
            tr_g = _grid_tr(scene, med[sel], lane[sel], bounce, o[sel],
                            d[sel], dist[sel], salt=0x51AD)
            tr = tr.index_put((sel,), tr_g[:, None].expand(-1, channels))
    return torch.where(in_med[:, None], tr, 1.0)


@torch.profiler.record_function(WALK_RANGE)
def _shadow_tr_walk(scene: SceneData, o, d, dist, med0, lane, bounce: int,
                    usable, traverse, time=None, channels: int = 3):
    """VisibilityTester::Tr (core/light.cpp:47-63; tpurt :1433): march the
    shadow segment through null-material boundaries, up to
    SHADOW_WALK_STEPS closest-hit crossings, multiplying each
    sub-segment's transmittance in; a real material occludes, and so does
    the budget's end (counted in TRACK_STATS).  Only the lanes still
    walking are traced at each crossing.  Returns (occluded, tr) with
    ``channels`` colour channels."""
    n = o.shape[0]
    tr = torch.ones((n, channels), dtype=torch.float32, device=o.device)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    idx = torch.nonzero(usable).squeeze(1)
    o_w, d_w, med = o[idx], d[idx], med0[idx]
    rem = torch.clamp(dist, min=0.0)[idx]
    lane_w = lane[idx]
    time_w = None if time is None else time[idx]
    kinds = scene.mt_table[:, C_KIND].to(torch.int32)
    for k in range(SHADOW_WALK_STEPS):
        if idx.numel() == 0:
            break
        hit = intersect_closest(scene.geo, o_w, d_w, rem, traverse, time_w)
        si = compute_interaction(scene.geo, hit, o_w, d_w, time=time_w,
                                 media=True)
        hv = hit.prim >= 0
        # Material "none" rows pass through (light.cpp:52)
        blocker = hv & (si.material_id >= 0) & (
            kinds[si.material_id.clamp(min=0).long()] != MAT_NONE)
        seg = torch.where(hv, hit.t, rem)
        seg_tr = _medium_tr(scene, med, seg, o_w, d_w, lane_w,
                            bounce * SHADOW_WALK_STEPS + k,
                            channels=channels)
        tr = tr.index_put((idx,), tr[idx] * seg_tr)
        occ = occ.index_put((idx,), blocker)
        crossed = hv & ~blocker
        entering = dot(d_w, si.ng) < 0
        med_next = torch.where(entering, si.med_in, si.med_out)
        o_next = offset_ray_origin(si.p, si.ng, d_w, si.p_eps)
        rem = torch.clamp(rem - seg, min=0.0)
        idx = idx[crossed]
        o_w, d_w, rem = o_next[crossed], d_w[crossed], rem[crossed]
        med, lane_w = med_next[crossed], lane_w[crossed]
        time_w = None if time_w is None else time_w[crossed]
    # the lanes still inside geometry after the budget are occluded
    TRACK_STATS.add(WALK_OVERFLOW, idx.numel())
    occ = occ.index_put((idx,), torch.ones_like(idx, dtype=torch.bool))
    return occ, tr


# ---------------------------------------------------------------------------
# the volumetric path tracer as a wavefront step
# ---------------------------------------------------------------------------

def _nee_from(scene: SceneData, si, ctx, u_choice, u_light, alive, med,
              is_medium, g_med, bounce: int, lane, traverse, time,
              strategy: str):
    """Next-event estimation from a surface or a medium vertex (tpurt's
    nee_from, :1517-1558): the phase function stands in for the BSDF at a
    medium vertex, whose shadow ray starts at the point itself, and the
    shadow ray's transmittance scales the light."""
    lt = scene.lights
    lidx, pmf = choose_light(lt, u_choice, strategy, p=si.p)
    ls = sample_li(lt, lidx, si.p, u_light)
    f_surf, pdf_surf = shade_f(scene, ctx, si.ns, si.wo, ls.wi)
    f_surf = f_surf * dot(ls.wi, si.ns).abs()[:, None]
    nch = f_surf.shape[-1]
    # si.wo = -ray.d: the propagation direction is -wo
    ph = _hg_phase(dot(-si.wo, ls.wi), g_med)
    f = torch.where(is_medium[:, None], ph[:, None].expand(-1, nch), f_surf)
    scatter_pdf = torch.where(is_medium, ph, pdf_surf)
    usable = (alive & (ls.pdf > 0) & (ls.li > 0).any(dim=-1)
              & (f > 0).any(dim=-1))
    o_sh = torch.where(is_medium[:, None], si.p,
                       offset_ray_origin(si.p, si.ng, ls.wi, si.p_eps))
    dist = norm(ls.p_light - o_sh)
    t_max = shadow_t_max(ls, dist, usable)
    if scene.has_null_boundaries:
        occluded, tr = _shadow_tr_walk(scene, o_sh, ls.wi, t_max, med, lane,
                                       bounce, usable, traverse, time,
                                       channels=nch)
    else:
        occluded = intersect_any(scene.geo, o_sh, ls.wi, t_max, traverse,
                                 time)
        tr = _medium_tr(scene, med, dist, o_sh, ls.wi, lane, bounce,
                        live=usable & ~occluded, channels=nch)
    w = torch.where(ls.is_delta, 1.0,
                    power_heuristic(1.0, ls.pdf, 1.0, scatter_pdf))
    contrib = (f * lift_illum_maybe(ls.li, nch) * tr
               * (w / torch.clamp(ls.pdf * pmf, min=1e-20))[:, None])
    return torch.where((usable & ~occluded)[:, None], contrib, 0.0)


def volpath_bounce_init(scene: SceneData, sampler, camera, px, py, sidx,
                        cfg: IntegratorConfig, traverse, crop_xy=(0, 0),
                        track_lane=None) -> Dict[str, Any]:
    """The path step's lane state (camera setup and the bounce-0 closest
    hit) with volpath's own: ``med``, the medium each lane's ray travels
    in (the camera's at first), ``specular`` set (an emitter reached only
    through null boundaries keeps its full weight, :1715) and
    ``track_lane``, each lane's position in tpurt's chunk for the
    tracking hash."""
    st = path_bounce_init(scene, sampler, camera, px, py, sidx, cfg,
                          traverse, crop_xy)
    del st["eta_scale"]  # volpath's Russian roulette has none
    st.update(specular=torch.ones_like(st["alive"]),
              med=torch.full(px.shape, scene.camera_medium,
                             dtype=torch.int32, device=px.device),
              track_lane=track_lane)
    return st


def volpath_bounce_step(scene: SceneData, sampler, cfg: IntegratorConfig,
                        state: Dict[str, Any], bounce: int, traverse,
                        camera=None, texture_eval=None) -> Dict[str, Any]:
    """One bounce of volpath_radiance's bounce_body (:1560-1712) over the
    lane-state dict: shade the carried hit, then trace the next closest
    hit (none after the last bounce, where every lane ends)."""
    px, py, sidx, sctx = (state["px"], state["py"], state["sidx"],
                          state["sctx"])
    n = px.shape[0]
    o, d = state["o"], state["d"]
    beta, L, alive = state["beta"], state["L"], state["alive"]
    specular, prev_pdf, prev_p = (state["specular"], state["prev_pdf"],
                                  state["prev_p"])
    med, lane, time = state["med"], state["track_lane"], state.get("time")
    out = dict(state)

    si = carried_interaction(scene, state, bounce, camera, texture_eval,
                             media=True)
    t_surf = torch.where(si.valid, state["hit_t"], INF)

    def dim(k):
        return sampler.dim(px, py, sidx, d0 + k, sctx)

    # ---- medium sampling (homogeneous.cpp Sample, grid.cpp Sample) ----
    d0 = CAMERA_DIMS + bounce * DIMS_PER_BOUNCE_VOL
    in_med = med >= 0
    scattered, t_min, thru, g_med = _sample_medium_distance(
        scene, med, o, d, t_surf, dim(0), dim(1), lane, bounce, cfg.nch)
    sampled_med = alive & scattered
    beta = torch.where((alive & in_med)[:, None], beta * thru, beta)

    # ---- emitted light where the surface was reached ----
    Le, lrow = _emitted(scene, si)
    if bounce == 0:
        w_emit = torch.ones(n, dtype=torch.float32, device=o.device)
    else:
        lrow_c = lrow.clamp(min=0)
        light_pdf = pdf_li_from_hit(scene.lights, lrow_c, prev_p, d, si.p,
                                    si.ng)
        pmf = choice_pmf_at(scene.lights, lrow_c, cfg.light_strategy, n,
                            prev_p)
        w_emit = torch.where(specular, 1.0, power_heuristic(
            1.0, prev_pdf, 1.0, light_pdf * pmf))
    L = L + torch.where((alive & si.valid & ~sampled_med)[:, None],
                        beta * lift_illum_maybe(Le, cfg.nch)
                        * w_emit[:, None], 0.0)
    lt = scene.lights
    if lt.has_infinite:
        pmf_inf = (lt.inf_power_pmf
                   if cfg.light_strategy in ("power", "spatial")
                   else 1.0 / lt.n_lights)
        if bounce == 0:
            w_inf = torch.ones(n, dtype=torch.float32, device=o.device)
        else:
            w_inf = torch.where(specular, 1.0, power_heuristic(
                1.0, prev_pdf, 1.0, _escape_pdf(lt, d) * pmf_inf))
        L = L + torch.where((alive & ~si.valid & ~sampled_med)[:, None],
                            beta * lift_illum_maybe(_escape_radiance(lt, d),
                                                    cfg.nch)
                            * w_inf[:, None], 0.0)

    alive = alive & (si.valid | sampled_med) & (bounce < cfg.max_depth)

    # the medium vertex
    p_med = o + t_min[:, None] * d
    si_eff = si._replace(p=torch.where(sampled_med[:, None], p_med, si.p),
                         wo=torch.where(sampled_med[:, None], -d, si.wo))

    ctx = make_shade_ctx(scene, si, texture_eval, channels=cfg.nch)
    any_lobe = ctx.lobes.active.any(dim=-1)
    if ctx.special is not None:
        any_lobe = any_lobe | ctx.special
    # a null-material boundary: pass through and switch media (before NEE)
    null_boundary = (alive & si.valid & ~sampled_med & ~any_lobe
                     & ((si.med_in >= 0) | (si.med_out >= 0)))
    new_med = torch.where(dot(d, si.ng) < 0, si.med_in, si.med_out)
    med = torch.where(null_boundary, new_med, med)
    alive_shade = alive & (sampled_med | (si.valid & any_lobe))

    # ---- NEE ----
    u_light = torch.stack([dim(3), dim(4)], dim=-1)
    L = L + beta * _nee_from(scene, si_eff, ctx, dim(2), u_light,
                             alive_shade, med, sampled_med, g_med, bounce,
                             lane, traverse, time, cfg.light_strategy)

    # ---- continuation: phase sample (medium) or BSDF sample ----
    u1, u2 = dim(6), dim(7)
    wi_surf, f, pdf, is_spec, is_trans = shade_sample(scene, ctx, si.ns,
                                                      si.wo, dim(5), u1, u2)
    wi_med, ph = _hg_sample(d, g_med, u1, u2)
    wi = torch.where(sampled_med[:, None], wi_med, wi_surf)
    ok_surf = (pdf > 0) & (f > 0).any(dim=-1)
    thru_surf = f * (dot(wi_surf, si.ns).abs()
                     / torch.clamp(pdf, min=1e-20))[:, None]
    beta = torch.where((alive_shade & ~sampled_med & ok_surf)[:, None],
                       beta * thru_surf, beta)
    # a pass-through boundary is not a path vertex (volpath.cpp's
    # bounces-- retry): it keeps the previous real vertex's MIS state
    specular = torch.where(sampled_med, False,
                           torch.where(null_boundary, specular, is_spec))
    prev_pdf = torch.where(sampled_med, ph,
                           torch.where(null_boundary, prev_pdf,
                                       torch.clamp(pdf, min=1e-20)))
    prev_p = torch.where(null_boundary[:, None], prev_p, si_eff.p)
    d = torch.where(null_boundary[:, None], d, wi)
    o = torch.where(sampled_med[:, None], p_med,
                    offset_ray_origin(si.p, si.ng, d, si.p_eps))
    alive = (alive_shade & (sampled_med | ok_surf)) | null_boundary
    # transmission through a surface switches media too (after the
    # continuation)
    med = torch.where(alive & ~sampled_med & ~null_boundary & is_trans,
                      new_med, med)

    # ---- Russian roulette (no etaScale; bounces > 3) ----
    if bounce > 3:
        u_rr = dim(8)
        rr_beta = beta.amax(dim=-1)
        q = torch.clamp(1.0 - rr_beta, min=0.05)
        do_rr = (rr_beta < cfg.rr_threshold) & alive
        killed = do_rr & (u_rr < q)
        alive = alive & ~killed
        beta = torch.where((do_rr & ~killed)[:, None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                           beta)

    out.update(o=o, d=d, beta=beta, L=L, alive=alive, specular=specular,
               prev_pdf=prev_pdf, prev_p=prev_p, med=med)
    if bounce < cfg.max_depth:
        hit = intersect_closest(scene.geo, o, d,
                                torch.where(alive, INF, 0.0), traverse, time)
        out.update(hit_t=hit.t, hit_prim=hit.prim, hit_b0=hit.b0,
                   hit_b1=hit.b1)
    return out
