"""Stochastic progressive photon mapping (port of tpurt/render/sppm.py:
SPPMPixels, _init_pixels, _camera_chunk, _to_grid, _cell_hash,
_build_grid, _ri_dyn, _photon_chunk, _update_pixels and render_sppm).

Reference analog: integrators/sppm.{h,cpp}.  Each iteration runs (1) a
camera pass that stores a visible point at the first diffuse vertex
(sppm.cpp:135-236), (2) a hash grid over the visible points
(:240-300), (3) a photon pass that walks light paths and deposits each
photon hit on the visible points near it (:304-414) and (4) the radius
and tau update (:417-445); the image is Ld / nIterations + tau /
(Np pi r^2) (:450-461).

The pixel state is a struct of arrays over the film on the render
device.  The camera pass is tpurt's bounce loop, max_depth + 1 steps
(the last one only the MIS emission probe of the lanes that stored a
visible point), with the alive lanes kept by a boolean index between
steps as render/driver.py:trace_lanes does: every lane's arithmetic is
tpurt's, so Ld and the visible points are tpurt's to the rounding.

The grid is tpurt's sorted (cell hash, visible point) entry list, entry
for entry (int64 hashes masked to 32 bits, a stable sort, the bounds and
resolution in float32 in tpurt's order).  The photon pass walks the
live photons, compacted, and keeps the records of their hits after the
first.  The deposit differs in layout, not in result: tpurt walks every
record over max_occ slots with masked scatter-adds onto row 0; here each
record's run [start, end) of entries is expanded into its candidate
(record, visible point) pairs, so the work is the sum of the run
lengths, the pairs within the radius are kept by a boolean index, their
visible points' shading contexts are gathered in slices of DEPOSIT_SLICE
pairs, and only the live pairs are scattered with ``index_add_``.  The
float sums are taken in another order than tpurt's.

Quirks of tpurt's sppm, copied (ROADMAP, Queue 3): the photon pass
traces with no ray time and no shading tangents, so on a moving scene
photons see the geometry at time 0; EstimateDirect's BSDF half is the
path-MIS emission probe bounce and the lobe choice takes its own
dimension (photon dims advance 4 a bounce); a Material "none" surface
ends a camera path; the photon pass ignores media.  The camera pass
draws its dims from a Halton sampler of ``n_iters`` samples, whatever
the scene's Sampler says (sppm.cpp:125).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from tpurt_torch.render.film import FilmState
from tpurt_torch.render.integrator import (CAMERA_DIMS, DIMS_PER_BOUNCE, INF,
                                           SceneData, ShadeCtx,
                                           _camera_setup, _emitted,
                                           _escape_pdf, _escape_radiance,
                                           _nee_prepare, _nee_resolve,
                                           lift_illum_maybe, make_shade_ctx,
                                           shade_f, shade_sample,
                                           to_rgb_maybe, zero_shade_ctx)
from tpurt_torch.render.interaction import (compute_interaction,
                                            offset_ray_origin)
from tpurt_torch.render.intersect import (Hit, intersect_any,
                                          intersect_closest)
from tpurt_torch.render.lights import (choice_pmf_at, choose_light,
                                       pdf_li_from_hit, sample_le)
from tpurt_torch.render.sampling_warps import dot, power_heuristic
from tpurt_torch.sampling import lowdiscrepancy as ld
from tpurt_torch.sampling.samplers import (ONE_MINUS_EPS, _digits_needed,
                                           _fma32, halton_from_tables,
                                           halton_tables)
from tpurt_torch.spectrum_sampled import luminance_bins
from tpurt_torch.utils.stats import STATS, ProgressReporter

log = logging.getLogger("tpurt_torch.sppm")

# profiler ranges around the four stages of an iteration
CAMERA_RANGE = "tpurt_torch.sppm_camera"
GRID_RANGE = "tpurt_torch.sppm_grid"
PHOTON_RANGE = "tpurt_torch.sppm_photons"
DEPOSIT_RANGE = "tpurt_torch.sppm_deposit"
# candidate (photon record, visible point) pairs tested a deposit slice
DEPOSIT_SLICE = 1 << 22
# the 27 cells a visible point's +-radius window can overlap
_OFFS = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]


def _lum(c):
    """Spectrum::y(): RGB's weights (spectrum.h:440), or the CIE-Y bin
    quadrature of 60 bins (spectrum.h:315; tpurt's sppm.py:75-85)."""
    if c.shape[-1] != 3:
        return luminance_bins(c)
    return 0.212671 * c[:, 0] + 0.715160 * c[:, 1] + 0.072169 * c[:, 2]


def _ctx_map(fn, *ctxs):
    """fn applied leaf by leaf over ShadeCtx trees of one structure (None
    leaves stay None)."""
    x = ctxs[0]
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return fn(*ctxs)
    parts = [_ctx_map(fn, *leaves) for leaves in zip(*ctxs)]
    return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)


# ---------------------------------------------------------------------------
# per-pixel state (SPPMPixel, sppm.cpp:63-87)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SPPMPixels:
    radius: torch.Tensor  # (P,)
    Ld: torch.Tensor  # (P, C) direct light summed over the iterations
    N: torch.Tensor  # (P,) photon count, gamma-weighted
    tau: torch.Tensor  # (P, C)
    Phi: torch.Tensor  # (P, C) this iteration's photon sum
    M: torch.Tensor  # (P,) this iteration's photon count
    vp_valid: torch.Tensor  # (P,) bool
    vp_p: torch.Tensor  # (P, 3)
    vp_wo: torch.Tensor  # (P, 3) world space
    vp_ns: torch.Tensor  # (P, 3) shading normal
    vp_beta: torch.Tensor  # (P, C)
    vp_shade: ShadeCtx  # the visible point's full material context
    # C: the colour channels, 3 or the 60 bins of spectral mode


def _init_pixels(n_pix: int, initial_radius: float, scene: SceneData,
                 device, nch: int = 3) -> SPPMPixels:
    """The pixel state of an SPPM render on ``device`` with ``nch``
    colour channels (tpurt's _init_pixels, sppm.py:108-125)."""
    def z(*shape):
        return torch.zeros((n_pix,) + shape, dtype=torch.float32,
                           device=device)

    return SPPMPixels(
        radius=z() + initial_radius, Ld=z(nch), N=z(), tau=z(nch),
        Phi=z(nch), M=z(),
        vp_valid=torch.zeros(n_pix, dtype=torch.bool, device=device),
        vp_p=z(3), vp_wo=z(3), vp_ns=z(3), vp_beta=z(nch),
        vp_shade=zero_shade_ctx(scene, n_pix, device, channels=nch))


# ---------------------------------------------------------------------------
# camera pass (sppm.cpp:135-236)
# ---------------------------------------------------------------------------

def _camera_chunk(scene: SceneData, camera, smplr, px, py, sidx,
                  max_depth: int, traverse, texture_eval=None,
                  nch: int = 3):
    """One wavefront of camera paths (tpurt's _camera_chunk,
    sppm.py:132-302): returns each lane's direct light Ld (N, nch) and its
    visible point, a dict of (N, ...) tensors valid, p, wo, ns, beta and
    shade (zeros where the lane stored none).  The visible point is the
    first diffuse vertex, or a glossy one at the last bounce
    (sppm.cpp:203-214; hair counts as glossy); next-event estimation runs
    at every vertex; a lane that stored one continues exactly one more
    bounce as the MIS emission probe, and the beta-threshold roulette
    skips probe lanes."""
    n = px.shape[0]
    dev = px.device
    _, _, _, o, d, ray_w, sctx, l_time = _camera_setup(
        smplr, camera, px, py, sidx, (0, 0),
        draw_time=camera.animated or scene.has_motion)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zc = torch.zeros((n, nch), dtype=torch.float32, device=dev)
    zb = torch.zeros(n, dtype=torch.bool, device=dev)
    Ld_out = zc.clone()
    vp = dict(valid=zb.clone(), p=z3.clone(), wo=z3.clone(), ns=z3.clone(),
              beta=zc.clone(),
              shade=zero_shade_ctx(scene, n, dev, channels=nch))
    hit = intersect_closest(scene.geo, o, d, INF, traverse, time=l_time)
    st = dict(lane=torch.arange(n, device=dev), px=px, py=py, sidx=sidx,
              sctx=sctx, time=l_time, o=o, d=d, hit_t=hit.t,
              hit_prim=hit.prim, hit_b0=hit.b0, hit_b1=hit.b1,
              beta=zc + ray_w[:, None], Ld=zc.clone(), alive=~zb,
              specular=zb.clone(), prev_pdf=torch.ones_like(ray_w), prev_p=o,
              vp_taken=zb.clone(), probe=zb.clone())
    for bounce in range(max_depth + 1):
        alive = st["alive"]
        if not bool(alive.all()):
            # a lane that is not alive adds nothing more: bank its Ld
            Ld_out[st["lane"][~alive]] = st["Ld"][~alive]
            st = {k: None if v is None else v[alive] for k, v in st.items()}
        if st["lane"].shape[0] == 0:
            return Ld_out, vp
        st = _camera_step(scene, smplr, st, bounce, max_depth, traverse,
                          texture_eval, vp)
    Ld_out[st["lane"]] = st["Ld"]
    return Ld_out, vp


def _camera_step(scene: SceneData, smplr, st, bounce: int, max_depth: int,
                 traverse, texture_eval, vp):
    """One bounce of the camera pass over the alive lanes ``st`` (tpurt's
    bounce_body, sppm.py:152-290); stores the visible points it takes
    into ``vp`` at their lanes.  The step past max_depth only collects
    the probe lanes' emission."""
    lt = scene.lights
    px, py, sidx, sctx = st["px"], st["py"], st["sidx"], st["sctx"]
    m = px.shape[0]
    o, d, beta, Ld = st["o"], st["d"], st["beta"], st["Ld"]
    prev_pdf, prev_p, probe = st["prev_pdf"], st["prev_p"], st["probe"]
    specular, l_time = st["specular"], st["time"]
    nch = beta.shape[-1]
    hit = Hit(t=st["hit_t"], prim=st["hit_prim"], b0=st["hit_b0"],
              b1=st["hit_b1"])
    si = compute_interaction(scene.geo, hit, o, d,
                             tangents=scene.has_tangents, time=l_time,
                             faces=scene.has_ptex)

    # emitted light with path-MIS weights into Ld (sppm.cpp:195-200);
    # past max_depth only the probe lanes collect it
    Le, lrow = _emitted(scene, si)
    if bounce == 0:
        w_emit = torch.ones(m, dtype=torch.float32, device=o.device)
    else:
        lrow_c = lrow.clamp(min=0)
        light_pdf = pdf_li_from_hit(lt, lrow_c, prev_p, d, si.p, si.ng)
        pmf = choice_pmf_at(lt, lrow_c, "uniform", m, prev_p)
        w_emit = torch.where(specular, 1.0,
                             power_heuristic(1.0, prev_pdf, 1.0,
                                             light_pdf * pmf))
    emit_ok = probe | (bounce < max_depth)
    Ld = Ld + torch.where((emit_ok & si.valid)[:, None],
                          beta * lift_illum_maybe(Le, nch) * w_emit[:, None],
                          0.0)
    if lt.has_infinite:
        if bounce == 0:
            w_inf = torch.ones(m, dtype=torch.float32, device=o.device)
        else:
            w_inf = torch.where(
                specular, 1.0,
                power_heuristic(1.0, prev_pdf, 1.0,
                                _escape_pdf(lt, d) * (1.0 / lt.n_lights)))
        Ld = Ld + torch.where((emit_ok & ~si.valid)[:, None],
                              beta * lift_illum_maybe(_escape_radiance(lt, d),
                                                      nch)
                              * w_inf[:, None], 0.0)
    out = dict(st, Ld=Ld)
    if bounce == max_depth:
        # the probe lanes stop here: nothing past the emission is read
        out["alive"] = torch.zeros_like(st["alive"])
        return out

    alive = si.valid & ~probe
    shade = make_shade_ctx(scene, si, texture_eval, channels=nch)
    act = shade.lobes.active
    any_lobe = act.any(dim=-1)
    is_diffuse = act[:, 0]
    is_glossy = act[:, 1]
    if shade.special is not None:
        # HairBSDF and FourierBSDF are BSDF_GLOSSY in the reference
        any_lobe = any_lobe | shade.special
        is_glossy = is_glossy | shade.special
    alive = alive & any_lobe

    # the visible point: first diffuse vertex, or glossy at the last
    # camera bounce (sppm.cpp:203-214)
    store = alive & ~st["vp_taken"] & (
        is_diffuse | (is_glossy & (bounce == max_depth - 1)))
    lanes = st["lane"][store]
    vp["valid"][lanes] = True
    vp["p"][lanes] = si.p[store]
    vp["wo"][lanes] = si.wo[store]
    vp["ns"][lanes] = si.ns[store]
    vp["beta"][lanes] = beta[store]
    _ctx_map(lambda full, new: full.index_put_((lanes,), new[store]),
             vp["shade"], shade)

    # next-event estimation at every vertex (UniformSampleOneLight,
    # sppm.cpp:201)
    d0 = CAMERA_DIMS + bounce * DIMS_PER_BOUNCE

    def dim(k):
        return smplr.dim(px, py, sidx, d0 + k, sctx)

    u_light = torch.stack([dim(1), dim(2)], dim=-1)
    nee_c, o_sh, wi_sh, t_sh, nee_ok = _nee_prepare(
        scene, si, shade, dim(0), u_light, "uniform",
        alive & (is_diffuse | is_glossy))
    beta_nee = beta

    # BSDF continuation; stored lanes continue one more bounce as the
    # MIS emission probe
    wi, f, pdf, is_spec, _ = shade_sample(scene, shade, si.ns, si.wo, dim(3),
                                          dim(4), dim(5))
    ok = alive & (pdf > 0) & (f > 0).any(dim=-1)
    beta = torch.where(ok[:, None],
                       beta * f * (dot(wi, si.ns).abs()
                                   / torch.clamp(pdf, min=1e-20))[:, None],
                       beta)
    alive = ok
    probe = store & ok

    # beta-threshold termination (sppm.cpp:225-230), skipped on probes
    u_rr = dim(6)
    y = _lum(beta)
    do_rr = alive & ~probe & (y < 0.25)
    q = torch.clamp(y, max=1.0)
    killed = do_rr & (u_rr > q)
    alive = alive & ~killed
    beta = torch.where((do_rr & ~killed)[:, None],
                       beta / torch.clamp(q, min=1e-6)[:, None], beta)

    o = offset_ray_origin(si.p, si.ng, wi, si.p_eps)
    occluded = intersect_any(scene.geo, o_sh, wi_sh, t_sh, traverse, l_time)
    hit = intersect_closest(scene.geo, o, wi, torch.where(alive, INF, 0.0),
                            traverse, l_time)
    out.update(o=o, d=wi, hit_t=hit.t, hit_prim=hit.prim, hit_b0=hit.b0,
               hit_b1=hit.b1, beta=beta,
               Ld=Ld + beta_nee * _nee_resolve(nee_c, nee_ok, occluded),
               alive=alive, specular=is_spec,
               prev_pdf=torch.clamp(pdf, min=1e-20), prev_p=si.p,
               vp_taken=st["vp_taken"] | store, probe=probe)
    return out


# ---------------------------------------------------------------------------
# grid (sppm.cpp:240-300)
# ---------------------------------------------------------------------------

def _to_grid(p, lo, diag, res):
    """ToGrid (sppm.cpp:92-101): the cell of each point and whether it
    lies inside the grid."""
    pg = (p - lo) / torch.clamp(diag, min=1e-20)
    pi = (res.to(torch.float32) * pg).to(torch.int32)
    inb = ((pi >= 0) & (pi < res)).all(dim=-1)
    return torch.minimum(torch.clamp(pi, min=0), res - 1), inb


def _cell_hash(c, hash_size: int):
    """hash() (sppm.cpp:103-107) with uint32 wrap-around: int64 products
    masked to 32 bits."""
    c = c.to(torch.int64) & 0xFFFFFFFF
    x = (c[..., 0] * 73856093) & 0xFFFFFFFF
    y = (c[..., 1] * 19349663) & 0xFFFFFFFF
    z = (c[..., 2] * 83492791) & 0xFFFFFFFF
    return (x ^ y ^ z) % hash_size


def _build_grid(vp_p, vp_valid, radius, hash_size: int):
    """The sorted (cell hash, visible point) entry list (tpurt's
    _build_grid, sppm.py:325-368): each visible point enters the <= 27
    cells its +-radius window overlaps, the pairs sorted by hash (stable).
    Returns (es_keys, es_vals, lo, diag, res, max_occ): invalid entries
    carry the key hash_size and sort last; max_occ is the fullest cell's
    count, a device scalar."""
    n = vp_p.shape[0]
    dev = vp_p.device
    big = 3e37
    v3 = vp_valid[:, None]
    lo = torch.where(v3, vp_p - radius[:, None], big).amin(dim=0)
    hi = torch.where(v3, vp_p + radius[:, None], -big).amax(dim=0)
    any_vp = vp_valid.any()
    lo = torch.where(any_vp, lo, 0.0)
    hi = torch.where(any_vp, hi, 1.0)
    diag = torch.clamp(hi - lo, min=1e-20)
    max_r = torch.where(vp_valid, radius, 0.0).amax()
    max_diag = diag.amax()
    # float32 on the device, in tpurt's order
    base_res = torch.clamp((max_diag / torch.clamp(max_r, min=1e-20))
                           .to(torch.int32), min=1)
    res = torch.clamp((base_res.to(torch.float32) * diag / max_diag)
                      .to(torch.int32), min=1)

    cmin, _ = _to_grid(vp_p - radius[:, None], lo, diag, res)
    cmax, _ = _to_grid(vp_p + radius[:, None], lo, diag, res)
    offs = torch.tensor(_OFFS, dtype=torch.int32, device=dev)
    cells = cmin[:, None, :] + offs[None, :, :]  # (P, 27, 3)
    ok = v3 & (cells <= cmax[:, None, :]).all(dim=-1)
    key = torch.where(ok, _cell_hash(cells, hash_size), hash_size).reshape(-1)
    val = torch.arange(n, device=dev).repeat_interleave(27)
    ks, order = torch.sort(key, stable=True)
    vs = val[order]
    max_occ = torch.bincount(ks, minlength=hash_size + 1)[:hash_size].amax()
    return ks, vs, lo, diag, res, max_occ


# ---------------------------------------------------------------------------
# photon pass (sppm.cpp:304-414)
# ---------------------------------------------------------------------------

def _ri_dyn(a, base: int, n_digits: int):
    """Unscrambled radical inverse over a fixed digit count (tpurt's
    _ri_dyn, sppm.py:375-389, whose base is traced inside its scan: a
    float32 1/base and n_digits digits for every base).  Each digit's
    term is added as a fused multiply-add, as tpurt's jitted photon pass
    computes it on the CPU, so the dims are bit-equal to its render's."""
    inv = float(np.float32(1.0) / np.float32(base))
    acc = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    scale = acc + inv
    for _ in range(n_digits):
        acc = _fma32(acc, (a % base).to(torch.float32), scale)
        a = a // base
        scale = scale * inv
    return torch.clamp(acc, max=ONE_MINUS_EPS)


def _radical_inverse(a, base: int):
    """tpurt's static-base _radical_inverse (samplers.py:203) as its
    jitted photon pass computes it on the CPU: the digit loop unrolled,
    the first two terms summed with the first product fused, every later
    term added as a fused multiply-add."""
    inv = float(np.float32(1.0 / base))
    scale = torch.full(a.shape, inv, dtype=torch.float32, device=a.device)
    acc = None
    for k in range(_digits_needed(base, 1 << 31)):
        digit = (a % base).to(torch.float32)
        if k == 0:
            first = (digit, scale)
        elif k == 1:
            acc = _fma32(digit * scale, *first)
        else:
            acc = _fma32(acc, digit, scale)
        scale = scale * inv
        a = a // base
    return torch.clamp(acc, max=ONE_MINUS_EPS)


def _wrap_i32(x):
    """int64 lanes wrapped to int32 values (tpurt's int32 photon index)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _photon_walk(scene: SceneData, hidx, max_depth: int, traverse,
                 texture_eval=None, nch: int = 3):
    """Trace the photons of Halton indices ``hidx`` (int64 lanes holding
    tpurt's int32 values; tpurt's _photon_chunk up to its deposit,
    sppm.py:398-449): returns the records (p, wi, beta) of their surface
    hits after the first, every record valid.  Light choice and Sample_Le
    take radical-inverse dims 0-4 (primes 2-11, sppm.cpp:313-330), bounce
    b dims 6+4b .. 9+4b (lobe, u1, u2, roulette) through _ri_dyn."""
    lt = scene.lights
    u = [_radical_inverse(hidx, int(ld.PRIMES[k])) for k in range(5)]
    lidx, lpmf = choose_light(lt, u[0], "power")
    le = sample_le(lt, lidx, u[1], u[2], u[3], u[4])
    ok0 = (le.pdf_pos > 0) & (le.pdf_dir > 0) & (le.le > 0).any(dim=-1)
    beta = lift_illum_maybe(le.le, nch) * (
        dot(le.n, le.d).abs()
        / torch.clamp(lpmf * le.pdf_pos * le.pdf_dir, min=1e-20))[:, None]
    alive = ok0 & (beta > 0).any(dim=-1)
    o = torch.where((le.is_delta_pos | le.is_infinite)[:, None], le.p,
                    offset_ray_origin(le.p, le.n, le.d))
    d = le.d
    n_digits = _digits_needed(17, 1 << 31)
    recs = []
    for b in range(max_depth):
        if not bool(alive.all()):
            hidx, o, d, beta = hidx[alive], o[alive], d[alive], beta[alive]
        if hidx.shape[0] == 0:
            break
        # no ray time, no shading tangents (tpurt's sppm.py:420-421)
        hit = intersect_closest(scene.geo, o, d, INF, traverse)
        si = compute_interaction(scene.geo, hit, o, d, faces=scene.has_ptex)
        valid = si.valid
        if b > 0:
            recs.append((si.p[valid], -d[valid], beta[valid]))
        shade = make_shade_ctx(scene, si, texture_eval, channels=nch)
        d0 = 6 + 4 * b
        u_lobe, u1, u2, u_rr = (_ri_dyn(hidx, int(ld.PRIMES[d0 + k]),
                                        n_digits) for k in range(4))
        wi, f, pdf, _, _ = shade_sample(scene, shade, si.ns, si.wo, u_lobe,
                                        u1, u2)
        ok = valid & (pdf > 0) & (f > 0).any(dim=-1)
        bnew = beta * f * (dot(wi, si.ns).abs()
                           / torch.clamp(pdf, min=1e-20))[:, None]
        # photon Russian roulette (sppm.cpp:405-408)
        q = torch.clamp(1.0 - _lum(bnew) / torch.clamp(_lum(beta), min=1e-20),
                        min=0.0)
        killed = u_rr < q
        beta = torch.where((ok & ~killed)[:, None],
                           bnew / torch.clamp(1.0 - q, min=1e-6)[:, None],
                           beta)
        alive = ok & ~killed
        o = offset_ray_origin(si.p, si.ng, wi, si.p_eps)
        d = wi
    if not recs:
        z = torch.zeros((0, 3), dtype=torch.float32, device=hidx.device)
        return z, z, torch.zeros((0, nch), dtype=torch.float32,
                                 device=hidx.device)
    return tuple(torch.cat(parts) for parts in zip(*recs))


def _cell_runs(grid, rec_p, hash_size: int):
    """The grid entries each record's cell holds: (rid, start, count,
    ends), rid the records inside the grid (indices into rec_p), start and
    count their cell's run in the sorted entries, ends the running sum of
    the counts (record k's candidate pairs are [ends[k] - count[k],
    ends[k]))."""
    ks, _, lo, diag, res, _ = grid
    cell, inb = _to_grid(rec_p, lo, diag, res)
    rid = torch.nonzero(inb).squeeze(1)
    h = _cell_hash(cell[rid], hash_size)
    start = torch.searchsorted(ks, h)
    count = torch.searchsorted(ks, h, right=True) - start
    return rid, start, count, torch.cumsum(count, dim=0)


def _pair_slice(es_vals, start, count, ends, a: int, b: int):
    """Candidate pairs a..b-1 of _cell_runs: (k, vp), k an index into its
    rid, vp the visible point."""
    pair = torch.arange(a, b, device=ends.device)
    k = torch.searchsorted(ends, pair, right=True)
    return k, es_vals[start[k] + pair - (ends[k] - count[k])]


def _deposit(scene: SceneData, pix: SPPMPixels, grid, rec_p, rec_wi,
             rec_beta, hash_size: int) -> int:
    """Add each record's photon to the visible points within their radius
    (sppm.cpp:346-375; tpurt's deposit, sppm.py:451-491), into pix.Phi
    and pix.M in place.  Each record's run of grid entries is expanded
    into candidate pairs; the pairs with d^2 <= r^2 at a valid visible
    point gather that point's context and scatter beta * f.  Returns the
    number of candidate pairs tested."""
    rid, start, count, ends = _cell_runs(grid, rec_p, hash_size)
    p, wi, beta = rec_p[rid], rec_wi[rid], rec_beta[rid]
    total = int(ends[-1]) if ends.numel() else 0
    for a in range(0, total, DEPOSIT_SLICE):
        rec, vp = _pair_slice(grid[1], start, count, ends, a,
                              min(a + DEPOSIT_SLICE, total))
        dp = p[rec] - pix.vp_p[vp]
        d2 = (dp * dp).sum(dim=-1)
        r = pix.radius[vp]
        live = torch.nonzero((d2 <= r * r) & pix.vp_valid[vp]).squeeze(1)
        rec, vp = rec[live], vp[live]
        ctx = _ctx_map(lambda t: t[vp], pix.vp_shade)
        f, _ = shade_f(scene, ctx, pix.vp_ns[vp], pix.vp_wo[vp], wi[rec])
        pix.Phi.index_add_(0, vp, beta[rec] * f)
        pix.M.index_add_(0, vp, torch.ones(vp.shape[0], dtype=torch.float32,
                                           device=vp.device))
    return total


def _photon_chunk(scene: SceneData, pix: SPPMPixels, grid, hidx,
                  max_depth: int, hash_size: int, traverse,
                  texture_eval=None, lap=None) -> int:
    """Trace one wavefront of photons and deposit their records into pix
    (tpurt's _photon_chunk); returns the candidate pairs tested.
    ``lap(stage)``, when given, is called at the end of each stage
    ("photons_s", "deposit_s")."""
    with torch.profiler.record_function(PHOTON_RANGE):
        recs = _photon_walk(scene, hidx, max_depth, traverse, texture_eval,
                            pix.Ld.shape[-1])
    if lap is not None:
        lap("photons_s")
    with torch.profiler.record_function(DEPOSIT_RANGE):
        pairs = _deposit(scene, pix, grid, *recs, hash_size)
    if lap is not None:
        lap("deposit_s")
    return pairs


# ---------------------------------------------------------------------------
# statistics update (sppm.cpp:417-445)
# ---------------------------------------------------------------------------

def _update_pixels(pix: SPPMPixels) -> SPPMPixels:
    """The radius and tau update of the pixels that received photons
    (tpurt's _update_pixels, sppm.py:498-515); clears Phi, M and the
    visible points."""
    gamma = float(np.float32(2.0 / 3.0))
    has = pix.M > 0
    n_new = pix.N + gamma * pix.M
    r_new = pix.radius * torch.sqrt(n_new / torch.clamp(pix.N + pix.M,
                                                        min=1e-20))
    ratio = (r_new * r_new) / torch.clamp(pix.radius * pix.radius,
                                          min=1e-20)
    tau = torch.where(has[:, None],
                      (pix.tau + pix.vp_beta * pix.Phi) * ratio[:, None],
                      pix.tau)
    return dataclasses.replace(
        pix, radius=torch.where(has, r_new, pix.radius),
        N=torch.where(has, n_new, pix.N), tau=tau,
        Phi=torch.zeros_like(pix.Phi), M=torch.zeros_like(pix.M),
        vp_valid=torch.zeros_like(pix.vp_valid),
        vp_beta=torch.zeros_like(pix.vp_beta))


# ---------------------------------------------------------------------------
# driver (SPPMIntegrator::Render, sppm.cpp:112-505)
# ---------------------------------------------------------------------------

def sppm_params(params, quick: bool = False) -> dict:
    """CreateSPPMIntegrator's parameters (sppm.cpp:507-519): iterations
    (or numiterations) 64, divided by 16 under quick; maxdepth 5;
    photonsperiteration -1 (the film's area); radius 1."""
    n_iters = params.find_one_int("iterations",
                                  params.find_one_int("numiterations", 64))
    if quick:
        n_iters = max(1, n_iters // 16)
    return dict(n_iters=n_iters,
                max_depth=params.find_one_int("maxdepth", 5),
                radius=params.find_one_float("radius", 1.0),
                photons=params.find_one_int("photonsperiteration", -1))


def sppm_sampler(film, n_iters: int, device):
    """SPPM's own Halton sampler over the iterations (sppm.cpp:125), its
    digit sums fused as in tpurt's jitted camera pass."""
    return halton_from_tables(dict(
        halton_tables(max(n_iters, 1), film.full_x, film.full_y), fma=True),
        device)


def _camera_pass(job, pix: SPPMPixels, smplr, it: int, max_depth: int,
                 traverse) -> None:
    """Iteration ``it``'s camera paths, a lane a pixel in chunks of
    WAVEFRONT_SIZE: adds their direct light to pix.Ld and stores their
    visible points in pix."""
    from tpurt_torch.config import WAVEFRONT_SIZE

    film = job.film
    w = film.width
    n_pix = w * film.height
    x0, _, y0, _ = film.crop
    dev = pix.Ld.device
    for c0 in range(0, n_pix, WAVEFRONT_SIZE):
        pid = torch.arange(c0, min(c0 + WAVEFRONT_SIZE, n_pix), device=dev)
        Ld, vp = _camera_chunk(job.scene, job.camera, smplr, x0 + pid % w,
                               y0 + pid // w, torch.full_like(pid, it),
                               max_depth, traverse, job.texture_eval,
                               job.cfg.nch)
        pix.Ld.index_add_(0, pid, Ld)
        for k in ("valid", "p", "wo", "ns", "beta"):
            getattr(pix, "vp_" + k)[pid] = vp[k]
        _ctx_map(lambda full, v: full.index_copy_(0, pid, v), pix.vp_shade,
                 vp["shade"])


def render_sppm_job(job, params, quick: bool = False, traverse=None,
                    stats: Optional[dict] = None):
    """The SPPM pipeline on a built job (tpurt's render_sppm,
    sppm.py:522-645).  ``params``: the scene's Integrator parameters.
    The hash table has the film's area of buckets.  Fills ``stats``
    (when given) with the seconds of each stage summed over the
    iterations (camera_s, grid_s, photons_s, deposit_s: the device is
    synchronised at each stage's end, which only a run with ``stats``
    pays) and, per iteration, the fullest grid cell (max_occ) and the
    candidate (photon, visible point) pairs tested.  Returns the (H, W, 3)
    image."""
    from tpurt_torch.config import WAVEFRONT_SIZE
    from tpurt_torch.kernels.traverse import traverse_wide

    traverse = traverse or traverse_wide
    cfg = sppm_params(params, quick)
    n_iters, max_depth = cfg["n_iters"], cfg["max_depth"]
    film = job.film
    scene = job.scene
    dev = scene.geo.device
    w, h = film.width, film.height
    n_pix = w * h
    n_photons = cfg["photons"] if cfg["photons"] > 0 else n_pix
    hash_size = n_pix
    smplr = sppm_sampler(film, n_iters, dev)
    chunk = min(WAVEFRONT_SIZE, n_photons)
    timed = stats is not None
    stats = {} if stats is None else stats
    stats.update(camera_s=0.0, grid_s=0.0, photons_s=0.0, deposit_s=0.0,
                 max_occ=[], pairs=[])
    pix = _init_pixels(n_pix, cfg["radius"], scene, dev, job.cfg.nch)
    reporter = ProgressReporter(2 * n_iters, "Rendering (sppm)",
                                quiet=not log.isEnabledFor(logging.INFO))
    t_start = time.time()
    t_lap = [t_start]

    def lap(key):
        """Add the seconds since the last lap to stats[key]."""
        if timed:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.time()
            stats[key] += now - t_lap[0]
            t_lap[0] = now

    for it in range(n_iters):
        with torch.profiler.record_function(CAMERA_RANGE):
            _camera_pass(job, pix, smplr, it, max_depth, traverse)
        reporter.update(1)
        lap("camera_s")
        with torch.profiler.record_function(GRID_RANGE):
            grid = _build_grid(pix.vp_p, pix.vp_valid, pix.radius, hash_size)
        if timed:
            stats["max_occ"].append(int(grid[5]))
        lap("grid_s")
        pairs = 0
        for c0 in range(0, n_photons, chunk):
            hidx = _wrap_i32(it * n_photons + torch.arange(
                c0, min(c0 + chunk, n_photons), device=dev))
            pairs += _photon_chunk(scene, pix, grid, hidx, max_depth,
                                   hash_size, traverse, job.texture_eval,
                                   lap)
        stats["pairs"].append(pairs)
        pix = _update_pixels(pix)
        reporter.update(1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reporter.done_report()
    STATS.counter("SPPM/Photon paths followed", n_iters * n_photons)
    STATS.phase_times["Render (sppm)"] += time.time() - t_start

    # L = Ld / nIterations + tau / (Np pi r^2) (sppm.cpp:450-461), as
    # film splats resolved at scale 1; spectral bins become RGB here
    np_total = float(n_iters) * float(n_photons)
    L = (pix.Ld / torch.full((), float(n_iters), device=dev)
         + pix.tau / (np_total * np.pi
                      * torch.clamp(pix.radius, min=1e-20)[:, None] ** 2))
    L = to_rgb_maybe(L)
    z = torch.zeros((h, w), dtype=torch.float32, device=dev)
    state = FilmState(rgb=z[..., None].expand(h, w, 3), weight=z,
                      splat=L.reshape(h, w, 3))
    return film.to_image(state, splat_scale=1.0)


def render_sppm(sd, device="cuda", quick: bool = False, crop_override=None,
                traverse=None, stats: Optional[dict] = None,
                spectrum: str = "rgb"):
    """Build the job of ``sd`` on ``device`` and render it through SPPM;
    returns (image, job).  ``spectrum`` "sampled" carries 60 bins through
    Phi, tau and Ld, RGB at the end."""
    from tpurt_torch.render.driver import build_job

    job = build_job(sd, device, quick=quick, crop_override=crop_override,
                    spectrum=spectrum)
    img = render_sppm_job(job, sd.integrator_params, quick=quick,
                          traverse=traverse, stats=stats)
    return img, job
