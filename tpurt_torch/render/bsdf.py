"""BSDF: tpurt's seven lobe slots with per-lane parameters (port of
tpurt/render/bsdf.py).

  slot 0  DIFFUSE      Lambertian / Oren-Nayar (kd, A, B), or the Disney
                       diffuse stack (retro-reflection, sheen, fake
                       subsurface)
  slot 1  GLOSSY       microfacet GGX reflection (ks, alpha; Fresnel:
                       dielectric | conductor | Schlick | Disney | none)
  slot 2  SPEC_MIRROR  perfect specular reflection (kr, Fresnel noop/diel)
  slot 3  SPEC_FRESNEL FresnelSpecular reflection + transmission (smooth
                       glass: fs_kr, kt, eta)
  slot 4  GTRANS       GGX microfacet transmission (kt_g)
  slot 5  CLEARCOAT    Disney clearcoat, GTR1 (cc, cc_gloss)
  slot 6  DTRANS       Lambertian transmission (kd_t)

Sampling follows BSDF::Sample_f's uniform choice among active slots
(reflection.cpp:714): u picks an active slot, the slot samples wi, f sums
the non-specular active slots on the correct hemisphere and pdf averages
them; the specular slots keep their discrete pdf.  The slots keep tpurt's
order, so the same u picks the same lobe.

tpurt computes every slot and every Fresnel kind for every lane and
masks, which XLA fuses; in eager PyTorch every masked term is a run of
kernel launches.  So the functions take ``slots``, what some material of
the scene can activate (materials_build.lobe_slots' LobeSet; ALL_SLOTS,
the default, holds every slot, Fresnel kind and material kind), and skip
the rest: a frame of matte and plastic surfaces pays nothing for
mirror, glass, conductors or Disney.  LobeParams fields that no material
of the scene needs are None.  The values are the same either way, since a
skipped term is masked out on every lane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpurt_torch.render.sampling_warps import (INV_PI, cosine_sample_hemisphere,
                                               cross, dot, norm)

F32_EPS = float(np.float32(1e-9))
N_SLOTS = 7
(SLOT_DIFFUSE, SLOT_GLOSSY, SLOT_MIRROR, SLOT_FS, SLOT_GTRANS,
 SLOT_CLEARCOAT, SLOT_DTRANS) = range(N_SLOTS)
FRESNEL_DIELECTRIC = 0
FRESNEL_CONDUCTOR = 1
FRESNEL_SCHLICK = 2
FRESNEL_NOOP = 3
FRESNEL_DISNEY = 4  # lerp(metallic, dielectric, FrSchlick(r0)) (disney.cpp:330)
ALL_FRESNEL = (FRESNEL_DIELECTRIC, FRESNEL_CONDUCTOR, FRESNEL_SCHLICK,
               FRESNEL_NOOP, FRESNEL_DISNEY)


class LobeSet(tuple):
    """The lobe slots some material of a scene can activate (a tuple of
    slot numbers), with the glossy slot's Fresnel kinds (``fresnel``), the
    material kinds of the table's rows (``kinds``; None: any) and whether
    any material is Disney (``disney``), a mix (``mix``) or hair
    (``hair``: the integrator computes the hair BSDF only then)."""

    def __new__(cls, slots=range(N_SLOTS), fresnel=ALL_FRESNEL, disney=True,
                mix=True, kinds=None, hair=True):
        self = super().__new__(cls, sorted(slots))
        self.fresnel = tuple(sorted(fresnel))
        self.disney = bool(disney)
        self.mix = bool(mix)
        self.kinds = None if kinds is None else tuple(sorted(kinds))
        self.hair = bool(hair)
        return self

    def __repr__(self):
        return (f"LobeSet({tuple(self)}, fresnel={self.fresnel}, "
                f"disney={self.disney}, mix={self.mix}, kinds={self.kinds}, "
                f"hair={self.hair})")


ALL_SLOTS = LobeSet()


class LobeParams(NamedTuple):
    """Per-lane BSDF parameters, local-frame shading (tpurt's fields, and
    ``active``).  The fields after ``t_alpha_y`` are None where no
    material of the scene needs them."""

    kd: torch.Tensor  # (N,3) diffuse reflectance
    oren_a: torch.Tensor  # (N,)
    oren_b: torch.Tensor  # (N,)
    ks: torch.Tensor  # (N,3) glossy reflectance scale
    alpha_x: torch.Tensor  # (N,)
    alpha_y: torch.Tensor  # (N,)
    fresnel_kind: torch.Tensor  # (N,) int32
    eta: torch.Tensor  # (N,) dielectric ior (glossy + fresnel-specular)
    kr: torch.Tensor  # (N,3) mirror reflectance
    kt: torch.Tensor  # (N,3) fresnel-specular transmittance
    fs_kr: torch.Tensor  # (N,3) fresnel-specular reflectance
    kt_g: torch.Tensor  # (N,3) microfacet transmission scale
    t_alpha_x: torch.Tensor  # (N,) transmission distribution alphas
    t_alpha_y: torch.Tensor  # (N,)
    active: torch.Tensor  # (N,7) bool lobe activity (lobe_activity)
    eta3: Optional[torch.Tensor] = None  # (N,3) conductor eta
    k3: Optional[torch.Tensor] = None  # (N,3) conductor k
    cc: Optional[torch.Tensor] = None  # (N,) clearcoat weight
    cc_gloss: Optional[torch.Tensor] = None  # (N,) clearcoat GTR1 alpha
    kd_t: Optional[torch.Tensor] = None  # (N,3) lambertian transmission
    disney: Optional[torch.Tensor] = None  # (N,) bool: Disney diffuse + G1G1
    metallic: Optional[torch.Tensor] = None  # (N,) disney fresnel mix
    r0: Optional[torch.Tensor] = None  # (N,3) Schlick R0 color (disney)
    sheen: Optional[torch.Tensor] = None  # (N,3) disney sheen (weighted)
    retro: Optional[torch.Tensor] = None  # (N,3) disney retro-reflection
    kd_ss: Optional[torch.Tensor] = None  # (N,3) disney fake subsurface
    d_rough: Optional[torch.Tensor] = None  # (N,) raw disney roughness


def lobe_activity(kd, ks, kr, fs_kr, kt, kt_g, cc=None, kd_t=None,
                  retro=None, sheen=None, kd_ss=None, slots=ALL_SLOTS):
    """(N,7) bool: which slots each lane's parameters activate (tpurt's
    LobeParams.active; a slot outside ``slots`` is inactive on every
    lane)."""

    def diffuse():
        act = (kd > 0).any(dim=-1)
        for extra in (retro, sheen, kd_ss):
            if extra is not None:
                act = act | (extra > 0).any(dim=-1)
        return act

    cols = {SLOT_DIFFUSE: diffuse,
            SLOT_GLOSSY: lambda: (ks > 0).any(dim=-1),
            SLOT_MIRROR: lambda: (kr > 0).any(dim=-1),
            SLOT_FS: lambda: ((fs_kr > 0).any(dim=-1)
                              | (kt > 0).any(dim=-1)),
            SLOT_GTRANS: lambda: (kt_g > 0).any(dim=-1),
            SLOT_CLEARCOAT: lambda: cc > 0,
            SLOT_DTRANS: lambda: (kd_t > 0).any(dim=-1)}
    off = torch.zeros(kd.shape[0], dtype=torch.bool, device=kd.device)
    return torch.stack([cols[k]() if k in slots else off
                        for k in ALL_SLOTS], dim=-1)


def _cos_theta(w):
    return w[:, 2]


def _abs_cos_theta(w):
    return w[:, 2].abs()


def _same_hemisphere(a, b):
    return a[:, 2] * b[:, 2] > 0


def _pow5(c):
    """c ** 5 as jax's integer_pow evaluates it (binary powering)."""
    c2 = c * c
    return c * (c2 * c2)


def fr_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance (FrDielectric),
    entering/exiting by the sign of cos_i."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = cos_i.abs()
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    tir = sin_t >= 1
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = ((et * ci) - (ei * ct)) / torch.clamp((et * ci) + (ei * ct),
                                                  min=F32_EPS)
    r_perp = ((ei * ci) - (et * ct)) / torch.clamp((ei * ci) + (et * ct),
                                                   min=F32_EPS)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def fr_conductor(cos_i, eta, k):
    """Per-channel conductor Fresnel (FrConductor, bsdf.py:155): complex
    arithmetic spelled out in reals, in tpurt's operation order.  eta, k
    (N,3); cos_i (N,)."""
    c = torch.clamp(cos_i.abs(), 0.0, 1.0)[:, None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=F32_EPS)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=F32_EPS)
    return 0.5 * (rp + rs)


def _schlick(rs, cos_i):
    c = torch.clamp(1.0 - cos_i.abs(), 0.0, 1.0)[:, None]
    return rs + (1.0 - rs) * _pow5(c)


def _fresnel(lp: LobeParams, cos_i, kinds=ALL_FRESNEL):
    """Glossy-slot Fresnel (tpurt's _fresnel): the kinds in ``kinds``
    computed, each lane taking its own; any other lane gets 1 (noop).
    (N,3), or (N,1) where every lane is dielectric."""
    if tuple(kinds) == (FRESNEL_DIELECTRIC,):
        return fr_dielectric(cos_i, torch.ones_like(cos_i), lp.eta)[:, None]
    f = torch.ones_like(lp.ks)
    k = lp.fresnel_kind[:, None]
    fd = None
    if FRESNEL_DIELECTRIC in kinds or FRESNEL_DISNEY in kinds:
        fd = (fr_dielectric(cos_i, torch.ones_like(cos_i), lp.eta)[:, None]
              * torch.ones_like(lp.ks))
    # tpurt's select chain, innermost first
    if FRESNEL_DISNEY in kinds:
        # DisneyFresnel (disney.cpp:327-341): metallic mix of dielectric
        # and Schlick with the tinted R0
        fdis = ((1.0 - lp.metallic)[:, None] * fd
                + lp.metallic[:, None] * _schlick(lp.r0, cos_i))
        f = torch.where(k == FRESNEL_DISNEY, fdis, f)
    if FRESNEL_SCHLICK in kinds:
        f = torch.where(k == FRESNEL_SCHLICK, _schlick(lp.ks, cos_i), f)
    if FRESNEL_CONDUCTOR in kinds:
        f = torch.where(k == FRESNEL_CONDUCTOR,
                        fr_conductor(cos_i, lp.eta3, lp.k3), f)
    if FRESNEL_DIELECTRIC in kinds:
        f = torch.where(k == FRESNEL_DIELECTRIC, fd, f)
    return f


def roughness_to_alpha(rough):
    """TrowbridgeReitzDistribution::RoughnessToAlpha (microfacet.h:83-89)."""
    rough = torch.clamp(rough, min=1e-3)
    x = torch.log(rough)
    x2 = x * x  # x ** 3 and x ** 4 as jax's integer_pow evaluates them
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * (x * x2) + 0.000640711 * (x2 * x2))


# -- GGX / TrowbridgeReitz ---------------------------------------------------

def _ggx_d(wh, ax, ay):
    c2 = wh[:, 2] * wh[:, 2]
    t = (wh[:, 0] * wh[:, 0]) / (ax * ax) + (wh[:, 1] * wh[:, 1]) / (ay * ay) + c2
    return torch.where(t > 0, 1.0 / (np.pi * ax * ay * t * t), 0.0)


def _ggx_lambda(w, ax, ay):
    c = w[:, 2].abs()
    inv_c2 = torch.where(c > F32_EPS, 1.0 / (c * c), 0.0)
    a2_tan2 = (w[:, 0] * w[:, 0] * ax * ax
               + w[:, 1] * w[:, 1] * ay * ay) * inv_c2
    lam = 0.5 * (-1.0 + torch.sqrt(torch.clamp(1.0 + a2_tan2, min=0.0)))
    return torch.where(c > F32_EPS, lam, 1e9)


def _ggx_g1(w, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(w, ax, ay))


def _ggx_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(wo, ax, ay) + _ggx_lambda(wi, ax, ay))


def _ggx_sample_vndf(wo, ax, ay, u1, u2):
    """Visible-NDF sampling (Heitz 2018, JCGT); wo in either hemisphere."""
    flip = wo[:, 2] < 0
    w = torch.where(flip[:, None], -wo, wo)
    vh = torch.stack([ax * w[:, 0], ay * w[:, 1], w[:, 2]], dim=-1)
    vh = vh / torch.clamp(norm(vh, keepdim=True), min=F32_EPS)
    lensq = vh[:, 0] * vh[:, 0] + vh[:, 1] * vh[:, 1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=F32_EPS))
    ex = torch.zeros_like(vh)
    ex[:, 0] = 1.0
    t1 = torch.where(
        (lensq > 1e-7)[:, None],
        torch.stack([-vh[:, 1] * inv_len, vh[:, 0] * inv_len,
                     torch.zeros_like(inv_len)], dim=-1),
        ex,
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2 * np.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[:, None] * t1 + p2[:, None] * t2 + pz[:, None] * vh
    wh = torch.stack([ax * nh[:, 0], ay * nh[:, 1],
                      torch.clamp(nh[:, 2], min=1e-6)], dim=-1)
    wh = wh / torch.clamp(norm(wh, keepdim=True), min=F32_EPS)
    return torch.where(flip[:, None], -wh, wh)


def _ggx_pdf_wh(wo, wh, ax, ay):
    """Visible-NDF pdf of wh given wo."""
    d = _ggx_d(wh, ax, ay)
    g1 = _ggx_g1(wo, ax, ay)
    return (d * g1 * dot(wo, wh).abs()
            / torch.clamp(_abs_cos_theta(wo), min=F32_EPS))


# ---------------------------------------------------------------------------
# per-slot eval / pdf / sample
# ---------------------------------------------------------------------------

def _schlick_weight(cos_t):
    return _pow5(torch.clamp(1.0 - cos_t, 0.0, 1.0))


def _diffuse_f(lp: LobeParams, wo, wi):
    """Oren-Nayar; A=1, B=0 reduces to Lambertian (reflection.h:358), or
    where lp.disney the Disney diffuse stack: Burley diffuse +
    retro-reflection + sheen + fake subsurface (disney.cpp:92-228), folded
    into one additive cosine-sampled slot."""
    si = torch.sqrt(torch.clamp(1.0 - wi[:, 2] * wi[:, 2], min=0.0))
    so = torch.sqrt(torch.clamp(1.0 - wo[:, 2] * wo[:, 2], min=0.0))
    denom = torch.clamp(si * so, min=F32_EPS)
    cos_dphi = torch.clamp((wi[:, 0] * wo[:, 0] + wi[:, 1] * wo[:, 1]) / denom,
                           -1.0, 1.0)
    max_cos = torch.where((si > 1e-4) & (so > 1e-4),
                          torch.clamp(cos_dphi, min=0.0), 0.0)
    abs_ci = torch.clamp(_abs_cos_theta(wi), min=F32_EPS)
    abs_co = torch.clamp(_abs_cos_theta(wo), min=F32_EPS)
    sin_alpha = torch.where(abs_ci > abs_co, so, si)
    tan_beta = torch.where(abs_ci > abs_co, si / abs_ci, so / abs_co)
    scale = lp.oren_a + lp.oren_b * max_cos * sin_alpha * tan_beta
    f_on = lp.kd * (INV_PI * scale)[:, None]
    if lp.disney is None:
        return f_on

    # --- disney variant ---
    fo = _schlick_weight(abs_co)
    fi = _schlick_weight(abs_ci)
    f_base = lp.kd * (INV_PI * (1.0 - fo / 2.0) * (1.0 - fi / 2.0))[:, None]
    wh = wo + wi
    wh_len = norm(wh)
    degen = wh_len < F32_EPS
    whn = wh / torch.clamp(wh_len, min=F32_EPS)[:, None]
    cos_d = dot(wi, whn)
    rr = 2.0 * lp.d_rough * cos_d * cos_d
    f_retro = lp.retro * (INV_PI * rr
                          * (fo + fi + fo * fi * (rr - 1.0)))[:, None]
    f_sheen = lp.sheen * _schlick_weight(cos_d.abs())[:, None]
    fss90 = cos_d * cos_d * lp.d_rough
    fss = ((1.0 + fo * (fss90 - 1.0)) * (1.0 + fi * (fss90 - 1.0)))
    ss = 1.25 * (fss * (1.0 / torch.clamp(abs_co + abs_ci, min=F32_EPS) - 0.5)
                 + 0.5)
    f_ss = lp.kd_ss * (INV_PI * ss)[:, None]
    f_dis = f_base + torch.where(degen[:, None], 0.0,
                                 f_retro + f_sheen + f_ss)
    return torch.where(lp.disney[:, None], f_dis, f_on)


def _diffuse_pdf(wo, wi):
    return torch.where(_same_hemisphere(wo, wi),
                       _abs_cos_theta(wi) * INV_PI, 0.0)


def _glossy_f(lp: LobeParams, wo, wi, kinds=ALL_FRESNEL):
    """GGX microfacet reflection (MicrofacetReflection::f)."""
    co = _abs_cos_theta(wo)
    ci = _abs_cos_theta(wi)
    wh = wo + wi
    wh_len = norm(wh, keepdim=True)
    degenerate = (ci < F32_EPS) | (co < F32_EPS) | (wh_len[:, 0] < F32_EPS)
    wh = wh / torch.clamp(wh_len, min=F32_EPS)
    d = _ggx_d(wh, lp.alpha_x, lp.alpha_y)
    g = _ggx_g(wo, wi, lp.alpha_x, lp.alpha_y)
    if lp.disney is not None:
        # Disney uses the separable Smith form G1*G1 (disney.cpp:352-357)
        g = torch.where(lp.disney,
                        _ggx_g1(wo, lp.alpha_x, lp.alpha_y)
                        * _ggx_g1(wi, lp.alpha_x, lp.alpha_y), g)
    # Fresnel with cos at the half vector, oriented toward the normal
    wh_fwd = torch.where(wh[:, 2:3] < 0, -wh, wh)
    f = _fresnel(lp, dot(wi, wh_fwd), kinds)
    ks = lp.ks
    if FRESNEL_SCHLICK in kinds:  # Schlick folds ks into F
        ks = torch.where((lp.fresnel_kind == FRESNEL_SCHLICK)[:, None], 1.0,
                         ks)
    val = ks * f * (d * g / torch.clamp(4.0 * ci * co, min=F32_EPS))[:, None]
    return torch.where((degenerate | ~_same_hemisphere(wo, wi))[:, None], 0.0,
                       val)


def _glossy_pdf(lp: LobeParams, wo, wi):
    wh = wo + wi
    wh_len = norm(wh, keepdim=True)
    wh = wh / torch.clamp(wh_len, min=F32_EPS)
    pdf = _ggx_pdf_wh(wo, wh, lp.alpha_x, lp.alpha_y) / torch.clamp(
        4.0 * dot(wo, wh).abs(), min=F32_EPS)
    return torch.where(_same_hemisphere(wo, wi) & (wh_len[:, 0] > F32_EPS),
                       pdf, 0.0)


def _glossy_sample(lp: LobeParams, wo, u1, u2):
    wh = _ggx_sample_vndf(wo, lp.alpha_x, lp.alpha_y, u1, u2)
    return -wo + 2.0 * dot(wo, wh)[:, None] * wh


def _refract(wo, cos_i, eta_rel):
    """Refract -wo about +/-z; returns (ok, wi).  eta_rel = eta_i/eta_t."""
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta_rel * eta_rel * sin2_i
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    # local frame: n = (0,0,+-1) facing wo
    n_z = torch.where(cos_i > 0, 1.0, -1.0)
    wi = torch.stack([-wo[:, 0] * eta_rel, -wo[:, 1] * eta_rel,
                      -cos_t * n_z], dim=-1)
    return ok, wi


# -- microfacet transmission (reflection.cpp:246-271, 431-460) ---------------

def _gtrans_eta(lp: LobeParams, wo):
    """etaB/etaA seen from wo's side (etaA=1 outside, etaB=lp.eta)."""
    return torch.where(_cos_theta(wo) > 0, lp.eta, 1.0 / lp.eta)


def _gtrans_f(lp: LobeParams, wo, wi):
    co = _cos_theta(wo)
    ci = _cos_theta(wi)
    eta = _gtrans_eta(lp, wo)
    wh = wo + wi * eta[:, None]
    wh_len = norm(wh)
    wh = wh / torch.clamp(wh_len, min=F32_EPS)[:, None]
    wh = torch.where(wh[:, 2:3] < 0, -wh, wh)
    dwo = dot(wo, wh)
    dwi = dot(wi, wh)
    bad = (_same_hemisphere(wo, wi) | (co.abs() < F32_EPS)
           | (ci.abs() < F32_EPS) | (wh_len < F32_EPS) | (dwo * dwi > 0))
    fr = fr_dielectric(dwo, torch.ones_like(dwo), lp.eta)
    d = _ggx_d(wh, lp.t_alpha_x, lp.t_alpha_y)
    g = _ggx_g(wo, wi, lp.t_alpha_x, lp.t_alpha_y)
    denom = dwo + eta * dwi
    factor = 1.0 / eta  # radiance transport (reflection.cpp:265)
    # ci*co < 0 for transmission: take |.| before the epsilon clamp
    den_abs = torch.clamp((ci * co).abs() * denom * denom, min=F32_EPS)
    val = ((1.0 - fr)[:, None] * lp.kt_g
           * (d * g * eta * eta * dwi * dwo * factor * factor
              / den_abs).abs()[:, None])
    return torch.where(bad[:, None], 0.0, val)


def _gtrans_pdf(lp: LobeParams, wo, wi):
    eta = _gtrans_eta(lp, wo)
    wh = wo + wi * eta[:, None]
    wh_len = norm(wh)
    wh = wh / torch.clamp(wh_len, min=F32_EPS)[:, None]
    dwo = dot(wo, wh)
    dwi = dot(wi, wh)
    denom = dwo + eta * dwi
    dwh_dwi = (eta * eta * dwi).abs() / torch.clamp(denom * denom,
                                                    min=F32_EPS)
    wh_fwd = torch.where(wh[:, 2:3] < 0, -wh, wh)
    pdf = _ggx_pdf_wh(wo, wh_fwd, lp.t_alpha_x, lp.t_alpha_y) * dwh_dwi
    ok = (~_same_hemisphere(wo, wi)) & (wh_len > F32_EPS) & (dwo * dwi <= 0)
    return torch.where(ok, pdf, 0.0)


def _gtrans_sample(lp: LobeParams, wo, u1, u2):
    """Sample wh from the VNDF and refract wo about it
    (MicrofacetTransmission::Sample_f).  Returns (ok, wi)."""
    wh = _ggx_sample_vndf(wo, lp.t_alpha_x, lp.t_alpha_y, u1, u2)
    cos_i = dot(wo, wh)
    eta_rel = torch.where(_cos_theta(wo) > 0, 1.0 / lp.eta, lp.eta)
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    ok = (cos_i > 0) & (sin2_t < 1.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = -eta_rel[:, None] * wo + (eta_rel * cos_i - cos_t)[:, None] * wh
    return ok, wi


# -- disney clearcoat (disney.cpp:230-318) ------------------------------------

def _gtr1(cos_t, alpha):
    # the sign-flipped form of disney.cpp:248-252 (bsdf.py:448): for
    # alpha < 1 both (1-a2) and -log(a2) are positive
    a2 = alpha * alpha
    num = 1.0 - a2
    den = (np.pi * torch.clamp(-torch.log(torch.clamp(a2, min=F32_EPS)),
                               min=F32_EPS)
           * torch.clamp(1.0 + (a2 - 1.0) * cos_t * cos_t, min=F32_EPS))
    return num / den


def _smith_g_sep(cos_t, alpha):
    a2 = alpha * alpha
    c2 = cos_t * cos_t
    return 1.0 / torch.clamp(cos_t + torch.sqrt(a2 + c2 - a2 * c2),
                             min=F32_EPS)


def _cc_f(lp: LobeParams, wo, wi):
    wh = wo + wi
    wh_len = norm(wh)
    wh = wh / torch.clamp(wh_len, min=F32_EPS)[:, None]
    dr = _gtr1(_abs_cos_theta(wh), lp.cc_gloss)
    fr = 0.04 + 0.96 * _schlick_weight(dot(wo, wh))
    gr = (_smith_g_sep(_abs_cos_theta(wo), 0.25)
          * _smith_g_sep(_abs_cos_theta(wi), 0.25))
    val = lp.cc * gr * fr * dr / 4.0
    ok = _same_hemisphere(wo, wi) & (wh_len > F32_EPS)
    return torch.where(ok, val, 0.0)[:, None] * torch.ones_like(lp.kd)


def _cc_pdf(lp: LobeParams, wo, wi):
    wh = wo + wi
    wh_len = norm(wh)
    wh = wh / torch.clamp(wh_len, min=F32_EPS)[:, None]
    dr = _gtr1(_abs_cos_theta(wh), lp.cc_gloss)
    pdf = (dr * _abs_cos_theta(wh)
           / torch.clamp(4.0 * dot(wo, wh), min=F32_EPS))
    return torch.where(_same_hemisphere(wo, wi) & (wh_len > F32_EPS), pdf,
                       0.0)


def _cc_sample(lp: LobeParams, wo, u1, u2):
    a2 = lp.cc_gloss * lp.cc_gloss
    cos_t = torch.sqrt(torch.clamp(
        (1.0 - torch.pow(torch.clamp(a2, min=F32_EPS), 1.0 - u1))
        / torch.clamp(1.0 - a2, min=F32_EPS), min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * np.pi * u2
    wh = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                     dim=-1)
    wh = torch.where(_same_hemisphere(wo, wh)[:, None], wh, -wh)
    return -wo + 2.0 * dot(wo, wh)[:, None] * wh


# -- lambertian transmission (reflection.h:390, cpp:397-409) ------------------

def _dtrans_f(lp: LobeParams, wo, wi):
    return torch.where((~_same_hemisphere(wo, wi))[:, None],
                       lp.kd_t * INV_PI, 0.0)


def _dtrans_pdf(wo, wi):
    return torch.where(~_same_hemisphere(wo, wi),
                       _abs_cos_theta(wi) * INV_PI, 0.0)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def bsdf_f(lp: LobeParams, wo, wi, slots=ALL_SLOTS):
    """Sum of the non-specular lobes on the correct hemisphere (BSDF::f)."""
    act = lp.active
    refl = _same_hemisphere(wo, wi)
    f = torch.zeros_like(lp.kd)
    if SLOT_DIFFUSE in slots:
        f = f + torch.where((act[:, SLOT_DIFFUSE] & refl)[:, None],
                            _diffuse_f(lp, wo, wi), 0.0)
    if SLOT_GLOSSY in slots:
        f = f + torch.where((act[:, SLOT_GLOSSY] & refl)[:, None],
                            _glossy_f(lp, wo, wi, slots.fresnel), 0.0)
    if SLOT_GTRANS in slots:
        f = f + torch.where(act[:, SLOT_GTRANS][:, None],
                            _gtrans_f(lp, wo, wi), 0.0)
    if SLOT_CLEARCOAT in slots:
        f = f + torch.where((act[:, SLOT_CLEARCOAT] & refl)[:, None],
                            _cc_f(lp, wo, wi), 0.0)
    if SLOT_DTRANS in slots:
        f = f + torch.where(act[:, SLOT_DTRANS][:, None],
                            _dtrans_f(lp, wo, wi), 0.0)
    return f


def _smooth_pdf_sum(lp: LobeParams, wo, wi, slots=ALL_SLOTS):
    """Sum of the non-specular lobes' pdfs (hemisphere-masked)."""
    act = lp.active
    pdf = torch.zeros_like(wo[:, 0])
    terms = ((SLOT_DIFFUSE, lambda: _diffuse_pdf(wo, wi)),
             (SLOT_GLOSSY, lambda: _glossy_pdf(lp, wo, wi)),
             (SLOT_GTRANS, lambda: _gtrans_pdf(lp, wo, wi)),
             (SLOT_CLEARCOAT, lambda: _cc_pdf(lp, wo, wi)),
             (SLOT_DTRANS, lambda: _dtrans_pdf(wo, wi)))
    for k, term in terms:
        if k in slots:
            pdf = pdf + torch.where(act[:, k], term(), 0.0)
    return pdf


def bsdf_pdf(lp: LobeParams, wo, wi, slots=ALL_SLOTS):
    """Average pdf over the active lobes (BSDF::Pdf); specular lobes add 0
    but count toward the average, like the reference."""
    n_match = lp.active.sum(dim=-1).to(torch.float32)
    pdf = _smooth_pdf_sum(lp, wo, wi, slots)
    return torch.where(n_match > 0, pdf / torch.clamp(n_match, min=1.0), 0.0)


def bsdf_sample(lp: LobeParams, wo, u_lobe, u1, u2, slots=ALL_SLOTS):
    """Sample an outgoing direction.  Returns (wi, f, pdf, is_specular,
    is_transmission)."""
    act = lp.active
    act_i = act.to(torch.int64)
    n_match = act_i.sum(dim=-1)
    # pick the (u_lobe * n_match)-th active slot
    target = torch.minimum((u_lobe * n_match.to(torch.float32)).to(torch.int64),
                           (n_match - 1).clamp(min=0))
    cum = torch.cumsum(act_i, dim=-1) - act_i
    chosen = torch.argmax(((cum == target[:, None]) & act).to(torch.int64),
                          dim=-1)
    chosen = torch.where(n_match > 0, chosen, -1)
    n_match_f = torch.clamp(n_match.to(torch.float32), min=1.0)

    def is_slot(k):
        return chosen == k

    # the diffuse candidate; its mirror image below the surface is
    # Lambertian transmission's sample and tpurt's last select branch
    # (where no slot was chosen, such lanes end with pdf 0)
    wi_diff = cosine_sample_hemisphere(u1, u2)
    flip_z = torch.tensor([1.0, 1.0, -1.0], dtype=wi_diff.dtype,
                          device=wi_diff.device)
    wi_diff = torch.where(wo[:, 2:3] < 0, wi_diff * flip_z, wi_diff)
    wi = torch.where(is_slot(SLOT_DIFFUSE)[:, None], wi_diff,
                     wi_diff * flip_z)
    if SLOT_GLOSSY in slots:
        wi = torch.where(is_slot(SLOT_GLOSSY)[:, None],
                         _glossy_sample(lp, wo, u1, u2), wi)
    specular = SLOT_MIRROR in slots or SLOT_FS in slots
    if specular:
        cos_o = _cos_theta(wo)
        wi_mirror = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], dim=-1)
        f_spec = fr_dielectric(cos_o, torch.ones_like(cos_o), lp.eta)
        wi = torch.where(is_slot(SLOT_MIRROR)[:, None], wi_mirror, wi)
    if SLOT_FS in slots:
        # fresnel specular: reflect or transmit by F (FresnelSpecular)
        take_refl = u1 < f_spec
        eta_rel = torch.where(cos_o > 0, 1.0 / lp.eta, lp.eta)
        t_ok, wi_trans = _refract(wo, cos_o, eta_rel)
        wi = torch.where(is_slot(SLOT_FS)[:, None],
                         torch.where(take_refl[:, None], wi_mirror, wi_trans),
                         wi)
    if SLOT_GTRANS in slots:
        gt_ok, wi_gt = _gtrans_sample(lp, wo, u1, u2)
        wi = torch.where(is_slot(SLOT_GTRANS)[:, None], wi_gt, wi)
    if SLOT_CLEARCOAT in slots:
        wi = torch.where(is_slot(SLOT_CLEARCOAT)[:, None],
                         _cc_sample(lp, wo, u1, u2), wi)

    # smooth slots: f sums all non-specular lobes, pdf averages them
    f = bsdf_f(lp, wo, wi, slots)
    pdf = _smooth_pdf_sum(lp, wo, wi, slots) / n_match_f
    no = torch.zeros_like(n_match, dtype=torch.bool)
    is_spec, is_trans, bad = no, no, (n_match == 0)
    if specular:
        abs_ci = torch.clamp(_abs_cos_theta(wi), min=F32_EPS)
        is_spec = is_slot(SLOT_MIRROR) | is_slot(SLOT_FS)
    if SLOT_MIRROR in slots:
        # SpecularReflection::Sample_f: fresnel noop or dielectric
        fr_m = torch.where((lp.fresnel_kind == FRESNEL_NOOP)[:, None], 1.0,
                           f_spec[:, None])
        f = torch.where(is_slot(SLOT_MIRROR)[:, None],
                        lp.kr * fr_m / abs_ci[:, None], f)
        pdf = torch.where(is_slot(SLOT_MIRROR), 1.0 / n_match_f, pdf)
    if SLOT_FS in slots:
        # transmission scales radiance by (etaI/etaT)^2
        f_refl = lp.fs_kr * f_spec[:, None] / abs_ci[:, None]
        f_trans = (lp.kt * ((1.0 - f_spec) * (eta_rel * eta_rel))[:, None]
                   / abs_ci[:, None])
        f_trans = torch.where(t_ok[:, None], f_trans, 0.0)
        f = torch.where(is_slot(SLOT_FS)[:, None],
                        torch.where(take_refl[:, None], f_refl, f_trans), f)
        pdf = torch.where(is_slot(SLOT_FS),
                          torch.where(take_refl, f_spec, 1.0 - f_spec)
                          / n_match_f, pdf)
        is_trans = is_slot(SLOT_FS) & ~take_refl
    if SLOT_GTRANS in slots:
        is_trans = is_trans | is_slot(SLOT_GTRANS)
        bad = bad | (is_slot(SLOT_GTRANS) & ~gt_ok)
    if SLOT_DTRANS in slots:
        is_trans = is_trans | (is_slot(SLOT_DTRANS)
                               & ~_same_hemisphere(wo, wi))
    bad = bad | (pdf <= 0)
    f = torch.where(bad[:, None], 0.0, f)
    pdf = torch.where(bad, 0.0, pdf)
    return wi, f, pdf, is_spec, is_trans
