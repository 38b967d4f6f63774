"""BSDF for matte and plastic: the diffuse and GGX glossy lobes of tpurt's
slot mixture (port of tpurt/render/bsdf.py restricted to slots 0 and 1
with dielectric Fresnel).

  slot 0  DIFFUSE  Lambertian / Oren-Nayar (kd, A, B)
  slot 1  GLOSSY   microfacet GGX reflection (ks, alpha, dielectric eta)

Sampling follows BSDF::Sample_f's uniform choice among active slots
(reflection.cpp:714): u picks an active slot, the slot samples wi, f sums
the active slots on the correct hemisphere and pdf averages them.  Both
slots are non-specular, so is_specular and is_transmission are always
False here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.render.sampling_warps import (INV_PI, cosine_sample_hemisphere,
                                               cross, dot, norm)

F32_EPS = float(np.float32(1e-9))
N_SLOTS = 2
SLOT_DIFFUSE, SLOT_GLOSSY = range(N_SLOTS)


class LobeParams(NamedTuple):
    """Per-lane BSDF parameters, local-frame shading."""

    kd: torch.Tensor  # (N,3) diffuse reflectance
    oren_a: torch.Tensor  # (N,)
    oren_b: torch.Tensor  # (N,)
    ks: torch.Tensor  # (N,3) glossy reflectance scale
    alpha_x: torch.Tensor  # (N,)
    alpha_y: torch.Tensor  # (N,)
    eta: torch.Tensor  # (N,) dielectric ior of the glossy Fresnel

    @property
    def active(self):
        """(N,2) bool lobe activity."""
        return torch.stack([(self.kd > 0).any(dim=-1),
                            (self.ks > 0).any(dim=-1)], dim=-1)


def _abs_cos_theta(w):
    return w[:, 2].abs()


def _same_hemisphere(a, b):
    return a[:, 2] * b[:, 2] > 0


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

def _diffuse_f(lp: LobeParams, wo, wi):
    """Oren-Nayar; A=1, B=0 reduces to Lambertian (reflection.h:358)."""
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
    return lp.kd * (INV_PI * scale)[:, None]


def _diffuse_pdf(wo, wi):
    return torch.where(_same_hemisphere(wo, wi),
                       _abs_cos_theta(wi) * INV_PI, 0.0)


def _glossy_f(lp: LobeParams, wo, wi):
    """GGX microfacet reflection (MicrofacetReflection::f)."""
    co = _abs_cos_theta(wo)
    ci = _abs_cos_theta(wi)
    wh = wo + wi
    wh_len = norm(wh, keepdim=True)
    degenerate = (ci < F32_EPS) | (co < F32_EPS) | (wh_len[:, 0] < F32_EPS)
    wh = wh / torch.clamp(wh_len, min=F32_EPS)
    d = _ggx_d(wh, lp.alpha_x, lp.alpha_y)
    g = _ggx_g(wo, wi, lp.alpha_x, lp.alpha_y)
    # Fresnel with cos at the half vector, oriented toward the normal
    wh_fwd = torch.where(wh[:, 2:3] < 0, -wh, wh)
    f = fr_dielectric(dot(wi, wh_fwd), torch.ones_like(co), lp.eta)
    val = lp.ks * f[:, None] * (d * g / torch.clamp(4.0 * ci * co,
                                                    min=F32_EPS))[:, None]
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


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def bsdf_f(lp: LobeParams, wo, wi):
    """Sum of the active lobes on the correct hemisphere (BSDF::f)."""
    act = lp.active
    refl = _same_hemisphere(wo, wi)
    f = torch.where((act[:, SLOT_DIFFUSE] & refl)[:, None],
                    _diffuse_f(lp, wo, wi), 0.0)
    return f + torch.where((act[:, SLOT_GLOSSY] & refl)[:, None],
                           _glossy_f(lp, wo, wi), 0.0)


def _pdf_sum(lp: LobeParams, wo, wi):
    act = lp.active
    return (torch.where(act[:, SLOT_DIFFUSE], _diffuse_pdf(wo, wi), 0.0)
            + torch.where(act[:, SLOT_GLOSSY], _glossy_pdf(lp, wo, wi), 0.0))


def bsdf_pdf(lp: LobeParams, wo, wi):
    """Average pdf over the active lobes (BSDF::Pdf)."""
    n_match = lp.active.sum(dim=-1).to(torch.float32)
    pdf = _pdf_sum(lp, wo, wi)
    return torch.where(n_match > 0, pdf / torch.clamp(n_match, min=1.0), 0.0)


def bsdf_sample(lp: LobeParams, wo, u_lobe, u1, u2):
    """Sample an outgoing direction.  Returns (wi, f, pdf); the slice's
    lobes are never specular or transmissive, so tpurt's two flags are
    not returned."""
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

    wi_diff = cosine_sample_hemisphere(u1, u2)
    flip_z = torch.tensor([1.0, 1.0, -1.0], dtype=wi_diff.dtype,
                          device=wi_diff.device)
    wi_diff = torch.where(wo[:, 2:3] < 0, wi_diff * flip_z, wi_diff)
    wi_gloss = _glossy_sample(lp, wo, u1, u2)
    wi = torch.where((chosen == SLOT_DIFFUSE)[:, None], wi_diff,
                     torch.where((chosen == SLOT_GLOSSY)[:, None], wi_gloss,
                                 wi_diff * flip_z))

    n_match_f = torch.clamp(n_match.to(torch.float32), min=1.0)
    f = bsdf_f(lp, wo, wi)
    pdf = _pdf_sum(lp, wo, wi) / n_match_f
    bad = (n_match == 0) | (pdf <= 0)
    f = torch.where(bad[:, None], 0.0, f)
    pdf = torch.where(bad, 0.0, pdf)
    return wi, f, pdf
