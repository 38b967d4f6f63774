"""Hair BSDF, the pbrt-v3 Marschner-style model over (N,) lanes (port of
tpurt/render/hair.py).

A longitudinal term Mp, an attenuation term Ap for each internal path
count p and an azimuthal trimmed logistic Np, summed over p = 0..2 plus
a residual uniform p = 3 term (hair.cpp f :264-326, Sample_f :355-450,
Pdf :452-498).  The local frame is the reference's: x = the fiber
tangent (dpdu), z = the shading normal; wo.x = sin(thetaO).  Every
branch over p is unrolled into selects, as in tpurt, and expressions keep
tpurt's operation order.  ``demux_float`` splits a float's 32-bit fixed
point in int64 with 32-bit masks, as ``sampling/threefry.py`` does its
words.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

P_MAX = 3
SQRT_PI_OVER_8 = float(np.float32(0.626657069))
_PI = float(np.float32(np.pi))
# RGBSpectrum::y() luminance weights (spectrum.h:437)
_YW = (0.212671, 0.715160, 0.072169)
_U32 = 0xFFFFFFFF


class HairParams(NamedTuple):
    """Per-lane hair BSDF parameters ((N,) / (N, 3))."""

    h: torch.Tensor  # (N,) offset across the fiber width in [-1, 1]
    eta: torch.Tensor  # (N,)
    sigma_a: torch.Tensor  # (N, 3)
    beta_m: torch.Tensor  # (N,)
    beta_n: torch.Tensor  # (N,)
    alpha: torch.Tensor  # (N,) scale tilt (degrees)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0, 1.0))


def _sqr(x):
    return x * x


def _ipow(x, n: int):
    """x ** n by repeated squaring, as XLA's integer_pow computes jnp's
    ``x ** 20``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _jnp_mod(x, y: float):
    """jnp.mod: the truncated remainder moved onto the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _i0(x):
    """Modified Bessel I0 by its 10-term series (hair.cpp:63-76)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    xx = x * x
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * xx
        i4 *= 4.0
    return val


def _log_i0(x):
    """log I0 with the large-argument asymptote (hair.cpp:78-83)."""
    xc = torch.clamp(x, min=1e-12)
    big = x + 0.5 * (-float(np.log(np.float32(2.0 * _PI)))
                     + torch.log(1.0 / xc) + 1.0 / (8.0 * xc))
    small = torch.log(torch.clamp(_i0(torch.clamp(x, max=12.0)), min=1e-35))
    return torch.where(x > 12.0, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering Mp (hair.cpp:51-61), split at v = 0.1 as
    the reference does."""
    v_small = torch.clamp(v, 1e-7, 0.1)
    v_big = torch.clamp(v, min=0.1)
    a_s = cos_ti * cos_to / v_small
    b_s = sin_ti * sin_to / v_small
    mp_small = torch.exp(_log_i0(a_s) - b_s - 1.0 / v_small + 0.6931
                         + torch.log(1.0 / (2.0 * v_small)))
    a_b = cos_ti * cos_to / v_big
    b_b = sin_ti * sin_to / v_big
    mp_big = ((torch.exp(-b_b) * _i0(a_b))
              / (torch.sinh(1.0 / v_big) * 2.0 * v_big))
    return torch.where(v <= 0.1, mp_small, mp_big)


def _fr_dielectric_scalar(cos_i, eta):
    """FrDielectric for exterior incidence (reflection.cpp:47)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t = _safe_sqrt(1.0 - cos_i * cos_i) / eta
    total = sin_t >= 1.0
    cos_t = _safe_sqrt(1.0 - sin_t * sin_t)
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t,
                                                min=1e-12)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t,
                                                 min=1e-12)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(total, 1.0, fr)


def _derived(hp: HairParams):
    """The constants the HairBSDF constructor precomputes per lane
    (hair.cpp:228-262): longitudinal variances v[p], the azimuthal
    logistic scale s and the 2^k alpha rotations."""
    bm = hp.beta_m
    v0 = _sqr(0.726 * bm + 0.812 * _sqr(bm) + 3.7 * _ipow(bm, 20))
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    bn = hp.beta_n
    s = SQRT_PI_OVER_8 * (0.265 * bn + 1.194 * _sqr(bn)
                          + 5.372 * _ipow(bn, 22))
    rad = hp.alpha * (_PI / 180.0)
    sin2k = [torch.sin(rad)]
    cos2k = [_safe_sqrt(1.0 - _sqr(sin2k[0]))]
    for i in range(1, 3):
        sin2k.append(2.0 * cos2k[i - 1] * sin2k[i - 1])
        cos2k.append(_sqr(cos2k[i - 1]) - _sqr(sin2k[i - 1]))
    return v, s, sin2k, cos2k


def _tilted(sin_to, cos_to, sin2k, cos2k, p: int):
    """(sinThetaO, cosThetaO) rotated by the scale tilt of term p
    (hair.cpp:294-313)."""
    if p == 0:
        s = sin_to * cos2k[1] - cos_to * sin2k[1]
        c = cos_to * cos2k[1] + sin_to * sin2k[1]
    elif p == 1:
        s = sin_to * cos2k[0] + cos_to * sin2k[0]
        c = cos_to * cos2k[0] - sin_to * sin2k[0]
    elif p == 2:
        s = sin_to * cos2k[2] + cos_to * sin2k[2]
        c = cos_to * cos2k[2] - sin_to * sin2k[2]
    else:
        return sin_to, cos_to
    return s, c.abs()


def _ap(cos_to, eta, h, T):
    """Attenuation terms A_p (hair.cpp:85-104): 4 x (N, 3)."""
    cos_go = _safe_sqrt(1.0 - h * h)
    f = _fr_dielectric_scalar(cos_to * cos_go, eta)[:, None]
    ap0 = f.expand(T.shape)
    ap1 = _sqr(1.0 - f) * T
    ap2 = ap1 * T * f
    ap3 = ap2 * T * f / torch.clamp(1.0 - T * f, min=1e-5)
    return [ap0, ap1, ap2, ap3]


def _phi_fn(p: int, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * _PI


def _logistic(x, s):
    x = x.abs()
    e = torch.exp(-x / s)
    return e / (s * _sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a: float, b: float):
    return _logistic(x, s) / (_logistic_cdf(_full(s, b), s)
                              - _logistic_cdf(_full(s, a), s))


def _full(like, value: float):
    return torch.full_like(like, value)


def _np_term(phi, p: int, s, gamma_o, gamma_t):
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = _jnp_mod(dphi + _PI, 2.0 * _PI) - _PI
    return _trimmed_logistic(dphi, s, -_PI, _PI)


def _refraction_terms(hp: HairParams, sin_to, cos_to):
    """gammaT and the transmittance T of the refracted internal path
    (hair.cpp:275-287)."""
    sin_tt = sin_to / hp.eta
    cos_tt = _safe_sqrt(1.0 - _sqr(sin_tt))
    etap = (torch.sqrt(torch.clamp(_sqr(hp.eta) - _sqr(sin_to), min=0.0))
            / torch.clamp(cos_to, min=1e-7))
    sin_gt = hp.h / torch.clamp(etap, min=1e-7)
    cos_gt = _safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = _safe_asin(sin_gt)
    T = torch.exp(-hp.sigma_a
                  * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-7))[:, None])
    return gamma_t, T


def _wo_terms(w):
    sin_t = w[:, 0]
    cos_t = _safe_sqrt(1.0 - _sqr(sin_t))
    phi = torch.atan2(w[:, 2], w[:, 1])
    return sin_t, cos_t, phi


def hair_f(hp: HairParams, wo, wi):
    """HairBSDF::f (hair.cpp:264-326): (N, 3), with the 1/|cos thetaI|
    factor as in the reference."""
    v, s, sin2k, cos2k = _derived(hp)
    sin_to, cos_to, phi_o = _wo_terms(wo)
    sin_ti, cos_ti, phi_i = _wo_terms(wi)
    gamma_o = _safe_asin(hp.h)
    gamma_t, T = _refraction_terms(hp, sin_to, cos_to)
    ap = _ap(cos_to, hp.eta, hp.h, T)
    phi = phi_i - phi_o
    fsum = torch.zeros_like(T)
    for p in range(P_MAX):
        s_op, c_op = _tilted(sin_to, cos_to, sin2k, cos2k, p)
        mp = _mp(cos_ti, c_op, sin_ti, s_op, v[p])
        np_p = _np_term(phi, p, s, gamma_o, gamma_t)
        fsum = fsum + (mp * np_p)[:, None] * ap[p]
    mp_res = _mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
    fsum = fsum + (mp_res / (2.0 * _PI))[:, None] * ap[P_MAX]
    abs_cos = wi[:, 2].abs()
    return torch.where(abs_cos[:, None] > 0,
                       fsum / torch.clamp(abs_cos, min=1e-12)[:, None], fsum)


def _ap_pdf(hp: HairParams, cos_to):
    """ComputeApPdf (hair.cpp:328-353): luminance-normalized Ap."""
    sin_to = _safe_sqrt(1.0 - _sqr(cos_to))
    _, T = _refraction_terms(hp, sin_to, cos_to)
    ap = _ap(cos_to, hp.eta, hp.h, T)
    yw = torch.tensor(_YW, dtype=T.dtype, device=T.device)
    ys = [(a * yw).sum(dim=-1) for a in ap]
    total = torch.clamp(ys[0] + ys[1] + ys[2] + ys[3], min=1e-20)
    return [y / total for y in ys]


def hair_pdf(hp: HairParams, wo, wi):
    """HairBSDF::Pdf (hair.cpp:452-498)."""
    v, s, sin2k, cos2k = _derived(hp)
    sin_to, cos_to, phi_o = _wo_terms(wo)
    sin_ti, cos_ti, phi_i = _wo_terms(wi)
    gamma_o = _safe_asin(hp.h)
    gamma_t, _T = _refraction_terms(hp, sin_to, cos_to)
    ap_pdf = _ap_pdf(hp, cos_to)
    phi = phi_i - phi_o
    pdf = torch.zeros_like(sin_to)
    for p in range(P_MAX):
        s_op, c_op = _tilted(sin_to, cos_to, sin2k, cos2k, p)
        mp = _mp(cos_ti, c_op, sin_ti, s_op, v[p])
        pdf = pdf + mp * ap_pdf[p] * _np_term(phi, p, s, gamma_o, gamma_t)
    mp_res = _mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
    return pdf + mp_res * ap_pdf[P_MAX] / (2.0 * _PI)


def _compact_1_by_1(x):
    """Drop the odd bits of a 32-bit word, packing the even bits low (the
    Morton decode behind DemuxFloat, hair.h:131-146); x int64 holding a
    uint32."""
    x = x & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    x = (x ^ (x >> 8)) & 0x0000FFFF
    return x


def demux_float(u):
    """DemuxFloat (hair.h:138): one uniform float into two, by
    de-interleaving the bits of its 32-bit fixed point."""
    bits = torch.clamp(u * float(2.0 ** 32),
                       max=float(np.float32(2.0 ** 32 - 1))).to(torch.int64)
    bits = bits & _U32
    a = _compact_1_by_1(bits)
    b = _compact_1_by_1(bits >> 1)
    scale = 1.0 / (1 << 16)
    return (a.to(torch.float32) * scale, b.to(torch.float32) * scale)


def _sample_trimmed_logistic(u, s, a: float, b: float):
    k = _logistic_cdf(_full(s, b), s) - _logistic_cdf(_full(s, a), s)
    x = -s * torch.log(1.0 / torch.clamp(u * k + _logistic_cdf(_full(s, a), s),
                                         min=1e-12)
                       - 1.0 + 1e-12)
    return torch.clamp(x, a, b)


def _select(p_idx, choices):
    """jnp.select over p = 0..3 (p_idx is always one of them)."""
    out = torch.zeros_like(choices[0])
    for p in range(len(choices) - 1, -1, -1):
        out = torch.where(p_idx == p, choices[p], out)
    return out


def hair_sample(hp: HairParams, wo, u2a, u2b):
    """HairBSDF::Sample_f (hair.cpp:355-450).  u2a, u2b: two uniform
    dimensions, demuxed into four as in the reference.  Returns (wi, f,
    pdf)."""
    v, s, sin2k, cos2k = _derived(hp)
    sin_to, cos_to, phi_o = _wo_terms(wo)
    u0a, u0b = demux_float(u2a)
    u1a, u1b = demux_float(u2b)

    # p from the Ap pdf by sequential subtraction (hair.cpp:366-371)
    ap_pdf = _ap_pdf(hp, cos_to)
    c0 = ap_pdf[0]
    c1 = c0 + ap_pdf[1]
    c2 = c1 + ap_pdf[2]
    p_idx = ((u0a >= c0).to(torch.int32) + (u0a >= c1).to(torch.int32)
             + (u0a >= c2).to(torch.int32))

    tilts = [_tilted(sin_to, cos_to, sin2k, cos2k, p) for p in range(4)]
    s_op = _select(p_idx, [t[0] for t in tilts])
    c_op = _select(p_idx, [t[1] for t in tilts])
    vp = _select(p_idx, v)

    # Mp for thetaI (hair.cpp:385-392)
    u1a = torch.clamp(u1a, min=1e-5)
    vp_c = torch.clamp(vp, min=1e-7)
    cos_theta = 1.0 + vp_c * torch.log(u1a + (1.0 - u1a)
                                       * torch.exp(-2.0 / vp_c))
    sin_theta = _safe_sqrt(1.0 - _sqr(cos_theta))
    cos_phi = torch.cos(2.0 * _PI * u1b)
    sin_ti = -cos_theta * s_op + sin_theta * cos_phi * c_op
    cos_ti = _safe_sqrt(1.0 - _sqr(sin_ti))

    # Np for dphi (hair.cpp:394-404)
    gamma_o = _safe_asin(hp.h)
    gamma_t, _T = _refraction_terms(hp, sin_to, cos_to)
    phi_p = _select(p_idx, [_phi_fn(p, gamma_o, gamma_t) for p in range(4)])
    dphi_lobe = phi_p + _sample_trimmed_logistic(u0b, s, -_PI, _PI)
    dphi = torch.where(p_idx < P_MAX, dphi_lobe, 2.0 * _PI * u0b)

    phi_i = phi_o + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], dim=-1)

    # the pdf over every term at the sampled direction (hair.cpp:412-446)
    pdf = torch.zeros_like(sin_to)
    for p in range(P_MAX):
        s_p, c_p = tilts[p]
        mp = _mp(cos_ti, c_p, sin_ti, s_p, v[p])
        pdf = pdf + mp * ap_pdf[p] * _np_term(dphi, p, s, gamma_o, gamma_t)
    mp_res = _mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
    pdf = pdf + mp_res * ap_pdf[P_MAX] / (2.0 * _PI)
    return wi, hair_f(hp, wo, wi), pdf


def sigma_a_from_concentration(ce, cp):
    """HairBSDF::SigmaAFromConcentration (hair.cpp:510-517)."""
    eu = np.asarray([0.419, 0.697, 1.37], np.float32)
    ph = np.asarray([0.187, 0.4, 1.05], np.float32)
    return ce * eu + cp * ph


def sigma_a_from_reflectance(c, beta_n):
    """HairBSDF::SigmaAFromReflectance (hair.cpp:519-527)."""
    c = np.clip(np.asarray(c, np.float64), 1e-5, 1.0)
    d = (5.969 - 0.215 * beta_n + 2.532 * beta_n ** 2 - 10.73 * beta_n ** 3
         + 5.574 * beta_n ** 4 + 0.245 * beta_n ** 5)
    return (np.log(c) / d) ** 2
