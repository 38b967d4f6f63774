"""Subsurface scattering: the tabulated separable BSSRDF (port of
tpurt/render/bssrdf.py).

Host part, numpy at scene build, a copy of tpurt's (:33-259): the
measured presets MEASURED_SS and get_medium_scattering_properties
(core/medium.cpp:48-182), the Fresnel moments, beam_diffusion_ms and
beam_diffusion_ss (core/bssrdf.cpp:68-144), and the (rho x radius)
profile table with its rho_eff and radial CDF, one a distinct (g, eta)
(compute_beam_diffusion_table, bssrdf.cpp:146-178, cached for the
process); subsurface_from_diffuse (:262), tpurt's inversion of the
rho -> rho_eff map for kdsubsurface.

Device part, torch over lanes (tpurt's :295-357): _profile_interp,
bss_sr (TabulatedBSSRDF::Sr, bssrdf.cpp:198), bss_pdf_sr (Pdf_Sr :359),
bss_sample_sr (Sample_Sr :350), fresnel_moment1_j and bss_sw
(SeparableBSSRDF::Sw, bssrdf.h:89).  tpurt evaluates every table on
every lane and selects by table index (integrator.py:526-556,
``_bss_*_multi``); here the scene's tables are one stack (BSSTables) and
each lane gathers from its own, ``tix``, so the values are tpurt's and
the launches do not grow with the number of tables.  Every table has
the same rho and radius nodes (compute_beam_diffusion_table's fixed
spacing), so the stack holds them once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tpurt_torch.render.bsdf import fr_dielectric
from tpurt_torch.sampling.interpolation import (catmull_rom_eval,
                                                catmull_rom_weights,
                                                integrate_catmull_rom_np,
                                                sample_catmull_rom_2d)

# measured subsurface presets (medium.cpp:48-177): name -> (sigma_prime_s,
# sigma_a), mm^-1
MEASURED_SS: Dict[str, Tuple[Tuple[float, float, float],
                             Tuple[float, float, float]]] = {
    "Apple": ((2.29, 2.39, 1.97), (0.0030, 0.0034, 0.046)),
    "Chicken1": ((0.15, 0.21, 0.38), (0.015, 0.077, 0.19)),
    "Chicken2": ((0.19, 0.25, 0.32), (0.018, 0.088, 0.20)),
    "Cream": ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163)),
    "Ketchup": ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
    "Marble": ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "Potato": ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12)),
    "Skimmilk": ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "Skin1": ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "Skin2": ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "Spectralon": ((11.6, 20.4, 14.9), (0.00, 0.00, 0.00)),
    "Wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
    "Lowfat Milk": ((0.89187, 1.5136, 2.532), (0.002875, 0.00575, 0.0115)),
    "Reduced Milk": ((2.4858, 3.1669, 4.5214),
                     (0.0025556, 0.0051111, 0.012778)),
    "Regular Milk": ((4.5513, 5.8294, 7.136), (0.0015333, 0.0046, 0.019933)),
    "Espresso": ((0.72378, 0.84557, 1.0247), (4.7984, 6.5751, 8.8493)),
    "Mint Mocha Coffee": ((0.31602, 0.38538, 0.48131), (3.772, 5.8228, 7.82)),
    "Lowfat Soy Milk": ((0.30576, 0.34233, 0.61664),
                        (0.0014375, 0.0071875, 0.035937)),
    "Regular Soy Milk": ((0.59223, 0.73866, 1.4693),
                         (0.0019167, 0.0095833, 0.065167)),
    "Lowfat Chocolate Milk": ((0.64925, 0.83916, 1.1057),
                              (0.0115, 0.0368, 0.1564)),
    "Regular Chocolate Milk": ((1.4585, 2.1289, 2.9527),
                               (0.010063, 0.043125, 0.14375)),
    "Coke": ((8.9053e-05, 8.372e-05, 0), (0.10014, 0.16503, 0.2468)),
    "Pepsi": ((6.1697e-05, 4.2564e-05, 0), (0.091641, 0.14158, 0.20729)),
    "Sprite": ((6.0306e-06, 6.4139e-06, 6.5504e-06),
               (0.001886, 0.0018308, 0.0020025)),
    "Gatorade": ((0.0024574, 0.003007, 0.0037325),
                 (0.024794, 0.019289, 0.008878)),
    "Chardonnay": ((1.7982e-05, 1.3758e-05, 1.2023e-05),
                   (0.010782, 0.011855, 0.023997)),
    "White Zinfandel": ((1.7501e-05, 1.9069e-05, 1.288e-05),
                        (0.012072, 0.016184, 0.019843)),
    "Merlot": ((2.1129e-05, 0, 0), (0.11632, 0.25191, 0.29434)),
    "Budweiser Beer": ((2.4356e-05, 2.4079e-05, 1.0564e-05),
                       (0.011492, 0.024911, 0.057786)),
    "Coors Light Beer": ((5.0922e-05, 4.301e-05, 0),
                         (0.006164, 0.013984, 0.034983)),
    "Clorox": ((0.0024035, 0.0031373, 0.003991),
               (0.0033542, 0.014892, 0.026297)),
    "Apple Juice": ((0.00013612, 0.00015836, 0.000227),
                    (0.012957, 0.023741, 0.052184)),
    "Cranberry Juice": ((0.00010402, 0.00011646, 7.8139e-05),
                        (0.039437, 0.094223, 0.12426)),
    "Grape Juice": ((5.382e-05, 0, 0), (0.10404, 0.23958, 0.29325)),
    "Ruby Grapefruit Juice": ((0.011002, 0.010927, 0.011036),
                              (0.085867, 0.18314, 0.25262)),
    "White Grapefruit Juice": ((0.22826, 0.23998, 0.32748),
                               (0.0138, 0.018831, 0.056781)),
    "Shampoo": ((0.0007176, 0.0008303, 0.0009016),
                (0.014107, 0.045693, 0.061717)),
    "Strawberry Shampoo": ((0.00015671, 0.00015947, 1.518e-05),
                           (0.01449, 0.05796, 0.075823)),
    "Head & Shoulders Shampoo": ((0.023805, 0.028804, 0.034306),
                                 (0.084621, 0.15688, 0.20365)),
    "Lemon Tea Powder": ((0.040224, 0.045264, 0.051081),
                         (2.4288, 4.5757, 7.2127)),
    "Orange Powder": ((0.00015617, 0.00017482, 0.0001762),
                      (0.001449, 0.003441, 0.007863)),
    "Pink Lemonade Powder": ((0.00012103, 0.00013073, 0.00012528),
                             (0.001165, 0.002366, 0.003195)),
    "Cappuccino Powder": ((1.8436, 2.5851, 2.1662), (35.844, 49.547, 61.084)),
    "Salt Powder": ((0.027333, 0.032451, 0.031979),
                    (0.28415, 0.3257, 0.34148)),
    "Sugar Powder": ((0.00022272, 0.00025513, 0.000271),
                     (0.012638, 0.031051, 0.050124)),
    "Suisse Mocha Powder": ((2.7979, 3.5452, 4.3365),
                            (17.502, 27.004, 35.433)),
    "Pacific Ocean Surface Water": ((0.0001764, 0.00032095, 0.00019617),
                                    (0.031845, 0.031324, 0.030147)),
}


def get_medium_scattering_properties(name: str):
    """GetMediumScatteringProperties (medium.cpp:182): returns
    (sigma_a, sigma_prime_s) rgb arrays, or None."""
    e = MEASURED_SS.get(name)
    if e is None:
        return None
    sp_s, s_a = e
    return np.asarray(s_a, np.float64), np.asarray(sp_s, np.float64)


# ---------------------------------------------------------------------------
# host precompute (photon beam diffusion)
# ---------------------------------------------------------------------------

def fresnel_moment1(eta):
    """First Fresnel reflectance moment (bssrdf.cpp:43)."""
    eta = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return np.where(eta < 1, lo, hi)


def fresnel_moment2(eta):
    """Second Fresnel reflectance moment (bssrdf.cpp:55)."""
    eta = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / np.maximum(eta, 1e-9)
    hi = (-547.033 + 45.3087 * r ** 3 - 218.725 * r ** 2 + 458.843 * r
          + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return np.where(eta < 1, lo, hi)


def _fr_dielectric_np(cos_i, eta_i, eta_t):
    """FrDielectric (reflection.cpp:47), numpy."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    swap = cos_i <= 0
    ei = np.where(swap, eta_t, eta_i)
    et = np.where(swap, eta_i, eta_t)
    cos_i = np.abs(cos_i)
    sin_t = ei / et * np.sqrt(np.maximum(0.0, 1 - cos_i * cos_i))
    total = sin_t >= 1
    cos_t = np.sqrt(np.maximum(0.0, 1 - sin_t * sin_t))
    r_par = (et * cos_i - ei * cos_t) / np.maximum(et * cos_i + ei * cos_t,
                                                   1e-12)
    r_perp = (ei * cos_i - et * cos_t) / np.maximum(ei * cos_i + et * cos_t,
                                                    1e-12)
    return np.where(total, 1.0, 0.5 * (r_par ** 2 + r_perp ** 2))


def _phase_hg_np(cos_theta, g):
    d = 1 + g * g + 2 * g * cos_theta
    return (1 - g * g) / (4 * np.pi * d * np.maximum(np.sqrt(d), 1e-12))


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r):
    """Multiple-scattering beam diffusion (bssrdf.cpp:68-122), vectorized
    over r."""
    r = np.asarray(r, np.float64)
    n = 100
    sigmap_s = sigma_s * (1 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / max(sigmap_t, 1e-12)
    d_g = (2 * sigma_a + sigmap_s) / (3 * sigmap_t ** 2)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1 = float(fresnel_moment1(eta))
    fm2 = float(fresnel_moment2(eta))
    ze = -2 * d_g * (1 + 3 * fm2) / (1 - 2 * fm1)
    c_phi = 0.25 * (1 - 2 * fm1)
    c_e = 0.5 * (1 - 3 * fm2)
    i = np.arange(n)[:, None]
    zr = -np.log(1 - (i + 0.5) / n) / sigmap_t
    zv = -zr + 2 * ze
    dr = np.sqrt(r[None, :] ** 2 + zr ** 2)
    dv = np.sqrt(r[None, :] ** 2 + zv ** 2)
    inv4pi = 1.0 / (4 * np.pi)
    phi_d = inv4pi / d_g * (np.exp(-sigma_tr * dr) / dr
                            - np.exp(-sigma_tr * dv) / dv)
    e_dn = inv4pi * (zr * (1 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr ** 3
                     - zv * (1 + sigma_tr * dv) * np.exp(-sigma_tr * dv)
                     / dv ** 3)
    e = phi_d * c_phi + e_dn * c_e
    kappa = 1 - np.exp(-2 * sigmap_t * (dr + zr))
    return (kappa * rhop * rhop * e).mean(axis=0)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r):
    """Single-scattering term (bssrdf.cpp:124-144), vectorized over r."""
    r = np.asarray(r, np.float64)
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / max(sigma_t, 1e-12)
    t_crit = r * np.sqrt(max(eta * eta - 1, 0.0))
    n = 100
    i = np.arange(n)[:, None]
    ti = t_crit[None, :] - np.log(1 - (i + 0.5) / n) / sigma_t
    d = np.sqrt(r[None, :] ** 2 + ti ** 2)
    cos_o = ti / np.maximum(d, 1e-12)
    ess = (rho * np.exp(-sigma_t * (d + t_crit[None, :]))
           / np.maximum(d * d, 1e-24)
           * _phase_hg_np(cos_o, g)
           * (1 - _fr_dielectric_np(-cos_o, 1.0, eta))
           * np.abs(cos_o))
    return ess.mean(axis=0)


@dataclasses.dataclass
class BSSRDFTableHost:
    """The (rho x radius) diffusion profile (BSSRDFTable, bssrdf.h:142)."""

    rho_samples: np.ndarray  # (R,)
    radius_samples: np.ndarray  # (S,)
    profile: np.ndarray  # (R, S)  2*pi*r*(SS+MS)
    rho_eff: np.ndarray  # (R,)
    profile_cdf: np.ndarray  # (R, S)


# one table a (g, eta), kept for the process, as tpurt keeps it
_TABLE_CACHE: Dict[Tuple[float, float], BSSRDFTableHost] = {}


def compute_beam_diffusion_table(g: float, eta: float,
                                 n_rho: int = 100,
                                 n_radius: int = 64) -> BSSRDFTableHost:
    """ComputeBeamDiffusionBSSRDF (bssrdf.cpp:146-178)."""
    key = (round(float(g), 6), round(float(eta), 6))
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    rho = (1 - np.exp(-8 * np.arange(n_rho) / (n_rho - 1))) / (1 - np.exp(-8.0))
    profile = np.zeros((n_rho, n_radius))
    for i in range(n_rho):
        profile[i] = 2 * np.pi * radius * (
            beam_diffusion_ss(rho[i], 1 - rho[i], g, eta, radius)
            + beam_diffusion_ms(rho[i], 1 - rho[i], g, eta, radius))
    rho_eff, cdf = integrate_catmull_rom_np(radius, profile)
    tbl = BSSRDFTableHost(rho_samples=rho, radius_samples=radius,
                          profile=profile, rho_eff=rho_eff, profile_cdf=cdf)
    _TABLE_CACHE[key] = tbl
    return tbl


def subsurface_from_diffuse(table: BSSRDFTableHost, rho_eff: np.ndarray,
                            mfp: np.ndarray):
    """SubsurfaceFromDiffuse (bssrdf.cpp:180) as tpurt computes it
    (bssrdf.py:262-278): the spline rho -> rho_eff evaluated in float32 at
    4096 points spread over rho's nodes, inverted per channel by linear
    interpolation in float64 (np.interp), where pbrt calls
    InvertCatmullRom; then 1/mfp split into (sigma_a, sigma_s)."""
    xs = np.linspace(table.rho_samples[0], table.rho_samples[-1], 4096)
    ys = catmull_rom_eval(
        torch.as_tensor(table.rho_samples, dtype=torch.float32),
        torch.as_tensor(table.rho_eff, dtype=torch.float32),
        torch.as_tensor(xs, dtype=torch.float32)).numpy()
    rho = np.interp(np.asarray(rho_eff, np.float64), ys, xs)
    sigma_s = rho / np.maximum(mfp, 1e-9)
    sigma_a = (1 - rho) / np.maximum(mfp, 1e-9)
    return sigma_a, sigma_s


# ---------------------------------------------------------------------------
# device evaluation (per lane, each lane on its own table)
# ---------------------------------------------------------------------------

class BSSTables(NamedTuple):
    """The scene's diffusion tables on the device, stacked: the shared
    nodes rho (R,) and radius (S,), and per table the profile (T, R, S),
    rho_eff (T, R) and the radial CDF (T, R, S) (tpurt's BSSTable, one a
    table)."""

    rho: torch.Tensor
    radius: torch.Tensor
    profile: torch.Tensor
    rho_eff: torch.Tensor
    cdf: torch.Tensor


def stack_tables(tables: Sequence[BSSRDFTableHost]) -> dict:
    """The host tables stacked as float32 arrays (tpurt's SceneData,
    driver.py:247-263, less its copy of the nodes a table): the shared
    nodes bss_rho (R,) and bss_radius (S,), which
    compute_beam_diffusion_table builds alike for every (g, eta), and
    bss_profile (T, R, S), bss_rhoeff (T, R), bss_cdf (T, R, S)."""

    def stack(field):
        return np.stack([getattr(t, field) for t in tables]).astype(
            np.float32)

    return dict(bss_rho=tables[0].rho_samples.astype(np.float32),
                bss_radius=tables[0].radius_samples.astype(np.float32),
                bss_profile=stack("profile"), bss_rhoeff=stack("rho_eff"),
                bss_cdf=stack("profile_cdf"))


def tables_to_device(stacks: dict, device) -> BSSTables:
    """stack_tables' arrays as BSSTables on ``device``."""

    def dev(k):
        return torch.tensor(np.asarray(stacks[k]), dtype=torch.float32,
                            device=device)

    return BSSTables(rho=dev("bss_rho"), radius=dev("bss_radius"),
                     profile=dev("bss_profile"), rho_eff=dev("bss_rhoeff"),
                     cdf=dev("bss_cdf"))


def _profile_interp(tbl: BSSTables, tix, rho_ch, r_opt):
    """Tensor-spline profile interpolation and the interpolated rho_eff
    (the inner loops of TabulatedBSSRDF::Sr / Pdf_Sr), each lane on its
    table tix."""
    ok_r, off_r, w_r = catmull_rom_weights(tbl.rho, rho_ch)
    ok_d, off_d, w_d = catmull_rom_weights(tbl.radius, r_opt)
    four = torch.arange(4, device=rho_ch.device)
    rows = torch.clamp(off_r[:, None] + four, 0, tbl.rho.shape[0] - 1)
    cols = torch.clamp(off_d[:, None] + four, 0, tbl.radius.shape[0] - 1)
    vals = tbl.profile[tix[:, None, None], rows[:, :, None],
                       cols[:, None, :]]  # (N, 4, 4)
    # tpurt's einsum("ni,nij,nj->n") contracted over i, then j, as
    # elementwise products and sums (a batch of 4x4 products is no work
    # for a GEMM)
    sr = ((w_r[:, :, None] * vals).sum(dim=1) * w_d).sum(dim=1)
    rho_eff = (tbl.rho_eff[tix[:, None], rows] * w_r).sum(dim=-1)
    return torch.where(ok_r & ok_d, sr, 0.0), rho_eff


def _per_radius(sr, r_opt):
    """The profile's 2 pi r factor divided out where r > 0."""
    return torch.where(r_opt > 0, sr / torch.clamp(2 * np.pi * r_opt,
                                                   min=1e-20), sr)


def bss_sr(tbl: BSSTables, tix, sigma_t, rho, r):
    """TabulatedBSSRDF::Sr (bssrdf.cpp:198): the (N, 3) profile value in
    world units.  sigma_t, rho (N, 3); r (N,).  The three channels run as
    one call over 3N lanes (channel-major)."""
    n = r.shape[0]
    sig = sigma_t.t().reshape(-1)
    r_opt = r.repeat(3) * sig
    sr, _ = _profile_interp(tbl, tix.repeat(3), rho.t().reshape(-1), r_opt)
    out = torch.clamp(_per_radius(sr, r_opt), min=0.0) * sig ** 2
    return out.reshape(3, n).t()


def bss_pdf_sr(tbl: BSSTables, tix, sigma_t_ch, rho_ch, r):
    """TabulatedBSSRDF::Pdf_Sr (bssrdf.cpp:359): one channel's radial pdf
    in world units."""
    r_opt = r * sigma_t_ch
    sr, rho_eff = _profile_interp(tbl, tix, rho_ch, r_opt)
    return torch.clamp(_per_radius(sr, r_opt) * sigma_t_ch ** 2
                       / torch.clamp(rho_eff, min=1e-20), min=0.0)


def bss_sample_sr(tbl: BSSTables, tix, sigma_t_ch, rho_ch, u):
    """TabulatedBSSRDF::Sample_Sr (bssrdf.cpp:350): a radius in world
    units; -1 where sigma_t is 0."""
    r_opt, _, _ = sample_catmull_rom_2d(tbl.rho, tbl.radius, tbl.profile,
                                        tbl.cdf, rho_ch, u, tix=tix)
    return torch.where(sigma_t_ch > 0,
                       r_opt / torch.clamp(sigma_t_ch, min=1e-20), -1.0)


def fresnel_moment1_j(eta):
    """fresnel_moment1 on a tensor (tpurt's fresnel_moment1_j)."""
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1, lo, hi)


def bss_sw(eta, cos_w):
    """SeparableBSSRDF::Sw (bssrdf.h:89): the directional exit term."""
    c = 1.0 - 2.0 * fresnel_moment1_j(1.0 / eta)
    return ((1.0 - fr_dielectric(cos_w, torch.ones_like(cos_w), eta))
            / torch.clamp(c * np.pi, min=1e-9))
