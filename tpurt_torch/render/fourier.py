"""The Fourier-basis tabulated BSDF of layered-material .bsdf files (port
of tpurt/render/fourier.py: FourierTableHost, read_bsdf_file,
write_bsdf_file, bake_fourier_table and the device table, _mu_weights,
_interp_cells, _interp_vcdf, _phi_series, _cos_dphi, _angles, _scale,
fourier_f, fourier_pdf, fourier_sample, make_lambertian_table;
materials/fourier.cpp FourierBSDFTable::Read :106, core/reflection.cpp
FourierBSDF::f :312, Sample_f :533, Pdf :613).

As in tpurt, each (muO, muI) cell's azimuthal series (ragged, variable
order m in the file) is baked at load onto 512 phi nodes over [0, pi]
with the cumulative integral of its first channel.  The series is linear
in its coefficients, so interpolating the baked cells with the 4x4
Catmull-Rom weights over (muI, muO) is the reference's
interpolate-then-evaluate up to the phi grid.  Sampling takes the zenith
from the file's own a0/cdf tables (SampleCatmullRom2D) and the azimuth
by a 10-step bisection of the interpolated cumulative table, each step a
16-tap gather, with tpurt's side flip; the pdf it reports is the density
it samples.  The baking is host numpy; the tables live on the job's
device.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.sampling.interpolation import (catmull_rom_weights,
                                                integrate_catmull_rom_np,
                                                sample_catmull_rom_2d)

N_PHI = 512  # baked azimuth nodes over [0, pi]
_BISECT_STEPS = 10  # log2(N_PHI) + 1


@dataclasses.dataclass
class FourierTableHost:
    """A parsed SCATFUN v1 table (FourierBSDFTable, reflection.h:130)."""

    eta: float
    m_max: int
    n_channels: int
    mu: np.ndarray  # (nMu,)
    cdf: np.ndarray  # (nMu, nMu) [muO, muI]
    a0: np.ndarray  # (nMu, nMu)
    m: np.ndarray  # (nMu, nMu) int
    a_offset: np.ndarray  # (nMu, nMu) int
    a: np.ndarray  # (nCoeffs,) flat coefficients


def read_bsdf_file(path: str) -> FourierTableHost:
    """FourierBSDFTable::Read (fourier.cpp:106-204).  Raises ValueError
    on a file that is not a SCATFUN v1 table of 1 or 3 channels."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"SCATFUN\x01":
        raise ValueError(f"{path}: not a SCATFUN v1 file")
    (flags, n_mu, n_coeffs, m_max, n_channels, n_bases,
     _u0, _u1, _u2) = struct.unpack("<9i", data[8:44])
    (eta,) = struct.unpack("<f", data[44:48])
    # 4 more unused ints pad the header to 64 bytes
    if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
        raise ValueError(f"{path}: unsupported SCATFUN variant "
                         f"(flags={flags} channels={n_channels} "
                         f"bases={n_bases})")
    off = 64
    mu = np.frombuffer(data, np.float32, n_mu, off)
    off += 4 * n_mu
    cdf = np.frombuffer(data, np.float32, n_mu * n_mu, off).reshape(n_mu, n_mu)
    off += 4 * n_mu * n_mu
    ol = np.frombuffer(data, np.int32, n_mu * n_mu * 2, off).reshape(-1, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(data, np.float32, n_coeffs, off)
    a_offset = ol[:, 0].reshape(n_mu, n_mu)
    m = ol[:, 1].reshape(n_mu, n_mu)
    a0 = np.where(m > 0, a[np.clip(a_offset, 0, len(a) - 1)], 0.0)
    return FourierTableHost(eta=float(eta), m_max=int(m_max),
                            n_channels=int(n_channels),
                            mu=mu.astype(np.float64), cdf=cdf.copy(),
                            a0=a0.astype(np.float32), m=m, a_offset=a_offset,
                            a=a)


def write_bsdf_file(path: str, tbl: FourierTableHost) -> None:
    """Write ``tbl`` as a SCATFUN v1 file, read_bsdf_file's inverse (the
    reference has no writer)."""
    n_mu = len(tbl.mu)
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9i", 1, n_mu, len(tbl.a), tbl.m_max,
                            tbl.n_channels, 1, 0, 0, 0))
        f.write(struct.pack("<f", tbl.eta))
        f.write(struct.pack("<4i", 0, 0, 0, 0))
        f.write(np.asarray(tbl.mu, np.float32).tobytes())
        f.write(np.asarray(tbl.cdf, np.float32).tobytes())
        ol = np.stack([tbl.a_offset.ravel(), tbl.m.ravel()], axis=-1)
        f.write(np.asarray(ol, np.int32).tobytes())
        f.write(np.asarray(tbl.a, np.float32).tobytes())


class FourierTableDev(NamedTuple):
    """The baked tables of one .bsdf file, on a device."""

    mu: torch.Tensor  # (nMu,)
    a0: torch.Tensor  # (nMu, nMu) [muO, muI]
    cdf: torch.Tensor  # (nMu, nMu)
    values: torch.Tensor  # (nMu, nMu, N_PHI, 3) series on the phi grid
    vcdf: torch.Tensor  # (nMu, nMu, N_PHI) cumulative integral, channel 0


def bake_fourier_table(host: FourierTableHost, n_phi: int = N_PHI) -> dict:
    """Every cell's series evaluated on the phi grid, and the cumulative
    integral of its first (luminance) channel, as host arrays with
    FourierTableDev's fields (tpurt's bake_fourier_table)."""
    n_mu = len(host.mu)
    phi = np.linspace(0.0, np.pi, n_phi)
    values = np.zeros((n_mu, n_mu, n_phi, 3), np.float32)
    for o in range(n_mu):
        for i in range(n_mu):
            mm = int(host.m[o, i])
            if mm <= 0:
                continue
            base = int(host.a_offset[o, i])
            cosk = np.cos(np.outer(phi, np.arange(mm)))  # (n_phi, m)
            for c in range(host.n_channels):
                values[o, i, :, c] = cosk @ host.a[base + c * mm:
                                                   base + (c + 1) * mm]
    if host.n_channels == 1:
        values[..., 1] = values[..., 0]
        values[..., 2] = values[..., 0]
    y = np.maximum(values[..., 0], 0.0)
    dphi = phi[1] - phi[0]
    vcdf = np.concatenate([
        np.zeros((n_mu, n_mu, 1), np.float32),
        np.cumsum(0.5 * (y[..., 1:] + y[..., :-1]) * dphi, axis=-1)
    ], axis=-1).astype(np.float32)
    return dict(mu=np.asarray(host.mu, np.float32),
                a0=np.asarray(host.a0, np.float32),
                cdf=np.asarray(host.cdf, np.float32), values=values,
                vcdf=vcdf)


def table_to_device(baked: dict, device) -> FourierTableDev:
    """bake_fourier_table's arrays as a FourierTableDev on ``device``."""
    return FourierTableDev(**{k: torch.tensor(v, device=device)
                              for k, v in baked.items()})


def _mu_weights(tbl: FourierTableDev, x):
    ok, off, w = catmull_rom_weights(tbl.mu, x)
    rows = torch.clamp(off[:, None] + torch.arange(4, device=x.device), 0,
                       tbl.mu.shape[0] - 1)
    return ok, rows, w


def _blend(v, w_o, w_i):
    """sum_{o,i} w_o[o] v[o, i] w_i[i] over (N, 4, 4) cells."""
    return ((v * w_i[:, None, :]).sum(dim=-1) * w_o).sum(dim=-1)


def _interp_cells(tbl: FourierTableDev, rows_i, w_i, rows_o, w_o, kidx, ch):
    """sum_{o,i} w_o w_i values[o_cell, i_cell, kidx, ch]; kidx (N,)."""
    v = tbl.values[rows_o[:, :, None], rows_i[:, None, :],
                   kidx[:, None, None], ch]  # (N, 4, 4)
    return _blend(v, w_o, w_i)


def _interp_vcdf(tbl: FourierTableDev, rows_i, w_i, rows_o, w_o, kidx):
    v = tbl.vcdf[rows_o[:, :, None], rows_i[:, None, :], kidx[:, None, None]]
    return _blend(v, w_o, w_i)


def _phi_series(tbl: FourierTableDev, rows_i, w_i, rows_o, w_o, phi, ch):
    """The interpolated series at phi in [0, pi], linear between the
    baked nodes."""
    fk = phi / np.pi * (N_PHI - 1)
    k0 = torch.clamp(fk.to(torch.int64), 0, N_PHI - 2)
    t = fk - k0.to(torch.float32)
    v0 = _interp_cells(tbl, rows_i, w_i, rows_o, w_o, k0, ch)
    v1 = _interp_cells(tbl, rows_i, w_i, rows_o, w_o, k0 + 1, ch)
    return v0 * (1.0 - t) + v1 * t


def _cos_dphi(wi_neg, wo):
    """CosDPhi(-wi, wo) (reflection.h): the cosine of the azimuth
    difference."""
    num = wi_neg[:, 0] * wo[:, 0] + wi_neg[:, 1] * wo[:, 1]
    den = torch.sqrt((wi_neg[:, 0] ** 2 + wi_neg[:, 1] ** 2)
                     * (wo[:, 0] ** 2 + wo[:, 1] ** 2))
    return torch.clamp(num / torch.clamp(den, min=1e-12), -1.0, 1.0)


def _angles(wo, wi):
    return -wi[:, 2], wo[:, 2], torch.arccos(_cos_dphi(-wi, wo))


def _scale(tbl_eta: float, mu_i, mu_o):
    s = torch.where(mu_i.abs() > 1e-9,
                    1.0 / torch.clamp(mu_i.abs(), min=1e-9), 0.0)
    # the adjoint eta^2 factor of radiance transport (reflection.cpp:352)
    eta = torch.where(mu_i > 0, 1.0 / tbl_eta, tbl_eta)
    return torch.where(mu_i * mu_o > 0, s * eta * eta, s)


def _rgb(tbl, rows_i, w_i, rows_o, w_o, phi, y, eta, mu_i, mu_o):
    """The (N, 3) rgb of the series at phi from its luminance y and the
    red and blue channels (the reference's green from Y, R, B)."""
    r = _phi_series(tbl, rows_i, w_i, rows_o, w_o, phi, 1)
    b = _phi_series(tbl, rows_i, w_i, rows_o, w_o, phi, 2)
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    s = _scale(eta, mu_i, mu_o)
    return torch.stack([r * s, g * s, b * s], dim=-1)


def fourier_f(tbl: FourierTableDev, eta: float, wo, wi):
    """FourierBSDF::f (reflection.cpp:312): (N, 3) rgb."""
    mu_i, mu_o, phi = _angles(wo, wi)
    ok_i, rows_i, w_i = _mu_weights(tbl, mu_i)
    ok_o, rows_o, w_o = _mu_weights(tbl, mu_o)
    y = torch.clamp(_phi_series(tbl, rows_i, w_i, rows_o, w_o, phi, 0),
                    min=0.0)
    rgb = _rgb(tbl, rows_i, w_i, rows_o, w_o, phi, y, eta, mu_i, mu_o)
    return torch.where((ok_i & ok_o)[:, None], torch.clamp(rgb, min=0.0),
                       0.0)


def fourier_pdf(tbl: FourierTableDev, wo, wi):
    """FourierBSDF::Pdf (reflection.cpp:613): Y / (sum_o w_o rho_o)."""
    mu_i, mu_o, phi = _angles(wo, wi)
    ok_i, rows_i, w_i = _mu_weights(tbl, mu_i)
    ok_o, rows_o, w_o = _mu_weights(tbl, mu_o)
    y = _phi_series(tbl, rows_i, w_i, rows_o, w_o, phi, 0)
    n_mu = tbl.mu.shape[0]
    rho = (tbl.cdf[rows_o, n_mu - 1] * w_o).sum(dim=-1) * 2.0 * np.pi
    return torch.where(ok_i & ok_o & (rho > 0) & (y > 0),
                       y / torch.clamp(rho, min=1e-20), 0.0)


def fourier_sample(tbl: FourierTableDev, eta: float, wo, u0, u1):
    """FourierBSDF::Sample_f (reflection.cpp:533): (wi, f (N, 3), pdf).
    The zenith from the file's (a0, cdf) tables, the azimuth from the
    baked cumulative series by bisection."""
    mu_o = wo[:, 2]
    mu_i, _f0, pdf_mu = sample_catmull_rom_2d(tbl.mu, tbl.mu, tbl.a0,
                                              tbl.cdf, mu_o, u1)
    ok_i, rows_i, w_i = _mu_weights(tbl, mu_i)
    ok_o, rows_o, w_o = _mu_weights(tbl, mu_o)

    # phi in [0, pi] from the interpolated cumulative table, with the
    # reference's side flip (SampleFourier, interpolation.cpp:363)
    flip = u0 >= 0.5
    u = torch.where(flip, 1.0 - 2.0 * (u0 - 0.5), 2.0 * u0)
    last = torch.full_like(rows_i[:, 0], N_PHI - 1)
    total = _interp_vcdf(tbl, rows_i, w_i, rows_o, w_o, last)
    target = u * total
    lo = torch.zeros_like(last)
    hi = last
    for _ in range(_BISECT_STEPS):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        below = _interp_vcdf(tbl, rows_i, w_i, rows_o, w_o, mid) <= target
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid - 1)
    k = torch.clamp(lo, 0, N_PHI - 2)
    c0 = _interp_vcdf(tbl, rows_i, w_i, rows_o, w_o, k)
    c1 = _interp_vcdf(tbl, rows_i, w_i, rows_o, w_o, k + 1)
    t = torch.clamp((target - c0) / torch.clamp(c1 - c0, min=1e-20), 0.0,
                    1.0)
    phi_half = (k.to(torch.float32) + t) * (np.pi / (N_PHI - 1))
    y_phi = torch.clamp(
        _phi_series(tbl, rows_i, w_i, rows_o, w_o, phi_half, 0), min=0.0)
    # density over the full circle: y / (2 * total)
    pdf_phi = torch.where(total > 0,
                          y_phi / torch.clamp(2.0 * total, min=1e-20), 0.0)
    phi = torch.where(flip, 2.0 * np.pi - phi_half, phi_half)

    # wi (reflection.cpp:583-599)
    sin2_i = torch.clamp(1.0 - mu_i * mu_i, min=0.0)
    sin2_o = torch.clamp(1.0 - mu_o * mu_o, min=0.0)
    nrm = torch.sqrt(sin2_i / torch.clamp(sin2_o, min=1e-20))
    nrm = torch.where(torch.isfinite(nrm), nrm, 0.0)
    sp = torch.sin(phi)
    cp = torch.cos(phi)
    wi = -torch.stack([nrm * (cp * wo[:, 0] - sp * wo[:, 1]),
                       nrm * (sp * wo[:, 0] + cp * wo[:, 1]), mu_i], dim=-1)
    wi = wi / torch.clamp(torch.linalg.vector_norm(wi, dim=-1, keepdim=True),
                          min=1e-12)

    f3 = torch.clamp(_rgb(tbl, rows_i, w_i, rows_o, w_o, phi_half, y_phi,
                          eta, mu_i, mu_o), min=0.0)
    ok = ok_i & ok_o
    pdf = torch.where(ok, torch.clamp(pdf_mu, min=0.0) * pdf_phi, 0.0)
    return wi, torch.where(ok[:, None], f3, 0.0), pdf


def make_lambertian_table(rho: float = 0.5, n_mu: int = 24
                          ) -> FourierTableHost:
    """A single-order table of a Lambertian BRDF of reflectance rho: the
    stored series value is f * |muI| = rho / pi * |muI| on pairs of
    opposite hemispheres."""
    mu = np.cos(np.linspace(np.pi, 0.0, n_mu))
    mu[0], mu[-1] = -1.0, 1.0
    a0 = np.zeros((n_mu, n_mu), np.float32)
    coeffs = []
    offsets = np.zeros((n_mu, n_mu), np.int32)
    orders = np.zeros((n_mu, n_mu), np.int32)
    for o in range(n_mu):
        for i in range(n_mu):
            if mu[o] * mu[i] < 0:  # reflection pair
                val = rho / np.pi * abs(mu[i])
                offsets[o, i] = len(coeffs)
                orders[o, i] = 1
                coeffs.append(val)
                a0[o, i] = val
    # cdf rows: the integral of a0 over muI for each muO row
    _, cdf = integrate_catmull_rom_np(mu, a0.astype(np.float64))
    return FourierTableHost(eta=1.0, m_max=1, n_channels=1,
                            mu=mu, cdf=cdf.astype(np.float32), a0=a0,
                            m=orders, a_offset=offsets,
                            a=np.asarray(coeffs, np.float32))
