"""Sampled-spectrum (60-bin) rendering mode: the bins, RGB <-> spectrum
conversions and the CIE integration of the spectral pipeline (port of
tpurt/spectrum_sampled.py; pbrt-v3's SampledSpectrum, spectrum.h:48-50,
:295-340, spectrum.cpp:40-65, :310-385).

A spectrum is a (..., 60) channel axis in place of RGB's 3: nothing
branches per channel.  RGB scene parameters are promoted to smooth spectra
by the seven-basis combination of SampledSpectrum::FromRGB (a (N, 7)
coefficient matrix, the six min-ordering cases as masked selects, times a
(7, 60) basis, with the 0.94 reflectance and 0.86445 illuminant scales);
radiance goes back to RGB at the film through one (60, 3) matrix
(ToXYZ and XYZToRGB fused).

The basis and CIE tables are data of pbrt-v3's ``core/spectrum.cpp``.
``tables()`` reads them where tpurt does, in its order: tpurt's cached
``spectral_tables_v1.npz`` (``$TPURT_CACHE``, else ``~/.cache/tpurt``),
then the source tree named by ``$TPURT_PBRT_SRC``; without either it
builds tpurt's analytic fallback basis from the CIE fits, so both packages
promote colours the same way.  The port reads the cache and never writes
it.  tpurt also looks in a fixed checkout path of its own development
tree; the port does not: point ``$TPURT_PBRT_SRC`` at that tree instead.

The basis is built in float64 on the host and kept in float32, as tpurt's.
The device lifts are (N, 7) @ (7, 60) float32 products with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, "highest" float32
matmul precision): tpurt's product on the CPU is full float32.
"""

from __future__ import annotations

import functools
import logging
import os
import re

import numpy as np
import torch

from tpurt_torch.spectrum import (CIE_Y_INTEGRAL, XYZ_TO_RGB, _planck, cie_x,
                                  cie_y, cie_z)

log = logging.getLogger("tpurt_torch.spectrum")

N_BINS = 60
LAMBDA_START = 400.0
LAMBDA_END = 700.0
# the reflectance and illuminant scales of SampledSpectrum::FromRGB
REFL_SCALE = 0.94
ILLUM_SCALE = 0.86445

_BASIS_NAMES = [
    "RGB2SpectLambda",
    "RGBRefl2SpectWhite", "RGBRefl2SpectCyan", "RGBRefl2SpectMagenta",
    "RGBRefl2SpectYellow", "RGBRefl2SpectRed", "RGBRefl2SpectGreen",
    "RGBRefl2SpectBlue",
    "RGBIllum2SpectWhite", "RGBIllum2SpectCyan", "RGBIllum2SpectMagenta",
    "RGBIllum2SpectYellow", "RGBIllum2SpectRed", "RGBIllum2SpectGreen",
    "RGBIllum2SpectBlue",
]
_COLOURS = ("White", "Cyan", "Magenta", "Yellow", "Red", "Green", "Blue")


def _cache_file() -> str:
    """tpurt's cache of the parsed tables (tpurt's _cache_dir)."""
    d = os.environ.get("TPURT_CACHE", os.path.expanduser("~/.cache/tpurt"))
    return os.path.join(d, "spectral_tables_v1.npz")


def _extract_float_array(text: str, name: str):
    """Parse ``const Float NAME[...] = { ... };`` from C++ source text."""
    m = re.search(r"Float\s+" + re.escape(name) + r"\s*\[[^\]]*\]\s*=\s*\{"
                  r"([^}]*)\}", text, re.S)
    if not m:
        return None
    vals = re.findall(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?",
                      m.group(1))
    return np.array([float(v) for v in vals], np.float64)


def _load_upstream_tables():
    """The basis and CIE curves of pbrt-v3 (numeric data only): tpurt's
    cached npz, else ``$TPURT_PBRT_SRC/core/spectrum.cpp``; None when
    neither is there."""
    cache = _cache_file()
    if os.path.isfile(cache):
        z = np.load(cache)
        return {k: z[k] for k in z.files}
    root = os.environ.get("TPURT_PBRT_SRC")
    if not root:
        return None
    src = os.path.join(root, "core", "spectrum.cpp")
    if not os.path.isfile(src):
        return None
    with open(src, errors="replace") as fh:
        text = fh.read()
    out = {}
    for name in _BASIS_NAMES + ["CIE_lambda", "CIE_X", "CIE_Y", "CIE_Z"]:
        arr = _extract_float_array(text, name)
        if arr is None:
            return None
        out[name] = arr
    return out


def _average_samples(lam: np.ndarray, val: np.ndarray,
                     l0: float, l1: float) -> float:
    """AverageSpectrumSamples (spectrum.cpp:40-65): the mean of the
    piecewise-linear SPD over [l0, l1], constant past its ends."""
    lam = np.asarray(lam, np.float64)
    val = np.asarray(val, np.float64)
    if len(lam) == 1 or l1 <= lam[0]:
        return float(val[0])
    if l0 >= lam[-1]:
        return float(val[-1])
    s = 0.0
    if l0 < lam[0]:
        s += val[0] * (lam[0] - l0)
    if l1 > lam[-1]:
        s += val[-1] * (l1 - lam[-1])
    i = max(int(np.searchsorted(lam, l0, side="right") - 1), 0)

    def interp(w, j):
        t = (w - lam[j]) / (lam[j + 1] - lam[j])
        return (1 - t) * val[j] + t * val[j + 1]

    while i + 1 < len(lam) and l1 >= lam[i]:
        s0 = max(l0, lam[i])
        s1 = min(l1, lam[i + 1])
        if s1 > s0:
            s += 0.5 * (interp(s0, i) + interp(s1, i)) * (s1 - s0)
        i += 1
    return s / (l1 - l0)


def spd_to_bins(lambdas, values) -> np.ndarray:
    """A piecewise-linear SPD, sorted or not, averaged into the 60 bins
    (SampledSpectrum::FromSampled, spectrum.h:295-313)."""
    lam = np.asarray(lambdas, np.float64)
    val = np.asarray(values, np.float64)
    order = np.argsort(lam)
    lam, val = lam[order], val[order]
    out = np.empty(N_BINS)
    for i in range(N_BINS):
        l0 = LAMBDA_START + (LAMBDA_END - LAMBDA_START) * i / N_BINS
        l1 = LAMBDA_START + (LAMBDA_END - LAMBDA_START) * (i + 1) / N_BINS
        out[i] = _average_samples(lam, val, l0, l1)
    return out


def bin_centers() -> np.ndarray:
    e = np.linspace(LAMBDA_START, LAMBDA_END, N_BINS + 1)
    return 0.5 * (e[:-1] + e[1:])


class SpectralTables:
    """The conversion tables of the sampled mode (tpurt's SpectralTables):
    ``basis_refl`` and ``basis_illum`` (7, 60), ``cie_bins`` (60, 3),
    ``to_xyz`` and ``to_rgb`` (60, 3), ``y_weight`` (60,), all float32
    but ``cie_bins``; ``source`` says where they came from."""

    def __init__(self):
        up = _load_upstream_tables()
        if up is not None:
            lam32 = up["RGB2SpectLambda"]
            self.basis_refl = np.stack([
                spd_to_bins(lam32, up["RGBRefl2Spect" + n])
                for n in _COLOURS])
            self.basis_illum = np.stack([
                spd_to_bins(lam32, up["RGBIllum2Spect" + n])
                for n in _COLOURS])
            self.cie_bins = np.stack([
                spd_to_bins(up["CIE_lambda"], up["CIE_" + a])
                for a in "XYZ"], axis=1)
            self.source = "upstream"
        else:
            log.warning("sampled-spectrum mode: upstream basis tables "
                        "unavailable; synthesizing an analytic basis "
                        "(RGB promotion will deviate from the reference)")
            grid = bin_centers()
            cx, cy, cz = cie_x(grid), cie_y(grid), cie_z(grid)
            self.cie_bins = np.stack([cx, cy, cz], axis=1)

            # tpurt's crude smooth basis: white flat, the primaries and
            # secondaries from the normalised CIE lobes
            def nz(a):
                return a / max(a.max(), 1e-9)

            r, g, b = nz(cx * (grid > 560)), nz(cy), nz(cz)
            white = np.ones(N_BINS)
            self.basis_refl = np.stack([white, 1 - r, 1 - g, 1 - b, r, g, b])
            self.basis_illum = self.basis_refl.copy()
            self.source = "analytic-fallback"
        scale = (LAMBDA_END - LAMBDA_START) / (CIE_Y_INTEGRAL * N_BINS)
        # xyz = bins @ to_xyz (SampledSpectrum::ToXYZ)
        self.to_xyz = (self.cie_bins * scale).astype(np.float32)
        self.to_rgb = (self.to_xyz @ XYZ_TO_RGB.T).astype(np.float32)
        self.basis_refl = self.basis_refl.astype(np.float32)
        self.basis_illum = self.basis_illum.astype(np.float32)
        # y = bins @ y_weight (Spectrum::y)
        self.y_weight = self.to_xyz[:, 1]


@functools.lru_cache(maxsize=None)
def tables() -> SpectralTables:
    return SpectralTables()


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: str) -> torch.Tensor:
    return torch.tensor(getattr(tables(), name), device=device)


def _exact_matmul(device) -> None:
    """A CUDA float32 product in full float32: TF32 off."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def rgb_to_coeff7(rgb):
    """The six min-ordering cases of SampledSpectrum::FromRGB as a
    (..., 7) stack [white, cyan, magenta, yellow, red, green, blue] of an
    (..., 3) numpy array or tensor."""
    if isinstance(rgb, np.ndarray):
        where, stack, zeros = np.where, np.stack, np.zeros_like
    else:
        where, stack, zeros = torch.where, torch.stack, torch.zeros_like
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    z = zeros(r)
    c_w = c_c = c_m = c_y = c_r = c_g = c_b = z
    m_r = (r <= g) & (r <= b)                    # r is the least
    m_g = ~m_r & (g <= r) & (g <= b)             # g is
    m_b = ~m_r & ~m_g                            # b is
    gb = g <= b
    c_w = where(m_r, r, c_w)
    c_c = where(m_r, where(gb, g - r, b - r), c_c)
    c_b = where(m_r & gb, b - g, c_b)
    c_g = where(m_r & ~gb, g - b, c_g)
    rb = r <= b
    c_w = where(m_g, g, c_w)
    c_m = where(m_g, where(rb, r - g, b - g), c_m)
    c_b = where(m_g & rb, b - r, c_b)
    c_r = where(m_g & ~rb, r - b, c_r)
    rg = r <= g
    c_w = where(m_b, b, c_w)
    c_y = where(m_b, where(rg, r - b, g - b), c_y)
    c_g = where(m_b & rg, g - r, c_g)
    c_r = where(m_b & ~rg, r - g, c_r)
    if isinstance(rgb, np.ndarray):
        return stack([c_w, c_c, c_m, c_y, c_r, c_g, c_b], axis=-1)
    return stack([c_w, c_c, c_m, c_y, c_r, c_g, c_b], dim=-1)


def _lift(rgb: torch.Tensor, basis: str, scale) -> torch.Tensor:
    _exact_matmul(rgb.device)
    out = rgb_to_coeff7(rgb) @ _device_table(basis, str(rgb.device))
    if scale is not None:
        out = out * scale
    return torch.clamp(out, min=0.0)


def lift_refl(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) reflectance -> (..., 60): one (7, 60) product and the 0.94
    scale."""
    return _lift(rgb, "basis_refl", REFL_SCALE)


def lift_illum(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) illuminant -> (..., 60) through the illuminant basis and
    the 0.86445 scale."""
    return _lift(rgb, "basis_illum", ILLUM_SCALE)


def lift_refl_raw(rgb: torch.Tensor) -> torch.Tensor:
    """The reflectance lift without the 0.94 scale: for BSDF values
    already evaluated in 3 channels (the hair model), where the scale would
    lose energy against RGB mode."""
    return _lift(rgb, "basis_refl", None)


def to_rgb_matrix(device) -> torch.Tensor:
    """(60, 3) radiance -> RGB (ToXYZ and XYZToRGB fused) on ``device``."""
    return _device_table("to_rgb", str(torch.device(device)))


def to_rgb(bins: torch.Tensor) -> torch.Tensor:
    """(..., 60) radiance -> (..., 3) RGB."""
    _exact_matmul(bins.device)
    return bins @ to_rgb_matrix(bins.device)


def luminance_bins(bins):
    """Spectrum::y of (..., 60) bins -> (...,), numpy or tensor."""
    if isinstance(bins, np.ndarray):
        return bins @ tables().y_weight
    _exact_matmul(bins.device)
    return bins @ _device_table("y_weight", str(bins.device))


def blackbody_bins(temperature: float, scale: float = 1.0) -> np.ndarray:
    """The normalised Planck SPD in bins (BlackbodyNormalized,
    spectrum.cpp:230-240)."""
    grid = np.arange(360.0, 831.0)
    v = _planck(grid, temperature)
    lam_max = 2.8977721e-3 / temperature * 1e9
    v = v / max(_planck(np.array([lam_max]), temperature)[0], 1e-30)
    return spd_to_bins(grid, v * scale)
