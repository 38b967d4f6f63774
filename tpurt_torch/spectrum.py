"""Color/spectrum conversions.  The framework is RGB-native (the reference's
default Spectrum is RGBSpectrum; pbrt.h:126-130) with a (..., 3) channel
axis; this module converts the scene format's other spectrum flavors
(xyz / blackbody / sampled-spectrum params) into RGB at scene-build time.

Reference analog: core/spectrum.{h,cpp}.  CIE matching functions use the
multi-lobe Gaussian fits of Wyman, Sloan & Shirley, "Simple Analytic
Approximations to the CIE XYZ Color Matching Functions" (JCGT 2013), which
are accurate to well under 1% of peak — sufficient for scene-description
color conversion without shipping the 471-entry tables.
"""

from __future__ import annotations

import numpy as np

# pbrt's XYZ<->RGB matrices (core/spectrum.h XYZToRGB/RGBToXYZ).
XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)

#: integral of the CIE Y matching curve (core/spectrum.h CIE_Y_integral)
CIE_Y_INTEGRAL = 106.856895


def xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    return np.asarray(xyz, dtype=np.float64) @ XYZ_TO_RGB.T


def rgb_to_xyz(rgb: np.ndarray) -> np.ndarray:
    return np.asarray(rgb, dtype=np.float64) @ RGB_TO_XYZ.T


def _g(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_x(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return (
        _g(lam, 1.056, 599.8, 37.9, 31.0)
        + _g(lam, 0.362, 442.0, 16.0, 26.7)
        + _g(lam, -0.065, 501.1, 20.4, 26.2)
    )


def cie_y(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return _g(lam, 0.821, 568.8, 46.9, 40.5) + _g(lam, 0.286, 530.9, 16.3, 31.1)


def cie_z(lam):
    lam = np.asarray(lam, dtype=np.float64)
    return _g(lam, 1.217, 437.0, 11.8, 36.0) + _g(lam, 0.681, 459.0, 26.0, 13.8)


def spectrum_samples_to_rgb(lambdas, values) -> np.ndarray:
    """Piecewise-linear SPD (sorted (lambda, value) samples) -> RGB, by
    integrating against the CIE curves over 360-830nm (the reference
    resamples to 60 bins then converts; spectrum.cpp FromSampled)."""
    lam = np.asarray(lambdas, dtype=np.float64)
    val = np.asarray(values, dtype=np.float64)
    order = np.argsort(lam)
    lam, val = lam[order], val[order]
    grid = np.arange(360.0, 831.0)
    v = np.interp(grid, lam, val, left=val[0], right=val[-1])
    x = np.trapezoid(v * cie_x(grid), grid)
    y = np.trapezoid(v * cie_y(grid), grid)
    z = np.trapezoid(v * cie_z(grid), grid)
    scale = 1.0 / CIE_Y_INTEGRAL
    return xyz_to_rgb(np.array([x, y, z]) * scale)


def blackbody_rgb(temperature: float, scale: float = 1.0) -> np.ndarray:
    """'blackbody' spectrum param: Planck emitter at T kelvin, normalized so
    its peak value is ``scale`` (spectrum.cpp BlackbodyNormalized)."""
    grid = np.arange(360.0, 831.0)
    le = _planck(grid, temperature)
    # Wien's displacement law peak (in nm)
    lambda_max = 2.8977721e-3 / temperature * 1e9
    peak = _planck(np.array([lambda_max]), temperature)[0]
    return spectrum_samples_to_rgb(grid, le / peak * scale)


def _planck(lam_nm, t):
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    l = np.asarray(lam_nm, dtype=np.float64) * 1e-9
    return (2 * h * c * c) / (l ** 5 * (np.expm1(h * c / (l * kb * t))))


def luminance(rgb: np.ndarray) -> np.ndarray:
    """y() of an RGB spectrum (spectrum.h RGBSpectrum::y)."""
    rgb = np.asarray(rgb)
    return (
        0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    )
