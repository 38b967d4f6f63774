"""Reconstruction filters, evaluated per stamped pixel on the device (port
of tpurt/render/filters.py: box, triangle, gaussian, mitchell and windowed
sinc, and make_filter with the reference defaults)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpurt_torch.scene.paramset import ParamSet


class Filter(NamedTuple):
    name: str
    radius: Tuple[float, float]
    params: Tuple[float, ...] = ()

    def evaluate(self, dx, dy):
        """Filter weight at offset (dx, dy) from the sample position."""
        rx, ry = self.radius
        if self.name == "box":
            return torch.ones_like(dx)
        if self.name == "triangle":
            return (torch.clamp(rx - dx.abs(), min=0.0)
                    * torch.clamp(ry - dy.abs(), min=0.0))
        if self.name == "gaussian":
            alpha = self.params[0]
            expx = float(np.exp(-alpha * rx * rx))
            expy = float(np.exp(-alpha * ry * ry))
            gx = torch.clamp(torch.exp(-alpha * dx * dx) - expx, min=0.0)
            gy = torch.clamp(torch.exp(-alpha * dy * dy) - expy, min=0.0)
            return gx * gy
        if self.name == "mitchell":
            b, c = self.params
            return _mitchell_1d(dx / rx, b, c) * _mitchell_1d(dy / ry, b, c)
        if self.name == "sinc":
            tau = self.params[0]
            return _windowed_sinc(dx, rx, tau) * _windowed_sinc(dy, ry, tau)
        raise ValueError(self.name)


def _mitchell_1d(x, b, c):
    x = (2.0 * x).abs()
    x2, x3 = x * x, x * x * x
    inner = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
             + (6 - 2 * b)) * (1.0 / 6.0)
    outer = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
             + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    return torch.where(x > 1, torch.where(x < 2, outer, 0.0), inner)


def _sinc(x):
    x = x.abs()
    return torch.where(x < 1e-5, 1.0, torch.sin(np.pi * x) / (np.pi * x))


def _windowed_sinc(x, radius, tau):
    return torch.where(x.abs() > radius, 0.0, _sinc(x) * _sinc(x / tau))


# reference defaults (api.cpp MakeFilter :839-858): half-width, and the
# extra parameters by name
_DEFAULTS = {
    "box": (0.5, ()),
    "triangle": (2.0, ()),
    "gaussian": (2.0, (("alpha", 2.0),)),
    "mitchell": (2.0, (("B", 1.0 / 3.0), ("C", 1.0 / 3.0))),
    "sinc": (4.0, (("tau", 3.0),)),
}


def make_filter(name: str, ps: ParamSet) -> Filter:
    """MakeFilter dispatch with the reference defaults."""
    if name == "lanczossinc":
        name = "sinc"
    if name not in _DEFAULTS:
        raise NotImplementedError(f'PixelFilter "{name}"')
    width, extra = _DEFAULTS[name]
    return Filter(name, (ps.find_one_float("xwidth", width),
                         ps.find_one_float("ywidth", width)),
                  tuple(ps.find_one_float(k, v) for k, v in extra))
