"""Reconstruction filter (port of tpurt/render/filters.py, box only)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpurt_torch.scene.paramset import ParamSet


class Filter(NamedTuple):
    name: str
    radius: Tuple[float, float]

    def evaluate(self, dx, dy):
        """Filter weight at offset (dx, dy) from the sample position."""
        return torch.ones_like(dx)


def make_filter(name: str, ps: ParamSet) -> Filter:
    """MakeFilter (api.cpp :839-858) for the box filter."""
    if name != "box":
        raise NotImplementedError(f'PixelFilter "{name}"')
    return Filter("box", (ps.find_one_float("xwidth", 0.5),
                          ps.find_one_float("ywidth", 0.5)))
