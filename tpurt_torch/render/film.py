"""Film: RGB accumulation with filter-stamped scatter-add (port of
tpurt/render/film.py: make_film, Film.add_samples, Film.add_splats,
Film.to_image).

The film is an (H, W, 3) + (H, W) pair of tensors on the render device.
Unlike tpurt's functional update, add_samples accumulates IN PLACE with
``index_put_(..., accumulate=True)``, which saves a copy of the film per
banked batch.  On CUDA the accumulation uses atomics, so the float sums
are taken in an order that changes from run to run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpurt_torch.scene.paramset import ParamSet
from tpurt_torch.render.filters import Filter


@dataclasses.dataclass
class FilmState:
    rgb: torch.Tensor  # (H, W, 3) filter-weighted radiance sums
    weight: torch.Tensor  # (H, W) filter weight sums
    splat: Optional[torch.Tensor] = None  # (H, W, 3) unweighted splats


@dataclasses.dataclass(frozen=True)
class Film:
    full_x: int
    full_y: int
    # crop window in pixels: [x0, x1), [y0, y1)
    crop: Tuple[int, int, int, int]
    filter: Filter
    filename: str
    scale: float
    max_sample_luminance: float

    @property
    def width(self) -> int:
        return self.crop[1] - self.crop[0]

    @property
    def height(self) -> int:
        return self.crop[3] - self.crop[2]

    def sample_bounds(self) -> Tuple[int, int, int, int]:
        """Film::GetSampleBounds (film.cpp:80-86): the crop bounds
        expanded by the filter radius (x0, x1, y0, y1)."""
        rx, ry = self.filter.radius
        x0, x1, y0, y1 = self.crop
        return (int(np.floor(x0 + 0.5 - rx)), int(np.ceil(x1 - 0.5 + rx)),
                int(np.floor(y0 + 0.5 - ry)), int(np.ceil(y1 - 0.5 + ry)))

    def initial_state(self, device, splats: bool = False) -> FilmState:
        h, w = self.height, self.width
        return FilmState(
            rgb=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
            weight=torch.zeros((h, w), dtype=torch.float32, device=device),
            splat=(torch.zeros((h, w, 3), dtype=torch.float32,
                               device=device) if splats else None))

    def _clamp(self, L):
        """maxSampleLuminance clamp (film.h:161)."""
        if not np.isfinite(self.max_sample_luminance):
            return L
        y = 0.212671 * L[:, 0] + 0.715160 * L[:, 1] + 0.072169 * L[:, 2]
        s = torch.where(y > self.max_sample_luminance,
                        torch.full_like(y, self.max_sample_luminance)
                        / torch.clamp(y, min=1e-20), 1.0)
        return L * s[:, None]

    def add_samples(self, state: FilmState, p_film, L, ray_weight) -> None:
        """Filter-stamped accumulation of N samples into ``state``.
        p_film: (N, 2) raster coords in crop-window space; L: (N, 3);
        ray_weight: (N,)."""
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        L = self._clamp(L)
        rx, ry = self.filter.radius
        kx = max(1, int(np.ceil(2 * rx - 1e-6)))
        ky = max(1, int(np.ceil(2 * ry - 1e-6)))
        h, w = self.height, self.width
        dx = p_film[:, 0] - 0.5
        dy = p_film[:, 1] - 0.5
        valid = torch.isfinite(dx) & torch.isfinite(dy)
        x0 = torch.ceil(torch.where(valid, dx - rx, 0.0)).long()
        y0 = torch.ceil(torch.where(valid, dy - ry, 0.0)).long()
        contrib = L * ray_weight[:, None]
        for j in range(ky):
            for i in range(kx):
                px = x0 + i
                py = y0 + j
                fw = self.filter.evaluate(px.float() - dx, py.float() - dy)
                ok = valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)
                fw = torch.where(ok, fw, 0.0)
                idx = (py.clamp(0, h - 1), px.clamp(0, w - 1))
                state.rgb.index_put_(idx, contrib * fw[:, None],
                                     accumulate=True)
                state.weight.index_put_(idx, fw * ray_weight,
                                        accumulate=True)

    def add_splats(self, state: FilmState, p_film, v) -> None:
        """Film::AddSplat (film.cpp:139): unweighted accumulation of N
        values v (N, 3) at the pixels holding p_film (N, 2), in
        crop-window raster space, IN PLACE; a position off the film (or
        not finite) adds nothing (tpurt's film.py:119-136).  Only the
        splats that add something are scattered: bdpt's dead lanes carry
        zeros, which clamped onto one pixel would serialise the scatter
        on the card."""
        v = torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
        v = self._clamp(v)
        fin = torch.isfinite(p_film).all(dim=-1)
        pf = torch.where(fin[:, None], p_film, -1.0)
        px = torch.floor(pf[:, 0]).long()
        py = torch.floor(pf[:, 1]).long()
        ok = (fin & (px >= 0) & (px < self.width) & (py >= 0)
              & (py < self.height) & (v != 0).any(dim=-1))
        sel = torch.nonzero(ok).squeeze(1)
        state.splat.index_put_((py[sel], px[sel]), v[sel], accumulate=True)

    def to_image(self, state: FilmState,
                 splat_scale: float = 1.0) -> np.ndarray:
        """Resolve to an (H, W, 3) image (Film::WriteImage :169-195), the
        splats scaled by ``splat_scale`` added after the weighted
        resolve."""
        rgb = state.rgb.double().cpu().numpy()
        wsum = state.weight.double().cpu().numpy()
        img = rgb / np.where(wsum > 0, wsum, 1.0)[..., None]
        if state.splat is not None:
            img = img + splat_scale * state.splat.double().cpu().numpy()
        img = img * self.scale
        return np.maximum(img, 0.0).astype(np.float32)


def make_film(ps: ParamSet, filt: Filter, quick: bool = False,
              crop_override=None) -> Film:
    """MakeFilm (api.cpp :860-869 -> film.cpp CreateFilm) defaults."""
    xres = ps.find_one_int("xresolution", 1280)
    yres = ps.find_one_int("yresolution", 720)
    if quick:
        xres = max(1, xres // 4)
        yres = max(1, yres // 4)
    crop = ps.find_float_array("cropwindow")
    if crop_override is not None:
        crop = np.asarray(crop_override, dtype=np.float64)
    if crop is not None and len(crop) == 4:
        cx0, cx1 = sorted((float(crop[0]), float(crop[1])))
        cy0, cy1 = sorted((float(crop[2]), float(crop[3])))
    else:
        cx0, cx1, cy0, cy1 = 0.0, 1.0, 0.0, 1.0

    # pbrt crop pixel bounds, computed in f32 like film.cpp's ctor
    def _cb(res, c):
        return int(np.ceil(np.float32(res) * np.float32(c)))

    x0 = _cb(xres, cx0)
    x1 = max(x0 + 1, _cb(xres, cx1))
    y0 = _cb(yres, cy0)
    y1 = max(y0 + 1, _cb(yres, cy1))
    return Film(
        full_x=xres, full_y=yres, crop=(x0, x1, y0, y1), filter=filt,
        filename=ps.find_one_string("filename", "pbrt.exr"),
        scale=ps.find_one_float("scale", 1.0),
        max_sample_luminance=ps.find_one_float("maxsampleluminance", np.inf),
    )
