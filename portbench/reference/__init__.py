"""The plain reference of portbench: an RPF frame's value at chosen pixels,
worked out from the scene file alone, in plain PyTorch and numpy.

It imports nothing of the program (``tpurt_torch``) and takes nothing the
program made: ``pbrt.py`` reads the scene file, ``sampler.py`` draws the
sampler's streams, ``geometry.py`` answers the ray queries, ``path.py``
traces every sample of the chosen pixels' boxes with its RPF features,
and ``rpf.py`` filters each chosen pixel.  A pixel of an RPF frame depends
only on the samples of its box, so the reference traces those alone.

``judge(scene_path, pixels, box, device, controls)`` returns, for the
pixels (K, 2) as (y, x):
- "value" (K, 3): the frame's value, its samples traced and filtered in
  float32;
- "unfiltered" (K, 3): the mean of the pixel's own samples before the
  filter, which tells where the filter acts;
- for each control, its values (K, 3): "bf16", the filter computed in
  bfloat16 from a sample buffer held in bfloat16 (the precision below
  the configuration's float32).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import geometry, path, pbrt, rpf, sampler

CONTROLS = ("bf16",)
PIXEL_BATCH = 64


def _filter(rows, where, valid, centre, box, spp, dtype):
    """Filtered values of the pixels whose boxes' rows in ``rows`` are
    ``where`` (K, box^2) with ``valid`` (K, box^2)."""
    dev = rows.device
    centre_rows = torch.zeros(where.shape[1], dtype=torch.bool, device=dev)
    centre_rows[centre] = True
    centre_rows = centre_rows.repeat_interleave(spp)
    out = []
    for a in range(0, where.shape[0], PIXEL_BATCH):
        w = where[a:a + PIXEL_BATCH]
        window = rows[w].reshape(w.shape[0], -1, 19)
        ok = valid[a:a + PIXEL_BATCH].repeat_interleave(spp, dim=1)
        window = torch.where(ok[..., None], window, 0.0)
        own = rows[w[:, centre]]
        out.append(rpf.filter_pixels(own, window, ok, centre_rows, box,
                                     dtype))
    return torch.cat(out)


def judge(scene_path: str, pixels, box: int, device, controls=()) -> dict:
    for c in controls:
        if c not in CONTROLS:
            raise ValueError(f"control {c!r}")
    sc = pbrt.read_scene(scene_path)
    if sc.integrator != "rpf":
        raise ValueError(f"Integrator {sc.integrator!r}: the reference "
                         "renders rpf frames")
    rx, ry = sc.res
    spp = sc.spp
    pixels = np.asarray(pixels, np.int64).reshape(-1, 2)
    offs, centre = rpf.box_offsets(box)
    offs = np.asarray(offs, np.int64)
    win = pixels[:, None, :] + offs[None]  # (K, box^2, 2)
    inside = ((win[..., 0] >= 0) & (win[..., 0] < ry)
              & (win[..., 1] >= 0) & (win[..., 1] < rx))
    flat = np.where(inside, win[..., 0] * rx + win[..., 1], -1)
    need = np.unique(flat[flat >= 0])  # pixel numbers to trace
    slot = np.full(rx * ry, -1, np.int64)
    slot[need] = np.arange(len(need))
    lanes = (np.repeat(need % rx, spp), np.repeat(need // rx, spp),
             np.tile(np.arange(spp), len(need)))
    with torch.no_grad():
        geom = geometry.Geometry(sc, device)
        tracer = path.Tracer(sc, geom, sampler.make(sc.sampler, rx, ry))
        rows = tracer.trace(lanes).reshape(len(need), spp, 19)
        del geom, tracer
        where = torch.tensor(np.where(flat >= 0, slot[np.maximum(flat, 0)],
                                      0), device=device)
        valid = torch.tensor(inside, device=device)
        out = dict(
            value=_filter(rows, where, valid, centre, box, spp,
                          torch.float32).cpu().numpy(),
            unfiltered=rows[where[:, centre], :, rpf.COL].mean(1)
            .cpu().numpy())
        for c in controls:
            out[c] = _filter(rows, where, valid, centre, box, spp,
                             torch.bfloat16).cpu().numpy()
    return out
