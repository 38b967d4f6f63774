"""RPF render driver: sampling pass -> feature buffers -> joint bilateral
filter -> film splat (port of tpurt/rpf/driver.py).

Reference analog: custom/rpf.cpp Render (:737-805): FillSampleFilm ->
visualizeSF feature dumps -> ApplyRPFFilter per box size ({7}) -> splat
all filtered samples through the film filter -> WriteImage.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Sequence

import numpy as np
import torch

from tpurt_torch.config import resolve_device
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render.driver import (RenderJob, build_job,
                                       report_loop_counters, trace_lanes)
from tpurt_torch.render.film import FilmState
from tpurt_torch.rpf.filter import (COL, SD_LEN, SIGMA_FC_SEED,
                                    apply_rpf_filter)
from tpurt_torch.utils.stats import TRACK_STATS

log = logging.getLogger("tpurt_torch.rpf")

DEFAULT_BOX_SIZES = (7,)  # rpf.cpp:767 (multi-scale list commented out there)


def sampling_config(job: RenderJob):
    """The sampling pass's integrator configuration: the job's with
    feature capture on.  rpf.cpp Li passes a null light distribution to
    UniformSampleOneLight -> uniform light choice."""
    return dataclasses.replace(job.cfg, capture_features=True,
                               light_strategy="uniform")


def fill_sample_buffer(job: RenderJob):
    """FillSampleFilm analog: path-trace every (pixel, sample) lane with
    feature capture into the (H, W, S, 19) sample buffer on the job's
    device.  Finished lanes are written to their pixel-major rows by the
    lane numbers the driver carries through compaction."""
    film = job.film
    spp = job.sampler.spp
    h, w = film.height, film.width
    cfg = sampling_config(job)
    buf = torch.zeros((h * w * spp, SD_LEN), dtype=torch.float32,
                      device=job.scene.geo.device)

    def bank(st, sel):
        # SampleData layout (sd.h:40-59)
        rows = torch.cat([st["p_film_crop"],  # 0:2 crop-space raster coords
                          st["L"],  # 2:5
                          st["p_lens"],  # 5:7
                          st["n0"], st["p0"], st["n1"], st["p1"]],  # 7:19
                         dim=-1)
        lanes = st["lane"]
        if sel is not None:
            rows, lanes = rows[sel], lanes[sel]
        buf[lanes] = rows

    TRACK_STATS.reset()
    trace_lanes(job, cfg, traverse_wide, bank)
    report_loop_counters(job.scene)
    return buf.reshape(h, w, spp, SD_LEN)


# visualizeSF's six dumps: file suffix and the buffer columns averaged
_FEATURE_EXRS = (("I0_Normal", slice(7, 10)), ("I1_Normal", slice(13, 16)),
                 ("I0_Position", slice(10, 13)),
                 ("I1_Position", slice(16, 19)),
                 ("Film_Position", slice(0, 2)),
                 ("Lens_Position", slice(5, 7)))


def feature_exr_paths(filename: str):
    """The six files visualize_sf writes for ``filename``."""
    base = os.path.splitext(filename)[0]
    return [f"{base}_{name}.exr" for name, _ in _FEATURE_EXRS]


def visualize_sf(buffer, filename: str) -> None:
    """visualizeSF analog (rpf.cpp:37-101): write the six averaged,
    max-normalized feature-buffer debug EXRs beside ``filename``."""
    from tpurt_torch.io.exr import write_exr_rgb

    mean = buffer.mean(dim=2).cpu().numpy()  # (H, W, 19)
    for path, (_, cols) in zip(feature_exr_paths(filename), _FEATURE_EXRS):
        img = mean[..., cols]
        if img.shape[-1] == 2:  # film and lens positions: (x, y, 0)
            img = np.concatenate([img, np.zeros_like(img[..., :1])], -1)
        m = np.abs(img).max()
        write_exr_rgb(path, (img / m if m > 0 else img).astype(np.float32))


def splat_buffer(film, buffer) -> np.ndarray:
    """Splat (filtered) samples to the film through the reconstruction
    filter (rpf.cpp:779-794 uses FilmTile::AddSample over the full bounds).

    The buffer is PIXEL-MAJOR: sample (y, x, s) was generated inside pixel
    (y, x), so its filter stamp can only land on pixels within
    R = ceil(r + 0.5) of its own.  The scatter becomes (2R+1)^2 dense
    shifted adds: for each window offset, evaluate the filter at every
    sample, reduce over spp, and add the (H, W, 3) plane into the film at
    that offset, with film.add_samples' tap set (ceil(dx - r) + i), bounds
    drops, NaN/inf scrub and maxsampleluminance clamp.  Dense adds need
    no atomics, so the image is the same on every run.  Returns the
    (H, W, 3) float32 image."""
    h, w, s, _ = buffer.shape
    dev = buffer.device
    rx, ry = film.filter.radius
    kx = max(1, int(np.ceil(2 * rx - 1e-6)))
    ky = max(1, int(np.ceil(2 * ry - 1e-6)))
    Rx = int(np.ceil(rx + 0.5))
    Ry = int(np.ceil(ry + 0.5))

    dx = buffer[..., 0] - 0.5  # (H, W, S) continuous raster coords
    dy = buffer[..., 1] - 0.5
    L = torch.nan_to_num(buffer[..., COL], nan=0.0, posinf=0.0, neginf=0.0)
    if np.isfinite(film.max_sample_luminance):
        y = 0.212671 * L[..., 0] + 0.715160 * L[..., 1] + 0.072169 * L[..., 2]
        sc = torch.where(y > film.max_sample_luminance,
                         torch.full_like(y, film.max_sample_luminance)
                         / torch.clamp(y, min=1e-20), 1.0)
        L = L * sc[..., None]
    finite = torch.isfinite(dx) & torch.isfinite(dy)
    x0 = torch.ceil(torch.where(finite, dx - rx, 0.0)).to(torch.int32)
    y0 = torch.ceil(torch.where(finite, dy - ry, 0.0)).to(torch.int32)
    X = torch.arange(w, dtype=torch.int32, device=dev)[None, :, None]
    Y = torch.arange(h, dtype=torch.int32, device=dev)[:, None, None]
    rgb = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for dj in range(-Ry, Ry + 1):
        for di in range(-Rx, Rx + 1):
            px = X + di
            py = Y + dj
            fw = film.filter.evaluate(px.to(torch.float32) - dx,
                                      py.to(torch.float32) - dy)
            intap = ((px >= x0) & (px < x0 + kx)
                     & (py >= y0) & (py < y0 + ky) & finite)
            fwm = torch.where(intap, fw, 0.0)  # (H, W, S)
            c = (L * fwm[..., None]).sum(dim=2)  # (H, W, 3)
            ws = fwm.sum(dim=2)
            a0, a1 = max(0, dj), h + min(0, dj)
            b0, b1 = max(0, di), w + min(0, di)
            rgb[a0:a1, b0:b1] += c[a0 - dj:a1 - dj, b0 - di:b1 - di]
            wsum[a0:a1, b0:b1] += ws[a0 - dj:a1 - dj, b0 - di:b1 - di]
    return film.to_image(FilmState(rgb=rgb, weight=wsum))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def render_rpf_job(job: RenderJob,
                   box_sizes: Sequence[int] = DEFAULT_BOX_SIZES,
                   write_feature_exrs: bool = True,
                   return_buffers: bool = False,
                   sigma_seed: float = SIGMA_FC_SEED):
    """The RPF pipeline on a built job: sampling pass, the filter at each
    box size, splat.  ``sigma_seed`` is the filter's bilateral sigma seed
    (tpurt's config rpf_sigma_seed, config.py:119, read at
    rpf/filter.py:379-380; rpf.cpp:533's 0.002 by default).  Returns
    (image, extras): the stage times in seconds ("sampling_time",
    "filter_time", "splat_time"), and with return_buffers the raw and
    filtered sample buffers (host numpy)."""
    dev = job.scene.geo.device
    _sync(dev)
    t0 = time.time()
    buffer = fill_sample_buffer(job)
    _sync(dev)
    sampling_time = time.time() - t0
    log.info("sampling pass: %.2fs", sampling_time)

    if write_feature_exrs:
        try:
            visualize_sf(buffer, job.film.filename)
        except OSError as e:
            log.error("feature EXR dump failed: %s", e)

    t0 = time.time()
    buf = buffer
    for box in box_sizes:
        buf = apply_rpf_filter(buf, box, sigma_seed)
        log.info("RPF filter pass (box %d) done", box)
    _sync(dev)
    filter_time = time.time() - t0
    log.info("RPF filter: %.2fs", filter_time)

    t0 = time.time()
    img = splat_buffer(job.film, buf)
    splat_time = time.time() - t0
    extras = {"sampling_time": sampling_time, "filter_time": filter_time,
              "splat_time": splat_time}
    if return_buffers:
        extras["raw_buffer"] = buffer.cpu().numpy()
        extras["filtered_buffer"] = buf.cpu().numpy()
    return img, extras


def render_rpf(sd, device="cuda", quick: bool = False, crop_override=None,
               box_sizes: Sequence[int] = DEFAULT_BOX_SIZES,
               write_feature_exrs: bool = True,
               return_buffers: bool = False,
               sigma_seed: float = SIGMA_FC_SEED):
    """The full RPF pipeline on ``device``; returns (image, job, extras).
    ``sigma_seed``: render_rpf_job's."""
    job = build_job(sd, resolve_device(device), quick=quick,
                    crop_override=crop_override)
    img, extras = render_rpf_job(job, box_sizes, write_feature_exrs,
                                 return_buffers, sigma_seed)
    return img, job, extras
