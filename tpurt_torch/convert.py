"""Carry a tpurt render job across to the port.

``scene_from_tpurt(job)`` reads every table of a tpurt ``RenderJob``
(geometry, lights, materials, camera, Halton sampler, film, integrator
config) with ``np.asarray`` and returns the host-table dict that
``tpurt_torch.render.driver.host_tables`` builds from a scene description,
so tests can feed both packages identical state and compare the two
builds bit for bit.  Upload it with ``driver.job_from_tables``.

This module never imports jax: it only reads attributes of the job it is
handed.
"""

from __future__ import annotations

import numpy as np

from tpurt_torch.render.film import Film
from tpurt_torch.render.filters import Filter
from tpurt_torch.render.integrator import IntegratorConfig


def scene_from_tpurt(job) -> dict:
    """Host tables of a tpurt RenderJob for the path slice."""
    cfg = job.cfg
    if cfg.name != "path" or cfg.spectral:
        raise NotImplementedError(f'tpurt job integrator "{cfg.name}"')
    g = job.scene.geo
    if (g.accel != "bvh" or g.n_curves or g.wnodes_delta is not None
            or g.quad_trs is not None):
        raise NotImplementedError("tpurt geometry outside the path slice")
    lt = job.scene.lights
    if lt.has_infinite or lt.has_lightmaps:
        raise NotImplementedError("tpurt lights outside the path slice")
    cam = job.camera
    if cam.kind != "perspective" or cam.animated:
        raise NotImplementedError(f'tpurt camera "{cam.kind}"')
    s = job.sampler
    if s.name != "halton" or s.scramble != "affine":
        raise NotImplementedError("tpurt sampler outside the path slice")
    f = job.film
    if f.filter.name != "box":
        raise NotImplementedError(f'tpurt filter "{f.filter.name}"')
    a = np.asarray
    return dict(
        geo=dict(wnodes=a(g.wnodes), shade_rows=a(g.shade_rows),
                 prim_type=a(g.prim_type), quad_id=a(g.quad_id),
                 quad_w2o=a(g.quad_w2o), quad_params=a(g.quad_params),
                 n_tris=int(g.n_tris), n_quads=int(g.n_quads),
                 wstack_depth=int(g.wstack_depth)),
        lights=dict(rows=a(lt.rows), prim_to_light=a(lt.prim_to_light),
                    power_pmf=a(lt.power_pmf), power_cdf=a(lt.power_cdf),
                    spat_cdf=a(lt.spat_cdf), spat_pmf=a(lt.spat_pmf),
                    spat_lo=a(lt.spat_lo),
                    spat_inv_extent=a(lt.spat_inv_extent),
                    spat_res=int(lt.spat_res), n_lights=int(lt.n_lights)),
        mt_table=a(job.scene.mt_table),
        camera=dict(camera_to_world=a(cam.camera_to_world),
                    raster_to_camera=a(cam.raster_to_camera),
                    lens_radius=cam.lens_radius,
                    focal_distance=cam.focal_distance,
                    shutter_open=cam.shutter_open,
                    shutter_close=cam.shutter_close,
                    res_x=cam.res_x, res_y=cam.res_y),
        sampler=dict(spp=int(s.spp), offsets=a(s.offsets).astype(np.int64),
                     stride=int(s.stride), exp_x=int(s.exp_x),
                     scale_y=int(s.scale_y),
                     sample_at_center=bool(s.sample_at_center),
                     max_index=int(s.max_index)),
        film=Film(full_x=f.full_x, full_y=f.full_y, crop=tuple(f.crop),
                  filter=Filter(f.filter.name, tuple(f.filter.radius)),
                  filename=f.filename, scale=f.scale,
                  max_sample_luminance=f.max_sample_luminance),
        cfg=IntegratorConfig(max_depth=cfg.max_depth,
                             rr_threshold=cfg.rr_threshold,
                             light_strategy=cfg.light_strategy,
                             capture_features=cfg.capture_features),
    )
