"""Render driver: SceneDescription -> device tables -> bounce-compacted
wavefront render (port of tpurt/render/driver.py: build_job for the path,
rpf, directlighting and whitted integrators, and the loop of
_render_compact; the RPF passes live in tpurt_torch.rpf).

Scene features outside the ported slices raise NotImplementedError naming
the feature: here for the integrator, film, accelerator, media and
shapes, and in the module that would build them for samplers, filters,
lights, cameras, materials and textures.  Between bounces the loop
keeps the alive lanes with a boolean index and banks the terminated ones
into the film, so terminated paths cost nothing in later bounces (tpurt's
power-of-two buckets, lax.scan twin and trace caches are XLA machinery
with no counterpart here).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tpurt_torch.config import WAVEFRONT_SIZE, resolve_device
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render.camera import (Camera, camera_from_tables,
                                       camera_tables)
from tpurt_torch.render.film import Film, make_film
from tpurt_torch.render.filters import make_filter
from tpurt_torch.render.geometry_build import flatten_geometry
from tpurt_torch.render.integrator import (IntegratorConfig, SceneData,
                                           path_bounce_init,
                                           path_bounce_step)
from tpurt_torch.render.intersect import DeviceGeometry
from tpurt_torch.render.lights import light_table_from_tables, light_tables
from tpurt_torch.render.materials_build import (build_material_table,
                                                fuse_material_rows,
                                                lobe_slots)
from tpurt_torch.render.texeval import TexEval, make_texture_eval
from tpurt_torch.sampling.samplers import sampler_from_tables, sampler_tables
from tpurt_torch.scene.records import TextureRecord
from tpurt_torch.scene import load_scene  # noqa: F401  (re-exported)
from tpurt_torch.scene.records import MaterialRecord, SceneDescription

log = logging.getLogger("tpurt_torch.render")


@dataclasses.dataclass
class RenderJob:
    scene: SceneData
    camera: Camera
    sampler: Any  # a sampler of tpurt_torch.sampling.samplers
    film: Film
    cfg: IntegratorConfig
    texture_eval: Optional[TexEval] = None


class MaterialIndexer:
    """Deduplicates MaterialRecords during scene flattening."""

    def __init__(self):
        self.materials: List[Optional[MaterialRecord]] = []
        self._ids: Dict[int, int] = {}

    def __call__(self, rec: Optional[MaterialRecord]) -> int:
        key = -1 if rec is None else id(rec)
        if key not in self._ids:
            self._ids[key] = len(self.materials)
            self.materials.append(rec)
        return self._ids[key]


def _check_slice(sd: SceneDescription) -> None:
    """Raise NotImplementedError for scene features outside the slice."""
    if sd.integrator_name not in INTEGRATORS:
        raise NotImplementedError(f'Integrator "{sd.integrator_name}"')
    if sd.film_name != "image":
        raise NotImplementedError(f'Film "{sd.film_name}"')
    if sd.accelerator_name != "bvh":
        raise NotImplementedError(f'Accelerator "{sd.accelerator_name}"')
    if sd.media or sd.camera_medium:
        raise NotImplementedError("participating media")
    for pr in sd.primitives:
        sh = pr.shape
        kind = getattr(sh, "kind", type(sh).__name__)
        if kind not in SHAPES:
            raise NotImplementedError(f'Shape "{kind}"')
        if kind == "trianglemesh" and sh.alpha_texture is not None:
            raise NotImplementedError("alpha textures")
        if pr.medium_inside or pr.medium_outside:
            raise NotImplementedError("MediumInterface (participating media)")


INTEGRATORS = ("path", "rpf", "directlighting", "whitted")
SHAPES = ("trianglemesh", "sphere", "cylinder", "disk", "cone", "paraboloid",
          "hyperboloid", "curve")


def make_integrator_config(sd: SceneDescription) -> IntegratorConfig:
    """Integrator parameters with the reference defaults.  tpurt also
    parses directlighting's "strategy" and reads it nowhere; it is not
    carried here."""
    ps = sd.integrator_params
    name = sd.integrator_name
    if name in ("directlighting", "whitted"):
        return IntegratorConfig(specular_only=True,
                                max_depth=ps.find_one_int("maxdepth", 5))
    cfg = IntegratorConfig(
        max_depth=ps.find_one_int("maxdepth", 5),
        rr_threshold=ps.find_one_float("rrthreshold", 1.0),
        light_strategy=ps.find_one_string("lightsamplestrategy", "spatial"),
        capture_features=name == "rpf")
    if cfg.light_strategy not in ("spatial", "power", "uniform"):
        raise NotImplementedError(
            f'lightsamplestrategy "{cfg.light_strategy}"')
    return cfg


def any_imagemap(records) -> bool:
    """True when any material's texture DAG contains an imagemap (then
    interactions carry MIP filter widths)."""

    def walk(v):
        if isinstance(v, TextureRecord):
            return v.name == "imagemap" or any(walk(x)
                                               for x in v.params.values())
        return isinstance(v, tuple) and len(v) == 2 and walk(v[1])

    return any(r is not None and any(walk(s) for s in r.slots.values())
               for r in records)


def has_bump(records) -> bool:
    return any(r is not None and isinstance(r.slots.get("bumpmap"), tuple)
               and r.slots["bumpmap"][0] == "texture" for r in records)


def host_tables(sd: SceneDescription, quick: bool = False,
                crop_override=None) -> dict:
    """All host-side tables of a render job (numpy arrays and Python
    values), before upload.  tpurt_torch.convert builds the same dict from
    a tpurt RenderJob."""
    _check_slice(sd)
    mat_index = MaterialIndexer()
    area_records = []

    def arealight_index(prim, _):
        if prim.area_light is None:
            return -1
        key = id(prim.area_light)
        for i, (k, _r) in enumerate(area_records):
            if k == key:
                return i
        area_records.append((key, prim.area_light))
        return len(area_records) - 1

    t0 = time.time()
    geo_h = flatten_geometry(
        sd.primitives, mat_index, arealight_index,
        max_prims_per_leaf=(sd.accelerator_params.find_one_int(
            "maxnodeprims", 4) if sd.accelerator_params else 4))
    geo = DeviceGeometry.host_tables(geo_h)
    log.info("scene flatten + BVH build: %.2fs (%d prims, %d wide rows)",
             time.time() - t0, geo_h.n_prims, geo["wnodes"].shape[0])
    mt = build_material_table(mat_index.materials)
    # the texture evaluator reads only the records that hold a texture
    records = [r if r is not None and any(
        isinstance(v, tuple) and v[0] == "texture" for v in r.slots.values())
        else None for r in mt.records]
    lights = light_tables(sd.lights, geo_h,
                          [(r.L, r.scale, r.two_sided)
                           for _k, r in area_records])

    filt = make_filter(sd.filter_name, sd.filter_params)
    film = make_film(sd.film_params, filt, quick=quick,
                     crop_override=crop_override)
    return dict(
        geo=geo, lights=lights,
        mt_table=fuse_material_rows(mt),
        materials=dict(records=records, textured=mt.textured,
                       has_bump=has_bump(records),
                       has_texfilter=any_imagemap(records)),
        camera=camera_tables(sd.camera_name, sd.camera_params,
                             sd.camera_to_world, film.full_x, film.full_y,
                             camera_to_world_end=sd.camera_to_world_end,
                             transform_times=sd.transform_times),
        sampler=sampler_tables(sd.sampler_name, sd.sampler_params,
                               film.full_x, film.full_y, quick=quick,
                               sample_bounds=film.sample_bounds()),
        film=film, cfg=make_integrator_config(sd))


def job_from_tables(tab: dict, device) -> RenderJob:
    """Upload host tables to ``device``."""
    mats = tab["materials"]
    scene = SceneData(
        geo=DeviceGeometry.from_tables(tab["geo"], device),
        lights=light_table_from_tables(tab["lights"], device),
        mt_table=torch.tensor(tab["mt_table"], device=device),
        has_bump=mats["has_bump"], has_texfilter=mats["has_texfilter"],
        lobe_slots=lobe_slots(tab["mt_table"]))
    return RenderJob(scene=scene, camera=camera_from_tables(tab["camera"],
                                                            device),
                     sampler=sampler_from_tables(tab["sampler"], device),
                     film=tab["film"], cfg=tab["cfg"],
                     texture_eval=make_texture_eval(
                         mats["records"], mats["textured"], scene.mt_table))


def build_job(sd: SceneDescription, device, quick: bool = False,
              crop_override=None) -> RenderJob:
    return job_from_tables(host_tables(sd, quick, crop_override),
                           resolve_device(device))


def trace_lanes(job: RenderJob, cfg: IntegratorConfig, traverse, bank
                ) -> None:
    """Run every (pixel, sample) lane of the film through the bounce loop.

    Lanes are numbered in pixel-major order (lane = pixel * spp + sample,
    pixels row-major over the crop) and run in chunks of WAVEFRONT_SIZE.
    Between bounces the alive lanes are kept with a boolean index; the
    state carries each lane's number as ``st["lane"]``, so finished lanes
    can be put back in order.  ``bank(st, sel)`` receives each batch of
    finished lanes: the lanes of ``st`` where the boolean mask ``sel`` is
    set, or all of them when ``sel`` is None."""
    film = job.film
    dev = job.scene.geo.device
    spp = job.sampler.spp
    x0, _, y0, _ = film.crop
    w = film.width
    total = film.width * film.height * spp
    chunk = min(total, WAVEFRONT_SIZE)
    for start in range(0, total, chunk):
        ids = torch.arange(start, min(start + chunk, total), device=dev)
        pid = ids // spp
        sidx = ids % spp
        px = x0 + pid % w
        py = y0 + pid // w
        st = path_bounce_init(job.scene, job.sampler, job.camera, px, py,
                              sidx, cfg, traverse, crop_xy=(x0, y0))
        st["lane"] = ids
        for bounce in range(cfg.max_depth + 1):
            alive = st["alive"]
            n_alive = int(alive.sum())
            if n_alive == 0:
                break
            if n_alive < alive.shape[0]:
                # bank the terminated lanes, keep the alive ones
                bank(st, ~alive)
                # (a sampler without a lane context carries None)
                st = {k: None if v is None else v[alive]
                      for k, v in st.items()}
            st = path_bounce_step(job.scene, job.sampler, cfg, st, bounce,
                                  traverse, camera=job.camera,
                                  texture_eval=job.texture_eval)
        bank(st, None)


def render_job(job: RenderJob, traverse=None) -> np.ndarray:
    """Render a built job; returns the (H, W, 3) float32 image.  traverse
    defaults to the kernel wrapper (kernels.traverse.traverse_wide)."""
    film = job.film
    state = film.initial_state(job.scene.geo.device)

    def bank(st, sel):
        pick = (lambda v: v) if sel is None else (lambda v: v[sel])
        film.add_samples(state, pick(st["p_film_crop"]), pick(st["L"]),
                         pick(st["ray_w"]))

    trace_lanes(job, job.cfg, traverse or traverse_wide, bank)
    return film.to_image(state)


def render(sd: SceneDescription, device="cuda", quick: bool = False,
           crop_override=None, traverse=None):
    """Render a scene description on ``device``; returns (image, job).
    Writes no files (the CLI writes the image)."""
    job = build_job(sd, device, quick=quick, crop_override=crop_override)
    t0 = time.time()
    img = render_job(job, traverse)
    log.info("render complete: %.2fs", time.time() - t0)
    return img, job
