"""Render driver: SceneDescription -> device tables -> bounce-compacted
wavefront render (port of tpurt/render/driver.py: build_job for the path,
volpath, rpf, directlighting, whitted, ao, bdpt, mlt and sppm integrators
with the media and BSSRDF tables, and the loop of _render_compact,
trace_lanes / trace_chunk, which the sharded render of parallel/mesh.py
also runs a shard at a time; the RPF passes
live in tpurt_torch.rpf, MLT's chains in render/mlt.py, SPPM's iterations
in render/sppm.py).  Scene build and render record tpurt's counters
(``Scene/*``, ``Memory/*``, ``Integrator/Camera rays traced``) in
utils/stats.py's registry, which the CLI prints.  volpath on a scene with
media runs its own bounce step (render/volpath.py), ao one closest hit and
its occlusion rays a chunk, bdpt one call of bdpt_radiance a chunk (no
bounce loop; its t=1 strategies bank film splats, resolved at 1/spp as
tpurt's driver.py:527-530 does); the other integrators render a scene
with media and ignore the media, as tpurt's do.

Scene features outside the ported slices raise NotImplementedError naming
the feature: here for the integrator, film, accelerator and shapes, and
in the module that would build them for samplers, filters,
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

from tpurt_torch.config import WAVEFRONT_SIZE, resolve_device, tpurt_chunk
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render.bdpt import bdpt_radiance
from tpurt_torch.render.camera import (Camera, camera_from_tables,
                                       camera_tables)
from tpurt_torch.render.film import Film, make_film
from tpurt_torch.render.filters import make_filter
from tpurt_torch.render.geometry_build import flatten_geometry
from tpurt_torch.render.integrator import (IntegratorConfig, SceneData,
                                           ao_radiance, path_bounce_init,
                                           path_bounce_step, to_rgb_maybe)
from tpurt_torch.render.volpath import (volpath_bounce_init,
                                        volpath_bounce_step)
from tpurt_torch.render.intersect import DeviceGeometry
from tpurt_torch.render.lights import light_table_from_tables, light_tables
from tpurt_torch.render.materials_build import (MAT_NONE,
                                                build_material_table,
                                                fuse_material_rows,
                                                lobe_slots)
from tpurt_torch.render.bssrdf import stack_tables, tables_to_device
from tpurt_torch.render.fourier import table_to_device
from tpurt_torch.render.texeval import TexEval, make_texture_eval
from tpurt_torch.sampling.samplers import sampler_from_tables, sampler_tables
from tpurt_torch.scene.records import TextureRecord
from tpurt_torch.scene import load_scene  # noqa: F401  (re-exported)
from tpurt_torch.scene.records import MaterialRecord, SceneDescription
from tpurt_torch.utils.stats import BSS_OVERFLOW, STATS, TRACK_STATS

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
    if sd.accelerator_name not in ACCELERATORS:
        raise NotImplementedError(f'Accelerator "{sd.accelerator_name}"')
    for pr in sd.primitives:
        sh = pr.shape
        kind = getattr(sh, "kind", type(sh).__name__)
        if kind not in SHAPES:
            raise NotImplementedError(f'Shape "{kind}"')
        if kind == "trianglemesh" and sh.alpha_texture is not None:
            raise NotImplementedError("alpha textures")


INTEGRATORS = ("path", "volpath", "rpf", "directlighting", "whitted", "ao",
               "bdpt", "mlt", "sppm")
ACCELERATORS = ("bvh", "kdtree")
# the integrators whose film carries splats (Film::AddSplat)
SPLAT_INTEGRATORS = ("bdpt", "mlt")
SHAPES = ("trianglemesh", "sphere", "cylinder", "disk", "cone", "paraboloid",
          "hyperboloid", "curve")


SPECTRA = ("rgb", "sampled")
# the integrators that carry the 60-bin axis end to end under
# --spectrum sampled (pbrt.h:126-130 switches every integrator)
SPECTRAL_INTEGRATORS = ("path", "volpath", "directlighting", "whitted",
                        "bdpt", "mlt", "sppm")


def spectral_mode(name: str, spectrum: str) -> bool:
    """True when ``spectrum`` "sampled" applies to integrator ``name``
    (tpurt's _spectral_mode, driver.py:58-78).  rpf renders in RGB and
    says so, since the reference's SampleData is 3-double RGB
    (custom/sd.h:43); ao is colourless and renders as it is."""
    if spectrum not in SPECTRA:
        raise ValueError(f"spectrum {spectrum!r}: not one of {SPECTRA}")
    if spectrum != "sampled":
        return False
    if name in SPECTRAL_INTEGRATORS:
        return True
    if name != "ao":
        log.warning('spectrum_mode "sampled": integrator "%s" renders in '
                    "RGB mode (sampled spectra cover path/volpath/"
                    "directlighting/whitted/bdpt/mlt/sppm)", name)
    return False


def make_integrator_config(sd: SceneDescription,
                           spectrum: str = "rgb") -> IntegratorConfig:
    """Integrator parameters with the reference defaults (tpurt's
    driver.py:60-129).  tpurt also parses directlighting's "strategy" and
    reads it nowhere; it is not carried here.  ``spectrum`` "sampled"
    sets ``spectral`` on the integrators that carry the bins."""
    ps = sd.integrator_params
    name = sd.integrator_name
    spectral = spectral_mode(name, spectrum)
    if name in ("directlighting", "whitted"):
        return IntegratorConfig(name=name,
                                max_depth=ps.find_one_int("maxdepth", 5),
                                spectral=spectral)
    if name == "ao":
        return IntegratorConfig(
            name=name, ao_samples=ps.find_one_int("nsamples", 64),
            ao_cos_sample=ps.find_one_bool("cossample", True))
    if name == "sppm":
        # the iteration driver is render/sppm.py:render_sppm (tpurt's
        # driver.py:124-128)
        return IntegratorConfig(name=name,
                                max_depth=ps.find_one_int("maxdepth", 5),
                                spectral=spectral)
    if name in ("bdpt", "mlt"):
        # tpurt parses bdpt's lightsamplestrategy and samples by power
        # whatever it says; its mlt config fixes "power" (MLT's own
        # parameters are read by render/mlt.py:render_mlt)
        return IntegratorConfig(
            name=name, max_depth=ps.find_one_int("maxdepth", 5),
            light_strategy=(ps.find_one_string("lightsamplestrategy",
                                               "power")
                            if name == "bdpt" else "power"),
            spectral=spectral)
    cfg = IntegratorConfig(
        name=name, max_depth=ps.find_one_int("maxdepth", 5),
        rr_threshold=ps.find_one_float("rrthreshold", 1.0),
        light_strategy=ps.find_one_string("lightsamplestrategy", "spatial"),
        capture_features=name == "rpf", spectral=spectral)
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


def media_tables(sd: SceneDescription, geo_h, kinds) -> dict:
    """The participating media's host tables (tpurt's build_job,
    driver.py:169-222, :269-291): per medium sigma_t, sigma_s and g, the
    grid media's concatenated density lattices with each one's offset,
    dims, world-to-medium and 1 / max density; the camera's medium, and
    whether a Material "none" prim (``kinds`` of the material table)
    carries a MediumInterface.  A scene without media gets tpurt's
    one-row zero tables."""
    names = list(sd.media)
    n_med = max(len(names), 1)
    if names:
        sig_t = np.stack([sd.media[n].sigma_a + sd.media[n].sigma_s
                          for n in names]).astype(np.float32)
        sig_s = np.stack([sd.media[n].sigma_s
                          for n in names]).astype(np.float32)
        g = np.asarray([sd.media[n].g for n in names], np.float32)
    else:
        sig_t = np.zeros((1, 3), np.float32)
        sig_s = np.zeros((1, 3), np.float32)
        g = np.zeros(1, np.float32)
    grid_off = np.zeros(n_med, np.int32)
    grid_dims = np.ones((n_med, 3), np.int32)
    w2m = np.tile(np.eye(4, dtype=np.float32), (n_med, 1, 1))
    inv_maxd = np.ones(n_med, np.float32)
    is_grid = np.zeros(n_med, bool)
    parts, off = [], 0
    for i, name in enumerate(names):
        rec = sd.media[name]
        if rec.density is None:
            continue
        nz, ny, nx = rec.density.shape
        grid_off[i] = off
        grid_dims[i] = (nx, ny, nz)
        w2m[i] = rec.world_to_medium
        inv_maxd[i] = 1.0 / max(float(rec.density.max()), 1e-20)
        is_grid[i] = True
        parts.append(rec.density.ravel())
        off += rec.density.size
    mat = geo_h.material_id
    null = (mat >= 0) & (np.asarray(kinds)[np.clip(mat, 0, len(kinds) - 1)]
                         == MAT_NONE)
    return dict(
        sigma_t=sig_t, sigma_s=sig_s, g=g,
        camera_medium=(names.index(sd.camera_medium)
                       if sd.camera_medium in names else -1),
        has_media=bool(names),
        density=(np.concatenate(parts).astype(np.float32) if parts
                 else np.zeros(1, np.float32)),
        grid_off=grid_off, grid_dims=grid_dims, w2m=w2m, inv_maxd=inv_maxd,
        is_grid=is_grid, has_grid_media=bool(is_grid.any()),
        has_null_boundaries=bool((null & ((geo_h.medium_inside >= 0)
                                          | (geo_h.medium_outside >= 0)))
                                 .any()))


def host_tables(sd: SceneDescription, quick: bool = False,
                crop_override=None, spectrum: str = "rgb",
                device="cuda") -> dict:
    """All host-side tables of a render job (numpy arrays and Python
    values), before upload.  tpurt_torch.convert builds the same dict from
    a tpurt RenderJob.  ``device`` is where the realistic camera traces
    its exit pupil: the job's."""
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

    media_names = list(sd.media)

    def medium_index(name: str) -> int:
        return media_names.index(name) if name in media_names else -1

    t0 = time.time()
    geo_h = flatten_geometry(
        sd.primitives, mat_index, arealight_index,
        max_prims_per_leaf=(sd.accelerator_params.find_one_int(
            "maxnodeprims", 4) if sd.accelerator_params else 4),
        medium_index=medium_index)
    geo = DeviceGeometry.host_tables(geo_h, accel=sd.accelerator_name,
                                     accel_params=sd.accelerator_params)
    # tpurt's counters at build (driver.py:181-187)
    STATS.phase_times["Scene flatten + BVH build"] += time.time() - t0
    STATS.counter("Scene/Primitives", geo_h.n_prims)
    STATS.counter("Scene/BVH nodes", geo_h.bvh.n_nodes)
    STATS.counter("Scene/Triangles", geo_h.n_tris)
    STATS.counter("Scene/Quadrics", geo_h.n_quads)
    STATS.memory_counter("Memory/BVH tree", geo_h.bvh.n_nodes * 64)
    STATS.memory_counter("Memory/Primitive tables", geo_h.n_prims * 64)
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
    cfg = make_integrator_config(sd, spectrum)
    if cfg.spectral and mt.has_bssrdf:
        # tpurt's driver.py:305-310: its BSSRDF is 3-channel
        log.warning('spectrum_mode "sampled": scene uses BSSRDF '
                    "materials; rendering in RGB mode")
        cfg = dataclasses.replace(cfg, spectral=False)
    return dict(
        geo=geo, lights=lights,
        media=media_tables(sd, geo_h, mt.kinds),
        mt_table=fuse_material_rows(mt),
        fourier=dict(tables=mt.fourier_tables, etas=mt.fourier_etas),
        bss=(dict(mt_bss=mt.bss, mt_bss_tix=mt.bss_tix,
                  **stack_tables(mt.bss_tables)) if mt.has_bssrdf else None),
        materials=dict(records=records, textured=mt.textured,
                       has_bump=has_bump(records),
                       has_texfilter=any_imagemap(records)),
        camera=camera_tables(sd.camera_name, sd.camera_params,
                             sd.camera_to_world, film.full_x, film.full_y,
                             camera_to_world_end=sd.camera_to_world_end,
                             transform_times=sd.transform_times,
                             diagonal_m=sd.film_params.find_one_float(
                                 "diagonal", 35.0) * 0.001,
                             device=device),
        sampler=sampler_tables(sd.sampler_name, sd.sampler_params,
                               film.full_x, film.full_y, quick=quick,
                               sample_bounds=film.sample_bounds()),
        film=film, cfg=cfg)


def job_from_tables(tab: dict, device) -> RenderJob:
    """Upload host tables to ``device``."""
    mats = tab["materials"]
    med = tab["media"]
    media = {}
    if med["has_media"]:
        media = {f"med_{k}": torch.tensor(med[k], device=device)
                 for k in ("sigma_t", "sigma_s", "g", "density", "grid_off",
                           "grid_dims", "w2m", "inv_maxd", "is_grid")}
        media.update({k: med[k] for k in (
            "camera_medium", "has_media", "has_grid_media",
            "has_null_boundaries")})
    fr = tab["fourier"]
    bss = {}
    if tab["bss"] is not None:
        bss = dict(mt_bss=torch.tensor(tab["bss"]["mt_bss"], device=device),
                   mt_bss_tix=torch.tensor(tab["bss"]["mt_bss_tix"],
                                           device=device),
                   bss=tables_to_device(tab["bss"], device))
    scene = SceneData(
        geo=DeviceGeometry.from_tables(tab["geo"], device),
        lights=light_table_from_tables(tab["lights"], device),
        mt_table=torch.tensor(tab["mt_table"], device=device),
        has_bump=mats["has_bump"], has_texfilter=mats["has_texfilter"],
        lobe_slots=lobe_slots(tab["mt_table"]),
        fr_tables=tuple(table_to_device(t, device) for t in fr["tables"]),
        fr_etas=tuple(fr["etas"]), **media, **bss)
    texture_eval = make_texture_eval(mats["records"], mats["textured"],
                                     scene.mt_table)
    scene.has_ptex = texture_eval is not None and texture_eval.has_ptex
    return RenderJob(scene=scene, camera=camera_from_tables(tab["camera"],
                                                            device),
                     sampler=sampler_from_tables(tab["sampler"], device),
                     film=tab["film"], cfg=tab["cfg"],
                     texture_eval=texture_eval)


def build_job(sd: SceneDescription, device, quick: bool = False,
              crop_override=None, spectrum: str = "rgb") -> RenderJob:
    device = resolve_device(device)
    return job_from_tables(host_tables(sd, quick, crop_override, spectrum,
                                       device), device)


def trace_lanes(job: RenderJob, cfg: IntegratorConfig, traverse, bank
                ) -> None:
    """Run every (pixel, sample) lane of the film through the bounce loop.

    Lanes are numbered in pixel-major order (lane = pixel * spp + sample,
    pixels row-major over the crop) and run in chunks of WAVEFRONT_SIZE
    (trace_chunk).  ``bank(st, sel)`` receives each batch of finished
    lanes: the lanes of ``st`` where the boolean mask ``sel`` is set, or
    all of them when ``sel`` is None; bdpt's batches also carry their
    splats (``splat_p``, ``splat_L``)."""
    film = job.film
    dev = job.scene.geo.device
    total = film.width * film.height * job.sampler.spp
    chunk = min(total, WAVEFRONT_SIZE)
    for start in range(0, total, chunk):
        ids = torch.arange(start, min(start + chunk, total), device=dev)
        # the media hash reads each lane's place in tpurt's chunk
        trace_chunk(job, cfg, traverse, bank, ids,
                    track_lane=ids % tpurt_chunk(total),
                    track_chunk=tpurt_chunk(total),
                    texture_eval=job.texture_eval)


def trace_chunk(job: RenderJob, cfg: IntegratorConfig, traverse, bank,
                ids, track_lane, track_chunk: int, texture_eval) -> None:
    """Run the lanes numbered ``ids`` (trace_lanes' numbering) through the
    bounce loop.  Between bounces the alive lanes are kept with a boolean
    index; the state carries each lane's number as ``st["lane"]``, so
    finished lanes can be put back in order.  ``track_lane`` (and bdpt's
    ``track_chunk``): each lane's number in the media's tracking hash;
    ``texture_eval``: the textures' evaluator, or None to shade the
    material table's constants."""
    film = job.film
    spp = job.sampler.spp
    x0, _, y0, _ = film.crop
    pid = ids // spp
    sidx = ids % spp
    px = x0 + pid % film.width
    py = y0 + pid // film.width
    if cfg.name == "ao":
        bank(ao_radiance(job.scene, job.sampler, job.camera, px, py, sidx,
                         cfg, traverse, crop_xy=(x0, y0)), None)
        return
    if cfg.name == "bdpt":
        bank(bdpt_radiance(job.scene, job.sampler, job.camera, px, py, sidx,
                           cfg, traverse, crop_xy=(x0, y0),
                           texture_eval=texture_eval, track_lane=track_lane,
                           track_chunk=track_chunk), None)
        return
    # volpath runs its own step on a scene with media; without media it
    # is the path integrator, as in tpurt (integrator.py:1495-1497)
    volumetric = cfg.name == "volpath" and job.scene.has_media
    init, step = ((volpath_bounce_init, volpath_bounce_step) if volumetric
                  else (path_bounce_init, path_bounce_step))
    extra = dict(track_lane=track_lane) if volumetric else {}
    st = init(job.scene, job.sampler, job.camera, px, py, sidx, cfg,
              traverse, crop_xy=(x0, y0), **extra)
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
            st = {k: None if v is None else v[alive] for k, v in st.items()}
        st = step(job.scene, job.sampler, cfg, st, bounce, traverse,
                  camera=job.camera, texture_eval=texture_eval)
    bank(st, None)


def report_loop_counters(scene: SceneData) -> None:
    """Read the bounded loops' counters of a frame (utils/stats.py's
    TRACK_STATS: the media loops', the subsurface probe chain's) once,
    and log them; the probe chain's overflow count goes into STATS under
    tpurt's name, as tpurt's _report_budget_overflow puts it
    (integrator.py:1279-1297)."""
    if not (scene.has_media or scene.has_bssrdf):
        return
    for name, count in TRACK_STATS.read().items():
        if count and "exhausted" in name:
            log.warning("%s: %d lanes", name, count)
        else:
            log.info("%s: %d", name, count)
        if name == BSS_OVERFLOW and count:
            STATS.counter(name, count)


def render_job(job: RenderJob, traverse=None) -> np.ndarray:
    """Render a built job; returns the (H, W, 3) float32 image.  traverse
    defaults to the kernel wrapper (kernels.traverse.traverse_wide)."""
    film = job.film
    if job.cfg.name in ("mlt", "sppm"):
        raise ValueError(f'Integrator "{job.cfg.name}" renders through '
                         f"render/{job.cfg.name}.py:render_{job.cfg.name}"
                         "_job")
    state = film.initial_state(job.scene.geo.device,
                               splats=job.cfg.name in SPLAT_INTEGRATORS)

    def bank(st, sel):
        pick = (lambda v: v) if sel is None else (lambda v: v[sel])
        # spectral radiance becomes RGB before the film (tpurt's
        # driver.py:575-620)
        film.add_samples(state, pick(st["p_film_crop"]),
                         to_rgb_maybe(pick(st["L"])), pick(st["ray_w"]))
        if "splat_p" in st:
            film.add_splats(state, st["splat_p"], st["splat_L"])

    TRACK_STATS.reset()
    t0 = time.time()
    trace_lanes(job, job.cfg, traverse or traverse_wide, bank)
    STATS.counter("Integrator/Camera rays traced",
                  film.width * film.height * job.sampler.spp)
    STATS.phase_times["Render (trace + film)"] += time.time() - t0
    report_loop_counters(job.scene)
    # bdpt's splats are averaged over the samples at resolve time
    # (bdpt.cpp Render: WriteImage(1 / samplesPerPixel))
    return film.to_image(state, splat_scale=(
        1.0 / job.sampler.spp if job.cfg.name in SPLAT_INTEGRATORS
        else 1.0))


def render(sd: SceneDescription, device="cuda", quick: bool = False,
           crop_override=None, traverse=None, spectrum: str = "rgb"):
    """Render a scene description on ``device``; returns (image, job).
    Writes no files (the CLI writes the image).  ``Integrator "mlt"``
    renders through render/mlt.py:render_mlt, ``"sppm"`` through
    render/sppm.py:render_sppm (tpurt's driver.py:455-463).  ``spectrum``
    "sampled" renders with 60-bin spectra (spectral_mode)."""
    if sd.integrator_name == "mlt":
        from tpurt_torch.render.mlt import render_mlt

        return render_mlt(sd, device, quick=quick,
                          crop_override=crop_override, traverse=traverse,
                          spectrum=spectrum)
    if sd.integrator_name == "sppm":
        from tpurt_torch.render.sppm import render_sppm

        return render_sppm(sd, device, quick=quick,
                           crop_override=crop_override, traverse=traverse,
                           spectrum=spectrum)
    job = build_job(sd, device, quick=quick, crop_override=crop_override,
                    spectrum=spectrum)
    t0 = time.time()
    img = render_job(job, traverse)
    log.info("render complete: %.2fs", time.time() - t0)
    return img, job
