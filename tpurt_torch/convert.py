"""Carry a tpurt render job across to the port.

``scene_from_tpurt(job)`` reads every table of a tpurt ``RenderJob``
(geometry with its motion deltas, animated quadrics, tangents, curve
tree and kd-tree; lights; the media; materials with their texture records, hair
columns, fourier tables, ``Material "none"`` rows and the subsurface
materials' BSSRDF columns and diffusion tables; the camera,
animated or not, and the realistic camera's lens tables;
sampler, film, integrator config, volpath's and ao's included, and the
sampled-spectrum flag) with
``np.asarray`` and returns the host-table
dict that ``tpurt_torch.render.driver.host_tables`` builds from a scene
description, so tests can feed both packages identical state and compare
the two builds bit for bit.  Upload it with ``driver.job_from_tables``.

This module never imports jax: it only reads attributes of the job it is
handed.
"""

from __future__ import annotations

import numpy as np

from tpurt_torch.geom.transform import Transform
from tpurt_torch.render.driver import INTEGRATORS, any_imagemap, has_bump
from tpurt_torch.render.film import Film
from tpurt_torch.render.filters import Filter
from tpurt_torch.render.integrator import IntegratorConfig
from tpurt_torch.scene.records import MaterialRecord, TextureRecord


def _closure_value(fn, name: str):
    """The free variable ``name`` of the closure ``fn``, or None."""
    code = getattr(fn, "__code__", None)
    if code is None or name not in code.co_freevars:
        return None
    return fn.__closure__[code.co_freevars.index(name)].cell_contents


def _port_slot(v):
    """A tpurt slot value with every TextureRecord rebuilt as the port's."""
    if isinstance(v, tuple) and len(v) == 2 and v[0] in ("constant",
                                                         "texture"):
        return (v[0], _port_slot(v[1]))
    if hasattr(v, "tex_type") and hasattr(v, "params"):
        w2t = v.world_to_texture
        return TextureRecord(
            name=v.name, tex_type=v.tex_type,
            params={k: _port_slot(x) for k, x in v.params.items()},
            world_to_texture=None if w2t is None else Transform(w2t.m,
                                                                w2t.m_inv))
    return v


def _materials(job) -> dict:
    """The material records behind a tpurt job's texture callbacks.  A
    tpurt RenderJob keeps them only in the closures of its ``texture_eval``
    (the slot overrides close over the MaterialTable, the bump pass over
    its (material id, texture) list), so they are read from there."""
    n = int(np.asarray(job.scene.mt_table).shape[0])
    records = [None] * n
    textured = []
    te = job.texture_eval
    mt = _closure_value(getattr(te, "_fn", None), "mt")
    if mt is not None:
        textured = [(int(i), str(slot)) for i, slot in mt.textured]
        for i, rec in enumerate(mt.records[:n]):
            if rec is not None and any(i == j for j, _s in textured):
                records[i] = MaterialRecord(
                    rec.name, {k: _port_slot(v) for k, v in rec.slots.items()})
    for i, rec in _closure_value(getattr(te, "bump", None), "recs") or []:
        if records[i] is None:
            records[i] = MaterialRecord("", {})
        records[i].slots["bumpmap"] = ("texture", _port_slot(rec))
    return dict(records=records, textured=textured,
                has_bump=has_bump(records),
                has_texfilter=any_imagemap(records))


def _sampler(s) -> dict:
    a = np.asarray
    if s.name == "halton":
        return dict(name="halton", spp=int(s.spp),
                    offsets=a(s.offsets).astype(np.int64),
                    stride=int(s.stride), exp_x=int(s.exp_x),
                    scale_y=int(s.scale_y),
                    sample_at_center=bool(s.sample_at_center),
                    max_index=int(s.max_index), scramble=s.scramble,
                    perms=(a(s.perms).astype(np.int64)
                           if s.scramble == "pbrt" else None))
    if s.name == "sobol":
        return dict(name="sobol", spp=int(s.spp), m=int(s.m), mats=a(s.mats),
                    inv_cols=a(s.inv_cols), fmap_cols=a(s.fmap_cols),
                    smin_x=int(s.smin_x), smin_y=int(s.smin_y))
    if s.name == "maxmindist":
        return dict(name="maxmindist", spp=int(s.spp), seed=int(s.seed),
                    res_x=int(s.res_x),
                    cpixel=tuple(int(c) for c in s.cpixel))
    if s.name in ("random", "stratified", "02sequence"):
        return dict(s._asdict())
    raise NotImplementedError(f'tpurt sampler "{s.name}"')


def _config(cfg) -> IntegratorConfig:
    """The port's IntegratorConfig of a tpurt one, with the defaults the
    port's make_integrator_config gives the fields an integrator does not
    read (tpurt keeps its own defaults there)."""
    if cfg.name == "ao":
        return IntegratorConfig(name="ao", ao_samples=cfg.ao_samples,
                                ao_cos_sample=cfg.ao_cos_sample)
    spectral = bool(cfg.spectral)
    if cfg.name in ("directlighting", "whitted"):
        return IntegratorConfig(name=cfg.name, max_depth=cfg.max_depth,
                                spectral=spectral)
    return IntegratorConfig(name=cfg.name, max_depth=cfg.max_depth,
                            rr_threshold=cfg.rr_threshold,
                            light_strategy=cfg.light_strategy,
                            capture_features=cfg.capture_features,
                            spectral=spectral)


def scene_from_tpurt(job) -> dict:
    """Host tables of a tpurt RenderJob for the ported slices."""
    cfg = job.cfg
    if cfg.name not in INTEGRATORS:
        raise NotImplementedError(f'tpurt job integrator "{cfg.name}"')
    g = job.scene.geo
    if g.accel not in ("bvh", "kdtree"):
        raise NotImplementedError("tpurt geometry outside the ported slices")
    lt = job.scene.lights
    cam = job.camera
    if cam.kind not in ("perspective", "orthographic", "environment",
                        "realistic"):
        raise NotImplementedError(f'tpurt camera "{cam.kind}"')
    f = job.film
    a = np.asarray

    def opt(v):
        return None if v is None else a(v)

    geo = dict(wnodes=a(g.wnodes), shade_rows=a(g.shade_rows),
               prim_type=a(g.prim_type), quad_id=a(g.quad_id),
               quad_w2o=a(g.quad_w2o), quad_params=a(g.quad_params),
               n_tris=int(g.n_tris), n_quads=int(g.n_quads),
               wstack_depth=int(g.wstack_depth),
               has_tangents=bool(job.scene.has_tangents),
               wnodes_delta=opt(g.wnodes_delta),
               shade_delta=opt(g.shade_delta), quad_trs=opt(g.quad_trs),
               quad_animated=opt(g.quad_animated), shade_s=opt(g.shade_s))
    if g.n_curves:
        geo.update(n_curves=int(g.n_curves), cnodes=a(g.cnodes),
                   cnodes_aux=opt(g.cnodes_aux),
                   cstack_depth=int(g.cstack_depth))
    if g.accel == "kdtree":
        geo.update(accel="kdtree", knodes=a(g.knodes),
                   knodes_delta=opt(g.knodes_delta), kbounds=a(g.kbounds),
                   kstack_depth=int(g.kstack_depth))
    anim = dict(animated=bool(cam.animated), time0=float(cam.time0),
                time1=float(cam.time1), anim_t=opt(cam.anim_t),
                anim_q=opt(cam.anim_q), anim_s=opt(cam.anim_s))
    if cam.kind == "realistic":
        anim.update(lens_el=tuple(tuple(float(v) for v in row)
                                  for row in cam.lens_el),
                    exit_pupil=a(cam.exit_pupil), rear_z=float(cam.rear_z),
                    diagonal_m=float(cam.diagonal_m),
                    simple_weighting=bool(cam.simple_weighting),
                    epb0_area=float(cam.epb0_area))
    sc = job.scene
    media = dict(sigma_t=a(sc.med_sigma_t), sigma_s=a(sc.med_sigma_s),
                 g=a(sc.med_g), camera_medium=int(sc.camera_medium),
                 has_media=bool(sc.has_media), density=a(sc.med_density),
                 grid_off=a(sc.med_grid_off), grid_dims=a(sc.med_grid_dims),
                 w2m=a(sc.med_w2m), inv_maxd=a(sc.med_inv_maxd),
                 is_grid=a(sc.med_is_grid),
                 has_grid_media=bool(sc.has_grid_media),
                 has_null_boundaries=bool(sc.has_null_boundaries))
    return dict(
        geo={k: v for k, v in geo.items() if v is not None},
        media=media,
        lights=dict(rows=a(lt.rows), prim_to_light=a(lt.prim_to_light),
                    power_pmf=a(lt.power_pmf), power_cdf=a(lt.power_cdf),
                    spat_cdf=a(lt.spat_cdf), spat_pmf=a(lt.spat_pmf),
                    spat_lo=a(lt.spat_lo),
                    spat_inv_extent=a(lt.spat_inv_extent),
                    spat_res=int(lt.spat_res), n_lights=int(lt.n_lights),
                    world_radius=float(lt.world_radius),
                    world_center=a(lt.world_center),
                    env_map=a(lt.env_map), env_cond_cdf=a(lt.env_cond_cdf),
                    env_cond_int=a(lt.env_cond_int),
                    env_marg_cdf=a(lt.env_marg_cdf), env_w2l=a(lt.env_w2l),
                    env_l2w=a(lt.env_l2w), img_pool=a(lt.img_pool),
                    img_off=a(lt.img_off), img_wh=a(lt.img_wh),
                    w2l=a(lt.w2l), proj=a(lt.proj),
                    has_infinite=bool(lt.has_infinite),
                    env_light_row=int(lt.env_light_row)),
        mt_table=a(job.scene.mt_table),
        fourier=dict(tables=tuple({k: a(getattr(t, k)) for k in t._fields}
                                  for t in sc.fr_tables),
                     etas=tuple(float(e) for e in sc.fr_etas)),
        # tpurt keeps the shared rho and radius nodes once a table
        bss=(dict(mt_bss=a(sc.mt_bss), mt_bss_tix=a(sc.mt_bss_tix),
                  bss_rho=a(sc.bss_rho)[0], bss_radius=a(sc.bss_radius)[0],
                  **{k: a(getattr(sc, k)) for k in (
                      "bss_profile", "bss_rhoeff", "bss_cdf")})
             if sc.has_bssrdf else None),
        camera=dict(kind=cam.kind, camera_to_world=a(cam.camera_to_world),
                    raster_to_camera=a(cam.raster_to_camera),
                    lens_radius=cam.lens_radius,
                    focal_distance=cam.focal_distance,
                    shutter_open=cam.shutter_open,
                    shutter_close=cam.shutter_close,
                    res_x=cam.res_x, res_y=cam.res_y,
                    fp_base=float(cam.fp_base), fp_slope=float(cam.fp_slope),
                    **anim),
        materials=_materials(job),
        sampler=_sampler(job.sampler),
        film=Film(full_x=f.full_x, full_y=f.full_y, crop=tuple(f.crop),
                  filter=Filter(f.filter.name, tuple(f.filter.radius),
                                tuple(f.filter.params)),
                  filename=f.filename, scale=f.scale,
                  max_sample_luminance=f.max_sample_luminance),
        cfg=_config(cfg),
    )
