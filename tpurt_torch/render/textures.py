"""Texture factories: pbrt Texture directives -> TextureRecords.

Reference analog: src/textures/* Create*Texture factories dispatched from
api.cpp MakeFloatTexture/MakeSpectrumTexture (:610-680).  Records keep the
2D/3D mapping parameters and nested texture references; device evaluation
(tpurt.render.texeval) interprets them over batched hit buffers.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np

from tpurt_torch.geom.transform import Transform
from tpurt_torch.scene.paramset import ParamSet
from tpurt_torch.scene.records import TextureRecord

log = logging.getLogger("tpurt.scene")


def _mapping2d(ps: ParamSet) -> Dict:
    """UV/spherical/cylindrical/planar 2D mapping params
    (texture.h:51-133; api reads 'mapping')."""
    typ = ps.find_one_string("mapping", "uv")
    m = {"type": typ}
    if typ == "uv":
        m.update(
            uscale=ps.find_one_float("uscale", 1.0),
            vscale=ps.find_one_float("vscale", 1.0),
            udelta=ps.find_one_float("udelta", 0.0),
            vdelta=ps.find_one_float("vdelta", 0.0),
        )
    elif typ == "planar":
        m.update(
            v1=ps.find_one_vector3("v1", [1, 0, 0]),
            v2=ps.find_one_vector3("v2", [0, 1, 0]),
            udelta=ps.find_one_float("udelta", 0.0),
            vdelta=ps.find_one_float("vdelta", 0.0),
        )
    elif typ not in ("spherical", "cylindrical"):
        log.error('2D texture mapping "%s" unknown', typ)
        m["type"] = "uv"
    return m


def _tex_or_const(name: str, ps: ParamSet, tex_type: str, default,
                  float_textures, spectrum_textures):
    """Nested texture reference or constant (TextureParams semantics)."""
    tname = ps.find_texture(name, "")
    if tname:
        table = float_textures if tex_type == "float" else spectrum_textures
        if tname in table:
            return ("texture", table[tname])
        log.error('texture "%s" not found for "%s"', tname, name)
    if tex_type == "float":
        return ("constant", ps.find_one_float(name, default))
    return ("constant", ps.find_one_spectrum(name, default))


def make_texture(tex_class: str, tex_type: str, tex2world: Transform,
                 ps: ParamSet, float_textures: dict, spectrum_textures: dict
                 ) -> Optional[TextureRecord]:
    t = lambda n, d: _tex_or_const(n, ps, tex_type, d, float_textures, spectrum_textures)
    tf = lambda n, d: _tex_or_const(n, ps, "float", d, float_textures, spectrum_textures)

    if tex_class == "constant":
        return TextureRecord("constant", tex_type, {
            "value": (ps.find_one_float("value", 1.0) if tex_type == "float"
                      else ps.find_one_spectrum("value", 1.0))})
    if tex_class == "scale":
        return TextureRecord("scale", tex_type, {
            "tex1": t("tex1", 1.0), "tex2": t("tex2", 1.0)})
    if tex_class == "mix":
        return TextureRecord("mix", tex_type, {
            "tex1": t("tex1", 0.0), "tex2": t("tex2", 1.0),
            "amount": tf("amount", 0.5)})
    if tex_class == "bilerp":
        return TextureRecord("bilerp", tex_type, {
            "v00": t("v00", 0.0), "v01": t("v01", 1.0),
            "v10": t("v10", 0.0), "v11": t("v11", 1.0),
            "mapping": _mapping2d(ps)})
    if tex_class == "checkerboard":
        dim = ps.find_one_int("dimension", 2)
        rec = {
            "dimension": dim,
            "tex1": t("tex1", 1.0), "tex2": t("tex2", 0.0),
            "aamode": ps.find_one_string("aamode", "closedform"),
        }
        if dim == 2:
            rec["mapping"] = _mapping2d(ps)
        return TextureRecord("checkerboard", tex_type, rec,
                             world_to_texture=tex2world.inverse())
    if tex_class == "dots":
        return TextureRecord("dots", tex_type, {
            "inside": t("inside", 1.0), "outside": t("outside", 0.0),
            "mapping": _mapping2d(ps)})
    if tex_class == "uv":
        return TextureRecord("uv", tex_type, {"mapping": _mapping2d(ps)})
    if tex_class == "imagemap":
        return TextureRecord("imagemap", tex_type, {
            "filename": ps.find_one_filename("filename", ""),
            "wrap": ps.find_one_string("wrap", "repeat"),
            "maxanisotropy": ps.find_one_float("maxanisotropy", 8.0),
            "trilinear": ps.find_one_bool("trilinear", False),
            "scale": ps.find_one_float("scale", 1.0),
            "gamma": ps.find_one_bool(
                "gamma", ps.find_one_filename("filename", "").lower().endswith((".tga", ".png"))),
            "mapping": _mapping2d(ps)})
    if tex_class in ("fbm", "wrinkled"):
        return TextureRecord(tex_class, tex_type, {
            "octaves": ps.find_one_int("octaves", 8),
            "roughness": ps.find_one_float("roughness", 0.5)},
            world_to_texture=tex2world.inverse())
    if tex_class == "windy":
        return TextureRecord("windy", tex_type, {},
                             world_to_texture=tex2world.inverse())
    if tex_class == "marble":
        return TextureRecord("marble", tex_type, {
            "octaves": ps.find_one_int("octaves", 8),
            "roughness": ps.find_one_float("roughness", 0.5),
            "scale": ps.find_one_float("scale", 1.0),
            "variation": ps.find_one_float("variation", 0.2)},
            world_to_texture=tex2world.inverse())
    if tex_class == "ptex":
        # textures/ptex.cpp:63-183: per-face Ptex lookups keyed by
        # si.faceIndex, gamma applied post-filter.  tpurt reads the Ptex
        # container natively (tpurt/io/ptex.py) — the reference snapshot
        # itself CANNOT (its src/ext/ptex submodule is empty).
        fname = ps.find_one_filename("filename", "")
        if fname and not os.path.isfile(fname):
            # surface the problem at parse time (the reference's Ptex
            # library errors at texture creation, ptex.cpp:63-70); a job
            # that evaluates the texture raises (tpurt renders 0.5 gray)
            log.warning('ptex file "%s" not found; a render that reads '
                        "it will raise", fname)
        return TextureRecord("ptex", tex_type, {
            "filename": fname,
            "gamma": ps.find_one_float("gamma", 2.2)})
    log.warning('texture class "%s" unknown or unsupported', tex_class)
    return None
