"""Material factories: pbrt Material directives -> MaterialRecords.

Reference analog: src/materials/* Create*Material factories dispatched from
api.cpp MakeMaterial (:538-608).  A MaterialRecord is a named bag of
texture-or-constant slots; tpurt.render.build flattens all records into a
per-primitive material parameter table (SoA) and the device shades with a
masked lobe mixture instead of virtual BxDF stacks.

Defaults match the reference factories (e.g. matte Kd=0.5 matte.cpp:
CreateMatteMaterial; plastic Kd=0.25/Ks=0.25/rough=0.1 plastic.cpp).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from tpurt_torch.scene.paramset import TextureParams
from tpurt_torch.scene.records import MaterialRecord

log = logging.getLogger("tpurt.scene")

# Copper eta/k converted to RGB from the reference's sampled Cu spectra
# (materials/metal.cpp CopperN/CopperK); values are the RGB projection of
# those 56-sample spectra.
COPPER_ETA_RGB = np.array([0.19999069, 0.92208463, 1.09985996])
COPPER_K_RGB = np.array([3.90463543, 2.44763327, 2.13765264])


def make_material(name: str, tp: TextureParams) -> Optional[MaterialRecord]:
    if name in ("", "none"):
        return None
    fn = _FACTORIES.get(name)
    if fn is None:
        log.warning('material "%s" unknown; using "matte"', name)
        fn = _matte
    rec = fn(tp)
    return rec


def _common_bump(tp: TextureParams, slots: dict) -> None:
    bump = tp.get_float_texture_or_none("bumpmap")
    if bump is not None:
        slots["bumpmap"] = bump


def _matte(tp: TextureParams) -> MaterialRecord:
    slots = {
        "Kd": tp.get_spectrum_texture("Kd", 0.5),
        "sigma": tp.get_float_texture("sigma", 0.0),
    }
    _common_bump(tp, slots)
    return MaterialRecord("matte", slots)


def _plastic(tp: TextureParams) -> MaterialRecord:
    slots = {
        "Kd": tp.get_spectrum_texture("Kd", 0.25),
        "Ks": tp.get_spectrum_texture("Ks", 0.25),
        "roughness": tp.get_float_texture("roughness", 0.1),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
    }
    _common_bump(tp, slots)
    return MaterialRecord("plastic", slots)


def _mirror(tp: TextureParams) -> MaterialRecord:
    slots = {"Kr": tp.get_spectrum_texture("Kr", 0.9)}
    _common_bump(tp, slots)
    return MaterialRecord("mirror", slots)


def _glass(tp: TextureParams) -> MaterialRecord:
    eta = tp.get_float_texture_or_none("eta")
    if eta is None:
        eta = tp.get_float_texture("index", 1.5)
    slots = {
        "Kr": tp.get_spectrum_texture("Kr", 1.0),
        "Kt": tp.get_spectrum_texture("Kt", 1.0),
        "eta": eta,
        "uroughness": tp.get_float_texture("uroughness", 0.0),
        "vroughness": tp.get_float_texture("vroughness", 0.0),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
    }
    _common_bump(tp, slots)
    return MaterialRecord("glass", slots)


def _metal(tp: TextureParams) -> MaterialRecord:
    rough = tp.get_float_texture("roughness", 0.01)
    slots = {
        "eta": tp.get_spectrum_texture("eta", COPPER_ETA_RGB),
        "k": tp.get_spectrum_texture("k", COPPER_K_RGB),
        "roughness": rough,
        "uroughness": tp.get_float_texture_or_none("uroughness"),
        "vroughness": tp.get_float_texture_or_none("vroughness"),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
    }
    _common_bump(tp, slots)
    return MaterialRecord("metal", slots)


def _uber(tp: TextureParams) -> MaterialRecord:
    eta = tp.get_float_texture_or_none("eta")
    if eta is None:
        eta = tp.get_float_texture("index", 1.5)
    slots = {
        "Kd": tp.get_spectrum_texture("Kd", 0.25),
        "Ks": tp.get_spectrum_texture("Ks", 0.25),
        "Kr": tp.get_spectrum_texture("Kr", 0.0),
        "Kt": tp.get_spectrum_texture("Kt", 0.0),
        "roughness": tp.get_float_texture("roughness", 0.1),
        "uroughness": tp.get_float_texture_or_none("uroughness"),
        "vroughness": tp.get_float_texture_or_none("vroughness"),
        "eta": eta,
        "opacity": tp.get_spectrum_texture("opacity", 1.0),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
    }
    _common_bump(tp, slots)
    return MaterialRecord("uber", slots)


def _substrate(tp: TextureParams) -> MaterialRecord:
    slots = {
        "Kd": tp.get_spectrum_texture("Kd", 0.5),
        "Ks": tp.get_spectrum_texture("Ks", 0.5),
        "uroughness": tp.get_float_texture("uroughness", 0.1),
        "vroughness": tp.get_float_texture("vroughness", 0.1),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
    }
    _common_bump(tp, slots)
    return MaterialRecord("substrate", slots)


def _translucent(tp: TextureParams) -> MaterialRecord:
    slots = {
        "Kd": tp.get_spectrum_texture("Kd", 0.25),
        "Ks": tp.get_spectrum_texture("Ks", 0.25),
        "roughness": tp.get_float_texture("roughness", 0.1),
        "reflect": tp.get_spectrum_texture("reflect", 0.5),
        "transmit": tp.get_spectrum_texture("transmit", 0.5),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
    }
    _common_bump(tp, slots)
    return MaterialRecord("translucent", slots)


def _mix(tp: TextureParams) -> MaterialRecord:
    slots = {
        "amount": tp.get_spectrum_texture("amount", 0.5),
        "namedmaterial1": ("constant", tp.find_string("namedmaterial1", "")),
        "namedmaterial2": ("constant", tp.find_string("namedmaterial2", "")),
    }
    return MaterialRecord("mix", slots)


def _disney(tp: TextureParams) -> MaterialRecord:
    """Disney BSDF (materials/disney.cpp CreateDisneyMaterial :589-643).
    The color rides the Kd slot so image textures flow through the
    existing override plumbing; scatterdistance (BSSRDF) is parsed but
    not yet shaded (logged)."""
    sd = tp.get_spectrum_texture("scatterdistance", 0.0)
    if sd[0] == "constant" and np.any(np.asarray(sd[1]) > 0):
        log.warning("disney scatterdistance (BSSRDF) not yet shaded; "
                    "using the diffuse lobe")
    slots = {
        "Kd": tp.get_spectrum_texture("color", 0.5),
        "metallic": tp.get_float_texture("metallic", 0.0),
        "eta": tp.get_float_texture("eta", 1.5),
        "roughness": tp.get_float_texture("roughness", 0.5),
        "speculartint": tp.get_float_texture("speculartint", 0.0),
        "anisotropic": tp.get_float_texture("anisotropic", 0.0),
        "sheen": tp.get_float_texture("sheen", 0.0),
        "sheentint": tp.get_float_texture("sheentint", 0.5),
        "clearcoat": tp.get_float_texture("clearcoat", 0.0),
        "clearcoatgloss": tp.get_float_texture("clearcoatgloss", 1.0),
        "spectrans": tp.get_float_texture("spectrans", 0.0),
        "thin": ("constant", tp.find_bool("thin", False)),
        "flatness": tp.get_float_texture("flatness", 0.0),
        "difftrans": tp.get_float_texture("difftrans", 1.0),
    }
    _common_bump(tp, slots)
    return MaterialRecord("disney", slots)


def _subsurface(tp: TextureParams) -> MaterialRecord:
    """Subsurface material (materials/subsurface.cpp
    CreateSubsurfaceMaterial; tpurt's materials.py:188-220): glass-like
    surface BSDF + a tabulated BSSRDF from (sigma_a, sigma_s) or a named
    measured preset, whose reduced sigma_s sets g to 0."""
    from tpurt_torch.render.bssrdf import get_medium_scattering_properties

    sig_a_d = np.array([0.0011, 0.0024, 0.014])
    sig_s_d = np.array([2.55, 3.21, 3.77])
    g = tp.find_float("g", 0.0)
    preset = tp.find_string("name", "")
    props = get_medium_scattering_properties(preset) if preset else None
    if preset and props is None:
        log.warning('named scattering preset "%s" not found, using defaults',
                    preset)
    if props is not None:
        sig_a_d, sig_s_d = props
        g = 0.0  # preset sigma_s values are already reduced (subsurface.cpp)
    slots = {
        "sigma_a": tp.get_spectrum_texture("sigma_a", sig_a_d),
        "sigma_s": tp.get_spectrum_texture("sigma_s", sig_s_d),
        "scale": ("constant", tp.find_float("scale", 1.0)),
        "g": ("constant", g),
        "eta": tp.get_float_texture("eta", 1.33),
        "Kr": tp.get_spectrum_texture("Kr", 1.0),
        "Kt": tp.get_spectrum_texture("Kt", 1.0),
        "uroughness": tp.get_float_texture("uroughness", 0.0),
        "vroughness": tp.get_float_texture("vroughness", 0.0),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
    }
    _common_bump(tp, slots)
    return MaterialRecord("subsurface", slots)


def _kdsubsurface(tp: TextureParams) -> MaterialRecord:
    """kdsubsurface (materials/kdsubsurface.cpp): diffuse-reflectance +
    mean-free-path parameterization, inverted to (sigma_a, sigma_s) via
    SubsurfaceFromDiffuse at table build."""
    slots = {
        "Kd": tp.get_spectrum_texture("Kd", 0.5),
        "mfp": tp.get_float_texture("mfp", 1.0),
        "eta": tp.get_float_texture("eta", 1.33),
        "Kr": tp.get_spectrum_texture("Kr", 1.0),
        "Kt": tp.get_spectrum_texture("Kt", 1.0),
        "uroughness": tp.get_float_texture("uroughness", 0.0),
        "vroughness": tp.get_float_texture("vroughness", 0.0),
        "remaproughness": ("constant", tp.find_bool("remaproughness", True)),
        "g": ("constant", 0.0),
    }
    _common_bump(tp, slots)
    return MaterialRecord("kdsubsurface", slots)


def _hair(tp: TextureParams) -> MaterialRecord:
    """Hair material (materials/hair.cpp CreateHairMaterial :169-226):
    sigma_a wins over color wins over eumelanin/pheomelanin; default is
    SigmaAFromConcentration(1.3, 0) brown.  Resolution to the final
    sigma_a happens at table build (it needs beta_n)."""
    slots = {}
    for key, getter in (("sigma_a", tp.get_spectrum_texture_or_none),
                        ("color", tp.get_spectrum_texture_or_none),
                        ("eumelanin", tp.get_float_texture_or_none),
                        ("pheomelanin", tp.get_float_texture_or_none)):
        v = getter(key)
        if v is not None:
            slots[key] = v
    order = ["sigma_a", "color", "eumelanin", "pheomelanin"]
    present = [k for k in order if k in slots]
    if len(present) > 1 and present[0] in ("sigma_a", "color"):
        for k in present[1:]:
            log.warning('hair: ignoring "%s" since "%s" was provided',
                        k, present[0])
            del slots[k]
    slots["eta"] = tp.get_float_texture("eta", 1.55)
    slots["beta_m"] = tp.get_float_texture("beta_m", 0.3)
    slots["beta_n"] = tp.get_float_texture("beta_n", 0.3)
    slots["alpha"] = tp.get_float_texture("alpha", 2.0)
    _common_bump(tp, slots)
    return MaterialRecord("hair", slots)


def _fourier(tp: TextureParams) -> MaterialRecord:
    """Fourier tabulated BSDF (materials/fourier.cpp CreateFourierMaterial);
    the .bsdf table is read and baked at scene build."""
    slots = {"bsdffile": ("constant", tp.find_string("bsdffile", ""))}
    _common_bump(tp, slots)
    return MaterialRecord("fourier", slots)


_FACTORIES = {
    "matte": _matte,
    "plastic": _plastic,
    "mirror": _mirror,
    "glass": _glass,
    "metal": _metal,
    "uber": _uber,
    "substrate": _substrate,
    "translucent": _translucent,
    "mix": _mix,
    "fourier": _fourier,
    "disney": _disney,
    "hair": _hair,
    "subsurface": _subsurface,
    "kdsubsurface": _kdsubsurface,
}
