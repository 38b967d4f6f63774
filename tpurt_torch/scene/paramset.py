"""Typed parameter sets for the pbrt scene-description language.

Reference analog: core/paramset.{h,cpp} — typed key/value store with
FindOne* default lookups, used-parameter tracking (ReportUnused), and
TextureParams for resolving texture references.  Values arrive from the
parser as (type-string, python list) pairs.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpurt_torch import spectrum as spec

log = logging.getLogger("tpurt.scene")

# The declared types the grammar knows (paramset.cpp lookupType).
PARAM_TYPES = {
    "integer", "bool", "float",
    "point2", "vector2",
    "point3", "vector3", "point", "vector", "normal",
    "rgb", "color", "xyz", "blackbody", "spectrum",
    "string", "texture",
}


def parse_declaration(decl: str) -> Tuple[str, str]:
    """Split '<type> <name>' (e.g. 'float fov')."""
    parts = decl.split()
    if len(parts) != 2 or parts[0] not in PARAM_TYPES:
        raise ValueError(f"malformed parameter declaration: {decl!r}")
    return parts[0], parts[1]


class ParamSet:
    """Typed key/value store with pbrt's lookup semantics."""

    def __init__(self):
        # name -> (declared_type, values list/array)
        self._items: Dict[str, Tuple[str, Any]] = {}
        self._used: set = set()
        # directory of the scene file, for resolving 'spectrum' filenames
        self.base_dir: str = "."

    # -- construction --------------------------------------------------------
    def add(self, decl_type: str, name: str, values: List[Any]) -> None:
        t = decl_type
        if t == "point":
            t = "point3"
        elif t == "vector":
            t = "vector3"
        elif t == "color":
            t = "rgb"
        if t == "integer":
            values = np.asarray([int(v) for v in values], dtype=np.int64)
        elif t == "bool":
            out = []
            for v in values:
                if v in (True, "true"):
                    out.append(True)
                elif v in (False, "false"):
                    out.append(False)
                else:
                    log.warning('value "%s" unknown for bool parameter %s; using false',
                                v, name)
                    out.append(False)
            values = out
        elif t in ("float", "point2", "vector2", "point3", "vector3", "normal",
                   "rgb", "xyz", "blackbody"):
            values = np.asarray([float(v) for v in values], dtype=np.float64)
        self._items[name] = (t, values)

    @staticmethod
    def from_parsed(items: List[Tuple[str, List[Any]]], base_dir: str = ".") -> "ParamSet":
        ps = ParamSet()
        ps.base_dir = base_dir
        for decl, values in items:
            t, name = parse_declaration(decl)
            ps.add(t, name, values)
        return ps

    # -- generic access -------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._items

    def keys(self):
        return self._items.keys()

    def declared_type(self, name: str) -> Optional[str]:
        return self._items[name][0] if name in self._items else None

    def _get(self, name: str, want_types) -> Optional[Any]:
        if name not in self._items:
            return None
        t, v = self._items[name]
        if t not in want_types:
            return None
        self._used.add(name)
        return v

    # -- FindOne* (scalar with default) ---------------------------------------
    def find_one_float(self, name: str, default: float) -> float:
        v = self._get(name, ("float",))
        return float(v[0]) if v is not None and len(v) else default

    def find_one_int(self, name: str, default: int) -> int:
        v = self._get(name, ("integer",))
        return int(v[0]) if v is not None and len(v) else default

    def find_one_bool(self, name: str, default: bool) -> bool:
        v = self._get(name, ("bool",))
        return bool(v[0]) if v is not None and len(v) else default

    def find_one_string(self, name: str, default: str) -> str:
        v = self._get(name, ("string",))
        return str(v[0]) if v is not None and len(v) else default

    def find_one_filename(self, name: str, default: str = "") -> str:
        s = self.find_one_string(name, "")
        if not s:
            return default
        return s if os.path.isabs(s) else os.path.join(self.base_dir, s)

    def find_texture(self, name: str, default: str = "") -> str:
        v = self._get(name, ("texture",))
        return str(v[0]) if v is not None and len(v) else default

    def find_one_point2(self, name: str, default) -> np.ndarray:
        v = self._get(name, ("point2",))
        return np.array(v[:2]) if v is not None and len(v) >= 2 else np.asarray(default, dtype=np.float64)

    def _find_one_vec3(self, name: str, types, default) -> np.ndarray:
        v = self._get(name, types)
        if v is not None and len(v) >= 3:
            return np.array(v[:3], dtype=np.float64)
        return np.asarray(default, dtype=np.float64)

    def find_one_point3(self, name: str, default) -> np.ndarray:
        return self._find_one_vec3(name, ("point3",), default)

    def find_one_vector3(self, name: str, default) -> np.ndarray:
        return self._find_one_vec3(name, ("vector3",), default)

    def find_one_normal3(self, name: str, default) -> np.ndarray:
        return self._find_one_vec3(name, ("normal",), default)

    def find_one_spectrum(self, name: str, default) -> np.ndarray:
        """Any spectrum-typed param, converted to RGB."""
        if name not in self._items:
            return np.asarray(default, dtype=np.float64) * np.ones(3)
        t, v = self._items[name]
        rgb = self._spectrum_to_rgb(name, t, v)
        if rgb is None:
            return np.asarray(default, dtype=np.float64) * np.ones(3)
        self._used.add(name)
        return rgb

    def _spectrum_to_rgb(self, name, t, v):
        if t == "rgb":
            return np.array(v[:3], dtype=np.float64)
        if t == "xyz":
            return spec.xyz_to_rgb(np.array(v[:3]))
        if t == "blackbody":
            # pairs of (temperature, scale) — use the first pair
            temp = float(v[0])
            sc = float(v[1]) if len(v) > 1 else 1.0
            return spec.blackbody_rgb(temp, sc)
        if t == "spectrum":
            if len(v) and isinstance(v[0], str):
                lam, val = _read_spd_file(
                    v[0] if os.path.isabs(v[0]) else os.path.join(self.base_dir, v[0])
                )
                return spec.spectrum_samples_to_rgb(lam, val)
            arr = np.asarray([float(x) for x in v], dtype=np.float64)
            return spec.spectrum_samples_to_rgb(arr[0::2], arr[1::2])
        return None

    # -- array lookups ---------------------------------------------------------
    def find_float_array(self, name: str) -> Optional[np.ndarray]:
        v = self._get(name, ("float",))
        return np.asarray(v, dtype=np.float64) if v is not None else None

    def find_int_array(self, name: str) -> Optional[np.ndarray]:
        v = self._get(name, ("integer",))
        return np.asarray(v, dtype=np.int64) if v is not None else None

    def _find_vec_array(self, name: str, types) -> Optional[np.ndarray]:
        v = self._get(name, types)
        if v is None:
            return None
        v = np.asarray(v, dtype=np.float64)
        if len(v) % 3:
            log.warning("excess values given with parameter %s", name)
            v = v[: len(v) - len(v) % 3]
        return v.reshape(-1, 3)

    def find_point3_array(self, name: str) -> Optional[np.ndarray]:
        return self._find_vec_array(name, ("point3",))

    def find_vector3_array(self, name: str) -> Optional[np.ndarray]:
        return self._find_vec_array(name, ("vector3",))

    def find_normal3_array(self, name: str) -> Optional[np.ndarray]:
        return self._find_vec_array(name, ("normal",))

    def find_point2_array(self, name: str) -> Optional[np.ndarray]:
        v = self._get(name, ("point2", "float"))
        if v is None:
            return None
        v = np.asarray(v, dtype=np.float64)
        return v.reshape(-1, 2)

    def find_spectrum_array(self, name: str) -> Optional[np.ndarray]:
        if name not in self._items:
            return None
        t, v = self._items[name]
        if t == "rgb":
            self._used.add(name)
            return np.asarray(v, dtype=np.float64).reshape(-1, 3)
        rgb = self._spectrum_to_rgb(name, t, v)
        if rgb is None:
            return None
        self._used.add(name)
        return np.asarray(rgb).reshape(-1, 3)

    # -- diagnostics ------------------------------------------------------------
    def report_unused(self, context: str = "") -> None:
        for name in self._items:
            if name not in self._used:
                log.warning('parameter "%s" not used %s', name, context)

    def __repr__(self):
        return f"ParamSet({ {k: t for k, (t, _) in self._items.items()} })"


def _read_spd_file(path: str):
    """Read a pbrt .spd file: whitespace-separated (lambda, value) floats,
    '#' comments (core/floatfile.cpp)."""
    lam, val = [], []
    with open(path) as f:
        toks = []
        for line in f:
            line = line.split("#", 1)[0]
            toks += line.split()
    vals = [float(t) for t in toks]
    return np.asarray(vals[0::2]), np.asarray(vals[1::2])


class TextureParams:
    """Resolves texture-or-constant parameters for material factories
    (paramset.h:162).  ``geom_params`` shadows ``material_params``."""

    def __init__(self, geom_params: ParamSet, material_params: ParamSet,
                 float_textures: dict, spectrum_textures: dict):
        self.geom = geom_params
        self.mat = material_params
        self.float_textures = float_textures
        self.spectrum_textures = spectrum_textures

    def _tex_name(self, name: str) -> str:
        n = self.geom.find_texture(name, "")
        return n or self.mat.find_texture(name, "")

    def get_spectrum_texture(self, name: str, default):
        """Returns a texture record: ('texture', tex_obj) or ('constant', rgb)."""
        tex_name = self._tex_name(name)
        if tex_name:
            if tex_name in self.spectrum_textures:
                return ("texture", self.spectrum_textures[tex_name])
            log.error('couldn\'t find spectrum texture named "%s" for parameter "%s"',
                      tex_name, name)
        if name in self.geom and self.geom.declared_type(name) != "texture":
            return ("constant", self.geom.find_one_spectrum(name, default))
        if name in self.mat and self.mat.declared_type(name) != "texture":
            return ("constant", self.mat.find_one_spectrum(name, default))
        return ("constant", np.asarray(default, dtype=np.float64) * np.ones(3))

    def get_float_texture(self, name: str, default: float):
        tex_name = self._tex_name(name)
        if tex_name:
            if tex_name in self.float_textures:
                return ("texture", self.float_textures[tex_name])
            log.error('couldn\'t find float texture named "%s" for parameter "%s"',
                      tex_name, name)
        if name in self.geom and self.geom.declared_type(name) == "float":
            return ("constant", self.geom.find_one_float(name, default))
        if name in self.mat and self.mat.declared_type(name) == "float":
            return ("constant", self.mat.find_one_float(name, default))
        return ("constant", float(default))

    def get_spectrum_texture_or_none(self, name: str):
        tex_name = self._tex_name(name)
        if tex_name:
            if tex_name in self.spectrum_textures:
                return ("texture", self.spectrum_textures[tex_name])
            log.error('couldn\'t find spectrum texture named "%s"', tex_name)
            return None
        if name in self.geom and self.geom.declared_type(name) != "texture":
            return ("constant", self.geom.find_one_spectrum(name, 0.0))
        if name in self.mat and self.mat.declared_type(name) != "texture":
            return ("constant", self.mat.find_one_spectrum(name, 0.0))
        return None

    def get_float_texture_or_none(self, name: str):
        tex_name = self._tex_name(name)
        if tex_name:
            if tex_name in self.float_textures:
                return ("texture", self.float_textures[tex_name])
            log.error('couldn\'t find float texture named "%s"', tex_name)
            return None
        if name in self.geom and self.geom.declared_type(name) == "float":
            return ("constant", self.geom.find_one_float(name, 0.0))
        if name in self.mat and self.mat.declared_type(name) == "float":
            return ("constant", self.mat.find_one_float(name, 0.0))
        return None

    # scalar lookups fall through geom -> mat
    def find_float(self, name, default):
        return self.geom.find_one_float(name, self.mat.find_one_float(name, default))

    def find_int(self, name, default):
        return self.geom.find_one_int(name, self.mat.find_one_int(name, default))

    def find_bool(self, name, default):
        return self.geom.find_one_bool(name, self.mat.find_one_bool(name, default))

    def find_string(self, name, default):
        return self.geom.find_one_string(name, self.mat.find_one_string(name, default))

    def report_unused(self, context=""):
        self.geom.report_unused(context)
