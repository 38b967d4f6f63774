"""The reference's own reader of the benchmark's scene files: the subset of
pbrt-v3's scene format that they use (pbrt-v3 ``api.cpp``, ``paramset.cpp``,
``transform.cpp``), read into world-space arrays.

Directives: LookAt, Rotate, Scale, Translate, Camera, Film, Sampler,
Integrator, PixelFilter, WorldBegin, WorldEnd, AttributeBegin,
AttributeEnd, Material, AreaLightSource, Shape ("trianglemesh" and
"sphere").  Any other directive raises.  Transforms are composed in
float64 as pbrt composes them (each directive post-multiplies the current
transform), and the world-space vertices rounded once to float32.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List

import numpy as np

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"]+')


def _tokens(text: str):
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        yield from _TOKEN.findall(line)


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    return np.diag([x, y, z, 1.0])


def _rotate(deg, x, y, z):
    a = np.array([x, y, z], np.float64)
    a = a / np.linalg.norm(a)
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    m = np.eye(4)
    m[:3, :3] = [
        [a[0] * a[0] + (1 - a[0] * a[0]) * c,
         a[0] * a[1] * (1 - c) - a[2] * s,
         a[0] * a[2] * (1 - c) + a[1] * s],
        [a[0] * a[1] * (1 - c) + a[2] * s,
         a[1] * a[1] + (1 - a[1] * a[1]) * c,
         a[1] * a[2] * (1 - c) - a[0] * s],
        [a[0] * a[2] * (1 - c) - a[1] * s,
         a[1] * a[2] * (1 - c) + a[0] * s,
         a[2] * a[2] + (1 - a[2] * a[2]) * c]]
    return m


def _look_at(eye, look, up):
    """World-to-camera (pbrt-v3 LookAt: camera-to-world's columns are
    right, up, dir and the eye)."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, new_up, d, eye
    return np.linalg.inv(c2w)


@dataclasses.dataclass
class Material:
    kind: str  # "matte" or "plastic"
    kd: tuple
    ks: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.1
    remap: bool = True


@dataclasses.dataclass
class Scene:
    res: tuple  # (x, y)
    fov: float
    camera_to_world: np.ndarray  # (4, 4) float64
    sampler: str
    spp: int
    integrator: str
    maxdepth: int
    tri_v: np.ndarray  # (T, 3, 3) float32 world-space vertices
    tri_mat: np.ndarray  # (T,) int64 material index
    spheres: List[dict]  # center (3,), radius, material, light (or None)
    materials: List[Material]
    lights: List[dict]  # sphere area lights: center, radius, L, two_sided


def _params(tok, i):
    """Parameters after a directive's type name from token ``i``: a dict
    name -> (type, [values]); returns (dict, next index)."""
    out = {}
    while i < len(tok) and tok[i].startswith('"'):
        typ, name = tok[i][1:-1].split()
        i += 1
        if tok[i] == "[":
            j = tok.index("]", i)
            vals, i = tok[i + 1:j], j + 1
        else:
            vals, i = [tok[i]], i + 1
        if typ in ("string", "texture", "bool"):
            vals = [v.strip('"') for v in vals]
            if typ == "bool":
                vals = [v == "true" for v in vals]
        elif typ == "integer":
            vals = [int(v) for v in vals]
        else:
            vals = [float(v) for v in vals]
        out[name] = (typ, vals)
    return out, i


def _one(ps, name, default):
    return ps[name][1][0] if name in ps else default


def _rgb(ps, name, default):
    if name not in ps:
        return tuple(float(default) for _ in range(3))
    v = ps[name][1]
    return tuple(float(x) for x in (v * 3 if len(v) == 1 else v[:3]))


def read_scene(path: str) -> Scene:
    """The scene file at ``path`` as a Scene."""
    tok = list(_tokens(open(path).read()))
    ctm = np.eye(4)
    stack = []
    material = Material("matte", (0.5, 0.5, 0.5))
    area = None
    opts = dict(res=(640, 480), fov=90.0, c2w=np.eye(4), sampler="halton",
                spp=16, integrator="path", maxdepth=5)
    tris, tri_mat, spheres, materials, lights = [], [], [], [], []
    mat_ids = {}

    def mat_index(m):
        key = id(m)
        if key not in mat_ids:
            mat_ids[key] = len(materials)
            materials.append(m)
        return mat_ids[key]

    i = 0
    while i < len(tok):
        t = tok[i]
        i += 1
        if t in ("LookAt", "Rotate", "Scale", "Translate"):
            n = {"LookAt": 9, "Rotate": 4, "Scale": 3, "Translate": 3}[t]
            a = [float(x) for x in tok[i:i + n]]
            i += n
            m = {"LookAt": lambda: _look_at(a[0:3], a[3:6], a[6:9]),
                 "Rotate": lambda: _rotate(*a), "Scale": lambda: _scale(*a),
                 "Translate": lambda: _translate(*a)}[t]()
            ctm = ctm @ m
        elif t in ("WorldBegin", "WorldEnd"):
            ctm = np.eye(4)
        elif t == "AttributeBegin":
            stack.append((ctm, material, area))
        elif t == "AttributeEnd":
            ctm, material, area = stack.pop()
        else:
            name = tok[i].strip('"')
            ps, i = _params(tok, i + 1)
            if t == "Camera":
                if name != "perspective":
                    raise ValueError(f"Camera {name!r}")
                opts["fov"] = _one(ps, "fov", 90.0)
                opts["c2w"] = np.linalg.inv(ctm)
            elif t == "Film":
                opts["res"] = (_one(ps, "xresolution", 640),
                               _one(ps, "yresolution", 480))
            elif t == "Sampler":
                opts["sampler"] = name
                opts["spp"] = _one(ps, "pixelsamples", 16)
            elif t == "Integrator":
                opts["integrator"] = name
                opts["maxdepth"] = _one(ps, "maxdepth", 5)
            elif t == "PixelFilter":
                if name != "box" or ps:
                    raise ValueError(f"PixelFilter {name!r}")
            elif t == "Material":
                if name == "matte":
                    material = Material("matte", _rgb(ps, "Kd", 0.5))
                elif name == "plastic":
                    material = Material(
                        "plastic", _rgb(ps, "Kd", 0.25), _rgb(ps, "Ks", 0.25),
                        _one(ps, "roughness", 0.1),
                        _one(ps, "remaproughness", True))
                else:
                    raise ValueError(f"Material {name!r}")
            elif t == "AreaLightSource":
                area = dict(L=_rgb(ps, "L", 1.0),
                            two_sided=_one(ps, "twosided", False))
            elif t == "Shape" and name == "trianglemesh":
                if area is not None:
                    raise ValueError("emissive triangle meshes")
                p = np.asarray(ps["P"][1], np.float64).reshape(-1, 3)
                idx = np.asarray(ps["indices"][1], np.int64).reshape(-1, 3)
                pw = p @ ctm[:3, :3].T + ctm[:3, 3]
                tris.append(pw.astype(np.float32)[idx])
                tri_mat.append(np.full(len(idx), mat_index(material)))
            elif t == "Shape" and name == "sphere":
                if not np.allclose(ctm[:3, :3], np.eye(3)):
                    raise ValueError("spheres under rotation or scale")
                sph = dict(center=ctm[:3, 3].astype(np.float32),
                           radius=float(_one(ps, "radius", 1.0)),
                           material=mat_index(material), light=None)
                if area is not None:
                    sph["light"] = len(lights)
                    lights.append(dict(center=sph["center"],
                                       radius=sph["radius"], **area))
                spheres.append(sph)
            else:
                raise ValueError(f"{t} {name!r}")
    return Scene(res=opts["res"], fov=opts["fov"],
                 camera_to_world=opts["c2w"], sampler=opts["sampler"],
                 spp=opts["spp"], integrator=opts["integrator"],
                 maxdepth=opts["maxdepth"],
                 tri_v=np.concatenate(tris), tri_mat=np.concatenate(tri_mat),
                 spheres=spheres, materials=materials, lights=lights)
