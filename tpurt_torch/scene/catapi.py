"""--cat / --toply: echo the parsed scene as canonical pbrt directives
(port of tpurt/scene/catapi.py, host code only; the same text byte for
byte).

Reference analog: main/pbrt.cpp --cat/--toPly flags; with them set, every
pbrt* API call in api.cpp pretty-prints itself (catIndentCount nesting)
instead of building the scene, and --toPly additionally dumps big
triangle meshes to PLY files referenced by `Shape "plymesh"`.
"""

from __future__ import annotations

import os
import sys
from typing import List

from tpurt_torch.scene.paramset import ParamSet

# meshes with more triangles than this go to .ply under --toply (the
# reference uses the same threshold in api.cpp pbrtShape)
_TOPLY_THRESHOLD = 500


def _fmt_num(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    return "%g" % f


class PrintingAPI:
    """Drop-in for PbrtAPI that prints each directive (scene cat)."""

    def __init__(self, out=None, to_ply: bool = False, ply_dir: str = "."):
        self.out = out or sys.stdout
        self.indent = 0
        self.to_ply = to_ply
        self.ply_dir = ply_dir
        self.n_ply = 0
        self.render = None  # parity with PbrtAPI attribute surface

    # -- printing helpers ----------------------------------------------------
    def _p(self, text: str) -> None:
        print(" " * (4 * self.indent) + text, file=self.out)

    def _params(self, ps: ParamSet) -> str:
        parts: List[str] = []
        import numpy as np

        for name, (t, values) in ps._items.items():
            if isinstance(values, np.ndarray):
                vals = list(values.ravel())
            elif isinstance(values, (list, tuple)):
                vals = []
                for v in values:
                    if isinstance(v, np.ndarray):
                        vals.extend(v.ravel())
                    else:
                        vals.append(v)
            else:
                vals = [values]
            if t == "string" or (t == "texture"):
                body = " ".join(f'"{v}"' for v in vals)
            elif t == "bool":
                body = " ".join(
                    '"true"' if (v in (True, "true", 1)) else '"false"'
                    for v in vals)
            else:
                body = " ".join(_fmt_num(v) for v in vals)
            decl = {"point3": "point", "vector3": "vector",
                    "normal3": "normal"}.get(t, t)
            parts.append(f'"{decl} {name}" [ {body} ]')
        return (" " + " ".join(parts)) if parts else ""

    def _directive(self, name: str, *strings, params: ParamSet = None):
        head = name + "".join(f' "{s}"' for s in strings)
        self._p(head + (self._params(params) if params is not None else ""))

    # -- transform directives ------------------------------------------------
    def identity(self):
        self._p("Identity")

    def translate(self, tx, ty, tz):
        self._p(f"Translate {_fmt_num(tx)} {_fmt_num(ty)} {_fmt_num(tz)}")

    def rotate(self, angle, axis):
        self._p("Rotate " + _fmt_num(angle) + " "
                + " ".join(_fmt_num(v) for v in axis))

    def scale(self, sx, sy, sz):
        self._p(f"Scale {_fmt_num(sx)} {_fmt_num(sy)} {_fmt_num(sz)}")

    def look_at(self, eye, look, up):
        self._p("LookAt " + " ".join(
            _fmt_num(v) for v in list(eye) + list(look) + list(up)))

    def set_transform(self, values):
        self._p("Transform [ " + " ".join(_fmt_num(v) for v in values) + " ]")

    def concat_transform(self, values):
        self._p("ConcatTransform [ "
                + " ".join(_fmt_num(v) for v in values) + " ]")

    def coordinate_system(self, name):
        self._directive("CoordinateSystem", name)

    def coord_sys_transform(self, name):
        self._directive("CoordSysTransform", name)

    def active_transform(self, which):
        self._p(f"ActiveTransform {which}")

    def transform_times(self, start, end):
        self._p(f"TransformTimes {_fmt_num(start)} {_fmt_num(end)}")

    # -- options block -------------------------------------------------------
    def camera(self, name, params):
        self._directive("Camera", name, params=params)

    def film(self, name, params):
        self._directive("Film", name, params=params)

    def sampler(self, name, params):
        self._directive("Sampler", name, params=params)

    def integrator(self, name, params):
        self._directive("Integrator", name, params=params)

    def accelerator(self, name, params):
        self._directive("Accelerator", name, params=params)

    def pixel_filter(self, name, params):
        self._directive("PixelFilter", name, params=params)

    def make_named_medium(self, name, params):
        self._directive("MakeNamedMedium", name, params=params)

    def medium_interface(self, inside, outside):
        self._directive("MediumInterface", inside, outside)

    # -- world block ---------------------------------------------------------
    def world_begin(self):
        self._p("WorldBegin")
        self.indent += 1

    def world_end(self):
        self.indent = max(0, self.indent - 1)
        self._p("WorldEnd")
        return None

    def attribute_begin(self):
        self._p("AttributeBegin")
        self.indent += 1

    def attribute_end(self):
        self.indent = max(0, self.indent - 1)
        self._p("AttributeEnd")

    def transform_begin(self):
        self._p("TransformBegin")
        self.indent += 1

    def transform_end(self):
        self.indent = max(0, self.indent - 1)
        self._p("TransformEnd")

    def object_begin(self, name):
        self._directive("ObjectBegin", name)
        self.indent += 1

    def object_end(self):
        self.indent = max(0, self.indent - 1)
        self._p("ObjectEnd")

    def object_instance(self, name):
        self._directive("ObjectInstance", name)

    def reverse_orientation(self):
        self._p("ReverseOrientation")

    def material(self, name, params):
        self._directive("Material", name, params=params)

    def make_named_material(self, name, params):
        self._directive("MakeNamedMaterial", name, params=params)

    def named_material(self, name):
        self._directive("NamedMaterial", name)

    def texture(self, name, tex_type, tex_class, params):
        self._directive("Texture", name, tex_type, tex_class, params=params)

    def light_source(self, name, params):
        self._directive("LightSource", name, params=params)

    def area_light_source(self, name, params):
        self._directive("AreaLightSource", name, params=params)

    def shape(self, name, params):
        if self.to_ply and name == "trianglemesh":
            idx = params.find_int_array("indices")
            if idx is not None and len(idx) // 3 > _TOPLY_THRESHOLD:
                fn = os.path.join(self.ply_dir, "mesh_%05d.ply" % self.n_ply)
                self.n_ply += 1
                self._write_ply(fn, params)
                ps = ParamSet()
                ps.add("string", "filename", [fn])
                self._directive("Shape", "plymesh", params=ps)
                return
        self._directive("Shape", name, params=params)

    def _write_ply(self, path: str, ps: ParamSet) -> None:
        """ASCII PLY dump of a trianglemesh ParamSet (--toply)."""
        import numpy as np

        P = ps.find_point3_array("P")
        idx = np.asarray(ps.find_int_array("indices")).reshape(-1, 3)
        N = ps.find_normal3_array("N")
        uv = ps.find_point2_array("uv") or ps.find_point2_array("st")
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(P)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            if N is not None:
                f.write("property float nx\nproperty float ny\n"
                        "property float nz\n")
            if uv is not None:
                f.write("property float u\nproperty float v\n")
            f.write(f"element face {len(idx)}\n")
            f.write("property list uchar int vertex_indices\nend_header\n")
            for i in range(len(P)):
                row = list(P[i])
                if N is not None:
                    row += list(N[i])
                if uv is not None:
                    row += list(uv[i])
                f.write(" ".join("%g" % v for v in row) + "\n")
            for tri in idx:
                f.write("3 %d %d %d\n" % tuple(tri))
