"""The pbrt scene-description API state machine.

Reference analog: core/api.{h,cpp} — the 42 pbrt*() calls (api.h:47-89),
the Uninitialized/OptionsBlock/WorldBlock state guard, the CTM stack with
animated-transform pairs (MaxTransforms=2), the GraphicsState attribute
stack, named textures/materials/media/coordinate-systems, and object
instancing.  Instead of constructing renderer objects directly, every call
accumulates into a SceneDescription (tpurt.scene.records); WorldEnd seals
it for tpurt.render.build.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Optional

import numpy as np

from tpurt_torch.geom import transform as xf
from tpurt_torch.geom.shapes import make_shapes
from tpurt_torch.scene.paramset import ParamSet, TextureParams
from tpurt_torch.scene.records import (
    AreaLightRecord,
    LightRecord,
    MaterialRecord,
    PrimitiveRecord,
    SceneDescription,
    TextureRecord,
)

log = logging.getLogger("tpurt.scene")

MAX_TRANSFORMS = 2
START_TRANSFORM_BITS = 1 << 0
END_TRANSFORM_BITS = 1 << 1
ALL_TRANSFORMS_BITS = (1 << MAX_TRANSFORMS) - 1

_UNINITIALIZED, _OPTIONS_BLOCK, _WORLD_BLOCK = 0, 1, 2

# per-value element counts for pbrt's nValues semantics (one point3 = 1
# value = 3 floats in the flat store)
_ELEMS = {"point2": 2, "vector2": 2, "point3": 3, "vector3": 3,
          "normal": 3, "rgb": 3, "xyz": 3, "blackbody": 2}


def _shape_may_set_material_parameters(ps: ParamSet) -> bool:
    """shapeMaySetMaterialParameters (api.cpp:1428-1477): heuristically
    detect shape ParamSets that shadow material parameters, forcing a
    one-off material.  Texture refs (except alpha masks), any
    single-valued param, and strings other than the known shape ones
    ("filename"/"type"/"scheme") count; "radius" floats don't."""
    for name in ps.keys():
        t = ps.declared_type(name)
        n = len(ps._items[name][1]) // _ELEMS.get(t, 1)
        if t == "texture":
            if name not in ("alpha", "shadowalpha"):
                return True
        elif t == "float":
            if n == 1 and name != "radius":
                return True
        elif t == "string":
            if n == 1 and name not in ("filename", "type", "scheme"):
                return True
        elif n == 1:  # bool/int/point/vector/normal/spectrum single values
            return True
    return False


class APIError(RuntimeError):
    pass


class _TransformSet:
    """Pair of transforms for animated-transform endpoints
    (api.cpp TransformSet)."""

    def __init__(self):
        self.t = [xf.Transform(), xf.Transform()]

    def copy(self) -> "_TransformSet":
        new = _TransformSet()
        new.t = list(self.t)
        return new

    def inverse(self) -> "_TransformSet":
        new = _TransformSet()
        new.t = [t.inverse() for t in self.t]
        return new

    def is_animated(self) -> bool:
        return not np.array_equal(self.t[0].m, self.t[1].m)


class _GraphicsState:
    """Attribute state (api.cpp GraphicsState, :1129-1160)."""

    def __init__(self):
        self.float_textures: Dict[str, TextureRecord] = {}
        self.spectrum_textures: Dict[str, TextureRecord] = {}
        self.named_materials: Dict[str, MaterialRecord] = {}
        self.material_name: str = "matte"
        self.material_params: ParamSet = ParamSet()
        # The resolved record for the current Material directive, created
        # EAGERLY and shared by every Shape that doesn't shadow material
        # params (api.cpp:1248 MaterialInstance + GetMaterialForShape
        # :1479-1491).  Sharing is semantic, not just an optimization: the
        # BSSRDF probe chain admits crossings by material IDENTITY
        # (bssrdf.cpp:311 compares Material pointers), so two shapes under
        # one directive must map to one material id.
        self.current_material_rec: Optional[MaterialRecord] = None
        self.current_named_material: Optional[str] = None
        self.area_light: Optional[str] = None
        self.area_light_params: ParamSet = ParamSet()
        self.reverse_orientation: bool = False
        self.current_inside_medium: str = ""
        self.current_outside_medium: str = ""

    def copy(self) -> "_GraphicsState":
        new = _GraphicsState()
        new.__dict__.update(self.__dict__)
        # dict attributes use copy-on-write semantics like the reference's
        # shared_ptr maps: shallow-copy so writes in the child don't leak up.
        new.float_textures = dict(self.float_textures)
        new.spectrum_textures = dict(self.spectrum_textures)
        new.named_materials = dict(self.named_materials)
        return new


class PbrtAPI:
    """One rendering session; equivalent to the pbrt* global functions plus
    their hidden globals, made instance-scoped."""

    def __init__(self):
        self.state = _UNINITIALIZED
        self.scene: Optional[SceneDescription] = None

    # == lifecycle ===========================================================
    def init(self) -> None:
        if self.state != _UNINITIALIZED:
            raise APIError("pbrtInit() has already been called")
        self.state = _OPTIONS_BLOCK
        self.cur_transform = _TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems: Dict[str, _TransformSet] = {}
        self.render = SceneDescription()
        self.render.film_params = ParamSet()
        self.render.filter_params = ParamSet()
        self.render.camera_params = ParamSet()
        self.render.sampler_params = ParamSet()
        self.render.integrator_params = ParamSet()
        self.render.accelerator_params = ParamSet()
        self.camera_to_world = _TransformSet().inverse()
        self.transform_start_time = 0.0
        self.transform_end_time = 1.0
        self.graphics = _GraphicsState()
        self.pushed_graphics: List[_GraphicsState] = []
        self.pushed_transforms: List[_TransformSet] = []
        self.pushed_active_bits: List[int] = []
        self.named_media: Dict[str, ParamSet] = {}
        self.instances: Dict[str, List[PrimitiveRecord]] = {}
        self.current_instance: Optional[List[PrimitiveRecord]] = None

    def cleanup(self) -> None:
        if self.state == _UNINITIALIZED:
            raise APIError("pbrtCleanup() without pbrtInit()")
        self.state = _UNINITIALIZED

    def _verify_initialized(self, func: str) -> None:
        if self.state == _UNINITIALIZED:
            raise APIError(f"pbrtInit() must be called before {func}()")

    def _verify_options(self, func: str) -> None:
        self._verify_initialized(func)
        if self.state == _WORLD_BLOCK:
            raise APIError(f"options cannot be set inside world block; {func}() not allowed")

    def _verify_world(self, func: str) -> None:
        self._verify_initialized(func)
        if self.state == _OPTIONS_BLOCK:
            raise APIError(f"scene description must be inside world block; {func}() not allowed")

    # == transforms ==========================================================
    def _for_active(self, fn) -> None:
        for i in range(MAX_TRANSFORMS):
            if self.active_transform_bits & (1 << i):
                self.cur_transform.t[i] = fn(self.cur_transform.t[i])

    def identity(self) -> None:
        self._verify_initialized("Identity")
        self._for_active(lambda t: xf.Transform())

    def translate(self, dx, dy, dz) -> None:
        self._verify_initialized("Translate")
        self._for_active(lambda t: t * xf.translate([dx, dy, dz]))

    def rotate(self, angle, axis) -> None:
        self._verify_initialized("Rotate")
        self._for_active(lambda t: t * xf.rotate(angle, axis))

    def scale(self, sx, sy, sz) -> None:
        self._verify_initialized("Scale")
        self._for_active(lambda t: t * xf.scale(sx, sy, sz))

    def look_at(self, eye, look, up) -> None:
        self._verify_initialized("LookAt")
        cam2world = xf.look_at(eye, look, up)
        self._for_active(lambda t: t * cam2world.inverse())

    def concat_transform(self, values) -> None:
        self._verify_initialized("ConcatTransform")
        m = xf.from_param_matrix(values)
        self._for_active(lambda t: t * m)

    def set_transform(self, values) -> None:
        self._verify_initialized("Transform")
        m = xf.from_param_matrix(values)
        self._for_active(lambda t: m)

    def coordinate_system(self, name: str) -> None:
        self._verify_initialized("CoordinateSystem")
        self.named_coordinate_systems[name] = self.cur_transform.copy()

    def coord_sys_transform(self, name: str) -> None:
        self._verify_initialized("CoordSysTransform")
        if name in self.named_coordinate_systems:
            self.cur_transform = self.named_coordinate_systems[name].copy()
        else:
            log.warning('couldn\'t find named coordinate system "%s"', name)

    def active_transform(self, which: str) -> None:
        self._verify_initialized("ActiveTransform")
        bits = {"All": ALL_TRANSFORMS_BITS, "StartTime": START_TRANSFORM_BITS,
                "EndTime": END_TRANSFORM_BITS}.get(which)
        if bits is None:
            raise APIError(f"ActiveTransform: unknown time {which!r}")
        self.active_transform_bits = bits

    def transform_times(self, start: float, end: float) -> None:
        self._verify_options("TransformTimes")
        self.transform_start_time = start
        self.transform_end_time = end

    # == options block =======================================================
    def pixel_filter(self, name: str, params: ParamSet) -> None:
        self._verify_options("PixelFilter")
        self.render.filter_name = name
        self.render.filter_params = params

    def film(self, name: str, params: ParamSet) -> None:
        self._verify_options("Film")
        self.render.film_name = name
        self.render.film_params = params

    def sampler(self, name: str, params: ParamSet) -> None:
        self._verify_options("Sampler")
        self.render.sampler_name = name
        self.render.sampler_params = params

    def accelerator(self, name: str, params: ParamSet) -> None:
        self._verify_options("Accelerator")
        if name not in ("bvh", "kdtree", ""):
            # the reference offers bvh + kdtree (api.cpp:771-784)
            log.warning('accelerator "%s" unknown; using the wide BVH',
                        name)
            name = "bvh"
        self.render.accelerator_name = name
        self.render.accelerator_params = params

    def integrator(self, name: str, params: ParamSet) -> None:
        self._verify_options("Integrator")
        self.render.integrator_name = name
        self.render.integrator_params = params

    def camera(self, name: str, params: ParamSet) -> None:
        self._verify_options("Camera")
        self.render.camera_name = name
        self.render.camera_params = params
        self.render.camera_medium = self.graphics.current_outside_medium
        self.camera_to_world = self.cur_transform.inverse()
        self.named_coordinate_systems["camera"] = self.camera_to_world.copy()

    def make_named_medium(self, name: str, params: ParamSet) -> None:
        self._verify_initialized("MakeNamedMedium")
        self.named_media[name] = params
        kind = params.find_one_string("type", "homogeneous")
        import numpy as _np

        from tpurt_torch.scene.records import MediumRecord

        sig_a = params.find_one_spectrum("sigma_a", _np.array([0.0011, 0.0024, 0.014]))
        sig_s = params.find_one_spectrum("sigma_s", _np.array([2.55, 3.21, 3.77]))
        scale = params.find_one_float("scale", 1.0)
        g = params.find_one_float("g", 0.0)
        density = None
        w2m = None
        if kind in ("heterogeneous", "grid"):
            dens = params.find_float_array("density")
            nx = params.find_one_int("nx", 1)
            ny = params.find_one_int("ny", 1)
            nz = params.find_one_int("nz", 1)
            if dens is None or len(dens) != nx * ny * nz:
                log.error('grid medium "%s": density count != nx*ny*nz; '
                          'treating as homogeneous', name)
            else:
                density = _np.asarray(dens, _np.float32).reshape(nz, ny, nx)
                # medium-to-world = CTM * Translate(p0) * Scale(p1-p0)
                # (api.cpp MakeMedium: data2Medium, api.cpp:711-721)
                from tpurt_torch.geom.transform import scale as _scale
                from tpurt_torch.geom.transform import translate as _translate
                p0 = params.find_one_point3("p0", _np.zeros(3))
                p1 = params.find_one_point3("p1", _np.ones(3))
                m2w = (self.cur_transform.t[0] * _translate(p0)
                       * _scale(*(p1 - p0)))
                w2m = m2w.inverse().m.astype(_np.float32)
                st = sig_a * scale + sig_s * scale
                if not _np.allclose(st, st[0], rtol=1e-5):
                    log.warning('grid medium "%s": GridDensityMedium needs '
                                'spectrally uniform attenuation (grid.h '
                                'ctor CHECK); using channel 0', name)
        elif kind != "homogeneous":
            log.warning('medium type "%s" unknown; treating as homogeneous', kind)
        self.render.media[name] = MediumRecord(
            name=name, sigma_a=sig_a * scale, sigma_s=sig_s * scale, g=g,
            density=density, world_to_medium=w2m)

    def medium_interface(self, inside: str, outside: str) -> None:
        self._verify_initialized("MediumInterface")
        self.graphics.current_inside_medium = inside
        self.graphics.current_outside_medium = outside

    # == world block =========================================================
    def world_begin(self) -> None:
        self._verify_options("WorldBegin")
        self.state = _WORLD_BLOCK
        self.cur_transform = _TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems["world"] = self.cur_transform.copy()

    def attribute_begin(self) -> None:
        self._verify_world("AttributeBegin")
        self.pushed_graphics.append(self.graphics.copy())
        self.pushed_transforms.append(self.cur_transform.copy())
        self.pushed_active_bits.append(self.active_transform_bits)

    def attribute_end(self) -> None:
        self._verify_world("AttributeEnd")
        if not self.pushed_graphics:
            raise APIError("unmatched AttributeEnd")
        self.graphics = self.pushed_graphics.pop()
        self.cur_transform = self.pushed_transforms.pop()
        self.active_transform_bits = self.pushed_active_bits.pop()

    def transform_begin(self) -> None:
        self._verify_world("TransformBegin")
        self.pushed_transforms.append(self.cur_transform.copy())
        self.pushed_active_bits.append(self.active_transform_bits)

    def transform_end(self) -> None:
        self._verify_world("TransformEnd")
        if not self.pushed_transforms:
            raise APIError("unmatched TransformEnd")
        self.cur_transform = self.pushed_transforms.pop()
        self.active_transform_bits = self.pushed_active_bits.pop()

    def texture(self, name: str, tex_type: str, tex_class: str, params: ParamSet) -> None:
        self._verify_world("Texture")
        if tex_type not in ("float", "spectrum", "color"):
            raise APIError(f'texture type "{tex_type}" unknown')
        tex_type = "spectrum" if tex_type == "color" else tex_type
        from tpurt_torch.render.textures import make_texture

        rec = make_texture(
            tex_class, tex_type, self.cur_transform.t[0], params,
            self.graphics.float_textures, self.graphics.spectrum_textures,
        )
        if rec is None:
            return
        target = (self.graphics.float_textures if tex_type == "float"
                  else self.graphics.spectrum_textures)
        if name in target:
            log.warning('texture "%s" being redefined', name)
        target[name] = rec

    def material(self, name: str, params: ParamSet) -> None:
        self._verify_world("Material")
        self.graphics.material_name = name
        self.graphics.material_params = params
        self.graphics.current_named_material = None
        # resolve NOW (textures bind at directive time) and share the one
        # record across shapes — pbrtMaterial creates the MaterialInstance
        # immediately (api.cpp:1245-1249)
        self.graphics.current_material_rec = self._create_material(
            name, ParamSet(), params)

    def make_named_material(self, name: str, params: ParamSet) -> None:
        self._verify_world("MakeNamedMaterial")
        mat_name = params.find_one_string("type", "")
        if not mat_name:
            raise APIError("No parameter string \"type\" found in MakeNamedMaterial")
        rec = self._create_material(mat_name, ParamSet(), params)
        if name in self.graphics.named_materials:
            log.warning('named material "%s" redefined', name)
        self.graphics.named_materials[name] = rec

    def named_material(self, name: str) -> None:
        self._verify_world("NamedMaterial")
        self.graphics.current_named_material = name

    def _create_material(self, name: str, geom_params: ParamSet,
                         mat_params: ParamSet) -> Optional[MaterialRecord]:
        from tpurt_torch.render.materials import make_material

        tp = TextureParams(
            geom_params, mat_params,
            self.graphics.float_textures, self.graphics.spectrum_textures,
        )
        rec = make_material(name, tp)
        if rec is not None and rec.name == "mix":
            # resolve the named sub-materials NOW, like api.cpp
            # MakeMaterial (:552-570) passes the actual Materials to
            # MixMaterial
            for slot, key in (("submaterial1", "namedmaterial1"),
                              ("submaterial2", "namedmaterial2")):
                nm = rec.slots.get(key, ("constant", ""))[1]
                sub = self.graphics.named_materials.get(nm)
                if sub is None:
                    log.error('mix material: named material "%s" undefined; '
                              'using matte', nm)
                rec.slots[slot] = ("material", sub)
        return rec

    def _material_for_shape(self, geom_params: ParamSet) -> Optional[MaterialRecord]:
        """GraphicsState::GetMaterialForShape (api.cpp:1479-1491): a shape
        gets a ONE-OFF material only when its params apparently shadow
        material params (shapeMaySetMaterialParameters, api.cpp:1428);
        otherwise it shares the directive's record."""
        g = self.graphics
        if g.current_named_material is not None:
            rec = g.named_materials.get(g.current_named_material)
            if rec is None:
                log.error('named material "%s" not defined; using matte',
                          g.current_named_material)
                return self._create_material("matte", geom_params, ParamSet())
            return rec
        if _shape_may_set_material_parameters(geom_params):
            return self._create_material(g.material_name, geom_params,
                                         g.material_params)
        if g.current_material_rec is None:  # initial default matte
            g.current_material_rec = self._create_material(
                g.material_name, ParamSet(), g.material_params)
        return g.current_material_rec

    def light_source(self, name: str, params: ParamSet) -> None:
        self._verify_world("LightSource")
        self.render.lights.append(
            LightRecord(kind=name, light_to_world=self.cur_transform.t[0],
                        params=params, base_dir=params.base_dir)
        )

    def area_light_source(self, name: str, params: ParamSet) -> None:
        self._verify_world("AreaLightSource")
        self.graphics.area_light = name
        self.graphics.area_light_params = params

    def shape(self, name: str, params: ParamSet) -> None:
        self._verify_world("Shape")
        obj2world = self.cur_transform.t[0]

        # flat/ribbon curves tessellate facing the camera (the reference
        # orients them per ray, curve.cpp:216); the camera world position
        # is known here because Camera precedes WorldBegin
        cam_pos = None
        try:  # camera_to_world is already camera->world (api.cpp:1077)
            cam_pos = self.camera_to_world.t[0].m[:3, 3]
        except Exception:
            cam_pos = None
        shapes = make_shapes(name, obj2world, self.graphics.reverse_orientation,
                             params, camera_pos=cam_pos)
        if not shapes:
            return
        # animated transforms: tessellate the same shape under the END
        # transform too (TransformedPrimitive analog; deterministic
        # tessellation keeps the topology identical)
        shapes_end = [None] * len(shapes)
        if self.cur_transform.is_animated():
            from tpurt_torch.scene.records import QuadricRecord, TriangleMeshRecord

            def _motion_pair(a, b):
                # triangle meshes carry per-vertex deltas; quadrics carry a
                # decomposed TRS pair interpolated per lane at ray time
                # (AnimatedTransform, core/transform.h:412)
                if (isinstance(a, TriangleMeshRecord)
                        and isinstance(b, TriangleMeshRecord)):
                    return len(a.vertices) == len(b.vertices)
                if isinstance(a, QuadricRecord) and isinstance(b, QuadricRecord):
                    return a.kind == b.kind
                return False

            end = make_shapes(name, self.cur_transform.t[1],
                              self.graphics.reverse_orientation, params,
                              camera_pos=cam_pos)
            if (len(end) == len(shapes)
                    and all(_motion_pair(a, b)
                            for a, b in zip(shapes, end))):
                shapes_end = end
            else:
                log.warning('animated "%s": only triangle-mesh and quadric '
                            'shapes support motion; using the start transform',
                            name)
        mat = self._material_for_shape(params)
        params.report_unused(f'in Shape "{name}"')

        area = None
        if self.graphics.area_light is not None:
            ap = self.graphics.area_light_params
            if self.graphics.area_light in ("area", "diffuse"):
                area = AreaLightRecord(
                    L=ap.find_one_spectrum("L", 1.0),
                    scale=ap.find_one_spectrum("scale", 1.0),
                    n_samples=ap.find_one_int("samples", ap.find_one_int("nsamples", 1)),
                    two_sided=ap.find_one_bool("twosided", False),
                )
            else:
                log.warning('area light "%s" unknown', self.graphics.area_light)

        prims = [
            PrimitiveRecord(
                shape=s,
                material=mat,
                area_light=area,
                reverse_orientation=self.graphics.reverse_orientation,
                transform_swaps_handedness=obj2world.swaps_handedness(),
                medium_inside=self.graphics.current_inside_medium,
                medium_outside=self.graphics.current_outside_medium,
                shape_end=se,
            )
            for s, se in zip(shapes, shapes_end)
        ]
        if self.current_instance is not None:
            if area is not None:
                log.warning("area lights not supported with object instancing; ignoring")
            self.current_instance.extend(prims)
        else:
            self.render.primitives.extend(prims)

    def reverse_orientation(self) -> None:
        self._verify_world("ReverseOrientation")
        self.graphics.reverse_orientation = not self.graphics.reverse_orientation

    # == object instancing ====================================================
    def object_begin(self, name: str) -> None:
        self._verify_world("ObjectBegin")
        self.attribute_begin()
        if self.current_instance is not None:
            raise APIError("ObjectBegin called inside of instance definition")
        self.instances[name] = []
        self.current_instance = self.instances[name]

    def object_end(self) -> None:
        self._verify_world("ObjectEnd")
        if self.current_instance is None:
            raise APIError("ObjectEnd called outside of instance definition")
        self.current_instance = None
        self.attribute_end()

    def object_instance(self, name: str) -> None:
        self._verify_world("ObjectInstance")
        if self.current_instance is not None:
            raise APIError("ObjectInstance can't be called inside instance definition")
        if name not in self.instances:
            log.error('unable to find instance named "%s"', name)
            return
        # v1 flattens instances: bake the CTM into copies of the instance
        # primitives (the reference keeps a TransformedPrimitive indirection;
        # primitive.h:92 — indirection table is a v2 item for memory).
        instance_to_world = self.cur_transform.t[0]
        from tpurt_torch.scene.records import QuadricRecord, TriangleMeshRecord

        for prim in self.instances[name]:
            shape = prim.shape
            if isinstance(shape, TriangleMeshRecord):
                new_shape = copy.copy(shape)
                new_shape.vertices = instance_to_world.apply_point(shape.vertices)
                if shape.normals is not None:
                    n = instance_to_world.apply_normal(shape.normals)
                    new_shape.normals = n / np.linalg.norm(n, axis=-1, keepdims=True)
                if shape.tangents is not None:
                    new_shape.tangents = instance_to_world.apply_vector(shape.tangents)
            elif isinstance(shape, QuadricRecord):
                new_shape = copy.copy(shape)
                new_shape.object_to_world = instance_to_world * shape.object_to_world
            else:
                continue
            self.render.primitives.append(
                PrimitiveRecord(
                    shape=new_shape,
                    material=prim.material,
                    area_light=None,
                    reverse_orientation=prim.reverse_orientation,
                    transform_swaps_handedness=(
                        instance_to_world * _as_identity()).swaps_handedness()
                    ^ prim.transform_swaps_handedness,
                )
            )

    def world_end(self) -> SceneDescription:
        self._verify_world("WorldEnd")
        if self.pushed_graphics or self.pushed_transforms:
            log.warning("missing AttributeEnd/TransformEnd at WorldEnd")
            self.pushed_graphics.clear()
            self.pushed_transforms.clear()
            self.pushed_active_bits.clear()
        self.render.camera_to_world = self.camera_to_world.t[0]
        if self.camera_to_world.is_animated():
            self.render.camera_to_world_end = self.camera_to_world.t[1]
        self.render.transform_times = (self.transform_start_time,
                                       self.transform_end_time)
        self.state = _OPTIONS_BLOCK
        self.scene = self.render
        # Reset world state like the reference's graphicsState = GraphicsState()
        self.cur_transform = _TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        return self.scene


def _as_identity():
    return xf.Transform()


def load_scene(path: str) -> SceneDescription:
    """Parse a .pbrt file into a SceneDescription (pbrtInit + pbrtParseFile
    + implicit WorldEnd-capture)."""
    from tpurt_torch.scene.parser import parse_file

    api = PbrtAPI()
    api.init()
    parse_file(path, api)
    if api.scene is None:
        raise APIError(f"{path}: no WorldEnd seen")
    return api.scene


def load_scene_string(text: str, base_dir: str = ".") -> SceneDescription:
    from tpurt_torch.scene.parser import parse_string

    api = PbrtAPI()
    api.init()
    parse_string(text, api, base_dir=base_dir)
    if api.scene is None:
        raise APIError("no WorldEnd seen")
    return api.scene
