"""Intermediate scene representation produced by the API state machine.

Where the reference's pbrtWorldEnd immediately constructs Scene + Integrator
objects and renders (api.cpp:1591-1650), tpurt's API builds this declarative
SceneDescription; tpurt.render.build then flattens it into device SoA
tensors (vertex/index/material tables + BVH) and runs the integrator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpurt_torch.geom.transform import Transform
from tpurt_torch.scene.paramset import ParamSet


@dataclasses.dataclass
class TriangleMeshRecord:
    """World-space triangle mesh (the reference transforms mesh vertices to
    world space at creation; shapes/triangle.cpp mesh ctor)."""

    vertices: np.ndarray  # (V, 3) float
    indices: np.ndarray  # (T, 3) int
    normals: Optional[np.ndarray] = None  # (V, 3)
    uvs: Optional[np.ndarray] = None  # (V, 2)
    tangents: Optional[np.ndarray] = None  # (V, 3)
    alpha_texture: Optional[Any] = None
    # per-triangle source face ids ("integer faceIndices",
    # triangle.cpp:710-716) — ptex textures look faces up by this
    face_indices: Optional[np.ndarray] = None  # (T,) int
    kind: str = "trianglemesh"


@dataclasses.dataclass
class CurveRecord:
    """Ray-traced cubic Bezier curve spans, pre-split at build time.

    The reference intersects each Curve prim by recursive splitting at
    render time (shapes/curve.cpp:232-374, refinement depth from the
    width/20 criterion at curve.cpp:204-225).  The TPU design moves the
    data-dependent part of that recursion to the BUILD: every span below
    is already subdivided far enough that the residual refinement depth
    is <= the device kernel's fixed unroll (intersect.CURVE_LEAF_SUBDIV),
    so the device leaf test is a branch-free fixed-depth subdivision +
    the reference's depth-0 segment test.  Control points are WORLD
    space (widths scaled by the transform's uniform scale).

    Arrays are per-span (S spans total for this shape):
      cp (S, 4, 3)  cubic Bezier control points of the span
      width (S, 2)  curve width at the span's two ends
      u (S, 2)      span's parameter range within its segment [0,1]
      normals (S, 2, 3) or None  ribbon frame normals at span ends
      ctype: "flat" | "cylinder" | "ribbon"
    """

    cp: np.ndarray
    width: np.ndarray
    u: np.ndarray
    normals: Optional[np.ndarray] = None
    ctype: str = "flat"
    kind: str = "curve"


@dataclasses.dataclass
class QuadricRecord:
    """Analytic quadric kept in object space with its transform pair.
    Covers sphere/cylinder/disk/cone/paraboloid/hyperboloid via ``kind``."""

    kind: str
    object_to_world: Transform
    radius: float = 1.0
    z_min: float = -1.0
    z_max: float = 1.0
    phi_max: float = 360.0  # degrees
    # disk-specific
    height: float = 0.0
    inner_radius: float = 0.0
    # hyperboloid/cone-specific
    p1: Optional[np.ndarray] = None
    p2: Optional[np.ndarray] = None


@dataclasses.dataclass
class MaterialRecord:
    """Resolved material: factory name + texture-or-constant slots.
    ``slots`` maps param name -> ("constant", value) | ("texture", TextureRecord)."""

    name: str
    slots: Dict[str, Any] = dataclasses.field(default_factory=dict)
    index: int = -1  # assigned at scene build


@dataclasses.dataclass
class TextureRecord:
    name: str  # texture class: constant/scale/checkerboard/imagemap/...
    tex_type: str  # "float" | "spectrum"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    world_to_texture: Optional[Transform] = None


@dataclasses.dataclass
class AreaLightRecord:
    """DiffuseAreaLight attached to one shape (lights/diffuse.{h,cpp})."""

    L: np.ndarray  # (3,) radiance
    scale: np.ndarray  # (3,)
    n_samples: int = 1
    two_sided: bool = False


@dataclasses.dataclass
class LightRecord:
    """Non-area light: point/spot/distant/infinite/projection/goniometric."""

    kind: str
    light_to_world: Transform
    params: ParamSet = None
    base_dir: str = "."


@dataclasses.dataclass
class MediumRecord:
    """Participating medium (media/homogeneous.cpp, media/grid.cpp)."""

    name: str
    sigma_a: np.ndarray  # (3,) absorption (already scaled)
    sigma_s: np.ndarray  # (3,) scattering
    g: float = 0.0  # Henyey-Greenstein asymmetry
    index: int = -1
    # grid media (GridDensityMedium): density lattice + medium transform
    density: Optional[np.ndarray] = None  # (nz, ny, nx) f32
    world_to_medium: Optional[np.ndarray] = None  # (4,4)


@dataclasses.dataclass
class PrimitiveRecord:
    shape: Any  # TriangleMeshRecord | QuadricRecord
    material: Optional[MaterialRecord]
    area_light: Optional[AreaLightRecord] = None
    reverse_orientation: bool = False
    transform_swaps_handedness: bool = False
    medium_inside: str = ""
    medium_outside: str = ""
    # animated transforms (TransformedPrimitive): the same shape under
    # the END transform; None for static prims
    shape_end: Any = None



@dataclasses.dataclass
class SceneDescription:
    film_params: ParamSet = None
    film_name: str = "image"
    filter_name: str = "box"
    filter_params: ParamSet = None
    camera_name: str = "perspective"
    camera_params: ParamSet = None
    camera_to_world: Transform = None
    # animated camera (AnimatedTransform endpoints): end transform when
    # the CTM pair differs, plus TransformTimes
    camera_to_world_end: Transform = None
    transform_times: Tuple[float, float] = (0.0, 1.0)
    sampler_name: str = "halton"
    sampler_params: ParamSet = None
    integrator_name: str = "path"
    integrator_params: ParamSet = None
    accelerator_name: str = "bvh"
    accelerator_params: ParamSet = None
    primitives: List[PrimitiveRecord] = dataclasses.field(default_factory=list)
    lights: List[LightRecord] = dataclasses.field(default_factory=list)
    media: Dict[str, "MediumRecord"] = dataclasses.field(default_factory=dict)
    camera_medium: str = ""  # medium the camera sits in

    @property
    def resolution(self) -> Tuple[int, int]:
        ps = self.film_params or ParamSet()
        return (
            ps.find_one_int("xresolution", 1280),
            ps.find_one_int("yresolution", 720),
        )

    @property
    def output_filename(self) -> str:
        ps = self.film_params or ParamSet()
        return ps.find_one_string("filename", "pbrt.exr")
