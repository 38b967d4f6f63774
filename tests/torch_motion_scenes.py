"""Scenes shared by the tests of the motion blur, curves and hair slice
(frame E): small frames of each part of it, rendered by tpurt and by the
port's CLI on the CPU (render_both, check_close and the standing bounds
in torch_material_scenes).

- MOTION: a camera dollying over the shutter (TransformTimes 0 1), a quad
  mesh translating and a partial sphere rotating and rising under an area
  light: the motion leaves, the shading lerp, the quadric slerp and the
  animated camera.
- CURVES_HAIR: frame E's curves without motion: cylinder fibers under
  Material "hair", ribbons with normals under a second hair, flat curves
  under matte, over a matte ground.
- TANGENT: two metal quads whose u and v roughness differ, one carrying
  "vector S" along its diagonal: the mesh tangent frame.
"""

import numpy as np

from tpurt_torch.testscenes import _curves_text, hair_fibers

HEAD = """Film "image" "integer xresolution" [24] "integer yresolution" [20]
Sampler "halton" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [4]
"""

MOTION = HEAD + """TransformTimes 0 1
LookAt 0 2 -8  0 0.5 0  0 1 0
ActiveTransform EndTime
Translate 0.3 0 -0.3
ActiveTransform All
Camera "perspective" "float fov" [45] "float shutteropen" [0]
  "float shutterclose" [1]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [20 20 20]
  Translate 0 5 -2
  Shape "sphere" "float radius" [0.8]
AttributeEnd
Material "matte" "color Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "point P" [-10 0 -10  10 0 -10  10 0 10  -10 0 10]
  "integer indices" [0 2 1  0 3 2]
AttributeBegin
  Material "plastic" "color Kd" [0.5 0.2 0.2] "float roughness" [0.1]
  Translate -1.5 0.2 0
  ActiveTransform EndTime
  Translate 1.2 0.3 0
  ActiveTransform All
  Shape "trianglemesh" "point P" [-0.6 0 -0.6  0.6 0 -0.6  0.6 1.2 0
    -0.6 1.2 0] "integer indices" [0 1 2  0 2 3]
    "normal N" [0 0.5 -1  0 0.5 -1  0 0.5 -1  0 0.5 -1]
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.2 0.5 0.3]
  Translate 1.6 0.8 0.5
  ActiveTransform EndTime
  Translate 0 0.4 0
  Rotate 50 0 1 0
  ActiveTransform All
  Rotate -90 1 0 0
  Shape "sphere" "float radius" [0.7] "float phimax" [250]
AttributeEnd
WorldEnd
"""


def curves_hair_scene() -> str:
    fibers = _curves_text(hair_fibers(12) * np.array([0.5, 1.0, 0.5])
                          + np.array([0.0, 0.0, 2.2]), "cylinder", 0.05,
                          0.02)
    rib = np.array([[[0.9, 0.1, -0.8], [1.1, 0.5, -0.9], [1.3, 0.9, -1.1],
                     [1.5, 1.3, -1.4]]])
    rib_n = np.array([[[0.0, 0.0, -1.0], [-0.6, 0.0, -0.8]]])
    flat = np.array([[[-1.6, 0.1, -1.0], [-1.4, 0.5, -1.0],
                      [-1.2, 0.9, -1.0], [-1.0, 1.3, -1.0]]])
    return HEAD + f"""LookAt 0 1.5 -6  0 0.7 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "distant" "point from" [-2 6 -5] "point to" [0 0 0]
  "color L" [1.2 1.15 1.05]
AttributeBegin
  AreaLightSource "area" "color L" [20 20 20]
  Translate 2 5 -3
  Shape "sphere" "float radius" [0.8]
AttributeEnd
Material "matte" "color Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "point P" [-10 0 -10  10 0 -10  10 0 10  -10 0 10]
  "integer indices" [0 2 1  0 3 2]
AttributeBegin
  Material "hair" "float eumelanin" [1.3]
{fibers}AttributeEnd
AttributeBegin
  Material "hair" "color color" [0.7 0.5 0.3]
{_curves_text(rib, "ribbon", 0.3, 0.15, rib_n)}AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.7 0.6 0.2]
{_curves_text(flat, "flat", 0.25, 0.1)}AttributeEnd
WorldEnd
"""


TANGENT = HEAD + """LookAt 0 1.5 -5  0 0.8 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "point from" [1 3 -3] "color I" [12 12 12]
AttributeBegin
  AreaLightSource "area" "color L" [8 8 8]
  Translate -2 4 -2
  Shape "sphere" "float radius" [0.5]
AttributeEnd
Material "metal" "float uroughness" [0.02] "float vroughness" [0.4]
Shape "trianglemesh" "point P" [-2 0 0  -0.1 0 0  -0.1 1.8 0.4
  -2 1.8 0.4] "integer indices" [0 1 2  0 2 3]
  "vector S" [0.7 0.7 0  0.7 0.7 0  0.7 0.7 0  0.7 0.7 0]
Shape "trianglemesh" "point P" [0.1 0 0  2 0 0  2 1.8 0.4  0.1 1.8 0.4]
  "integer indices" [0 1 2  0 2 3]
Material "matte" "color Kd" [0.4 0.4 0.4]
Shape "trianglemesh" "point P" [-10 0 -10  10 0 -10  10 0 10  -10 0 10]
  "integer indices" [0 2 1  0 3 2]
WorldEnd
"""
