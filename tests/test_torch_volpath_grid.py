"""Volpath through a grid medium: a ``Material "none"`` sphere holding a
scattering heterogeneous medium (a seeded 4x5x6 density) before a lit
wall.  Camera rays cross it by delta tracking, shadow rays by ratio
tracking inside the boundary walk.  The port's CLI render against
tpurt's on the CPU.  One cold tpurt volpath jit.  Bounds:
test_torch_media.py's assert_standing_bounds."""

import numpy as np
import torch

from test_torch_media import assert_standing_bounds, render_pair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def grid_scene():
    dens = np.random.default_rng(0).uniform(0, 1, (6, 5, 4))
    values = " ".join("%g" % v for v in dens.astype(np.float32).ravel())
    return f"""
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "random" "integer pixelsamples" [4]
Integrator "volpath" "integer maxdepth" [4]
MakeNamedMedium "smoke" "string type" "heterogeneous"
  "integer nx" [4] "integer ny" [5] "integer nz" [6]
  "float density" [{values}]
  "point p0" [-1 -1 2] "point p1" [1 1 4]
  "rgb sigma_a" [0.5 0.5 0.5] "rgb sigma_s" [1.5 1.5 1.5]
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "color I" [10 10 10] "point from" [0 3 3]
AttributeBegin
  Material "none"
  MediumInterface "smoke" ""
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
Material "matte" "color Kd" [.6 .6 .6]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-3 -3 6  3 -3 6  3 3 6  -3 3 6]
WorldEnd
"""


def test_grid_medium_matches_tpurt(tmp_path):
    want, job, got = render_pair(grid_scene(), tmp_path)
    assert job.scene.has_grid_media and job.scene.has_null_boundaries
    assert_standing_bounds(got, want)
