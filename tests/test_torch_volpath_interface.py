"""Volpath across a null-material boundary (test_media.py's
medium-interface scene): the camera ray crosses the ``Material "none"``
sphere into and out of its smoke, and shadow rays walk the boundary.
The port's CLI render against tpurt's on the CPU.  One cold tpurt volpath
jit.  Bounds: test_torch_media.py's assert_standing_bounds."""

import torch

from test_torch_media import assert_standing_bounds, render_pair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

INTERFACE = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "random" "integer pixelsamples" [8]
Integrator "volpath" "integer maxdepth" [4]
MakeNamedMedium "smoke" "string type" "homogeneous"
  "rgb sigma_a" [0.4 0.4 0.4] "rgb sigma_s" [0.2 0.2 0.2]
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "color I" [6 6 6] "point from" [0 2 2]
AttributeBegin
  AreaLightSource "area" "color L" [4 4 4] "bool twosided" "true"
  Translate 0 0 6
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  Material "none"
  MediumInterface "smoke" ""
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""


def test_interface_crossing_matches_tpurt(tmp_path):
    want, job, got = render_pair(INTERFACE, tmp_path)
    assert job.scene.has_null_boundaries
    assert_standing_bounds(got, want)
    # the emitter seen through 2 units of smoke is dimmed below 4
    hot = got[..., 0][got[..., 0] > 0.5]
    assert len(hot) > 20 and 1.0 < hot.mean() < 3.6
