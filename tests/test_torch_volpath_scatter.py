"""Volpath through a scattering homogeneous fog (test_media.py's glowing
fog, with a ground quad and g = 0.3), the port's CLI render against
tpurt's on the CPU: in-scattered light from medium vertices, the phase
function's NEE and continuation.  One cold tpurt volpath jit.  Bounds:
test_torch_media.py's assert_standing_bounds."""

import torch

from test_torch_media import assert_standing_bounds, render_pair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

SCATTER = """
Film "image" "integer xresolution" [20] "integer yresolution" [20]
Sampler "halton" "integer pixelsamples" [8]
Integrator "volpath" "integer maxdepth" [3]
MakeNamedMedium "fog" "string type" "homogeneous"
  "rgb sigma_a" [0.01 0.02 0.01] "rgb sigma_s" [0.3 0.25 0.2] "float g" [0.3]
MediumInterface "" "fog"
Camera "perspective" "float fov" [60]
WorldBegin
LightSource "point" "color I" [20 20 20] "point from" [0 0 4]
Material "matte" "color Kd" [.5 .5 .5]
Shape "trianglemesh" "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def test_scattering_fog_matches_tpurt(tmp_path):
    want, _, got = render_pair(SCATTER, tmp_path)
    assert_standing_bounds(got, want)
