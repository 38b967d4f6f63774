"""Volpath through homogeneous fog, the port's CLI render against tpurt's
on the CPU (test_media.py's absorbing-fog scene, at 8 spp), and volpath on
a scene without media, which both packages render with the path
integrator.  One cold tpurt volpath jit.  Bounds: test_torch_media.py's
assert_standing_bounds."""

import numpy as np
import torch

from tpurt_torch.render.driver import render
from tpurt_torch.scene import load_scene_string
from test_torch_media import assert_standing_bounds, render_pair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

FOG = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "random" "integer pixelsamples" [8]
Integrator "volpath" "integer maxdepth" [2]
MakeNamedMedium "fog" "string type" "homogeneous"
  "rgb sigma_a" [0.2 0.2 0.2] "rgb sigma_s" [0 0 0]
MediumInterface "" "fog"
Camera "perspective" "float fov" [30]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [4 4 4] "bool twosided" "true"
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""


def test_absorbing_fog_matches_tpurt(tmp_path):
    """The camera in an absorbing fog sees the emitter at distance 2
    attenuated by Beer-Lambert; the port matches tpurt's image."""
    want, _, got = render_pair(FOG, tmp_path)
    assert_standing_bounds(got, want)
    hot = got[..., 0][got[..., 0] > 1.0]
    assert len(hot) > 30
    np.testing.assert_allclose(hot.mean(), 4.0 * np.exp(-0.2 * 2.0),
                               rtol=0.08)


def test_volpath_without_media_is_the_path_step():
    """A volpath scene without media renders through the path step (7
    dims a bounce, as tpurt's volpath_radiance falls back to
    path_radiance): the image equals the path integrator's bit for bit."""
    scene = """
    Film "image" "integer xresolution" [16] "integer yresolution" [16]
    Sampler "halton" "integer pixelsamples" [4]
    Integrator "{integ}" "integer maxdepth" [3]
    Camera "perspective" "float fov" [60]
    WorldBegin
    LightSource "point" "color I" [60 60 60] "point from" [0 3 2]
    Material "matte" "color Kd" [.6 .6 .6]
    Translate 0 0 4
    Shape "sphere" "float radius" [1]
    WorldEnd
    """
    img_v, job = render(load_scene_string(scene.format(integ="volpath")),
                        device="cpu")
    img_p, _ = render(load_scene_string(scene.format(integ="path")),
                      device="cpu")
    assert job.cfg.name == "volpath" and not job.scene.has_media
    assert img_v.mean() > 0.01
    np.testing.assert_array_equal(img_v, img_p)
