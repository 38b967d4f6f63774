"""The ao integrator: the port's CLI render of the stand-in under
``Integrator "ao"`` (its small size, 64 occlusion rays a hit) against
tpurt's on the CPU, cosine-weighted and uniform, and tpurt's timeless
occlusion rays on a moving scene.  Two cold tpurt ao jits, no volpath.
Bounds: test_torch_media.py's assert_standing_bounds; the first run
measured equal images under both samplings."""

import numpy as np
import pytest
import torch

from tpurt_torch.render.driver import render
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import standin_scene
from test_torch_media import assert_standing_bounds, render_pair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("cossample", ["true", "false"])
def test_ao_matches_tpurt(cossample, tmp_path):
    text = standin_scene("small", integrator="ao").replace(
        'Integrator "ao"', f'Integrator "ao" "bool cossample" "{cossample}"')
    want, job, got = render_pair(text, tmp_path)
    assert job.cfg.ao_samples == 64
    assert job.cfg.ao_cos_sample == (cossample == "true")
    assert_standing_bounds(got, want)
    assert got.max() <= 1.0 + 1e-5 and got.min() >= 0.0


def test_ao_sees_a_moving_scene_at_time_zero():
    """tpurt's ao passes no ray time (integrator.py:1155-1175), so a mesh
    moving over the shutter occludes as it stands at time 0: the image
    equals the one of the mesh held at its start (a fault of tpurt's that
    the port shares, ROADMAP Queue 3)."""
    scene = """
    Film "image" "integer xresolution" [12] "integer yresolution" [12]
    Sampler "halton" "integer pixelsamples" [2]
    Integrator "ao" "integer nsamples" [8]
    Camera "perspective" "float fov" [60]
    WorldBegin
    Shape "trianglemesh" "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]
      "integer indices" [0 1 2 2 3 0]
    Translate 0 0 4
    {motion}
    Shape "trianglemesh" "point P" [-1 -1 -1  1 -1 -1  0 1 -1]
      "integer indices" [0 1 2]
    WorldEnd
    """
    moving = 'ActiveTransform EndTime\nTranslate 3 0 0\nActiveTransform All'
    img_m, job = render(load_scene_string(scene.format(motion=moving)),
                        device="cpu")
    img_s, _ = render(load_scene_string(scene.format(motion="")),
                      device="cpu")
    assert job.scene.has_motion
    np.testing.assert_array_equal(img_m, img_s)
