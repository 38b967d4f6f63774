"""The port's SPPM render against tpurt's on the small caustic scene
(tpurt_torch.testscenes.write_caustic "small": 48x48, 4 iterations,
radius 0.25, one cold tpurt jit), and the port alone on the analytic
scenes of tpurt's tests/test_sppm.py (16x16): the furnace with its
closed form and the area light seen directly.

Bounds: the image means within 1e-3 relative, >= 99% of pixels within
1e-3 abs + 1e-3 rel (the standing render bounds); the furnace mean within
0.05 of sum_{k=1..5} 0.5^k; the emitter's centre pixel within 0.05 of its
L = 4 (tpurt's own bounds for these scenes).
"""

import numpy as np
import pytest
import torch

from tpurt.render.driver import render as tpurt_render
from tpurt.scene import load_scene as tpurt_load_scene
from tpurt_torch.render.driver import render
from tpurt_torch.scene import load_scene, load_scene_string
from tpurt_torch.testscenes import write_caustic
from tpurt_torch.utils.stats import STATS

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

FURNACE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "sppm" "integer iterations" [8] "float radius" [0.25]
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "color I" [3.1415926 3.1415926 3.1415926]
Material "matte" "color Kd" [.5 .5 .5] "float sigma" [0]
ReverseOrientation
Shape "sphere" "float radius" [1]
WorldEnd
"""

AREA = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "sppm" "integer iterations" [2] "float radius" [0.02]
Camera "perspective" "float fov" [45]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [4 4 4]
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""


def test_render_sppm_matches_tpurt(tmp_path):
    path = write_caustic(str(tmp_path / "c.pbrt"), "small")
    want, _ = tpurt_render(tpurt_load_scene(path), progress=False)
    want = np.asarray(want, np.float64)
    STATS.clear()
    got, job = render(load_scene(path), device="cpu")
    assert job.cfg.name == "sppm" and got.shape == (48, 48, 3)
    assert STATS.counters["SPPM/Photon paths followed"] == 4 * 48 * 48
    d = np.abs(got - want)
    frac = (d <= 1e-3 + 1e-3 * np.abs(want)).all(axis=-1).mean()
    mrel = abs(got.mean() - want.mean()) / want.mean()
    assert np.isfinite(got).all() and mrel < 1e-3 and frac >= 0.99, (
        mrel, frac)


def test_furnace_closed_form():
    # the camera at the light inside a Kd = .5 sphere: direct light 0.5,
    # photons at depths 1-4 add 0.5^2 .. 0.5^5 (tpurt's test_sppm.py)
    img, _ = render(load_scene_string(FURNACE), device="cpu")
    want = sum(0.5 ** k for k in range(1, 6))
    assert np.isfinite(img).all()
    assert abs(float(img.mean()) - want) < 0.05, (float(img.mean()), want)


def test_area_light_seen_directly():
    # pixels on the emitter read L through Ld (sppm.cpp:195)
    img, _ = render(load_scene_string(AREA), device="cpu")
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img[8, 8], 4.0, atol=0.05)
    assert img[0, 0].max() == pytest.approx(0.0)
