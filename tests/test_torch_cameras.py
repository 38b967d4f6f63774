"""The orthographic and environment cameras against tpurt on the CPU:
camera_tables against make_camera's fields, generate_rays at random film
and lens points (with a thin lens for the orthographic camera), and the
ray differentials the integrator takes from them.

Bounds: the tables bit for bit; origins and directions within 1e-5
(atol, and rtol 1e-6 for origins).  Inputs come from numpy with a fixed
seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.geom.transform import look_at as tpurt_look_at
from tpurt.render.camera import make_camera
from tpurt.render.integrator import (camera_ray_differentials as
                                     tpurt_differentials)
from tpurt.scene.paramset import ParamSet as TParamSet
from tpurt_torch.geom.transform import look_at
from tpurt_torch.render.camera import camera_from_tables, camera_tables
from tpurt_torch.render.integrator import camera_ray_differentials
from tpurt_torch.scene.paramset import ParamSet

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

CASES = {
    "orthographic": [("float", "screenwindow", [-3, 3, -2, 2])],
    "orthographic_lens": [("float", "lensradius", [0.2]),
                          ("float", "focaldistance", [4.0])],
    "environment": [],
    "perspective": [("float", "fov", [50.0])],
}
RES = (48, 32)


def _cams(case):
    name = case.split("_")[0]
    tps, pps = TParamSet(), ParamSet()
    for typ, key, val in CASES[case]:
        tps.add(typ, key, val)
        pps.add(typ, key, val)
    eye, at, up = [1, 2, -5], [0, 0.5, 0], [0, 1, 0]
    want = make_camera(name, tps, tpurt_look_at(eye, at, up).inverse(), *RES)
    tab = camera_tables(name, pps, look_at(eye, at, up).inverse(), *RES)
    return want, tab


@pytest.mark.parametrize("case", sorted(CASES))
def test_camera_tables_match_make_camera(case):
    want, tab = _cams(case)
    for k, v in tab.items():
        w = getattr(want, k)
        if isinstance(v, np.ndarray):
            assert v.tobytes() == np.asarray(w).tobytes(), k
        else:
            assert v == w, k


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_rays_match_tpurt(case):
    want_cam, tab = _cams(case)
    cam = camera_from_tables(tab, "cpu")
    rng = np.random.default_rng(sorted(CASES).index(case))
    n = 4096
    p_film = (rng.uniform(size=(n, 2)) * RES).astype(np.float32)
    p_lens = rng.uniform(size=(n, 2)).astype(np.float32)
    want = want_cam.generate_rays(jnp.asarray(p_film), jnp.asarray(p_lens))
    got = cam.generate_rays(torch.as_tensor(p_film), torch.as_tensor(p_lens))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the differentials of the camera hits (camera.cpp:46-66)
    want_d = tpurt_differentials(want_cam, None, jnp.asarray(p_film),
                                 jnp.asarray(p_lens), None, 8)
    got_d = camera_ray_differentials(cam, torch.as_tensor(p_film),
                                     torch.as_tensor(p_lens), got[0], got[1],
                                     8)
    for g, w in zip(got_d, want_d):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


def test_environment_camera_covers_the_sphere():
    """Rows run from the camera's +y pole to its -y pole, columns once
    around: the directions of a full frame integrate to the sphere's
    solid angle with the sin(theta) weight."""
    _, tab = _cams("environment")
    cam = camera_from_tables(tab, "cpu")
    ys, xs = torch.meshgrid(torch.arange(RES[1]) + 0.5,
                            torch.arange(RES[0]) + 0.5, indexing="ij")
    p = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    _, d, _ = cam.generate_rays(p, torch.zeros_like(p))
    c2w = torch.as_tensor(tab["camera_to_world"][:3, :3])
    d_cam = d @ c2w  # back to camera space (c2w is a rotation here)
    np.testing.assert_allclose(d_cam[:RES[0], 1].numpy(),
                               np.cos(np.pi * 0.5 / RES[1]), rtol=1e-5)
    np.testing.assert_allclose(d.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
