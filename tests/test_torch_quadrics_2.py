"""The five quadrics the slice adds against tpurt on the CPU: part 2 of the
cases of test_torch_quadrics.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_quadrics.py.
"""

import numpy as np
import torch

from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render import intersect as pisect
from tpurt_torch.render.driver import build_job
from tpurt_torch.scene import load_scene_string
from test_torch_quadrics import (  # noqa: F401  (fixtures among them)
    _rays,
    quadric,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_any_hit_sees_every_quadric(quadric):
    """intersect_any: occluded exactly where the closest hit lies before
    t_max."""
    _, _, pjob, (o, d) = quadric
    geo = pjob.scene.geo
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    closest = pisect.intersect_closest(geo, ot, dt, np.inf, traverse_wide)
    t_max = torch.full((len(o),), 4.5)
    occ = pisect.intersect_any(geo, ot, dt, t_max, traverse_wide)
    assert torch.equal(occ, (closest.prim >= 0) & (closest.t < t_max))


def test_cylinder_disk_quadrics():
    text = """Film "image" "integer xresolution" [4] "integer yresolution" [4]
Camera "perspective"
WorldBegin
Shape "cylinder" "float radius" [1] "float zmin" [-1] "float zmax" [1]
Translate 4 0 0
Shape "disk" "float radius" [1] "float height" [0]
WorldEnd
"""
    geo = build_job(load_scene_string(text), "cpu").scene.geo
    o = torch.tensor([[-5, 0, 0], [-5, 0, 2], [4, 0.5, -5], [4, 1.5, -5]],
                     dtype=torch.float32)
    d = torch.tensor([[1, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0, 1]],
                     dtype=torch.float32)
    hit = pisect.intersect_closest(geo, o, d, 1e8, traverse_wide)
    assert (hit.prim >= 0).tolist() == [True, False, True, False]
    np.testing.assert_allclose(hit.t[[0, 2]].numpy(), [4.0, 5.0], rtol=1e-4)


def test_hyperboloid_matches_implicit():
    text = """Film "image" "integer xresolution" [8] "integer yresolution" [8]
Camera "perspective" "float fov" [45]
WorldBegin
Material "matte" "color Kd" [.5 .5 .5]
Translate 0 0 4
Rotate 90 1 0 0
Shape "hyperboloid" "point p1" [1 0 -1] "point p2" [1.5 0 1]
WorldEnd
"""
    geo = build_job(load_scene_string(text), "cpu").scene.geo
    o, d = _rays(np.random.default_rng(8), 256, 0.5)
    hit = pisect.intersect_closest(geo, torch.as_tensor(o),
                                   torch.as_tensor(d), np.inf, traverse_wide)
    got = hit.prim.numpy() >= 0
    assert got.sum() > 20, got.sum()
    kind, qi = geo.quads[0]
    w2o = geo.quad_w2o[qi].numpy()
    ah, ch = geo.quad_params[qi][6:8].tolist()
    p_w = o[got] + hit.t.numpy()[got][:, None] * d[got]
    p_o = (w2o[:3, :3] @ p_w.T).T + w2o[:3, 3]
    f = ah * (p_o[:, 0] ** 2 + p_o[:, 1] ** 2) - ch * p_o[:, 2] ** 2
    np.testing.assert_allclose(f, 1.0, atol=5e-3)
