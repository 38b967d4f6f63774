"""The five quadrics the slice adds against tpurt on the CPU: part 3 of the
cases of test_torch_quadrics.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_quadrics.py.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render import interaction as pinter
from tpurt_torch.render import intersect as pisect
from tpurt_torch.render.driver import build_job
from tpurt_torch.render.sampling_warps import build_onb
from tpurt_torch.render.sampling_warps import to_world
from tpurt_torch.scene import load_scene_string
from test_torch_quadrics import (  # noqa: F401  (fixtures among them)
    SHAPES,
    _rays,
    _scene,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_quadric_reintersection(name):
    """Rays re-spawned from offset hit points do not re-hit the same
    surface at tiny t (shapes.cpp:154-544)."""
    rng = np.random.default_rng(12)
    geo = build_job(load_scene_string(_scene(SHAPES[name])), "cpu").scene.geo
    o, d = (torch.as_tensor(a) for a in _rays(rng, 512))
    hit = pisect.intersect_closest(geo, o, d, np.inf, traverse_wide)
    got = hit.prim >= 0
    assert got.sum() > 50, (name, int(got.sum()))
    si = pinter.compute_interaction(geo, hit, o, d)
    t_, b_ = build_onb(si.ng)
    u1 = torch.as_tensor(rng.uniform(0.05, 0.95, 512).astype(np.float32))
    u2 = torch.as_tensor(rng.uniform(0, 1, 512).astype(np.float32))
    local = torch.stack([torch.sqrt(1 - u1) * torch.cos(2 * np.pi * u2),
                         torch.sqrt(1 - u1) * torch.sin(2 * np.pi * u2),
                         torch.sqrt(u1)], -1)
    w = to_world(t_, b_, si.ng, local)
    o2 = pinter.offset_ray_origin(si.p, si.ng, w)
    hit2 = pisect.intersect_closest(geo, o2, w, np.inf, traverse_wide)
    self_hit = got & torch.isfinite(hit2.t) & (hit2.t < 1e-3)
    assert int(self_hit.sum()) == 0, (name, int(self_hit.sum()))
