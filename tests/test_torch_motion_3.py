"""Shading at a ray's time against tpurt on the CPU: compute_interaction
on frame E's hits with the rays' shutter times (the lerped triangle
vertices and normals, the animated quadric's frame, the curve and tangent
terms), against tpurt's compute_interaction on the same hits.

Bounds: p, ng, ns, uv, ss, dpdu, dpdv and p_eps within 2e-5 (abs + rel;
tpurt runs jitted, the quadric's frame goes through its LU inverse);
material and validity equal.  Inputs come from numpy with a fixed seed.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.render import interaction as tint
from tpurt.render import intersect as tix
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.render import interaction as pint
from tpurt_torch.render.driver import build_job
from tpurt_torch.render.intersect import Hit
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import motion_hair_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_interaction_at_time_matches_tpurt():
    text = motion_hair_scene("small")
    tjob = tpurt_build_job(tpurt_load_scene_string(text))
    pjob = build_job(load_scene_string(text), "cpu")
    assert pjob.scene.has_tangents and pjob.scene.has_motion
    rng = np.random.default_rng(41)
    n = 4096
    o = np.stack([rng.uniform(-6, 6, n), rng.uniform(0.2, 5, n),
                  rng.uniform(-12, -7, n)], -1).astype(np.float32)
    aim = np.stack([rng.uniform(-5, 5, n), rng.uniform(0, 2.5, n),
                    rng.uniform(-6, 4, n)], -1)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    time = rng.uniform(0, 1, n).astype(np.float32)
    tg = tjob.scene.geo
    h = tix.intersect_closest(tg, jnp.asarray(o), jnp.asarray(d), jnp.inf,
                              time=jnp.asarray(time))
    want = tint.compute_interaction(tg, h, jnp.asarray(o), jnp.asarray(d),
                                    tangents=True, dpduv=True,
                                    time=jnp.asarray(time))
    hit = Hit(*(torch.as_tensor(np.array(x)) for x in h))
    got = pint.compute_interaction(pjob.scene.geo, hit, torch.as_tensor(o),
                                   torch.as_tensor(d), tangents=True,
                                   dpduv=True, time=torch.as_tensor(time))
    prim = np.asarray(h.prim)
    ptype = np.asarray(tg.prim_type)[np.maximum(prim, 0)]
    valid = prim >= 0
    # triangles (moving and static), the animated sphere and curves
    assert {0, 1, 7} <= set(ptype[valid].tolist())
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.material_id.numpy(),
                                  np.asarray(want.material_id))
    for f in ("p", "ng", "ns", "uv", "ss", "dpdu", "dpdv", "p_eps"):
        np.testing.assert_allclose(
            getattr(got, f).numpy()[valid],
            np.asarray(getattr(want, f))[valid], rtol=2e-5, atol=2e-5,
            err_msg=f)
