"""Ribbons and curve shading against tpurt on the CPU: the port's analog
of tpurt's test_ribbon_width_projection (tests/test_curve_intersect.py:147)
with fuzzed rays through a twisting ribbon, and compute_interaction on
curve hits of every subtype (flat, cylinder, ribbon).

Bounds: the walk as in test_torch_curves.py (a ribbon's slerp goes
through sin, whose XLA and torch implementations may differ by an ulp:
prims equal on >= 99.99% of lanes, all in every measured run); shading
values within 2e-5 (abs + rel).  Inputs come from numpy with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_curves import bezier, check_walks, curve_scene, walk_both
from tpurt.render import interaction as tint
from tpurt.render import intersect as tix
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.render import interaction as pint
from tpurt_torch.render.driver import build_job
from tpurt_torch.render.intersect import Hit
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

STRAIGHT = np.array([[-1, 0, 0], [-1 / 3, 0, 0], [1 / 3, 0, 0], [1, 0, 0]])


def test_ribbon_walk_matches_tpurt():
    # face-on rays keep the full width, an edge-on ray sees none
    # (curve.cpp:313-321), as in tpurt's test
    flat = curve_scene(STRAIGHT, 0.2, 0.2, ctype="ribbon",
                       extra='"normal N" [0 0 1  0 0 1]')
    o = np.array([[0, 0.05, 2], [0.5, -0.09, 2], [0, 2, 0.0]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1], [0, -1, 0.001]], np.float32)
    want, got, _ = walk_both(flat, o, d)
    check_walks(want, got)
    np.testing.assert_array_equal(got[1] >= 0, [True, True, False])
    # a ribbon twisting by 80 degrees along its length, fuzzed rays
    rng = np.random.default_rng(51)
    n = 512
    twist = curve_scene(STRAIGHT, 0.3, 0.2, ctype="ribbon",
                        extra='"normal N" [0 0 1  0 0.985 0.174]')
    p_aim = bezier(STRAIGHT, rng.uniform(0, 1, n))
    o = p_aim + rng.normal(0, 0.6, (n, 3))
    o[:, 2] += 2.5
    d = p_aim + rng.normal(0, 0.1, (n, 3)) - o
    want, got, _ = walk_both(twist, o.astype(np.float32),
                             d.astype(np.float32))
    assert 0.2 < (want[1] >= 0).mean() < 0.95
    check_walks(want, got)


def test_curve_interaction_matches_tpurt():
    cp = np.array([[-1, 0, 0], [-0.3, 0.4, 0.2], [0.3, -0.4, -0.2],
                   [1, 0, 0]])
    pts = " ".join("%.9g" % x for x in cp.ravel())
    text = curve_scene(cp, 0.15, 0.25, ctype="flat") + "\n"
    text = text.replace("WorldEnd", f"""Translate 0 1.2 0
Shape "curve" "string type" "cylinder" "float width" [0.2] "point P" [{pts}]
Translate 0 1.2 0
Shape "curve" "string type" "ribbon" "float width" [0.3] "point P" [{pts}]
  "normal N" [0 0 1  0.6 0 0.8]
WorldEnd""")
    tjob = tpurt_build_job(tpurt_load_scene_string(text))
    pjob = build_job(load_scene_string(text), "cpu")
    rng = np.random.default_rng(52)
    n = 1536
    p_aim = bezier(cp, rng.uniform(0, 1, n))
    p_aim[:, 1] += 1.2 * rng.integers(0, 3, n)
    o = (p_aim + np.array([0.1, 0.2, 2.5])).astype(np.float32)
    d = (p_aim - o + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    tg = tjob.scene.geo
    h = tix.intersect_closest(tg, jnp.asarray(o), jnp.asarray(d), 1e4)
    want = tint.compute_interaction(tg, h, jnp.asarray(o), jnp.asarray(d),
                                    tangents=True, dpduv=True)
    hit = Hit(*(torch.as_tensor(np.array(x)) for x in h))
    got = pint.compute_interaction(pjob.scene.geo, hit, torch.as_tensor(o),
                                   torch.as_tensor(d), tangents=True,
                                   dpduv=True)
    valid = np.asarray(want.valid)
    rows = np.asarray(tg.shade_rows)[np.asarray(h.prim)[valid]]
    assert set(rows[:, 23].view(np.int32).tolist()) == {0, 1, 2}
    for f in ("p", "ng", "ns", "uv", "ss", "dpdu", "dpdv", "p_eps"):
        np.testing.assert_allclose(
            getattr(got, f).numpy()[valid],
            np.asarray(getattr(want, f))[valid], rtol=2e-5, atol=2e-5,
            err_msg=f)
