"""The motion leaf walk (K1m's plain version) against tpurt on the CPU,
and a quirk of tpurt's that the port shares under TransformTimes other
than 0 1.

Bounds: the walk's t, prim, b0 and b1 bit-equal to tpurt's _traverse_wide
with a delta table, on fuzzed rays at random shutter times, with tpurt
run op by op (jax.disable_jit: jitted, XLA contracts products into FMAs,
which moves t by up to ~15 ulp).  Inputs come from numpy with fixed
seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import intersect as tix
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.kernels.traverse import leaf_kind, traverse_wide_reference
from tpurt_torch.render.driver import build_job
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import motion_hair_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jobs():
    text = motion_hair_scene("small")
    return (tpurt_build_job(tpurt_load_scene_string(text)),
            build_job(load_scene_string(text), "cpu"))


def _rays(rng, n):
    """Rays from in front of frame E's meshes toward them, and times."""
    o = np.stack([rng.uniform(-6, 6, n), rng.uniform(0.2, 5, n),
                  rng.uniform(-12, -7, n)], -1)
    aim = np.stack([rng.uniform(-4, 4, n), rng.uniform(0, 2, n),
                    rng.uniform(-2, 4, n)], -1)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(rng.uniform(size=n) < 0.3, rng.uniform(3, 14, n), np.inf)
    return (o.astype(np.float32), d.astype(np.float32),
            tm.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32))


@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_walk_bit_equal_to_tpurt(jobs, any_hit):
    tjob, pjob = jobs
    assert leaf_kind(pjob.scene.geo, torch.zeros(1), "tri") == "motion"
    o, d, tm, time = _rays(np.random.default_rng(31), 2048)
    with jax.disable_jit():
        want = [np.asarray(x) for x in tix._traverse_wide(
            tjob.scene.geo, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            any_hit, time=jnp.asarray(time))]
    got = [x.numpy() for x in traverse_wide_reference(
        pjob.scene.geo, *(torch.as_tensor(a) for a in (o, d, tm)), any_hit,
        time=torch.as_tensor(time))]
    assert 0.2 < (want[1] >= 0).mean() < 0.99
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the times move the hits: the same rays at time 0 hit elsewhere
    static = traverse_wide_reference(
        pjob.scene.geo, *(torch.as_tensor(a) for a in (o, d, tm)), any_hit,
        time=torch.zeros(len(o)))
    assert not np.array_equal(static[0].numpy(), got[0])


QUIRK = """Film "image" "integer xresolution" [4] "integer yresolution" [4]
TransformTimes 0 2
Camera "perspective" "float shutteropen" [0] "float shutterclose" [2]
WorldBegin
Material "matte"
AttributeBegin
  ActiveTransform EndTime
  Translate 1 0 0
  ActiveTransform All
  Shape "trianglemesh" "point P" [-0.4 -0.4 5  0.4 -0.4 5  0.4 0.4 5
    -0.4 0.4 5] "integer indices" [0 1 2  0 2 3]
AttributeEnd
WorldEnd
"""


def test_mesh_lerp_reads_raw_time_in_both_packages():
    """A fault of tpurt's that the port shares (ROADMAP Queue 3): the mesh
    lerp reads the raw shutter time (v + time * dv), while the camera maps
    time through TransformTimes.  Under TransformTimes 0 2 a quad that
    moves by 1 in x over the interval sits 2 to the right at time 2 in
    both packages (pbrt puts it at 1), and 1 to the right at time 1 (pbrt:
    0.5)."""
    pjob = build_job(load_scene_string(QUIRK), "cpu")
    tjob = tpurt_build_job(tpurt_load_scene_string(QUIRK))
    # rays up the z axis at x, each at its time: where the quad is under
    # the raw-time lerp (first two), and where pbrt's mapping puts it
    xs = np.array([1.0, 2.0, 0.5, 1.0], np.float32)
    time = np.array([1, 2, 1, 2], np.float32)
    o = np.zeros((len(xs), 3), np.float32)
    o[:, 0] = xs
    d = np.tile(np.float32([0, 0, 1]), (len(xs), 1))
    tm = np.full(len(xs), np.inf, np.float32)
    want = tix._traverse_wide(tjob.scene.geo, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tm), False, time=jnp.asarray(time))
    got = traverse_wide_reference(pjob.scene.geo, torch.as_tensor(o),
                                  torch.as_tensor(d), torch.as_tensor(tm),
                                  False, time=torch.as_tensor(time))
    hit = got[1].numpy() >= 0
    np.testing.assert_array_equal(hit, np.asarray(want[1]) >= 0)
    # the quad spans [time - 0.4, time + 0.4] in x: the raw time, where
    # pbrt's [time / 2 - 0.4, time / 2 + 0.4] would give the opposite
    np.testing.assert_array_equal(hit, [True, True, False, False])
