"""The kd-tree accelerator (``Accelerator "kdtree"``) of the port against
tpurt's on the CPU: the tables, and the kd walk's plain twin
(kernels/traverse.py: traverse_kd_reference, K1k's plain version) against
tpurt's ``_traverse_wide`` on a kd DeviceGeometry, closest and any-hit.

The stand-in scene at "small" size is built with ``"integer maxprims"
[20]`` and ``"integer maxdepth" [6]``, so that leaves overflow their 12
triangles into continuation rows.  tpurt's walk runs op by op
(jax.disable_jit; jitted, XLA contracts products into FMAs, which moves t
by a few ulp), so both sides round each operation once in the same
order.  Rays: seeded from numpy, a quarter starting on a split plane of
the tree, a quarter with a zero direction component (parallel to the
planes of that axis), some lying in a split plane (o on it, d along it),
and a seventh cut short by t_max (2,048 rays a set).

Bounds: the tables bit for bit; t, prim, b0 and b1 bit-equal (stricter
than the kernel's bounds, prim on >= 99.99% of lanes and t within rtol
1e-5: both sides round the same operations in the same order).
The tables test makes the port build with the same builder as tpurt (the
C++ one when tpurt has it), as test_torch_intersect.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.native as tpurt_native
from tpurt.geom import kdtree as tkd
from tpurt.geom.wbvh import SLOT_KIND
from tpurt.render import intersect as tix
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
import tpurt_torch.native as port_native
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.geom import kdtree as pkd
from tpurt_torch.kernels.traverse import leaf_kind, traverse_kd_reference
from tpurt_torch.render.driver import build_job, host_tables
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import standin_scene, with_accelerator

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

KD_SCENE = with_accelerator(standin_scene("small"), "kdtree", maxprims=20,
                            maxdepth=6)


@pytest.fixture(scope="module")
def jobs():
    tjob = tpurt_build_job(tpurt_load_scene_string(KD_SCENE))
    return tjob, build_job(load_scene_string(KD_SCENE), "cpu")


def kd_rays(knodes, kbounds, n: int, seed: int):
    """Seeded rays through the kd box (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    lo, hi = kbounds
    o = rng.uniform(lo - 1, hi + 1, (n, 3)).astype(np.float32)
    d = (rng.uniform(lo, hi, (n, 3)) - o).astype(np.float32)
    interior = knodes[:, SLOT_KIND] == 0
    split = knodes[interior, tkd.SLOT_SPLIT]
    axis = knodes[interior, tkd.SLOT_AXIS].view(np.int32)
    q = n // 4
    k = rng.integers(0, len(split), 2 * q)
    # a quarter start on a split plane
    o[np.arange(q), axis[k[:q]]] = split[k[:q]]
    # a quarter run parallel to an axis's planes, half of them inside one
    d[q + np.arange(q), axis[k[q:]]] = 0.0
    half = q + np.arange(q // 2)
    o[half, axis[k[q:q + q // 2]]] = split[k[q:q + q // 2]]
    t_max = np.full(n, np.inf, np.float32)
    t_max[::7] = rng.uniform(0.5, 20, len(t_max[::7]))
    return o, d, t_max


def assert_walk_equal(tjob, pjob, any_hit: bool, time=None, seed=0):
    g, pg = tjob.scene.geo, pjob.scene.geo
    o, d, tm = kd_rays(np.asarray(g.knodes), np.asarray(g.kbounds), 2048,
                       seed)
    with jax.disable_jit():
        want = [np.asarray(x) for x in tix._traverse_wide(
            g, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), any_hit,
            time=None if time is None else jnp.asarray(time))]
    got = [x.numpy() for x in traverse_kd_reference(
        pg, *(torch.as_tensor(a) for a in (o, d, tm)), any_hit,
        time=None if time is None else torch.as_tensor(time))]
    assert 0.2 < (want[1] >= 0).mean() < 0.99
    for gv, wv in zip(got, want):
        np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))


def test_kd_tables_equal_tpurt(jobs, monkeypatch):
    tjob, _ = jobs
    if tpurt_native.get_lib() is None:
        for name in ("build_bvh_native", "build_kdtree_native"):
            monkeypatch.setattr(port_native, name, lambda *a, **k: None)
    elif port_native.get_lib() is None:
        pytest.skip("tpurt built with its C++ builders and the port has "
                    "none (no g++)")
    want = scene_from_tpurt(tjob)["geo"]
    got = host_tables(load_scene_string(KD_SCENE))["geo"]
    assert want["accel"] == got["accel"] == "kdtree"
    assert want["kstack_depth"] == got["kstack_depth"] == 6 + 2
    for k in ("knodes", "kbounds"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      want[k].view(np.int32), k)
    cont = want["knodes"][:, pkd.SLOT_CONT].view(np.int32)
    assert (cont >= 0).sum() > 0  # leaves chained past 12 triangles
    # the copied pure-Python builder against tpurt's on the same boxes
    g = tjob.scene.geo
    v = np.asarray(g.shade_rows)[:tjob.scene.geo.n_tris, 7:16]
    lo = np.minimum(np.minimum(v[:, 0:3], v[:, 3:6]), v[:, 6:9])
    hi = np.maximum(np.maximum(v[:, 0:3], v[:, 3:6]), v[:, 6:9])
    args = (lo.astype(np.float64), hi.astype(np.float64), 80, 1, 0.5, 20, 6)
    for a, b in zip(pkd._build_python(*args), tkd._build_python(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("any_hit", [False, True])
def test_kd_twin_matches_tpurt_walk(jobs, any_hit):
    tjob, pjob = jobs
    assert leaf_kind(pjob.scene.geo, None, "tri") == "kd"
    assert_walk_equal(tjob, pjob, any_hit, seed=1 + any_hit)
