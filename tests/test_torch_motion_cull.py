"""The motion group cull (render/intersect.py: motion_group_cull, the plain
copy of K1m's and K1km's ``group_near`` in traverse.cu) against tpurt's
lerped _tri_bundle_test(o, d, t_max, rec, drec, time) on the CPU: every
group of 4 triangles in which tpurt reports a hit passes the cull, and the
cull drops most groups that a ray's time puts elsewhere.

Leaf records of 12 triangles (the last slots of some NaN pads) are made
from a numpy seed: each a small patch of a mesh that moves many triangle
widths over the shutter and deforms as it goes.  Each ray has a time of 0,
1, 0.5, -0.5 or 2.0 (tpurt lerps by the raw shutter time) and is aimed at
one live triangle of its record as tpurt lerps it to that time: exactly at
a vertex or at a point of an edge, or 4 or 64 ulps of the point's
coordinates either side of the edge in the triangle's plane; an eighth run
in the plane itself (edge-on), and a quarter have a t_max at the aimed
point, 4 ulps either side of it.  The "swept" case aims each ray at its
patch at one time and gives it another: the ray crosses the patch's swept
volume, not the patch.  tpurt runs op by op (jax.disable_jit), as the
port's twin does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import intersect as tix
from tpurt_torch.geom.wbvh import LEAF_K, REC
from tpurt_torch.render.intersect import (GROUPS, PRIM_LO, _tri_bundle_test,
                                          motion_group_boxes,
                                          motion_group_cull)

torch.set_num_threads(1)

N = 4096
TIMES = np.array([0.0, 1.0, 0.5, -0.5, 2.0], np.float32)
EPS = float(np.finfo(np.float32).eps)


def unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_records(rng):
    """(rec, drec, verts, dverts, live) as f32: N leaf records of a
    moving, deforming mesh patch; verts / dverts (N, 12, 3, 3)."""
    centre = rng.uniform(-4, 4, (N, 1, 1, 3))
    # triangles of ~0.1 around their patch's 0.6-wide centre
    tri_c = rng.uniform(-0.3, 0.3, (N, LEAF_K, 1, 3))
    verts = centre + tri_c + rng.normal(0, 0.06, (N, LEAF_K, 3, 3))
    # the patch translates 0.5-2 units and each vertex jitters by 0.05
    move = unit(rng.normal(0, 1, (N, 1, 1, 3))) * rng.uniform(
        0.5, 2.0, (N, 1, 1, 1))
    dverts = move + rng.normal(0, 0.05, (N, LEAF_K, 3, 3))
    live_n = rng.integers(5, LEAF_K + 1, N)  # triangles fill from slot 0
    live = np.arange(LEAF_K)[None, :] < live_n[:, None]
    verts, dverts = verts.astype(np.float32), dverts.astype(np.float32)
    rec = np.zeros((N, REC), np.float32)
    drec = np.zeros((N, REC), np.float32)
    for k in range(3):
        for a in range(3):
            i = 3 * k + a
            rec[:, i * LEAF_K:(i + 1) * LEAF_K] = np.where(
                live, verts[:, :, k, a], np.nan)
            drec[:, i * LEAF_K:(i + 1) * LEAF_K] = np.where(
                live, dverts[:, :, k, a], 0.0)
    rec[:, PRIM_LO:PRIM_LO + LEAF_K] = np.arange(LEAF_K, dtype=np.int32).view(
        np.float32)
    return rec, drec, verts, dverts, live


def aimed_rays(rng, verts, dverts, live, time, vertices: bool):
    """(o, d, t_max) aimed at a live triangle at ``time`` (see the module
    docstring): at a vertex, or with ``vertices`` False at a point of an
    edge (a vertex for 30% of the rays)."""
    ar = np.arange(N)
    slot = (rng.integers(0, 1 << 20, N) % live.sum(1)).astype(np.int64)
    # the triangle as the twin lerps it, in f32, then in f64
    tri = (verts[ar, slot] + time[:, None, None] * dverts[ar, slot])
    tri = tri.astype(np.float32).astype(np.float64)
    k = rng.integers(0, 3, N)
    a, b = tri[ar, k], tri[ar, (k + 1) % 3]
    opp = tri[ar, (k + 2) % 3]
    u = np.where(vertices | (rng.uniform(0, 1, N) < 0.3), 0.0,
                 rng.uniform(0, 1, N))
    point = a + u[:, None] * (b - a)  # a vertex (u = 0) or an edge point
    normal = unit(np.cross(b - a, opp - a))
    # in the plane, across the edge, away from the opposite vertex
    across = unit(np.cross(normal, b - a))
    across *= np.sign(((point - opp) * across).sum(1))[:, None]
    ulps = rng.choice([0.0, 4.0, -4.0, 64.0, -64.0], N)
    point = point + across * (ulps * EPS * np.abs(point).max(1))[:, None]
    d = unit(rng.normal(0, 1, (N, 3)))
    d = unit(d - 0.5 * normal * np.sign((d * normal).sum(1))[:, None])
    q = N // 8
    d[:q] = -across[:q]  # edge-on: in the triangle's plane
    dist = rng.uniform(0.5, 6.0, N)
    o = point - d * dist[:, None]
    t_max = np.full(N, np.inf)
    tight = slice(N // 4, N // 2)
    t_max[tight] = dist[tight] * (1 + rng.choice([-4, 0, 4], N // 4) * EPS)
    return o, d, t_max


def run(o, d, t_max, rec, drec, time):
    """(tpurt's hits (N, 12), the cull (N, GROUPS)), and the port's twin
    held to tpurt's hits."""
    o, d, t_max = (x.astype(np.float32) for x in (o, d, t_max))
    with jax.disable_jit():
        hit = np.asarray(tix._tri_bundle_test(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jnp.asarray(rec), jnp.asarray(drec), jnp.asarray(time))[0])
    tt = [torch.as_tensor(x) for x in (o, d, t_max, rec, drec, time)]
    assert (_tri_bundle_test(*tt)[0].numpy() == hit).all()
    near = motion_group_cull(*tt[:3], tt[5], motion_group_boxes(tt[3], tt[4]))
    return hit, near.numpy()


@pytest.mark.parametrize("case", ["edges", "vertices", "swept"])
def test_cull_keeps_every_tpurt_hit(case):
    rng = np.random.default_rng({"edges": 0, "vertices": 1, "swept": 2}[case])
    rec, drec, verts, dverts, live = make_records(rng)
    time = TIMES[rng.integers(0, len(TIMES), N)]
    # "swept": aimed at the patch 1.5 time units away, where it sits
    # 0.75-3 units from where it is at the ray's time
    aim = (np.where(time >= 0.5, time - 1.5, time + 1.5).astype(np.float32)
           if case == "swept" else time)
    o, d, t_max = aimed_rays(rng, verts, dverts, live, aim,
                             case == "vertices")
    hit, near = run(o, d, t_max, rec, drec, time)
    hit_g = hit.reshape(N, GROUPS, 4).any(axis=2)
    live_g = live.reshape(N, GROUPS, 4).any(axis=2)
    assert not (near & ~live_g).any()  # pad groups never pass
    # sound: no group with a hit is culled, at every time
    missed = hit_g & ~near
    assert not missed.any(), np.argwhere(missed)[:10]
    for tau in TIMES:
        assert (time == tau).sum() > N // 8
    if case == "swept":
        # not vacuous: the ray crosses only the swept volume
        assert near[live_g].mean() < 0.1, near[live_g].mean()
    else:
        # not vacuous: many groups hold a hit (a ray aimed at a vertex
        # hits only from inside both of its edges)
        assert hit_g.sum() >= N // 8, hit_g.sum()
