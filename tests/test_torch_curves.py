"""The curve leaf walk (K1c's plain version) against tpurt and against a
dense float64 oracle on the CPU: the port's analog of tpurt's
test_fuzz_vs_dense_oracle (tests/test_curve_intersect.py:112), seeds 0-2.

Bounds: the walk's prim, t and s bit-equal to tpurt's _traverse_wide over
the curve tree on >= 99.99% of lanes (all, in every measured run), with
tpurt run op by op (jax.disable_jit), v within 1e-6; against the oracle,
tpurt's own bounds (hit classification away from the width boundary, t
within 2% and u within 0.05).  Inputs come from numpy with fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import intersect as tix
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.kernels.traverse import traverse_wide_reference
from tpurt_torch.render.driver import build_job
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def bezier(cp, u):
    """float64 cubic Bezier points at u (M,)."""
    cp = np.asarray(cp, np.float64)
    u = np.asarray(u, np.float64)[:, None]
    a = [cp[i] + u * (cp[i + 1] - cp[i]) for i in range(3)]
    b = [a[i] + u * (a[i + 1] - a[i]) for i in range(2)]
    return b[0] + u * (b[1] - b[0])


def oracle(cp, w0, w1, o, d, n_samp=20001):
    """Dense-sampling hit oracle (tests/test_curve_intersect.py:_oracle):
    (hit, t, u, margin in widths from the acceptance boundary)."""
    u = np.linspace(0.0, 1.0, n_samp)
    q = bezier(cp, u) - o
    dl = np.linalg.norm(d)
    z = q @ (d / dl)
    r = np.sqrt(np.maximum(np.einsum("ij,ij->i", q, q) - z * z, 0.0))
    hw = 0.5 * (w0 + (w1 - w0) * u)
    inside = (r <= hw) & (z > 0)
    rel = (r - hw) / np.maximum(hw, 1e-12)
    if inside.any():
        i = int(np.argmin(np.where(inside, z, np.inf)))
        return True, z[i] / dl, u[i], -rel[i]
    i = int(np.argmin(rel))
    return False, np.inf, u[i], rel[i]


def curve_scene(cp, w0, w1, ctype="cylinder", extra=""):
    pts = " ".join("%.9g" % x for x in np.asarray(cp).ravel())
    return f"""
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Camera "perspective" "float fov" [45]
WorldBegin
Material "matte" "color Kd" [.5 .5 .5]
Shape "curve" "string type" "{ctype}" "float width0" [{w0}]
  "float width1" [{w1}] "point P" [{pts}] {extra}
WorldEnd
"""


def walk_both(text, o, d, any_hit=False):
    """(tpurt's, the port's) curve walks of the rays, as numpy."""
    tjob = tpurt_build_job(tpurt_load_scene_string(text))
    pjob = build_job(load_scene_string(text), "cpu")
    tm = np.full(len(o), 1e4, np.float32)
    with jax.disable_jit():
        want = [np.asarray(x) for x in tix._traverse_wide(
            tjob.scene.geo, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            any_hit, tree="curve")]
    got = [x.numpy() for x in traverse_wide_reference(
        pjob.scene.geo, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(tm), any_hit, tree="curve")]
    return want, got, pjob


def check_walks(want, got):
    same = (got[1] == want[1]) & (got[0] == want[0]) & (got[2] == want[2])
    assert same.mean() >= 0.9999, same.mean()
    hit = want[1] >= 0
    np.testing.assert_allclose(got[3][hit], want[3][hit], atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_curve_walk_matches_tpurt_and_oracle(seed):
    rng = np.random.default_rng(seed)
    cp = rng.uniform(-1, 1, (4, 3))
    cp[:, 0] = np.sort(cp[:, 0]) * 1.5
    w0, w1 = rng.uniform(0.05, 0.25, 2)
    n = 64
    p_aim = bezier(cp, rng.uniform(0, 1, n))
    o = p_aim + rng.normal(0, 0.5, (n, 3))
    o[:, 2] = 3.0
    d = p_aim + rng.normal(0, 0.12, (n, 3)) - o
    o32, d32 = o.astype(np.float32), d.astype(np.float32)
    want, got, pjob = walk_both(curve_scene(cp, w0, w1), o32, d32)
    check_walks(want, got)
    rows = pjob.scene.geo.shade_rows.numpy()
    t, prim, s = got[0], got[1], got[2]
    checked = 0
    for i in range(n):
        ohit, ot, ou, margin = oracle(cp, w0, w1, o[i], d[i])
        if abs(margin) < 0.12:
            continue  # inside the refinement tolerance: not asserted
        assert (prim[i] >= 0) == ohit, (i, margin, ohit)
        if ohit:
            r = rows[prim[i]]
            u_glob = r[21] + s[i] * (r[22] - r[21])
            assert abs(t[i] - ot) < 2e-2 * max(ot, 1.0), (i, t[i], ot)
            assert abs(u_glob - ou) < 0.05, (i, u_glob, ou)
        checked += 1
    assert checked >= n // 3
