"""The port's geometry upload and ray queries against tpurt's: part 3 of the
cases of test_torch_intersect.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_intersect.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.geom.wbvh import REC
from tpurt.geom.wbvh import WIDTH
from tpurt.render import intersect as tix
from tpurt.render.geometry_build import PT_SPHERE
from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render import intersect as pix
from test_torch_intersect import (  # noqa: F401  (fixtures among them)
    T_ATOL,
    _rays,
    scenes,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_box8_test_matches_tpurt():
    rng = np.random.default_rng(12)
    n = 512
    o, d = _rays(rng, n)
    d[::7, 0] = 0.0  # axis-parallel rays: 1/d is +-inf, (lo-o)*inf may be NaN
    rec = np.zeros((n, REC), np.float32)
    lo = rng.uniform(-3, 2, (n, 3, WIDTH))
    hi = lo + rng.uniform(0.01, 2, (n, 3, WIDTH))
    rec[:, :3 * WIDTH] = lo.reshape(n, -1)
    rec[:, 3 * WIDTH:6 * WIDTH] = hi.reshape(n, -1)
    rec[:, [6, 7, 14, 15, 22, 23, 30, 31, 38, 39, 46, 47]] = np.nan  # absent
    t_max = np.where(rng.uniform(size=n) < 0.5, np.inf,
                     rng.uniform(0.5, 6, n)).astype(np.float32)
    inv_d = np.asarray(jnp.where(jnp.asarray(d) != 0, 1.0 / jnp.asarray(d),
                                 jnp.where(jnp.asarray(d) >= 0, np.inf,
                                           -np.inf)))
    np.testing.assert_array_equal(
        pix.safe_inv_dir(torch.as_tensor(d)).numpy(), inv_d)
    wh, wt = (np.asarray(x) for x in tix._box8_test(
        jnp.asarray(rec), jnp.asarray(o), jnp.asarray(inv_d),
        jnp.asarray(t_max)))
    gh, gt = (x.numpy() for x in pix._box8_test(
        torch.as_tensor(rec), torch.as_tensor(o), torch.as_tensor(inv_d),
        torch.as_tensor(t_max)))
    assert wh.any() and not wh[:, 6:].any()  # NaN boxes never hit
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_allclose(gt[wh], wt[wh], rtol=1e-6)


def test_ray_sphere_matches_tpurt_ray_quadric():
    rng = np.random.default_rng(13)
    n = 1024
    o, d = _rays(rng, n, aim=np.zeros(3))
    o[:64] *= 0.1  # some origins inside the sphere
    t_max = np.full(n, np.inf, np.float32)
    t_max[::5] = 1.5
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (0.3, -0.2, 0.1)
    m[:3, :3] *= 1 / 1.3
    params = np.zeros(16, np.float32)
    params[:4] = (1.0, -1.0, 1.0, 2 * np.pi)
    # disable_jit: lax.switch would otherwise compile the sphere branch as
    # one XLA computation, whose FMA contraction breaks the compensated
    # discriminant's error terms; op by op it rounds like the port
    with jax.disable_jit():
        want = [np.asarray(x) for x in jax.vmap(
            lambda oo, dd, tt: tix.ray_quadric(
                oo, dd, tt, jnp.int32(PT_SPHERE), jnp.asarray(m),
                jnp.asarray(params))
        )(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))]
    got = [x.numpy() for x in pix.ray_quadric(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        PT_SPHERE, torch.as_tensor(m), torch.as_tensor(params))]
    h = want[0]
    assert h.mean() > 0.3
    np.testing.assert_array_equal(got[0], h)
    # rtol 1e-6 on t; u, v also pass through atan2/acos, whose XLA and
    # torch implementations may differ by an ulp or two (atol 1e-6)
    np.testing.assert_allclose(got[1][h], want[1][h], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g[h], w[h], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,aim", [("kernels", None),
                                      ("mesh", np.array([0.0, 1.5, 0.0]))])
def test_traverse_twin_matches_tpurt_traverse_wide(scenes, name, aim):
    _, job, pjob = scenes[name]
    geo, pgeo = job.scene.geo, pjob.scene.geo
    rng = np.random.default_rng(7)
    n = 4096
    o, d = _rays(rng, n, aim=aim)
    tm = np.where(rng.uniform(size=n) < 0.2, 2.0, np.inf).astype(np.float32)
    tm[:16] = 0.0  # t_max <= 0: dead from the start
    for any_hit in (False, True):
        t0, p0, b00, b10 = (np.asarray(x) for x in tix._traverse_wide(
            geo, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            any_hit=any_hit))
        calls = ktr.traverse_wide_reference.calls
        t1, p1, b01, b11 = (x.numpy() for x in ktr.traverse_wide(
            pgeo, torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(tm), any_hit=any_hit))
        # the wrapper runs the plain twin because the tensors are on the CPU
        assert ktr.traverse_wide_reference.calls == calls + 1
        hit = p0 >= 0
        assert 0.05 < hit.mean() < 0.95 and not hit[:16].any()
        if any_hit:
            np.testing.assert_array_equal(p1 >= 0, hit)  # occlusion
            continue
        np.testing.assert_array_equal(p1, p0)
        # rtol 2e-5 as in tests/test_kernels.py; T_ATOL for XLA's FMA
        # contraction in the jitted loop at near-zero t (module docstring)
        np.testing.assert_allclose(t1[hit], t0[hit], rtol=2e-5, atol=T_ATOL)
        np.testing.assert_allclose(b01[hit], b00[hit], atol=1e-5)
        np.testing.assert_allclose(b11[hit], b10[hit], atol=1e-5)
