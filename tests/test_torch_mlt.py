"""Main path H's pieces against tpurt's on the CPU (render/mlt.py against
tpurt/render/mlt.py): make_mlt_eval's value and raster lane by lane on
the same primary-sample rows for two path depths (bdpt_radiance in its
MLT mode: depth_select, s_select, every strategy returned as a splat),
and the bootstrap's per-depth normalisation b_d, whose rows both packages
draw from Threefry under the same seed.  The scene is the killeroo
stand-in at 16x16 under ``Integrator "mlt"``, maxdepth 2.  tpurt's
evaluations run eagerly (no jit).

Bounds: values within rtol 1e-4 / atol 1e-5 (float32 rounding of the
same bdpt arithmetic; measured 1e-5 absolute on values up to 2.9), the
raster equal; b_d within 1e-5 relative (measured <= 1.1e-6).  tpurt
returns a t=1 lane's raster from the s=0 strategy's splat row, the camera
sample's; the port copies it (ROADMAP, Queue 3), and this test holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import mlt as tmlt
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render import mlt as pmlt
from tpurt_torch.render.driver import job_from_tables
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import standin_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

MAX_DEPTH = 2
SCENE = standin_scene("small", integrator="mlt", res=16, maxdepth=MAX_DEPTH,
                      mutations=2)


@pytest.fixture(scope="module")
def jobs():
    job = tpurt_build_job(tpurt_load_scene_string(SCENE))
    return job, job_from_tables(scene_from_tpurt(job), "cpu")


def test_mlt_eval_matches_tpurt_lane_by_lane(jobs):
    job, pjob = jobs
    dims = pmlt.n_dims_for(MAX_DEPTH)
    assert dims == tmlt.n_dims_for(MAX_DEPTH)
    X = np.random.default_rng(0).uniform(0, 1, (512, dims)).astype(
        np.float32)
    for depth in (1, 2):
        assert (pmlt._strategy_pairs(depth, MAX_DEPTH)
                == tmlt._strategy_pairs(depth, MAX_DEPTH))
        v, r = tmlt.make_mlt_eval(job, depth)(job.scene, job.camera,
                                              jnp.asarray(X))
        pv, pr = pmlt.make_mlt_eval(pjob, depth, traverse_wide)(
            torch.tensor(X))
        v = np.asarray(v)
        assert (v > 0).any(-1).mean() > 0.05
        np.testing.assert_allclose(pv.numpy(), v, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(r))


def test_bootstrap_b_per_depth_matches_tpurt(jobs):
    """tpurt's bootstrap (mlt.py:164-175) for depths 1 and 2 against the
    port's render_mlt_job with the same seed and 2^12 rows a depth."""
    job, pjob = jobs
    n_boot = 1 << 12
    dims = tmlt.n_dims_for(MAX_DEPTH)
    key = jax.random.key(0)
    want = {}
    for d in range(MAX_DEPTH + 1):
        key, k = jax.random.split(key)
        if d in (1, 2):
            X = jax.random.uniform(k, (n_boot, dims), jnp.float32)
            val, _ = tmlt.make_mlt_eval(job, d)(job.scene, job.camera, X)
            want[d] = float(jnp.mean(tmlt._lum(val)))
    stats = {}
    img = pmlt.render_mlt_job(pjob, load_scene_string(SCENE)
                              .integrator_params, n_bootstrap=n_boot,
                              stats=stats)
    assert np.isfinite(img).all() and img.mean() > 0
    for d, b in want.items():
        assert b > 0
        assert abs(stats["b_per_depth"][d] - b) <= 1e-5 * b, (d, stats, want)
