"""MLT in sampled-spectrum mode, through its bdpt evaluation: tpurt's
make_mlt_eval on a spectral job against the port's, lane by lane on the
same primary-sample rows (depth 1 of maxdepth 1: the s = 0, t = 1 and
s = 1 strategies), on the CPU, one cold tpurt jit.  Each evaluation's
bins are converted to RGB at the deposit, so the chains' scalar
contribution (Spectrum::y of the splat) is RGB in both packages.  Whole
MLT images are not compared pixel by pixel: the chains draw from
different generators (test_torch_mlt_3.py holds them statistically).

Bounds: values within rtol 1e-4 / atol 1e-5 and the raster equal, as in
test_torch_mlt.py (float32 rounding of the same bdpt arithmetic, here
with 60-bin throughputs and a (60, 3) conversion)."""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_spectral import tpurt_spectral
from tpurt.render import mlt as tmlt
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render import mlt as pmlt
from tpurt_torch.render.driver import job_from_tables
from tpurt_torch.testscenes import spectral_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

MAX_DEPTH = 1


def test_spectral_mlt_eval_matches_tpurt():
    text = spectral_scene("mlt", maxdepth=MAX_DEPTH,
                          extra=' "integer mutationsperpixel" [2]')
    job = tpurt_spectral(tpurt_build_job, tpurt_load_scene_string(text))
    assert job.cfg.spectral
    pjob = job_from_tables(scene_from_tpurt(job), "cpu")
    assert pjob.cfg.spectral and pjob.cfg.nch == 60
    X = np.random.default_rng(4).uniform(
        0, 1, (1024, tmlt.n_dims_for(MAX_DEPTH))).astype(np.float32)
    v, r = tpurt_spectral(lambda: tmlt.make_mlt_eval(job, 1)(
        job.scene, job.camera, jnp.asarray(X)))
    pv, pr = pmlt.make_mlt_eval(pjob, 1, traverse_wide)(torch.tensor(X))
    v = np.asarray(v)
    assert v.shape == pv.shape and v.shape[-1] == 3
    assert (v > 0).any(-1).mean() > 0.05
    np.testing.assert_allclose(pv.numpy(), v, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(r))
