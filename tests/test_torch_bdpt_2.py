"""The port's camera importance and film splats against tpurt's on the
CPU: camera_we, camera_pdf_we and camera_sample_wi of a perspective
camera with and without a thin lens (render/camera.py against
tpurt/render/camera.py:426-502), and Film.add_splats with
to_image(splat_scale) (render/film.py against tpurt/render/film.py:
119-150).  Inputs come from numpy with fixed seeds; helpers are
test_torch_bdpt.py's.

Bounds: importance, pdfs and directions within rtol 1e-5 / atol 1e-6 on
>= 99.5% of lanes and rtol 1e-4 / atol 1e-4 on all (the port inverts the
camera matrices in float64, tpurt in float32); the raster points within
1e-3 pixels; the validity masks on >= 99.9% of lanes (a lane on a raster
edge may fall either side).  Splats and the resolved image within rtol
1e-5 / atol 1e-7 (scatter-add sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import camera as tcam
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render import camera as pcam
from tpurt_torch.render.driver import job_from_tables
from tpurt_torch.testscenes import mixed_scene
from test_torch_bdpt import N, _close_most, _t

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _jobs(lens: bool):
    job = tpurt_build_job(tpurt_load_scene_string(mixed_scene(lens=lens)))
    return job, job_from_tables(scene_from_tpurt(job), "cpu")


@pytest.mark.parametrize("lens", [False, True], ids=["pinhole", "lens"])
def test_camera_importance_matches_tpurt(lens):
    job, pjob = _jobs(lens)
    cam, pc = job.camera, pjob.camera
    assert (pc.lens_radius > 0) == lens
    rng = np.random.default_rng(11)
    # points in front of the camera (LookAt 0 2 -6 -> 0 1 0), some behind
    # it and some outside the view
    ref = (rng.uniform(-4, 4, (N, 3)) + [0, 1, 2]).astype(np.float32)
    ref[:64, 2] = -9.0
    u_lens = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    want = tcam.camera_sample_wi(cam, jnp.asarray(ref), jnp.asarray(u_lens))
    got = pcam.camera_sample_wi(pc, _t(ref), _t(u_lens))
    valid_w, valid_g = np.asarray(want[1]) > 0, got[1].numpy() > 0
    assert valid_w.mean() > 0.2 and (~valid_w).mean() > 0.05
    assert (valid_w == valid_g).mean() >= 0.999
    both = valid_w & valid_g
    for k in (0, 1, 2, 4):  # wi, pdf, we, p_lens_w
        _close_most(got[k][both], np.asarray(want[k])[both])
    np.testing.assert_allclose(got[3].numpy()[both],
                               np.asarray(want[3])[both], atol=1e-3)
    _close_most(got[5][None], np.asarray(want[5])[None])
    # We and Pdf_We of rays leaving the lens points
    d = rng.normal(size=(N, 3)).astype(np.float32) * [0.25, 0.25, 1.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.asarray(want[4])
    we_w, pr_w, ok_w = tcam.camera_we(cam, jnp.asarray(o), jnp.asarray(d))
    we_g, pr_g, ok_g = pcam.camera_we(pc, _t(o), _t(d))
    ok_w, ok_g = np.asarray(ok_w), ok_g.numpy()
    assert ok_w.mean() > 0.2 and (ok_w == ok_g).mean() >= 0.999
    both = ok_w & ok_g
    _close_most(we_g[both], np.asarray(we_w)[both])
    np.testing.assert_allclose(pr_g.numpy()[both], np.asarray(pr_w)[both],
                               atol=1e-3)
    pp_w, pd_w = tcam.camera_pdf_we(cam, jnp.asarray(d))
    pp_g, pd_g = pcam.camera_pdf_we(pc, _t(d))
    _close_most(pp_g, pp_w)
    _close_most(pd_g, pd_w)
    _close_most(pcam.camera_screen_area(pc)[None],
                np.asarray(tcam.camera_screen_area(cam))[None])


def test_add_splats_and_to_image_match_tpurt():
    """Weighted samples and splats (some off the film, some not finite,
    some over the luminance clamp) resolved at splat_scale 1/4."""
    job, pjob = _jobs(False)
    film = job.film._replace(max_sample_luminance=3.0)
    pfilm = dataclasses.replace(pjob.film, max_sample_luminance=3.0)
    rng = np.random.default_rng(5)
    n = 6000
    p = (rng.uniform(-1, 1, (n, 2)) * 2
         + rng.uniform(size=(n, 2)) * [film.width, film.height]
         ).astype(np.float32)
    v = rng.exponential(size=(n, 3)).astype(np.float32)
    v[5:9] = np.array([np.nan, np.inf, -np.inf, 1.0])[:, None]
    w = np.ones(n, np.float32)
    state = film.add_samples(film.initial_state(), jnp.asarray(p),
                             jnp.asarray(v[::-1].copy()), jnp.asarray(w))
    state = film.add_splats(state, jnp.asarray(p), jnp.asarray(v))
    want = film.to_image(state, splat_scale=0.25)
    pstate = pfilm.initial_state("cpu", splats=True)
    pfilm.add_samples(pstate, _t(p), _t(v[::-1].copy()), _t(w))
    pfilm.add_splats(pstate, _t(p), _t(v))
    np.testing.assert_allclose(pstate.splat.numpy(), np.asarray(state.splat),
                               rtol=1e-5, atol=1e-7)
    got = pfilm.to_image(pstate, splat_scale=0.25)
    assert got.shape == want.shape == (film.height, film.width, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # a film without splats resolves as before
    assert pfilm.initial_state("cpu").splat is None
