"""The port's shading stages against tpurt's, each fed identical inputs.

Camera rays, surface interactions, lobe fetch + BSDF evaluation and
sampling (matte and plastic), light choice / sampling / pdf, and the film.
Inputs come from numpy.random.default_rng; tpurt's functions run eagerly
(one XLA op at a time) on the CPU, the port's on CPU tensors.  Arithmetic
taken in the same order rounds identically; the tolerances below cover
transcendental functions (sin, cos, log, sqrt of sums), whose XLA and
torch implementations may differ by an ulp or two, and the order of
scatter-add sums on the film.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import interaction as tint
from tpurt.render import intersect as tix
from tpurt.render import materials_build as tmat
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import interaction as pint
from tpurt_torch.render import materials_build as pmat
from tpurt_torch.render.driver import job_from_tables
from tpurt_torch.render.intersect import Hit
from tpurt_torch.testscenes import mixed_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6  # transcendental ulps (module docstring)


@pytest.fixture(scope="module", params=[False, True], ids=["pinhole", "lens"])
def jobs(request):
    job = tpurt_build_job(load_scene_string(mixed_scene(lens=request.param)))
    return job, job_from_tables(scene_from_tpurt(job), "cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _camera_rays(job, pjob, n=2048, seed=1):
    rng = np.random.default_rng(seed)
    p_film = (rng.uniform(size=(n, 2))
              * [job.camera.res_x, job.camera.res_y]).astype(np.float32)
    p_lens = rng.uniform(size=(n, 2)).astype(np.float32)
    want = job.camera.generate_rays(jnp.asarray(p_film), jnp.asarray(p_lens))
    got = pjob.camera.generate_rays(_t(p_film), _t(p_lens))
    return want, got


def test_camera_rays_match_tpurt(jobs):
    job, pjob = jobs
    want, got = _camera_rays(job, pjob)
    for g, w in zip(got, want):
        _close(g, w)


def test_compute_interaction_matches_tpurt(jobs):
    job, pjob = jobs
    (o, d, _), _ = _camera_rays(job, pjob, seed=2)
    hit = tix.intersect_closest(job.scene.geo, o, d, jnp.inf)
    assert 0.3 < float(jnp.mean(hit.prim >= 0)) < 1.0
    want = tint.compute_interaction(job.scene.geo, hit, o, d)
    # media=True, faces=True: the port carries the medium ids and the
    # Ptex face index only when asked (tpurt always does), so they are
    # compared too
    got = pint.compute_interaction(
        pjob.scene.geo, Hit(_t(hit.t), _t(hit.prim), _t(hit.b0), _t(hit.b1)),
        _t(o), _t(d), media=True, faces=True)
    for f in pint.SurfaceInteraction._fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None:  # derivative / footprint fields: off on both sides
            assert w is None, f
            continue
        if g.dtype in (torch.int32, torch.bool):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), f)
        else:
            _close(g, w)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lobes(jobs):
    job, pjob = jobs
    rng = np.random.default_rng(3)
    n = 4096
    nmat = job.scene.mt_table.shape[0]
    mat = rng.integers(-1, nmat, n).astype(np.int32)  # -1: no material
    kinds = np.asarray(job.scene.mt_kinds)
    assert {tmat.MAT_MATTE, tmat.MAT_PLASTIC} <= set(kinds.tolist())
    want = tmat.fetch_lobes(job.scene.mt_table, jnp.asarray(mat))
    got = pmat.fetch_lobes(pjob.scene.mt_table, _t(mat))
    return rng, want, got


def test_fetch_lobes_matches_tpurt(lobes):
    _, want, got = lobes
    for f in pbsdf.LobeParams._fields:
        # (the fields a matte and plastic scene does not need are None)
        if f != "active" and getattr(got, f) is not None:
            _close(getattr(got, f), getattr(want, f), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert not np.asarray(want.active)[:, 2:].any()
