"""The port's shading stages against tpurt's, each fed identical inputs: part 2
of the cases of test_torch_shading.py, in files of at most three cases so
that xdist's loadfile queue runs them beside the suite's long files.
Helpers, fixtures and bounds are those of test_torch_shading.py.
"""

import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import bsdf as tbsdf
from tpurt.render import lights as tlights
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import lights as plights
from test_torch_shading import (  # noqa: F401  (fixtures among them)
    _close,
    _t,
    _unit,
    jobs,
    lobes,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_bsdf_f_pdf_sample_match_tpurt(lobes):
    rng, want_lp, got_lp = lobes
    n = want_lp.kd.shape[0]
    wo, wi = _unit(rng, n), _unit(rng, n)
    wi[::3, 2] = np.abs(wi[::3, 2]) * np.sign(wo[::3, 2])  # same hemisphere
    _close(pbsdf.bsdf_f(got_lp, _t(wo), _t(wi)),
           tbsdf.bsdf_f(want_lp, jnp.asarray(wo), jnp.asarray(wi)))
    _close(pbsdf.bsdf_pdf(got_lp, _t(wo), _t(wi)),
           tbsdf.bsdf_pdf(want_lp, jnp.asarray(wo), jnp.asarray(wi)))
    u = rng.uniform(size=(3, n)).astype(np.float32)
    want = tbsdf.bsdf_sample(want_lp, jnp.asarray(wo), *map(jnp.asarray, u))
    got = pbsdf.bsdf_sample(got_lp, _t(wo), *map(_t, u))
    ok = np.asarray(want[2]) > 0
    assert ok.mean() > 0.3
    _close(got[0].numpy()[ok], np.asarray(want[0])[ok])  # wi
    _close(got[1], want[1])  # f
    _close(got[2], want[2])  # pdf
    # matte and plastic are never specular or transmissive: the two
    # flags stay False on both sides
    assert len(got) == 5
    for g, w in zip(got[3:], want[3:]):
        assert not np.asarray(w).any() and not g.any()


@pytest.mark.parametrize("strategy", ["spatial", "power", "uniform"])
def test_lights_match_tpurt(jobs, strategy):
    job, pjob = jobs
    lt, plt = job.scene.lights, pjob.scene.lights
    assert lt.n_lights == 3 and lt.spat_res > 1
    rng = np.random.default_rng(4)
    n = 4096
    p = rng.uniform([-4, 0, -4], [4, 3, 4], (n, 3)).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    idx, pmf = tlights.choose_light(lt, jnp.asarray(u), strategy,
                                    p=jnp.asarray(p))
    pidx, ppmf = plights.choose_light(plt, _t(u), strategy, p=_t(p))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    _close(ppmf, pmf, rtol=0, atol=0)
    assert len(np.unique(np.asarray(idx))) == 3
    want = tlights.sample_li(lt, idx, jnp.asarray(p), jnp.asarray(u2))
    got = plights.sample_li(plt, pidx, _t(p), _t(u2))
    for f in ("wi", "li", "p_light"):
        _close(getattr(got, f), getattr(want, f))
    # the sphere's cone pdf is 1 / (2 pi (1 - cos_max)): far from the
    # light that cancellation multiplies a last-ulp difference in the
    # squared distance (XLA may sum the three squares in another order)
    _close(got.pdf, want.pdf, rtol=1e-4)
    np.testing.assert_array_equal(got.is_delta.numpy(),
                                  np.asarray(want.is_delta))
    ng = _unit(rng, n)
    _close(plights.pdf_li_from_hit(plt, pidx, _t(p), got.wi, got.p_light,
                                   _t(ng)),
           tlights.pdf_li_from_hit(lt, idx, jnp.asarray(p), want.wi,
                                   want.p_light, jnp.asarray(ng)),
           rtol=1e-4)  # the same cone pdf as above


def test_film_add_samples_to_image_match_tpurt(jobs):
    job, pjob = jobs
    rng = np.random.default_rng(5)
    n = 6000
    film = job.film._replace(max_sample_luminance=3.0)
    pfilm = dataclasses.replace(pjob.film, max_sample_luminance=3.0)
    p_film = (rng.uniform(-1, 1, (n, 2)) * 2
              + rng.uniform(size=(n, 2)) * [film.width, film.height]
              ).astype(np.float32)  # some samples land off the film
    p_film[:5] = np.nan
    L = rng.exponential(size=(n, 3)).astype(np.float32)
    L[5:9] = np.array([np.nan, np.inf, -np.inf, 1.0])[:, None]
    w = rng.uniform(0.5, 1, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    state = film.add_samples(film.initial_state(), jnp.asarray(p_film),
                             jnp.asarray(L), jnp.asarray(w),
                             mask=jnp.asarray(mask))
    want = film.to_image(state)
    pstate = pfilm.initial_state("cpu")
    # the port's driver banks only the lanes it means to add
    pfilm.add_samples(pstate, _t(p_film[mask]), _t(L[mask]), _t(w[mask]))
    got = pfilm.to_image(pstate)
    assert got.shape == want.shape == (film.height, film.width, 3)
    # rtol 1e-5: scatter-add sums of one pixel's samples in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
