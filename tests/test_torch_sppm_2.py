"""One SPPM iteration of the port against tpurt's on the small caustic
scene (tpurt_torch.testscenes.write_caustic "small": 48x48, a glass
sphere over a matte floor, radius 0.25), on the CPU: the camera pass
(_camera_chunk), the grid over its visible points and the photon pass
with its deposit (_photon_chunk) of iteration 1's photons (eight times
the film's area: ~500 deposits) from that pixel state.  tpurt runs the
three as one jitted function (one cold jit for the file).

Bounds: Ld, the visible points' ns and beta within 1e-5 of tpurt's,
their valid flags equal; p and wo within 1e-5 (abs + rel) on >= 99% of
the visible points and within 1e-3 on all.  Measured on an x86-64
CPU: 5 of 1,777 points (0.28%) leave 1e-5 in p, by up to 1.43e-4 at
|p| ~ 5: floor points seen through the glass sphere, where the two
packages' sphere hits differ in the last bits (XLA fuses multiply-adds,
torch does not) and the refraction carries the difference to the floor.
The photon pass then starts from tpurt's visible points (the same pixel
state on both sides): the grid's tables equal, M equal pixel for pixel,
Phi within 1e-4 relative (each pixel against 1e-4 of the image's largest
Phi; the port sums each pixel's deposits in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import sppm as tsppm
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.sampling.samplers import make_halton
from tpurt.scene import load_scene as tpurt_load_scene
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render import sppm as psppm
from tpurt_torch.render.driver import build_job
from tpurt_torch.sampling import lowdiscrepancy as ld
from tpurt_torch.sampling.samplers import halton_from_tables, halton_tables
from tpurt_torch.scene import load_scene
from tpurt_torch.testscenes import write_caustic

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

N_ITERS, MAX_DEPTH, IT = 4, 5, 1
VP_KEYS = ("valid", "p", "wo", "ns", "beta")


@pytest.fixture(scope="module")
def iteration(tmp_path_factory):
    path = write_caustic(str(tmp_path_factory.mktemp("sppm") / "c.pbrt"),
                         "small")
    # ---- tpurt ----
    tjob = tpurt_build_job(tpurt_load_scene(path))
    film = tjob.film
    n = film.width * film.height
    radius = 0.25
    smplr = make_halton(N_ITERS, film.full_x, film.full_y)
    primes = jnp.asarray(ld.PRIMES.astype(np.int32))
    pid = np.arange(n)
    px = (pid % film.width).astype(np.int32)
    py = (pid // film.width).astype(np.int32)
    n_ph = 8 * n
    hidx = (IT * n_ph + np.arange(n_ph)).astype(np.int32)

    @jax.jit
    def one_iteration(scene, camera, smplr, px, py, sidx, hidx):
        Ld, vp = tsppm._camera_chunk(scene, camera, smplr, px, py, sidx,
                                     px >= 0, MAX_DEPTH, tjob.texture_eval)
        pix = tsppm._init_pixels(n, radius, scene=scene)._replace(
            vp_valid=vp["valid"], vp_p=vp["p"], vp_wo=vp["wo"],
            vp_ns=vp["ns"], vp_beta=vp["beta"], vp_shade=vp["shade"])
        grid = tsppm._build_grid(pix.vp_p, pix.vp_valid, pix.radius, n)
        ks, vs, lo, diag, res, max_occ = grid
        Phi, M = tsppm._photon_chunk(scene, pix, ks, vs, max_occ, lo, diag,
                                     res, hidx, hidx >= 0, MAX_DEPTH, n,
                                     tjob.texture_eval, primes)
        return Ld, {k: vp[k] for k in VP_KEYS}, grid, Phi, M

    out = one_iteration(tjob.scene, tjob.camera, smplr, jnp.asarray(px),
                        jnp.asarray(py), jnp.full(n, IT, jnp.int32),
                        jnp.asarray(hidx))
    want = jax.tree_util.tree_map(np.asarray, out)

    # ---- the port ----
    job = build_job(load_scene(path), "cpu")
    psmplr = halton_from_tables(dict(
        halton_tables(N_ITERS, film.full_x, film.full_y), fma=True), "cpu")
    tpx, tpy = torch.tensor(px).long(), torch.tensor(py).long()
    Ld, vp = psppm._camera_chunk(job.scene, job.camera, psmplr, tpx, tpy,
                                 torch.full((n,), IT), MAX_DEPTH,
                                 traverse_wide, job.texture_eval)
    pix = psppm._init_pixels(n, radius, job.scene, "cpu")
    for k in VP_KEYS:  # tpurt's visible points, the port's contexts
        setattr(pix, "vp_" + k, torch.tensor(want[1][k]))
    pix.vp_shade = vp["shade"]
    grid = psppm._build_grid(pix.vp_p, pix.vp_valid, pix.radius, n)
    pairs = psppm._photon_chunk(job.scene, pix, grid,
                                torch.tensor(hidx).long(), MAX_DEPTH, n,
                                traverse_wide, job.texture_eval)
    got = (Ld.numpy(), {k: v.numpy() for k, v in vp.items() if k != "shade"},
           [g.numpy() for g in grid], pix.Phi.numpy(), pix.M.numpy(), pairs)
    return want, got


def test_camera_chunk_matches_tpurt(iteration):
    (Ld_t, vp_t, *_), (Ld_p, vp_p, *_) = iteration
    np.testing.assert_allclose(Ld_p, Ld_t, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(vp_p["valid"], vp_t["valid"])
    v = vp_t["valid"]
    assert 0.3 < v.mean() < 1 and Ld_t.mean() > 0
    for k in ("ns", "beta"):
        np.testing.assert_allclose(vp_p[k][v], vp_t[k][v], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("p", "wo"):
        err = np.abs(vp_p[k][v] - vp_t[k][v])
        ok = (err <= 1e-5 + 1e-5 * np.abs(vp_t[k][v])).all(axis=-1)
        assert ok.mean() >= 0.99 and err.max() <= 1e-3, (k, ok.mean(),
                                                          err.max())


def test_grid_and_photon_chunk_match_tpurt(iteration):
    (_, _, grid_t, Phi_t, M_t), (_, _, grid_p, Phi_p, M_p, pairs) = iteration
    for name, w, g in zip(("es_keys", "es_vals", "lo", "diag", "res",
                           "max_occ"), grid_t, grid_p):
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert M_t.sum() > 200 and pairs >= M_t.sum()
    np.testing.assert_array_equal(M_p, M_t)
    np.testing.assert_allclose(Phi_p, Phi_t, rtol=1e-4,
                               atol=1e-4 * float(Phi_t.max()))
    np.testing.assert_allclose(Phi_p.sum(), Phi_t.sum(), rtol=1e-5)
