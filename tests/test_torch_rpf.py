"""The port's RPF slice against tpurt's, on the CPU.

Inputs are made with numpy.random.default_rng and go through tpurt (jax)
and the port (torch).  Tolerances and why:

- MI and CF weights: the same float32 formulas, held to each other and to
  the f64 oracle with tpurt's own bounds (tests/test_rpf.py); CF weights
  of the same MI values agree to 1e-6.
- The filter (apply_rpf_filter) on a well-conditioned buffer: atol 2e-5.
  Sums over the neighborhood are taken in another order and exp/log differ
  in the last ulp; measured differences are below 5e-6 where the strong
  filter moves colors by up to 0.65.  (On features that are constant up
  to ~1e-4 the reference's one-pass std is rounding noise, and tpurt's own
  jitted and eager filters then disagree on a few pixels; that regime is
  covered by the whole-slice test below with its own bound.)
- The splat: the same dense shifted adds in the same order; rtol 1e-6.
- The whole slice (16x16, 2 spp stand-in): see the docstrings there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpf_oracle as oracle
from tpurt.config import set_config
from tpurt.rpf import filter as TF
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.rpf.driver import fill_sample_buffer as tpurt_fill_sample_buffer
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.rpf import filter as PF
from tpurt_torch.rpf.driver import render_rpf
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import standin_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _mi_inputs(seed, n=60):
    """Correlated and independent columns, and three pixels' masks (all
    rows, the first 49, every other row)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n)
    cols = np.zeros((n, 19), np.float32)
    for c in range(19):
        mix = (c % 4) / 4.0
        cols[:, c] = mix * base + (1 - mix) * rng.standard_normal(n)
    cols[:, 7] = 1.0  # a constant column: all mass in bin 0
    masks = np.zeros((3, n), np.float32)
    masks[0] = 1.0
    masks[1, :49] = 1.0
    masks[2, ::2] = 1.0
    return cols, masks


def _port_mi(cols, masks):
    n = masks.sum(1)
    bins = np.maximum(1, np.sqrt(n).astype(np.int32))
    b_max = int(bins.max()) + 1
    p = masks.shape[0]
    return PF._mutual_information(
        torch.as_tensor(np.broadcast_to(cols, (p,) + cols.shape).copy()),
        torch.as_tensor(masks[:, :, None]), torch.as_tensor(n),
        torch.as_tensor(bins), b_max).numpy(), bins, b_max


def test_mutual_information_matches_tpurt_and_oracle():
    """Both packages and the f64 oracle, per pixel of a 3-pixel batch.
    The port and tpurt usually agree to 1.2e-7; one cold-cache run
    measured 1.1e-5 (XLA's float32 log on the CPU), so the bound is the
    one tests/test_rpf.py holds tpurt to against the oracle."""
    cols, masks = _mi_inputs(0)
    got, bins, b_max = _port_mi(cols, masks)
    for k in range(3):
        m = masks[k]
        want = np.asarray(TF._mutual_information(
            jnp.asarray(cols), jnp.asarray(m[:, None]),
            jnp.float32(m.sum()), jnp.int32(bins[k]), b_max))
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5)
        rows = cols[m > 0].astype(np.float64)
        for j in range(0, 96, 5):
            a, b = TF._PAIRS[j]
            np.testing.assert_allclose(
                got[k, j], oracle.mutual_information(rows[:, a], rows[:, b]),
                rtol=1e-4, atol=1e-5)


def test_cf_weights_match_tpurt_and_oracle():
    rng = np.random.default_rng(2)
    n = 80
    nb = rng.standard_normal((n, 19)).astype(np.float32)
    nb[:, 2] = nb[:, 7] * 2 + 0.1 * rng.standard_normal(n)
    nb[:, 3] = nb[:, 8] + nb[:, 5] * 0.5
    mi, _, _ = _port_mi(nb, np.ones((1, n), np.float32))
    got = [x.numpy()[0] for x in PF._cf_weights(torch.as_tensor(mi))]
    want = [np.asarray(x) for x in TF._cf_weights(jnp.asarray(mi[0]))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    for g, w in zip(got, oracle.cf_weights(nb.astype(np.float64))):
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3)


def _filter_buffer(seed, h=10, w=10, s=4):
    """Colors driven by the random parameters, two feature regions with
    features well away from constant (a well-conditioned one-pass std)."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((h, w, s, 19), np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    buf[..., 0] = xx[..., None] + rng.uniform(0, 1, (h, w, s))
    buf[..., 1] = yy[..., None] + rng.uniform(0, 1, (h, w, s))
    r = rng.uniform(0, 1, (h, w, s, 2)).astype(np.float32)
    buf[..., 5:7] = r
    left = (xx < w // 2)[..., None, None]
    buf[..., 2:5] = (0.5 + 0.4 * np.sin(2 * np.pi * r[..., :1])
                     + 0.1 * np.cos(2 * np.pi * r[..., 1:2]) + 0.3 * left
                     + 0.05 * rng.standard_normal((h, w, s, 3)))
    buf[..., 7:19] = (np.where(left, 0.5, -0.5)
                      + 0.2 * rng.standard_normal((h, w, s, 12)))
    return buf


def _tpurt_filter(buf, box, sigma):
    set_config(rpf_sigma_seed=sigma)
    try:
        return np.asarray(TF.apply_rpf_filter(jnp.asarray(buf), box,
                                              pixel_chunk=16,
                                              chunks_per_call=8))
    finally:
        set_config(rpf_sigma_seed=TF.SIGMA_FC_SEED)


@pytest.mark.parametrize("box,sigma", [(3, 5.0), (7, 0.002), (7, 5.0)])
def test_apply_rpf_filter_matches_tpurt(box, sigma):
    """Box 3 leaves every color as it was (sigma_p = 3 // 4 = 0 admits
    only a sample's own position); at box 7 the reference seed 0.002 moves
    colors a little and the strong seed 5.0 a lot."""
    buf = _filter_buffer(5)
    want = _tpurt_filter(buf, box, sigma)
    got = PF.apply_rpf_filter(torch.as_tensor(buf), box,
                              sigma_seed=sigma).numpy()
    np.testing.assert_array_equal(got[..., 0:2], buf[..., 0:2])
    np.testing.assert_array_equal(got[..., 5:], buf[..., 5:])
    np.testing.assert_allclose(got[..., 2:5], want[..., 2:5], atol=2e-5)
    moved = np.abs(want - buf)[..., 2:5].max()
    assert moved == 0.0 if box == 3 else moved > (0.1 if sigma > 1 else 1e-3)


RPF_TEXT = standin_scene("small", integrator="rpf").replace("[32]", "[16]")


@pytest.fixture(scope="module")
def tpurt_buffer():
    """tpurt's sampling pass over the 16x16, 2 spp stand-in: the first
    stage of its render_rpf (fill_sample_buffer -> apply_rpf_filter ->
    splat_buffer), which the tests below run stage by stage."""
    job = tpurt_build_job(tpurt_load_scene_string(RPF_TEXT))
    buf, _ = tpurt_fill_sample_buffer(job)
    return job, np.asarray(buf)


@pytest.fixture(scope="module")
def port_render():
    img, job, extras = render_rpf(load_scene_string(RPF_TEXT), device="cpu",
                                  write_feature_exrs=False,
                                  return_buffers=True)
    assert (job.film.width, job.film.height, job.sampler.spp) == (16, 16, 2)
    return img, job, extras
