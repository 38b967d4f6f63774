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

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpf_oracle as oracle
from tpurt.config import set_config
from tpurt.rpf import filter as TF
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.rpf.driver import fill_sample_buffer as tpurt_fill_sample_buffer
from tpurt.rpf.driver import splat_buffer as tpurt_splat_buffer
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.render.film import Film
from tpurt_torch.render.filters import Filter
from tpurt_torch.rpf import filter as PF
from tpurt_torch.rpf.driver import render_rpf, splat_buffer
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


def test_mi_subset_path_matches_tpurt(monkeypatch):
    """A 64-row MI cap makes box 7 (4 + 196 neighborhood rows) take the
    strided-subset path in both packages."""
    monkeypatch.setattr(TF, "MI_MAX_SAMPLES", 64)
    monkeypatch.setattr(PF, "MI_MAX_SAMPLES", 64)
    TF._filter_run_call.cache_clear()
    buf = _filter_buffer(6)
    try:
        want = _tpurt_filter(buf, 7, 5.0)
    finally:
        TF._filter_run_call.cache_clear()  # drop the capped build
    assert PF.filter_plan(7, 4)[0] is not None
    got = PF.apply_rpf_filter(torch.as_tensor(buf), 7, sigma_seed=5.0).numpy()
    np.testing.assert_allclose(got[..., 2:5], want[..., 2:5], atol=2e-5)


@pytest.mark.parametrize("radius", [0.5, 1.5])
def test_splat_buffer_matches_tpurt(radius):
    """Same tap set, bounds drops, NaN/inf scrub and luminance clamp."""
    from tpurt.render.film import Film as TFilm
    from tpurt.render.filters import Filter as TFilter

    rng = np.random.default_rng(11)
    h, w, s = 9, 13, 4
    buf = np.zeros((h, w, s, 19), np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    buf[..., 0] = xx[..., None] + rng.uniform(0, 1, (h, w, s))
    buf[..., 1] = yy[..., None] + rng.uniform(0, 1, (h, w, s))
    buf[..., 2:5] = rng.uniform(0, 2, (h, w, s, 3))
    buf[0, 0, 0, 2] = np.nan
    buf[1, 2, 1, 3] = np.inf
    buf[2, 3, 2, 2:5] = 50.0
    tfilm = TFilm(full_x=w, full_y=h, crop=(0, w, 0, h),
                  filter=TFilter("box", (radius, radius), ()),
                  filename="t.exr", scale=1.0, diagonal_m=0.035,
                  max_sample_luminance=3.0)
    want = np.asarray(tpurt_splat_buffer(SimpleNamespace(film=tfilm),
                                         jnp.asarray(buf)))
    film = Film(full_x=w, full_y=h, crop=(0, w, 0, h),
                filter=Filter("box", (radius, radius)), filename="t.exr",
                scale=1.0, max_sample_luminance=3.0)
    got = splat_buffer(film, torch.as_tensor(buf))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


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


def test_rpf_sample_buffer_matches_tpurt(tpurt_buffer, port_render):
    """The raw (16, 16, 2, 19) buffers row for row.  The first measured
    run gave: film positions equal, lens positions within 3.0e-8 (one
    ulp), colors within 4.4e-6, normals and positions within 1.9e-5.
    Frozen bounds: positions within 1e-6; colors within 1e-3 abs + 1e-3
    rel on >= 99% of rows; normals and positions within 1e-4 abs + 1e-4
    rel on >= 99% of rows.  (Float rounding of the same Halton samples,
    tpurt's lax.scan step against the port's compacted bounce loop, as in
    test_torch_render.)"""
    want, got = tpurt_buffer[1], port_render[2]["raw_buffer"]
    assert got.shape == want.shape == (16, 16, 2, 19)
    np.testing.assert_allclose(got[..., 0:2], want[..., 0:2], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[..., 5:7], want[..., 5:7], rtol=0,
                               atol=1e-6)
    col = np.abs(got[..., 2:5] - want[..., 2:5]) <= 1e-3 + 1e-3 * np.abs(
        want[..., 2:5])
    assert col.all(axis=-1).mean() >= 0.99
    feat = np.abs(got[..., 7:] - want[..., 7:]) <= 1e-4 + 1e-4 * np.abs(
        want[..., 7:])
    assert feat.all(axis=-1).mean() >= 0.99
    assert np.abs(got[..., 7:]).max() > 0.1  # features were captured


@pytest.mark.parametrize("sigma", [0.002, 5.0])
def test_port_filter_and_splat_of_tpurt_buffer_match_tpurt(
        tpurt_buffer, port_render, sigma):
    """tpurt's raw buffer through tpurt's filter (box 7) and splat, and
    through the port's, at the reference seed and the strong seed 5.0.
    The first measured run gave filtered colors within 2.0e-6 (seed
    0.002, which moves no color of this frame) and 1.5e-5 (seed 5.0,
    which moves colors by up to 8.2e-3), images within 1.5e-7, and the
    port's own render within 1.5e-6 of tpurt's image (means 8.4e-8
    relative apart).  Frozen bounds: filtered colors within 1e-4 abs +
    1e-4 rel on >= 99% of samples, images within 1e-4 abs + 1e-4 rel on
    >= 99% of pixels and means within 1e-4 relative; the port's own
    render as the path slice (mean within 1e-3 relative, >= 99% of
    pixels within 1e-3 abs + 1e-3 rel)."""
    tjob, raw = tpurt_buffer
    set_config(rpf_sigma_seed=sigma)
    try:
        want_f = np.asarray(TF.apply_rpf_filter(jnp.asarray(raw), 7,
                                                pixel_chunk=16,
                                                chunks_per_call=16))
    finally:
        set_config(rpf_sigma_seed=TF.SIGMA_FC_SEED)
    want_img = np.asarray(tpurt_splat_buffer(tjob, jnp.asarray(want_f)))
    got_img, job, _ = port_render
    filt = PF.apply_rpf_filter(torch.as_tensor(raw.copy()), 7,
                               sigma_seed=sigma)
    ok = np.abs(filt.numpy()[..., 2:5] - want_f[..., 2:5]) <= (
        1e-4 + 1e-4 * np.abs(want_f[..., 2:5]))
    assert ok.all(axis=-1).mean() >= 0.99
    img = splat_buffer(job.film, filt)
    ok = np.abs(img - want_img) <= 1e-4 + 1e-4 * np.abs(want_img)
    assert ok.all(axis=-1).mean() >= 0.99
    assert abs(img.mean() - want_img.mean()) <= 1e-4 * want_img.mean()
    assert want_img.mean() > 0.01 and np.isfinite(got_img).all()
    if sigma == TF.SIGMA_FC_SEED:  # the port's render_rpf uses this seed
        assert abs(got_img.mean() - want_img.mean()) <= (
            1e-3 * want_img.mean())
        ok = np.abs(got_img - want_img) <= 1e-3 + 1e-3 * np.abs(want_img)
        assert ok.all(axis=-1).mean() >= 0.99
