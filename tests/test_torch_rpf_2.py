"""The port's RPF slice against tpurt's, on the CPU: part 2 of the cases of
test_torch_rpf.py, in files of at most three cases so that xdist's loadfile
queue runs them beside the suite's long files.  Helpers, fixtures and bounds
are those of test_torch_rpf.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from tpurt.rpf import filter as TF
from tpurt.rpf.driver import splat_buffer as tpurt_splat_buffer
from tpurt_torch.render.film import Film
from tpurt_torch.render.filters import Filter
from tpurt_torch.rpf import filter as PF
from tpurt_torch.rpf.driver import splat_buffer
from test_torch_rpf import (  # noqa: F401  (fixtures among them)
    _filter_buffer,
    _tpurt_filter,
    port_render,
    tpurt_buffer,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


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
