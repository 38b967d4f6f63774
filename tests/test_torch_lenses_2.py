"""Frame L in miniature against tpurt on the CPU: a 12x12 path render
through Camera "realistic" (tests/torch_lens_fourier_scenes.py), by the
port's CLI and from tpurt's own tables, under the standing bounds (mean
within 1e-3 relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel); and
the realistic camera's importance under bdpt, mlt and sppm, which is
tpurt's perspective formulas on the realistic camera's tables.  Both
packages build the exit pupil over 8 zones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lens_fourier_scenes import (realistic_tiny, tpurt_lens_zones,
                                       write_inputs)
from torch_material_scenes import (check_close, check_from_tpurt_tables,
                                   render_both)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    tpurt_lens_zones(mp)
    d = tmp_path_factory.mktemp("realistic")
    yield render_both(realistic_tiny(write_inputs(d)), d)
    mp.undo()


def test_realistic_frame_matches_tpurt(renders):
    """The CLI's image, and the port's render of tpurt's tables (the lens
    rows, exit pupil, rear z, diagonal and weighting carried across by
    tpurt_torch.convert), against tpurt's render."""
    want, job, got = renders
    assert job.camera.kind == "realistic"
    check_close(got, want)
    check_from_tpurt_tables(job, got)


def test_realistic_importance_is_tpurts_perspective_formulas(renders):
    """camera_we, camera_pdf_we and camera_sample_wi on the realistic
    camera (bdpt's t=1 strategies and its camera vertex pdfs) against
    tpurt's on seeded points and directions: the raster-to-camera of the
    identity camera-to-screen maps onto z = 0, so the screen area is
    infinite and We and the directional pdf are 0, as in tpurt."""
    from tpurt.render import camera as tc

    from tpurt_torch.convert import scene_from_tpurt
    from tpurt_torch.render import camera as pc

    _want, job, _got = renders
    cam = pc.camera_from_tables(scene_from_tpurt(job)["camera"], "cpu")
    assert not np.isfinite(float(cam.screen_area))
    rng = np.random.default_rng(4)
    n = 1024
    p = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    tj, pt = job.camera, lambda a: torch.tensor(a)
    we_t, raster_t, valid_t = map(np.asarray, tc.camera_we(
        tj, jnp.asarray(p), jnp.asarray(d)))
    we_p, raster_p, valid_p = (x.numpy() for x in pc.camera_we(
        cam, pt(p), pt(d)))
    np.testing.assert_array_equal(valid_p, valid_t)
    np.testing.assert_array_equal(we_p, we_t)
    assert valid_t.any() and (we_t == 0).all()
    np.testing.assert_allclose(raster_p[valid_t], raster_t[valid_t],
                               rtol=1e-4, atol=1e-4)
    for want, got in (
            (tc.camera_pdf_we(tj, jnp.asarray(d)), pc.camera_pdf_we(cam,
                                                                    pt(d))),
            (tc.camera_sample_wi(tj, jnp.asarray(p), jnp.asarray(u))[:3],
             pc.camera_sample_wi(cam, pt(p), pt(u))[:3])):
        for w, g in zip(want, got):
            w, g = np.asarray(w), g.numpy()
            assert w.shape == g.shape
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert (pc.camera_pdf_we(cam, pt(d))[1] == 0).all()
