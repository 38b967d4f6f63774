"""Scene D under Integrator "rpf" against tpurt on the CPU: the 32x32,
2 spp frame's sampling pass row for row, and the filtered image.  tpurt
runs its render_rpf stage by stage (fill_sample_buffer ->
apply_rpf_filter -> splat_buffer), the port its CLI path (render_rpf).

Bounds (those of test_torch_rpf): film and lens positions within 1e-6;
colors within 1e-3 abs + 1e-3 rel on >= 99% of rows; normals and
positions within 1e-4 abs + 1e-4 rel on >= 99% of rows; the image as
the path slice's (torch_material_scenes.check_close).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_material_scenes import check_close, write_maps
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.rpf import filter as TF
from tpurt.rpf.driver import fill_sample_buffer as tpurt_fill_sample_buffer
from tpurt.rpf.driver import splat_buffer as tpurt_splat_buffer
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.rpf.driver import render_rpf
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import materials_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("materials_rpf")
    text = materials_scene("small", write_maps(d), str(d / "out.exr"),
                           integrator="rpf")
    job = tpurt_build_job(tpurt_load_scene_string(text))
    raw = np.asarray(tpurt_fill_sample_buffer(job)[0])
    filt = TF.apply_rpf_filter(jnp.asarray(raw), 7, pixel_chunk=64,
                               chunks_per_call=16)
    want = np.asarray(tpurt_splat_buffer(job, filt))
    got, _job, extras = render_rpf(load_scene_string(text), device="cpu",
                                   write_feature_exrs=False,
                                   return_buffers=True)
    return raw, want, extras["raw_buffer"], got


def test_sample_buffer_matches_tpurt(frames):
    want, _, got, _ = frames
    assert got.shape == want.shape == (32, 32, 2, 19)
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


def test_filtered_image_matches_tpurt(frames):
    _, want, _, got = frames
    check_close(got, want)
