"""The RPF sampling pass under Sampler "random" and "stratified": the
port against tpurt on the CPU, row for row of the raw sample buffer.

Bounds (those of the Halton case in test_torch_rpf.py): film and lens
positions within 1e-6; colors within 1e-3 abs + 1e-3 rel on >= 99% of rows;
normals and positions within 1e-4 abs + 1e-4 rel on >= 99% of rows.  The
samplers themselves are bit-equal (test_torch_samplers.py); what differs
is float rounding in the bounce step.
"""

import numpy as np
import pytest
import torch

from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.rpf.driver import fill_sample_buffer as tpurt_fill_sample_buffer
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.rpf.driver import render_rpf
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import standin_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _sampler_text(sampler):
    text = standin_scene("small", integrator="rpf", sampler=sampler)
    text = text.replace("[32]", "[12]")
    # 2x2 strata: 4 spp keeps tpurt's filter compile small
    return text.replace('Sampler "stratified"', 'Sampler "stratified" '
                        '"integer xsamples" [2] "integer ysamples" [2]')


@pytest.mark.parametrize("sampler,spp", [("random", 2), ("stratified", 4)])
def test_rpf_sample_buffer_under_sampler_matches_tpurt(sampler, spp):
    """The sampling pass under Sampler "random" and "stratified" (12x12):
    the raw buffers row for row with the bounds of the module docstring, and the
    port's filtered, splatted image finite and close to its raw mean."""
    text = _sampler_text(sampler)
    job = tpurt_build_job(tpurt_load_scene_string(text))
    want = np.asarray(tpurt_fill_sample_buffer(job)[0])
    img, pjob, extras = render_rpf(load_scene_string(text), device="cpu",
                                   write_feature_exrs=False,
                                   return_buffers=True)
    got = extras["raw_buffer"]
    assert pjob.sampler.name == sampler and pjob.sampler.spp == spp
    assert got.shape == want.shape == (12, 12, spp, 19)
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
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert abs(img.mean() - got[..., 2:5].mean()) < 0.2 * img.mean()
