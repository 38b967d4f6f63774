"""The all-spheres strong-filter RPF gate: the port against tpurt on the
CPU (the scene of tpurt's own strong-filter test, where the bilateral
blend has neighbors to admit).  Bounds in the test's docstring.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.config import set_config
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.rpf import filter as TF
from tpurt.rpf.driver import fill_sample_buffer as tpurt_fill_sample_buffer
from tpurt.rpf.driver import splat_buffer as tpurt_splat_buffer
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.rpf import filter as PF
from tpurt_torch.rpf.driver import splat_buffer
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _tpurt_filter(buf, box, sigma):
    set_config(rpf_sigma_seed=sigma)
    try:
        return np.asarray(TF.apply_rpf_filter(jnp.asarray(buf), box,
                                              pixel_chunk=16,
                                              chunks_per_call=8))
    finally:
        set_config(rpf_sigma_seed=TF.SIGMA_FC_SEED)


SPHERES_RPF = """
LookAt 0 0.9 2.2  0 0.1 0  0 1 0
Camera "perspective" "float fov" [52]
Film "image" "integer xresolution" [20] "integer yresolution" [20]
  "string filename" "spheres.exr"
Sampler "halton" "integer pixelsamples" [4]
Integrator "rpf" "integer maxdepth" [4]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [30 29 25]
  Translate -1.5 3 1
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "plastic" "color Kd" [.3 .4 .65] "color Ks" [.45 .45 .45]
  "float roughness" [.07]
Shape "sphere" "float radius" [0.85]
Material "matte" "color Kd" [.5 .45 .4]
AttributeBegin
Translate 1.2 -0.3 0.6
Shape "sphere" "float radius" [0.45]
AttributeEnd
AttributeBegin
Translate -1.1 -0.4 0.4
Shape "sphere" "float radius" [0.35]
AttributeEnd
WorldEnd
"""


def test_all_spheres_strong_filter_matches_tpurt():
    """The all-spheres scene of tpurt's strong-filter gate (curvature in
    every pixel, so the bilateral blend has neighbors to admit) at sigma
    seed 5.0, 20x20 at 4 spp: each package filters and splats its OWN
    sampling pass.  Bounds: the filter moves tpurt's image (it acts), the
    raw and the filtered buffers' colors each agree within 1e-3 abs +
    1e-3 rel on >= 99% of samples, and images as the path slice (means
    within 1e-3 relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel)."""
    job = tpurt_build_job(tpurt_load_scene_string(SPHERES_RPF))
    raw = np.asarray(tpurt_fill_sample_buffer(job)[0])
    want_f = _tpurt_filter(raw, 7, 5.0)
    want_img = np.asarray(tpurt_splat_buffer(job, jnp.asarray(want_f)))
    raw_img = np.asarray(tpurt_splat_buffer(job, jnp.asarray(raw)))
    assert np.abs(want_img - raw_img).max() > 0.01  # the blend fires

    from tpurt_torch.render.driver import build_job
    from tpurt_torch.rpf.driver import fill_sample_buffer

    pjob = build_job(load_scene_string(SPHERES_RPF), "cpu")
    got_raw = fill_sample_buffer(pjob)
    col = np.abs(got_raw.numpy()[..., 2:5] - raw[..., 2:5]) <= (
        1e-3 + 1e-3 * np.abs(raw[..., 2:5]))
    assert col.all(axis=-1).mean() >= 0.99
    got_f = PF.apply_rpf_filter(got_raw, 7, sigma_seed=5.0)
    ok = np.abs(got_f.numpy()[..., 2:5] - want_f[..., 2:5]) <= (
        1e-3 + 1e-3 * np.abs(want_f[..., 2:5]))
    assert ok.all(axis=-1).mean() >= 0.99
    img = splat_buffer(pjob.film, got_f)
    assert abs(img.mean() - want_img.mean()) <= 1e-3 * want_img.mean()
    ok = np.abs(img - want_img) <= 1e-3 + 1e-3 * np.abs(want_img)
    assert ok.all(axis=-1).mean() >= 0.99
