"""The RPF filter's sigma seed (tpurt's config rpf_sigma_seed,
tpurt/config.py:119, read at tpurt/rpf/filter.py:379-380), which the
port takes as an argument: the port's filter at seed 0.05 (tpurt's
strong-filter gate's) and 0.5 equals tpurt's at the same rpf_sigma_seed
(raised through tpurt's own set_config and restored) on a
well-conditioned buffer within the standing 2e-5, and render_rpf passes
its ``sigma_seed`` to the filter.  On this buffer 0.05 still leaves
every pixel's own samples alone (features of independent noise
z-normalise to distances of order 1); 0.5 blends them.  The buffer's
features are centred on 0: on tpurt's recipe of 1 + 0.01 noise the
one-pass float32 std (ROADMAP Queue 3, "Fragile reference RPF") keeps ~3
digits, and at seed 0.5 the two packages then differ by up to 9e-5 on 6
seeded buffers (the mutual informations and weights equal to 6e-8); 2e-6
with the features centred.
"""

import numpy as np
import pytest
import torch

from torch_parallel_worker import filter_buffer

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)



@pytest.mark.parametrize("seed", [0.05, 0.5])
def test_filter_at_raised_seed_matches_tpurt(seed):
    import jax.numpy as jnp
    from tpurt.config import get_config, set_config
    from tpurt.rpf.filter import apply_rpf_filter as t_filter
    from tpurt_torch.rpf.filter import SIGMA_FC_SEED, apply_rpf_filter

    buf = filter_buffer(6, seed=3, offset=0.0)
    before = get_config().rpf_sigma_seed
    assert before == SIGMA_FC_SEED
    set_config(rpf_sigma_seed=seed)
    try:
        want = np.asarray(t_filter(jnp.asarray(buf), 5))
    finally:
        set_config(rpf_sigma_seed=before)
    got = apply_rpf_filter(torch.tensor(buf), 5, seed).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    weak = apply_rpf_filter(torch.tensor(buf), 5).numpy()
    assert (np.abs(weak - got).max() > 0.1) == (seed == 0.5)


def test_render_rpf_passes_the_seed():
    from tpurt_torch.rpf.driver import render_rpf
    from tpurt_torch.rpf.filter import apply_rpf_filter
    from tpurt_torch.scene import load_scene_string
    from tpurt_torch.testscenes import standin_scene

    sd = load_scene_string(standin_scene("small", integrator="rpf", res=12))
    _img, _job, ex = render_rpf(sd, "cpu", write_feature_exrs=False,
                                return_buffers=True, sigma_seed=0.5)
    raw = torch.tensor(ex["raw_buffer"])
    np.testing.assert_array_equal(ex["filtered_buffer"],
                                  apply_rpf_filter(raw, 7, 0.5).numpy())
    assert not np.array_equal(ex["filtered_buffer"],
                              apply_rpf_filter(raw, 7).numpy())
