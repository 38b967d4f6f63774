"""Integrator "bdpt" in sampled-spectrum mode: vertex throughputs and
emissions in 60 bins, scalar MIS weights, each strategy's contribution
and splat converted to RGB at its deposit.  The port's CLI render against
tpurt's on the CPU (maxdepth 2: every strategy kind, s = 0, t = 1 splats,
s = 1 and the general connection), one cold tpurt jit.  Bounds:
test_torch_spectral.py's."""

import torch

from test_torch_spectral import assert_standing_bounds, render_spectral_pair
from tpurt_torch.testscenes import spectral_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_spectral_bdpt_matches_tpurt(tmp_path):
    want, got = render_spectral_pair(spectral_scene("bdpt", maxdepth=2),
                                     tmp_path)
    assert_standing_bounds(got, want)
