"""Integrator "sppm" in sampled-spectrum mode: Phi, tau and Ld in 60 bins,
Spectrum::y through the CIE-Y bin weights in the camera pass's and the
photon walk's roulettes, RGB at the resolve.  The port's CLI render
against tpurt's on the CPU (2 iterations, maxdepth 2), one cold tpurt
jit.  Bounds: test_torch_spectral.py's."""

import torch

from test_torch_spectral import assert_standing_bounds, render_spectral_pair
from tpurt_torch.testscenes import spectral_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_spectral_sppm_matches_tpurt(tmp_path):
    want, got = render_spectral_pair(
        spectral_scene("sppm", maxdepth=2,
                       extra=' "integer iterations" [2] "float radius" [0.5]'),
        tmp_path)
    assert_standing_bounds(got, want)
