"""Integrator "whitted" in sampled-spectrum mode on a scene with a glass
sphere and a mirror (the specular continuation carries the bins), the
port's CLI render against tpurt's on the CPU, one cold tpurt jit.
Bounds: test_torch_spectral.py's."""

import torch

from test_torch_spectral import assert_standing_bounds, render_spectral_pair
from tpurt_torch.testscenes import SPECTRAL_SPECULAR_WORLD, spectral_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_spectral_whitted_matches_tpurt(tmp_path):
    want, got = render_spectral_pair(
        spectral_scene("whitted", maxdepth=4, world=SPECTRAL_SPECULAR_WORLD),
        tmp_path)
    assert_standing_bounds(got, want)
