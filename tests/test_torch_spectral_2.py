"""The path integrator in sampled-spectrum mode: the port's CLI render
(--spectrum sampled) against tpurt's render under spectrum_mode "sampled"
on the CPU, one cold tpurt jit.  Bounds: test_torch_spectral.py's."""

import torch

from test_torch_spectral import assert_standing_bounds, render_spectral_pair
from tpurt_torch.testscenes import spectral_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_spectral_path_matches_tpurt(tmp_path):
    want, got = render_spectral_pair(spectral_scene("path", maxdepth=4),
                                     tmp_path)
    assert_standing_bounds(got, want)
