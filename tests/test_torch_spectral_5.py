"""Integrator "volpath" in sampled-spectrum mode with both media kinds:
a homogeneous medium of coloured sigmas (each bin's own extinction, the
hero channel drawn over the 60 bins, pdf the bins' mean) in a
``Material "none"`` sphere, and a grid medium in another (per-bin albedo
sig_s / sig_t of the promoted sigmas, its scalar ratio-tracking
transmittance in every bin).  The port's CLI render against tpurt's on
the CPU, one cold tpurt jit.  Bounds: test_torch_spectral.py's."""

import torch

from test_torch_spectral import assert_standing_bounds, render_spectral_pair
from tpurt_torch.testscenes import spectral_media_world, spectral_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_spectral_volpath_media_match_tpurt(tmp_path):
    want, got = render_spectral_pair(
        spectral_scene("volpath", maxdepth=3, world=spectral_media_world()),
        tmp_path)
    assert_standing_bounds(got, want)
