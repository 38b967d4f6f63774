"""Frame M in miniature against tpurt on the CPU: a 12x12 path render of
the fourier mesh on the Ptex ground (tests/torch_lens_fourier_scenes.py),
by the port's CLI and from tpurt's own tables (the baked fourier tables,
their etas and the material rows' table index carried across by
tpurt_torch.convert), under the standing bounds; and the same scene
under --spectrum sampled, where the fourier f is lifted to the bins
without the 0.94 reflectance scale.
"""

import numpy as np
import pytest
import torch

from torch_lens_fourier_scenes import ptex_fourier_tiny, write_inputs
from torch_material_scenes import (check_close, check_from_tpurt_tables,
                                   render_both)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    d = tmp_path_factory.mktemp("ptex_fourier")
    files = write_inputs(d)
    return render_both(ptex_fourier_tiny(files), d) + (files,)


def test_ptex_fourier_frame_matches_tpurt(renders):
    want, job, got, _files = renders
    assert job.scene.has_fourier and len(job.scene.fr_tables) == 1
    check_close(got, want)
    check_from_tpurt_tables(job, got)


def test_ptex_fourier_spectral_lifts_the_tabulated_f(renders):
    """Under --spectrum sampled the fourier lanes carry 60 bins: the
    image is finite and within 20% of the RGB render's mean (the analytic
    basis is not energy-preserving: ROADMAP, Queue 3), and the fourier
    term is lifted by lift_refl_raw, not lift_refl."""
    from tpurt_torch.render.driver import render
    from tpurt_torch.render.integrator import lift_f_maybe
    from tpurt_torch.scene import load_scene_string
    from tpurt_torch.spectrum_sampled import lift_refl, lift_refl_raw

    _want, _job, got, files = renders
    img, job = render(load_scene_string(ptex_fourier_tiny(files)), "cpu",
                      spectrum="sampled")
    assert job.cfg.nch == 60 and np.isfinite(img).all()
    assert abs(img.mean() - got.mean()) < 0.2 * got.mean()
    f = torch.rand((64, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(lift_f_maybe(f, 60), lift_refl_raw(f))
    assert not torch.allclose(lift_refl(f), lift_refl_raw(f))
