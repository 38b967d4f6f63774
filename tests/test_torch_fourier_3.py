"""The realistic camera, Ptex and the fourier BSDF under Integrator
"bdpt" against tpurt on the CPU: a 12x12 render at maxdepth 1 of the
tiny fourier mesh on the Ptex ground seen through the realistic camera
(tests/torch_lens_fourier_scenes.py), by the port's CLI, under the
standing bounds.  It pins what tpurt does there: bdpt's shading
context replaces the gray stand-in lobe of the fourier rows by the
tabulated BSDF, and the realistic camera's importance is the perspective
formulas on its tables.  Both packages build the exit pupil over 8
zones.
"""

import pytest
import torch

from torch_lens_fourier_scenes import (ptex_fourier_tiny, tpurt_lens_zones,
                                       write_inputs)
from torch_material_scenes import check_close, render_both

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_realistic_ptex_fourier_bdpt_matches_tpurt(tmp_path, monkeypatch):
    tpurt_lens_zones(monkeypatch)
    text = ptex_fourier_tiny(write_inputs(tmp_path), integrator="bdpt",
                             maxdepth=1, realistic=True)
    want, job, got = render_both(text, tmp_path)
    assert job.camera.kind == "realistic" and job.scene.has_fourier
    check_close(got, want)
