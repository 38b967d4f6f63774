"""Scene D as a whole against tpurt on the CPU: the 32x32 frame of every
material kind, quadric and light the slice adds (2 spp halton, path,
maxdepth 5) through the port's CLI and through tpurt's own tables.
Bounds in torch_material_scenes.
"""

import pytest
import torch

from torch_material_scenes import (check_close, check_from_tpurt_tables,
                                   render_both, write_maps)
from tpurt_torch.testscenes import materials_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    d = tmp_path_factory.mktemp("materials")
    return render_both(materials_scene("small", write_maps(d),
                                       str(d / "out.exr")), d)


def test_cli_matches_tpurt(renders):
    want, _job, got = renders
    check_close(got, want)


def test_render_from_tpurt_tables_matches(renders):
    _want, job, got = renders
    check_from_tpurt_tables(job, got)
