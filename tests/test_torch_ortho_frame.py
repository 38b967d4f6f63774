"""The orthographic camera's 64x64 scene (a sphere and a box on a ground
under a constant infinite light and a distant light) against tpurt on the
CPU, through the port's CLI and through tpurt's own tables.  Bounds in
torch_material_scenes.
"""

import pytest
import torch

from torch_material_scenes import (check_close, check_from_tpurt_tables,
                                   render_both)
from tpurt_torch.testscenes import camera_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    d = tmp_path_factory.mktemp("ortho")
    return render_both(camera_scene("orthographic", {}, str(d / "out.exr")),
                       d)


def test_cli_matches_tpurt(renders):
    want, _job, got = renders
    check_close(got, want)


def test_render_from_tpurt_tables_matches(renders):
    _want, job, got = renders
    check_from_tpurt_tables(job, got)
