"""Mesh shading tangents against tpurt on the CPU: the 24x20 TANGENT
scene (torch_motion_scenes: an anisotropic metal quad carrying
"vector S" beside one without) through the port's CLI and through
tpurt's own tables.  Bounds in torch_material_scenes.
"""

import pytest
import torch

import torch_motion_scenes as scenes
from torch_material_scenes import (check_close, check_from_tpurt_tables,
                                   render_both)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    d = tmp_path_factory.mktemp("tangent")
    return render_both(scenes.TANGENT, d)


def test_cli_matches_tpurt(renders):
    want, _job, got = renders
    check_close(got, want)


def test_render_from_tpurt_tables_matches(renders):
    _want, job, got = renders
    check_from_tpurt_tables(job, got)
