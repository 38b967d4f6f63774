"""Frame F at its small size (tpurt_torch.testscenes.media_scene("small"):
32x32, 2 spp, volpath at maxdepth 5, the camera in fog, a 16^3 grid
medium inside a null-material sphere, a glass sphere holding a
scattering medium, a spot light and a sphere area light): the port's CLI
render against tpurt's on the CPU, the two packages' tables of it bit
for bit, and the port's render of tpurt's tables against its own.  One
cold tpurt volpath jit (the module fixture).

Bounds: test_torch_media.py's assert_standing_bounds.  The first run
measured the means 5.7e-4 relative apart and one pixel of 1,024 outside
1e-3 (by 0.45, one path that went another way); tpurt's volpath jitted
alone gives the port's lanes, all 2,048 of them, so that lane differs
between two XLA compilations of tpurt's own volpath (jitted alone and
jitted with the film) as well.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render.driver import host_tables, job_from_tables, render_job
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import media_scene
from test_torch_intersect import _assert_same_tables, _build_like_tpurt
from test_torch_media import assert_standing_bounds, render_pair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    return render_pair(media_scene("small"),
                       tmp_path_factory.mktemp("media"))


def test_media_frame_matches_tpurt(frame):
    want, job, got = frame
    sc = job.scene
    assert sc.has_media and sc.has_grid_media and sc.has_null_boundaries
    assert sc.camera_medium >= 0
    assert_standing_bounds(got, want)


def test_media_frame_tables_equal_port_build(frame, monkeypatch):
    """scene_from_tpurt on frame F equals the port's own build of the
    scene, table for table: the media tables, the medium ids in the shade
    rows, the Material "none" row and the volpath config."""
    _, job, _ = frame
    _build_like_tpurt(monkeypatch)
    tab = host_tables(load_scene_string(media_scene("small")))
    _assert_same_tables(scene_from_tpurt(job), tab)
    assert tab["cfg"].name == "volpath" and tab["media"]["has_grid_media"]


def test_render_from_tpurt_tables_equals_cli_render(frame):
    _, job, got = frame
    img = render_job(job_from_tables(scene_from_tpurt(job), "cpu"))
    np.testing.assert_array_equal(img, got)
