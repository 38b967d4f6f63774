"""Frame F at a small size under ``Integrator "bdpt"`` (16x16, 2 spp,
maxdepth 3: the camera in fog, a 16^3 grid medium in a null-material
sphere, a glass sphere holding a scattering medium, a spot and a sphere
area light): the media walk with its medium vertices, the connection
batch's shadow walk through the null boundary and its transmittance,
the port's CLI render against tpurt's on the CPU, the two packages'
tables of it bit for bit, and the port's render of tpurt's tables
against its own.  The grid's tracking uniforms hash tpurt's lane
numbering (the camera half, the light half at +chunk, connection
strategy k at +k chunks), so this frame holds the port to it.  One cold
tpurt bdpt jit (the module fixture).

Bounds: test_torch_media.py's assert_standing_bounds.  Measured on the
CPU: means 2.1e-7 relative apart, every pixel within the bound.
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

SCENE = media_scene("small", res=16, integrator="bdpt", maxdepth=3)


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    return render_pair(SCENE, tmp_path_factory.mktemp("bdpt_media"))


def test_bdpt_media_frame_matches_tpurt(frame):
    want, job, got = frame
    sc = job.scene
    assert job.cfg.name == "bdpt"
    assert sc.has_media and sc.has_grid_media and sc.has_null_boundaries
    assert_standing_bounds(got, want)


def test_bdpt_media_frame_tables_equal_port_build(frame, monkeypatch):
    _, job, _ = frame
    _build_like_tpurt(monkeypatch)
    tab = host_tables(load_scene_string(SCENE))
    _assert_same_tables(scene_from_tpurt(job), tab)
    assert tab["cfg"].name == "bdpt" and tab["media"]["has_grid_media"]


def test_render_from_tpurt_tables_equals_cli_render(frame):
    _, job, got = frame
    img = render_job(job_from_tables(scene_from_tpurt(job), "cpu"))
    np.testing.assert_array_equal(img, got)
