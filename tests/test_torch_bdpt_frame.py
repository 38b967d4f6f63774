"""Main path G at a small size: the killeroo stand-in under
``Integrator "bdpt"`` (16x16, 2 spp, maxdepth 3: every strategy of
depths 0-3, the light-tracing splats and the connection batch), the
port's CLI render against tpurt's on the CPU, the two packages' tables of
it bit for bit, and the port's render of tpurt's tables against its own.
One cold tpurt bdpt jit (the module fixture).

Bounds: test_torch_media.py's assert_standing_bounds (means within 1e-3
relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel).  Measured on the
CPU: means 1.7e-7 relative apart, every pixel within the bound.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render.driver import host_tables, job_from_tables, render_job
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import standin_scene
from test_torch_intersect import _assert_same_tables, _build_like_tpurt
from test_torch_media import assert_standing_bounds, render_pair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

SCENE = standin_scene("small", integrator="bdpt", res=16, maxdepth=3)


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    return render_pair(SCENE, tmp_path_factory.mktemp("bdpt"))


def test_bdpt_frame_matches_tpurt(frame):
    want, job, got = frame
    assert job.cfg.name == "bdpt" and job.cfg.max_depth == 3
    assert_standing_bounds(got, want)


def test_bdpt_frame_tables_equal_port_build(frame, monkeypatch):
    """scene_from_tpurt on the bdpt frame equals the port's own build of
    the scene, table for table: the light table's world centre and the
    bdpt config included."""
    _, job, _ = frame
    _build_like_tpurt(monkeypatch)
    tab = host_tables(load_scene_string(SCENE))
    _assert_same_tables(scene_from_tpurt(job), tab)
    assert tab["cfg"].name == "bdpt" and tab["cfg"].light_strategy == "power"
    assert tab["lights"]["world_center"].dtype == np.float32


def test_render_from_tpurt_tables_equals_cli_render(frame):
    _, job, got = frame
    img = render_job(job_from_tables(scene_from_tpurt(job), "cpu"))
    np.testing.assert_array_equal(img, got)
