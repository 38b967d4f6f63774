"""tpurt_torch.convert on scene D (the materials, quadrics, lights and
cameras slice): the host tables the port reads off a tpurt RenderJob
equal, bit for bit, the ones the port builds from the scene text (mix
ids, conductor k, the light rows, the environment CDFs and the pooled
light maps included), for the 32x32 scene D under path and rpf and for
the two camera scenes.  No render runs.
"""

import numpy as np
import pytest
import torch

from tpurt import native as tpurt_native
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch import native as port_native
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render.driver import host_tables
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import (camera_scene, materials_scene,
                                    write_gonio_map, write_sky_map,
                                    write_slide_map)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _same(a, b, path="tables"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path  # bit for bit, NaNs too
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    return dict(sky=write_sky_map(str(d / "sky.exr")),
                slide=write_slide_map(str(d / "slide.exr")),
                gonio=write_gonio_map(str(d / "gonio.exr")))


SCENES = {
    "path": lambda m: materials_scene("small", m),
    "rpf": lambda m: materials_scene("small", m, integrator="rpf"),
    "orthographic": lambda m: camera_scene("orthographic", m),
    "environment": lambda m: camera_scene("environment", m),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_from_tpurt_equal_port_build(maps, name, monkeypatch):
    text = SCENES[name](maps)
    job = tpurt_build_job(tpurt_load_scene_string(text))
    # the same kind of SAH builder as tpurt's (test_torch_intersect)
    if tpurt_native.get_lib() is None:
        monkeypatch.setattr(port_native, "build_bvh_native",
                            lambda *a, **k: None)
    elif port_native.get_lib() is None:
        pytest.skip("tpurt built with its C++ builder and the port has "
                    "none (no g++ now): nothing of the port's to compare")
    got, want = scene_from_tpurt(job), host_tables(load_scene_string(text))
    mats = (got.pop("materials"), want.pop("materials"))
    _same(got, want)
    assert mats[0]["textured"] == mats[1]["textured"]
    assert mats[0]["has_texfilter"] == mats[1]["has_texfilter"]
    if name in ("path", "rpf"):
        lt = got["lights"]
        assert lt["has_infinite"]
        assert {6, 7} <= set(lt["rows"][:, 0].astype(int).tolist())
        assert lt["env_map"].shape == (256, 512, 3)
        assert lt["img_pool"].shape == (128 * 128 + 64 * 32, 3)
        kinds = got["mt_table"][:, 39].astype(int)
        assert 10 in kinds  # the mix row, its subs appended
