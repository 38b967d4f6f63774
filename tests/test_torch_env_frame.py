"""The environment camera's 64x64 scene, which sees scene D's sky map
alone (its image is the map's lookup), against tpurt on the CPU through
the port's CLI and tpurt's own tables; and against the map's halves.
Bounds in torch_material_scenes.
"""

import numpy as np
import pytest
import torch

from torch_material_scenes import (check_close, check_from_tpurt_tables,
                                   render_both)
from tpurt_torch.io.image import read_image
from tpurt_torch.testscenes import camera_scene, write_sky_map

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    d = tmp_path_factory.mktemp("env")
    maps = dict(sky=write_sky_map(str(d / "sky.exr")))
    return render_both(camera_scene("environment", maps,
                                    str(d / "out.exr")), d) + (maps,)


def test_cli_matches_tpurt(renders):
    want, _job, got, _ = renders
    check_close(got, want)


def test_render_from_tpurt_tables_matches(renders):
    _want, job, got, _ = renders
    check_from_tpurt_tables(job, got)


def test_image_is_the_sky(renders):
    """The camera looks along +z with +y up; column x looks toward
    phi = 2 pi x / w from the camera's +x (environment.cpp), so the first
    and last quarters see world x > 0, the map's warm half, and the middle
    two world x < 0, its cool half (taken 70 degrees from the zenith,
    clear of the sun); the bottom row is the map's dim lower half."""
    _want, _job, got, maps = renders
    h, w = got.shape[:2]
    row = got[int(h * 70 / 180)]
    q = w // 4
    warm = np.concatenate([row[:q], row[3 * q:]]).mean(0)
    cool = row[q:3 * q].mean(0)
    assert warm[0] > 2 * warm[2] and cool[2] > 2 * cool[0], (warm, cool)
    sky = read_image(maps["sky"])
    np.testing.assert_allclose(got[-1].mean(), sky[-1].mean(), rtol=0.05)
