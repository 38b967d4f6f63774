"""The three light kinds the slice adds against tpurt on the CPU: part 4 of the
cases of test_torch_lights_env.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_lights_env.py.
"""

import dataclasses
import numpy as np
import pytest
import torch

from tpurt_torch.io.image import write_image
from tpurt_torch.render import lights as pl
from tpurt_torch.render.driver import render
from tpurt_torch.scene import load_scene_string
from test_torch_lights_env import (  # noqa: F401  (fixtures among them)
    KIND_NAMES,
    N,
    _t,
    _wall_scene,
    all_lights,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("kind", [pl.LIGHT_PROJECTION, pl.LIGHT_GONIO],
                         ids=lambda k: KIND_NAMES[k])
def test_table_of_one_image_kind_computes_only_it(all_lights, kind):
    """A table that holds one of the two image-lit kinds computes only its
    lookup, and gives exactly what the table holding both gives."""
    _, plt, _ = all_lights
    one = dataclasses.replace(plt, has_projection=kind == pl.LIGHT_PROJECTION,
                              has_gonio=kind == pl.LIGHT_GONIO)
    row = plt.rows[:, 0].tolist().index(kind)
    rng = np.random.default_rng(kind)
    ref = _t(rng.uniform(-2, 4, (N, 3)).astype(np.float32))
    u2 = _t(rng.uniform(size=(N, 2)).astype(np.float32))
    idx = torch.full((N,), row, dtype=torch.int64)
    other = {pl.LIGHT_PROJECTION: pl._gonio_factor,
             pl.LIGHT_GONIO: pl._projection_factor}[kind]
    calls = []
    orig = getattr(pl, other.__name__)
    setattr(pl, other.__name__, lambda *a: calls.append(1) or orig(*a))
    try:
        got = pl.sample_li(one, idx, ref, u2)
    finally:
        setattr(pl, other.__name__, orig)
    assert not calls
    want = pl.sample_li(plt, idx, ref, u2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_projection_light_projects_image(tmp_path):
    """A half-bright slide lights one side of the wall; flipping the slide
    flips the lit side."""
    img = np.zeros((8, 8, 3), np.float32)
    img[:, 4:] = 1.0
    sides = []
    for name, im in (("right", img), ("left", img[:, ::-1].copy())):
        p = str(tmp_path / f"slide_{name}.exr")
        write_image(p, im)
        out, _ = render(load_scene_string(_wall_scene(
            'LightSource "projection" "color I" [60 60 60] "float fov" [40] '
            f'"string mapname" "{p}"')), "cpu")
        lum = out.mean(-1)
        sides.append((lum[:, :8].mean(), lum[:, 8:].mean()))
    (l0, r0), (l1, r1) = sides
    assert abs(l0 - r0) > 0.2 * max(l0, r0)
    assert (l0 > r0) != (l1 > r1)  # flipping the slide flips the side


def test_goniometric_constant_map_matches_point(tmp_path):
    """A goniometric light with a constant map is a point light of the
    same intensity (goniometric.h Scale == 1)."""
    p = str(tmp_path / "flat.exr")
    write_image(p, np.ones((4, 8, 3), np.float32))
    img_g, _ = render(load_scene_string(_wall_scene(
        f'LightSource "goniometric" "color I" [5 5 5] "string mapname" '
        f'"{p}"')), "cpu")
    img_p, _ = render(load_scene_string(_wall_scene(
        'LightSource "point" "color I" [5 5 5]')), "cpu")
    np.testing.assert_allclose(img_g, img_p, rtol=1e-4, atol=1e-6)
