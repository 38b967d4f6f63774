"""The kd-tree's motion walk (K1km's plain version) and a whole kd render,
the port against tpurt on the CPU.

Motion: frame E's small scene (moving meshes, an animated camera, curves
and hair) under ``Accelerator "kdtree"``: the kd table's delta rows equal
tpurt's, the twin's walk at seeded shutter times bit-equal to tpurt's
op-by-op ``_traverse_wide`` (test_torch_kdtree.py's rays and bounds), and
the triangle rays take the kd body while the curves keep theirs.  Render:
the small stand-in (its light a quad) under the kd-tree through the
port's CLI against tpurt's render, one cold tpurt jit, within the
standing bounds (means within 1e-3 relative, >= 99% of pixels within
1e-3 abs + 1e-3 rel).
"""

import numpy as np
import torch

from test_torch_kdtree import assert_walk_equal
from test_torch_media import assert_standing_bounds, render_pair
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene as tpurt_load_scene
from tpurt_torch.kernels.traverse import leaf_kind
from tpurt_torch.render.driver import build_job
from tpurt_torch.scene import load_scene
from tpurt_torch.testscenes import standin_scene, with_accelerator, \
    write_motion_hair

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_kd_motion_walk_matches_tpurt(tmp_path):
    path = write_motion_hair(str(tmp_path / "e.pbrt"), "small",
                             accelerator="kdtree")
    tjob = tpurt_build_job(tpurt_load_scene(path))
    pjob = build_job(load_scene(path), "cpu")
    g, pg = tjob.scene.geo, pjob.scene.geo
    assert g.accel == pg.accel == "kdtree"
    np.testing.assert_array_equal(pg.knodes_delta.numpy(),
                                  np.asarray(g.knodes_delta))
    t = torch.zeros(1)
    assert leaf_kind(pg, t, "tri") == "kd_motion"
    assert leaf_kind(pg, None, "tri") == "kd"
    assert leaf_kind(pg, t, "curve") == "curve"
    time = np.random.default_rng(7).uniform(0, 1, 2048).astype(np.float32)
    for any_hit in (False, True):
        assert_walk_equal(tjob, pjob, any_hit, time=time, seed=3 + any_hit)


# the stand-in's sphere light as a two-sided quad: a scene of triangles
# only compiles tpurt's render in half the time
SPHERE_LIGHT = ('  AreaLightSource "area" "color L" [40 40 40]\n'
                '  Translate 3 9 -5\n'
                '  Shape "sphere" "float radius" [1.2]')
QUAD_LIGHT = ('  AreaLightSource "area" "color L" [40 40 40] "bool twosided" '
              '"true"\n'
              '  Shape "trianglemesh" "point P" [2 9 -6  4 9 -6  4 9 -4  '
              '2 9 -4] "integer indices" [0 1 2 0 2 3]')


def test_kd_render_matches_tpurt(tmp_path):
    text = standin_scene("small", res=16, spp=2)
    assert SPHERE_LIGHT in text
    text = with_accelerator(text.replace(SPHERE_LIGHT, QUAD_LIGHT), "kdtree")
    want, job, got = render_pair(text, tmp_path)
    assert job.scene.geo.accel == "kdtree" and job.scene.geo.n_quads == 0
    assert_standing_bounds(got, want)
