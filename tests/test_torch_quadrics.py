"""The five quadrics the slice adds (cylinder, disk, cone, paraboloid,
hyperboloid; the sphere with them) against tpurt on the CPU: ray_quadric
and the quadric pass, compute_interaction's normals, uv and dpdu / dpdv
per kind; then the port's analogs of tpurt's test_cylinder_disk_quadrics,
test_hyperboloid_renders_and_matches_implicit and
test_all_quadrics_reintersection (tests/test_intersect.py:172, :239,
:285).

Bounds: against tpurt's ray_quadric op by op, hit masks and the port's
closest prims equal, t within rtol 1e-6 and u / v within 1e-5; points,
normals, uv and dpdu / dpdv of the same hits within 1e-5 (abs + rel).
Inputs come from numpy with fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import interaction as tinter
from tpurt.render import intersect as tisect
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render import interaction as pinter
from tpurt_torch.render import intersect as pisect
from tpurt_torch.render.driver import build_job, host_tables
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

SHAPES = {
    "sphere": 'Shape "sphere" "float radius" [1] "float zmin" [-.6] '
              '"float phimax" [300]',
    "cylinder": 'Shape "cylinder" "float radius" [1] "float zmin" [-1] '
                '"float zmax" [1] "float phimax" [320]',
    "disk": 'Shape "disk" "float radius" [1.5] "float innerradius" [.4] '
            '"float height" [.2]',
    "cone": 'Shape "cone" "float radius" [1] "float height" [1.5]',
    "paraboloid": 'Shape "paraboloid" "float radius" [1] "float zmin" [.1] '
                  '"float zmax" [1]',
    "hyperboloid": 'Shape "hyperboloid" "point p1" [1 0 -1] '
                   '"point p2" [1.4 .3 1]',
}


def _scene(decl: str) -> str:
    return f"""
Film "image" "integer xresolution" [4] "integer yresolution" [4]
Camera "perspective"
WorldBegin
Material "matte" "color Kd" [.5 .5 .5]
Translate 0 0 4
Rotate 60 1 0.3 0
{decl}
WorldEnd
"""


def _rays(rng, n, spread=0.45):
    o = np.zeros((n, 3), np.float32)
    d = np.stack([rng.uniform(-spread, spread, n),
                  rng.uniform(-spread, spread, n), np.ones(n)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def quadric(request):
    """(name, tpurt job, port job, rays) of one quadric scene."""
    text = _scene(SHAPES[request.param])
    tjob = tpurt_build_job(tpurt_load_scene_string(text))
    pjob = build_job(load_scene_string(text), "cpu")
    assert pjob.scene.geo.quads[0][0] == int(np.asarray(
        tjob.scene.geo.prim_type)[pjob.scene.geo.n_tris])
    # (origins off the axis too, so rays hit from every side)
    rng = np.random.default_rng(sorted(SHAPES).index(request.param))
    o, d = _rays(rng, 4096)
    o[::2] += rng.normal(scale=0.4, size=(2048, 3)).astype(np.float32)
    return request.param, tjob, pjob, (o, d)


def test_tables_match_tpurt(quadric):
    name, tjob, pjob, _ = quadric
    text = _scene(SHAPES[name])
    geo = host_tables(load_scene_string(text))["geo"]
    tg = tjob.scene.geo
    for k in ("shade_rows", "quad_w2o", "quad_params", "prim_type",
              "quad_id"):
        assert geo[k].tobytes() == np.asarray(getattr(tg, k)).tobytes(), k


def test_ray_quadric_matches_tpurt(quadric):
    name, tjob, pjob, (o, d) = quadric
    tg, pg = tjob.scene.geo, pjob.scene.geo
    kind, qi = pg.quads[0]
    t_max = np.full(len(o), np.inf, np.float32)
    t_max[::5] = 4.0  # some rays end before the far side
    # disable_jit: lax.switch would otherwise compile the branch as one
    # XLA computation, whose FMA contraction breaks the compensated
    # discriminant's error terms; op by op it rounds like the port
    with jax.disable_jit():
        want = jax.vmap(lambda oo, dd, tm: tisect.ray_quadric(
            oo, dd, tm, jnp.int32(kind), tg.quad_w2o[qi],
            tg.quad_params[qi]))(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t_max))
    got = pisect.ray_quadric(torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(t_max), kind, pg.quad_w2o[qi],
                             pg.quad_params[qi])
    hit = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), hit)
    assert 0.1 < hit.mean() < 0.9, hit.mean()
    np.testing.assert_allclose(got[1].numpy()[hit], np.asarray(want[1])[hit],
                               rtol=1e-6)
    for k in (2, 3):  # u, v
        np.testing.assert_allclose(got[k].numpy()[hit],
                                   np.asarray(want[k])[hit], atol=1e-5)


@pytest.mark.parametrize("dpduv", [False, True])
def test_interaction_matches_tpurt(quadric, dpduv):
    """compute_interaction of the same hits in both (tpurt's ray_quadric,
    op by op, on the scene's one quadric): points, normals, uv and dpdu /
    dpdv; and the port's intersect_closest finds those hits."""
    _, tjob, pjob, (o, d) = quadric
    tg, pg = tjob.scene.geo, pjob.scene.geo
    kind, qi = pg.quads[0]
    with jax.disable_jit():
        h, t, u, v = jax.vmap(lambda oo, dd: tisect.ray_quadric(
            oo, dd, jnp.float32(np.inf), jnp.int32(kind), tg.quad_w2o[qi],
            tg.quad_params[qi]))(jnp.asarray(o), jnp.asarray(d))
    hit = np.asarray(h)
    prim = np.where(hit, pg.n_tris, -1).astype(np.int32)
    th = tisect.Hit(t=t, prim=jnp.asarray(prim), b0=u, b1=v)
    ph = pisect.intersect_closest(pg, torch.as_tensor(o), torch.as_tensor(d),
                                  np.inf, traverse_wide)
    np.testing.assert_array_equal(ph.prim.numpy(), prim)
    np.testing.assert_allclose(ph.t.numpy()[hit], np.asarray(t)[hit],
                               rtol=1e-6)
    want = tinter.compute_interaction(tg, th, jnp.asarray(o), jnp.asarray(d),
                                      dpduv=dpduv)
    same = pisect.Hit(*[torch.as_tensor(np.array(x)) for x in (
        t, prim, u, v)])
    got = pinter.compute_interaction(pg, same, torch.as_tensor(o),
                                     torch.as_tensor(d), dpduv=dpduv)
    fields = ("p", "ng", "ns", "uv") + (("dpdu", "dpdv") if dpduv else ())
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.material_id.numpy(),
                                  np.asarray(want.material_id))


# -- tpurt's quadric tests, for the port ---------------------------------------
