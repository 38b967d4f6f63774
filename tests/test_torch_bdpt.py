"""The port's light emission sampling against tpurt's on the CPU
(render/lights.py's sample_le, pdf_le and light_normal_at against
tpurt/render/lights.py:806-983), over a table holding every light kind:
point, spot, distant, triangle (one- and two-sided) and sphere area
lights, an infinite light (environment-mapped or constant), a projection
and a goniometric light.  Lane inputs come from numpy with fixed seeds.

Bounds: within rtol 1e-5 / atol 1e-6 on >= 99.5% of lanes and within
rtol 1e-4 / atol 1e-4 on all; the kind flags exactly.  The float32
rounding of the same operations moves a few lanes by more: tpurt's
two-sided area light remaps the side-choosing uniform as min(2 u,
0.9999994) mod 1, so every back-side emission takes the cosine warp's
rim, where z = sqrt(1 - x^2 - y^2) keeps a few bits (a fault of tpurt's
the port shares: ROADMAP, Queue 3); measured there, 5 direction
components of 12,288 off by up to 2.7e-5.
The helpers here (the light scene, the lane inputs, _close_most) serve
test_torch_bdpt_2.py and test_torch_bdpt_3.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import lights as tl
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.io.image import write_image
from tpurt_torch.render import lights as pl

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

N = 4096
ALL_KINDS = (pl.LIGHT_POINT, pl.LIGHT_SPOT, pl.LIGHT_DISTANT,
             pl.LIGHT_AREA_TRI, pl.LIGHT_AREA_SPHERE, pl.LIGHT_INFINITE,
             pl.LIGHT_PROJECTION, pl.LIGHT_GONIO)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close_most(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    near = np.isclose(g, w, rtol=1e-5, atol=1e-6)
    assert near.reshape(len(g), -1).all(-1).mean() >= 0.995
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def light_scene(directory, sky: str = "mapped") -> str:
    """Every light kind in one scene; ``sky`` "mapped" gives the infinite
    light an environment map, "constant" none."""
    rng = np.random.default_rng(7)
    maps = dict(sky=rng.uniform(0.1, 1.0, (8, 16, 3)),
                slide=rng.uniform(0.0, 1.0, (12, 16, 3)),
                gonio=rng.uniform(0.0, 1.0, (6, 10, 3)))
    paths = {}
    for name, im in maps.items():
        paths[name] = str(directory / f"{name}.exr")
        write_image(paths[name], im.astype(np.float32))
    inf = (f'"string mapname" "{paths["sky"]}"' if sky == "mapped" else "")
    return f"""
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    Camera "perspective" "float fov" [60]
    WorldBegin
    LightSource "point" "point from" [1 3 0] "color I" [5 5 5]
    LightSource "spot" "point from" [0 4 1] "point to" [0 0 4]
      "color I" [9 8 7] "float coneangle" [40] "float conedeltaangle" [10]
    LightSource "distant" "point from" [1 4 -2] "point to" [0 0 0]
      "color L" [1 2 3]
    AttributeBegin
    Rotate -90 1 0 0
    LightSource "infinite" {inf} "color L" [.5 .6 .7]
    AttributeEnd
    AttributeBegin
    Translate 0.5 2 -1
    Rotate 40 1 0 0
    LightSource "projection" "color I" [30 30 30] "float fov" [50]
      "string mapname" "{paths['slide']}"
    AttributeEnd
    AttributeBegin
    Translate -1 1 2
    Rotate 25 0 0 1
    LightSource "goniometric" "color I" [6 6 6]
      "string mapname" "{paths['gonio']}"
    AttributeEnd
    AttributeBegin
    AreaLightSource "diffuse" "color L" [4 4 4]
    Translate -2 3 4
    Shape "sphere" "float radius" [.5]
    AttributeEnd
    AttributeBegin
    AreaLightSource "diffuse" "color L" [2 3 4] "bool twosided" "true"
    Shape "trianglemesh" "point P" [1 3 1  2 3 1  1.5 3.5 1.5]
      "integer indices" [0 1 2]
    AttributeEnd
    AttributeBegin
    AreaLightSource "diffuse" "color L" [3 2 1]
    Shape "trianglemesh" "point P" [-1 2 3  -2 2 3  -1.5 2.5 3.5]
      "integer indices" [0 1 2]
    AttributeEnd
    Material "matte" "color Kd" [.5 .5 .5]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-6 -1 -2  6 -1 -2  6 -1 9  -6 -1 9]
    WorldEnd
    """


def light_tables(directory, sky: str = "mapped"):
    """(tpurt's LightTable, the port's of the same tables) of the scene."""
    from tpurt_torch.render.driver import job_from_tables

    job = tpurt_build_job(tpurt_load_scene_string(
        light_scene(directory, sky)))
    plt = job_from_tables(scene_from_tpurt(job), "cpu").scene.lights
    kinds = sorted(set(plt.rows[:, 0].to(torch.int64).tolist()))
    assert kinds == sorted(ALL_KINDS)
    return job.scene.lights, plt


def lane_inputs(n_lights: int, seed: int = 0):
    """(row per lane, four uniforms per lane): every row on N / n_lights
    lanes, the uniforms in [0, 1) with a few exactly 0 and 0.5."""
    rng = np.random.default_rng(seed)
    idx = np.arange(N) % n_lights
    u = rng.uniform(0, 1, (4, N)).astype(np.float32)
    u[:, :16] = 0.0
    u[2, 16:32] = 0.5  # the two-sided side switch
    return idx, u


@pytest.mark.parametrize("sky", ["mapped", "constant"])
def test_sample_le_matches_tpurt(tmp_path, sky):
    tlt, plt = light_tables(tmp_path, sky)
    idx, u = lane_inputs(plt.n_lights)
    want = tl.sample_le(tlt, jnp.asarray(idx), *map(jnp.asarray, u))
    got = pl.sample_le(plt, _t(idx), *map(_t, u))
    for name in ("p", "n", "d", "le", "pdf_pos", "pdf_dir"):
        _close_most(getattr(got, name), getattr(want, name))
    for name in ("is_delta_pos", "is_infinite"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_pdf_le_and_light_normal_match_tpurt(tmp_path):
    """pdf_le at the sampled emissions and at random directions, and
    light_normal_at the sampled points."""
    tlt, plt = light_tables(tmp_path)
    idx, u = lane_inputs(plt.n_lights, seed=1)
    le = tl.sample_le(tlt, jnp.asarray(idx), *map(jnp.asarray, u))
    rng = np.random.default_rng(2)
    d_rand = rng.normal(size=(N, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=-1, keepdims=True)
    for d in (np.asarray(le.d), d_rand):
        want = tl.pdf_le(tlt, jnp.asarray(idx), le.p, le.n, jnp.asarray(d))
        got = pl.pdf_le(plt, _t(idx), _t(le.p), _t(le.n), _t(d))
        _close_most(got[0], want[0])
        _close_most(got[1], want[1])
    want_n = tl.light_normal_at(tlt, jnp.asarray(idx), le.p)
    got_n = pl.light_normal_at(plt, _t(idx), _t(le.p))
    _close_most(got_n, want_n)
