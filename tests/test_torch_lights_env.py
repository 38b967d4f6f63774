"""The three light kinds the slice adds against tpurt on the CPU: the
environment map's env_sample / env_pdf / env_le on test_lights.py's 16x32
map (texels and directions of sampled lanes, ties on the CDF included),
sample_li and pdf_li_from_hit of every light kind in a scene holding
infinite, projection, goniometric, point, spot and area lights, and the
host tables bit for bit; then the port's analogs of tpurt's
test_lights.py and test_projection_lights.py.

Bounds: the sampled texel (its radiance) equal, directions within 1e-6,
pdfs and radiance within rtol 1e-5 / atol 1e-6 (env_le, sample_li and
pdf_li_from_hit on >= 99.5% of lanes and within rtol 1e-4 on all, see
_close_most).  Inputs come from numpy with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.io.exr import write_exr_rgb
from tpurt.render import lights as tl
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.io.image import write_image
from tpurt_torch.render import lights as pl
from tpurt_torch.render.driver import build_job, host_tables
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

N = 4096


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_most(got, want):
    """Within rtol 1e-5 / atol 1e-6 on >= 99.5% of lanes and rtol 1e-4 /
    atol 1e-6 on all, 4 times the worst lane measured: an ulp of atan2 or
    sqrt moves a bilinear weight at a texel edge 20 times brighter, or a
    cone pdf's 1 - cos_max.  Measured at atol 1e-6: env_le 3 lanes in 4096
    at 1.5e-5 relative, an area sphere's cone pdf (code of the first
    slice) 5 lanes in 4096 at 2.4e-5; every other light within 1e-5."""
    g, w = got.numpy(), np.asarray(want)
    near = np.isclose(g, w, rtol=1e-5, atol=1e-6)
    assert near.reshape(len(g), -1).all(-1).mean() >= 0.995
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """test_lights.py's map and scene: (tpurt lights, port lights, map)."""
    d = tmp_path_factory.mktemp("env")
    rng = np.random.default_rng(0)
    img = rng.uniform(0.05, 1.0, (16, 32, 3)).astype(np.float32)
    img[4:8, 10:16] *= 20.0  # a bright region to make importance matter
    img[12:14] = 0.0  # black rows: flat stretches of the marginal CDF
    img[2, 20:26] = 0.0  # and of a conditional one
    path = str(d / "env.exr")
    write_exr_rgb(path, img, half=False)
    text = f"""
    Film "image" "integer xresolution" [16] "integer yresolution" [16]
    Sampler "random" "integer pixelsamples" [4]
    Integrator "path" "integer maxdepth" [2]
    Camera "perspective" "float fov" [60]
    WorldBegin
    AttributeBegin
    Rotate 30 0 1 0
    LightSource "infinite" "string mapname" "{path}"
    AttributeEnd
    Material "matte" "color Kd" [.5 .5 .5]
    Translate 0 0 4
    Shape "sphere" "float radius" [1]
    WorldEnd
    """
    tlt = tpurt_build_job(tpurt_load_scene_string(text)).scene.lights
    plt = build_job(load_scene_string(text), "cpu").scene.lights
    assert plt.env_light_row == tlt.env_light_row >= 0
    return tlt, plt, img


def _uniforms(lt, rng):
    """N pairs of uniforms, a quarter of them exactly on CDF entries (the
    ties, where the search side decides the texel)."""
    u1 = rng.uniform(size=N).astype(np.float32)
    u2 = rng.uniform(size=N).astype(np.float32)
    cond = np.asarray(lt.env_cond_cdf)
    marg = np.asarray(lt.env_marg_cdf)
    k = N // 4
    u2[:k] = rng.choice(marg[:-1], k)
    u1[:k] = rng.choice(cond[:, :-1].ravel(), k)
    return u1, u2


def test_env_tables_match_tpurt(env):
    tlt, plt, _ = env
    for k in ("env_map", "env_cond_cdf", "env_cond_int", "env_marg_cdf",
              "env_w2l", "env_l2w", "rows", "power_pmf"):
        assert getattr(plt, k).numpy().tobytes() == np.asarray(
            getattr(tlt, k)).tobytes(), k


def test_env_sample_matches_tpurt(env):
    tlt, plt, _ = env
    u1, u2 = _uniforms(plt, np.random.default_rng(1))
    want = tl.env_sample(tlt, jnp.asarray(u1), jnp.asarray(u2))
    got = pl.env_sample(plt, _t(u1), _t(u2))
    # the same texel on every lane, ties included
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0], rtol=0, atol=1e-6)
    _close(got[2], want[2])


def test_row_search_is_searchsorted(env):
    """_row_search against numpy's searchsorted of each lane's own row."""
    _, plt, _ = env
    rng = np.random.default_rng(3)
    u1, _ = _uniforms(plt, rng)
    cond = plt.env_cond_cdf.numpy()
    vi = rng.integers(0, cond.shape[0], N)
    want = [np.searchsorted(cond[v], u, side="right") for v, u in zip(vi, u1)]
    got = pl._row_search(plt, _t(vi), _t(u1))
    np.testing.assert_array_equal(got.numpy(), want)


# -- tpurt's test_lights.py checks, for the port -------------------------------

# -- sample_li and pdf_li_from_hit of every kind -------------------------------

KIND_NAMES = {pl.LIGHT_POINT: "point", pl.LIGHT_SPOT: "spot",
              pl.LIGHT_AREA_SPHERE: "area sphere",
              pl.LIGHT_INFINITE: "infinite", pl.LIGHT_PROJECTION: "projection",
              pl.LIGHT_GONIO: "goniometric"}


@pytest.fixture(scope="module")
def all_lights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lights")
    rng = np.random.default_rng(7)
    sky = rng.uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
    slide = np.zeros((12, 16, 3), np.float32)
    slide[:, 8:] = 1.0
    slide[3:5] = 0.3
    gonio = rng.uniform(0.0, 1.0, (6, 10, 3)).astype(np.float32)
    paths = {}
    for name, im in (("sky", sky), ("slide", slide), ("gonio", gonio)):
        paths[name] = str(d / f"{name}.exr")
        write_image(paths[name], im)
    text = f"""
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    Camera "perspective" "float fov" [60]
    WorldBegin
    LightSource "point" "point from" [1 3 0] "color I" [5 5 5]
    LightSource "spot" "point from" [0 4 1] "point to" [0 0 4]
      "color I" [9 8 7] "float coneangle" [40]
    AttributeBegin
    Rotate -90 1 0 0
    LightSource "infinite" "string mapname" "{paths['sky']}"
      "color L" [.5 .6 .7]
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
    Material "matte" "color Kd" [.5 .5 .5]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-6 -1 -2  6 -1 -2  6 -1 9  -6 -1 9]
    WorldEnd
    """
    tlt = tpurt_build_job(tpurt_load_scene_string(text)).scene.lights
    tab = host_tables(load_scene_string(text))["lights"]
    plt = pl.light_table_from_tables(tab, "cpu")
    assert plt.has_infinite and plt.has_projection and plt.has_gonio
    kinds = plt.rows[:, 0].to(torch.int64).tolist()
    assert sorted(set(kinds)) == sorted(KIND_NAMES)
    return tlt, plt, tab


# -- tpurt's test_projection_lights.py checks, for the port --------------------

def _wall_scene(light_lines):
    return f"""
    Film "image" "integer xresolution" [16] "integer yresolution" [16]
    Sampler "random" "integer pixelsamples" [4]
    Integrator "path" "integer maxdepth" [2]
    Camera "perspective" "float fov" [70]
    WorldBegin
    {light_lines}
    Material "matte" "color Kd" [.7 .7 .7]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-6 -6 4  6 -6 4  6 6 4  -6 6 4]
    WorldEnd
    """
