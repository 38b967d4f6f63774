"""The direct-lighting textured slice against tpurt, on the CPU.

Module by module: filters, distant and spot lights, the mirror and glass
lobes, the uv derivatives (test_torch_direct_frames.py renders the slice
as a whole).  Inputs are made from numpy seeds.  Tolerances:

- filters: 1e-6 abs (the same float32 formulas; exp and sin differ in the
  last ulp between XLA and torch);
- sample_li of distant/spot lights and the lobe functions: rtol 2e-5,
  atol 1e-6, as the earlier shading tests hold their counterparts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import filters as tfilters
from tpurt.render import materials_build as tmat
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt.scene.paramset import ParamSet as TParamSet
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import filters as pfilters
from tpurt_torch.render import lights as plights
from tpurt_torch.render import materials_build as pmat
from tpurt_torch.render.driver import job_from_tables
from tpurt_torch.render.film import Film
from tpurt_torch.scene.paramset import ParamSet

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rtol=2e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------- filters

FILTERS = [("box", {}), ("triangle", {}), ("gaussian", {}),
           ("gaussian", {"xwidth": 1.3, "ywidth": 2.6, "alpha": 1.1}),
           ("mitchell", {}), ("mitchell", {"B": 0.2, "C": 0.6, "xwidth": 1.7}),
           ("sinc", {}), ("lanczossinc", {"tau": 2.0, "xwidth": 2.5})]


def _ps(cls, kw):
    p = cls()
    for k, v in kw.items():
        p.add("float", k, [v])
    return p


@pytest.mark.parametrize("name,kw", FILTERS)
def test_filter_evaluate_matches_tpurt(name, kw):
    want_f = tfilters.make_filter(name, _ps(TParamSet, kw))
    got_f = pfilters.make_filter(name, _ps(ParamSet, kw))
    assert (got_f.name, got_f.radius, got_f.params) == (
        want_f.name, want_f.radius, want_f.params)
    rng = np.random.default_rng(7)
    r = max(want_f.radius) * 1.2
    d = rng.uniform(-r, r, (2, 5000)).astype(np.float32)
    d[:, :3] = [[0.0, 1e-6, want_f.radius[0]], [0.0, -1e-6, want_f.radius[1]]]
    want = want_f.evaluate(jnp.asarray(d[0]), jnp.asarray(d[1]))
    _close(got_f.evaluate(_t(d[0]), _t(d[1])), want, rtol=0, atol=1e-6)
    assert name == "box" or float(np.ptp(np.asarray(want))) > 0.1


@pytest.mark.parametrize("radius", [(0.5, 0.5), (2.0, 2.0), (4.0, 4.0),
                                    (1.3, 2.6)])
def test_film_footprint_matches_tpurt_at_radius(radius):
    """Film.add_samples stamps the ceil(2r) window of tpurt's film at
    integer and non-integer radii (a gaussian, whose support ends inside
    the window)."""
    from tpurt.render.film import Film as TFilm

    rng = np.random.default_rng(9)
    w, h, n = 19, 15, 4000
    kw = dict(full_x=w, full_y=h, crop=(0, w, 0, h), filename="t.exr",
              scale=1.0, max_sample_luminance=np.inf)
    tfilm = TFilm(filter=tfilters.Filter("gaussian", radius, (0.7,)),
                  diagonal_m=0.035, **kw)
    film = Film(filter=pfilters.Filter("gaussian", radius, (0.7,)), **kw)
    p = (rng.uniform(-3, 3, (n, 2)) + rng.uniform(size=(n, 2)) * [w, h]
         ).astype(np.float32)
    L = rng.exponential(size=(n, 3)).astype(np.float32)
    wt = np.ones(n, np.float32)
    want = tfilm.to_image(tfilm.add_samples(
        tfilm.initial_state(), jnp.asarray(p), jnp.asarray(L),
        jnp.asarray(wt)))
    state = film.initial_state("cpu")
    film.add_samples(state, _t(p), _t(L), _t(wt))
    np.testing.assert_allclose(film.to_image(state), want, rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------------ lights

LIGHTS_SCENE = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 2 -6  0 1 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "distant" "color L" [.6 .7 .9] "point from" [3 6 4]
LightSource "spot" "color I" [30 20 10] "point from" [1 5 -1]
  "point to" [0 0 0.5] "float coneangle" [35] "float conedeltaangle" [10]
LightSource "point" "point from" [-2 3 0] "color I" [5 5 5]
AttributeBegin
  AreaLightSource "diffuse" "color L" [4 4 4]
  Translate -2 4 -1
  Shape "sphere" "float radius" [0.5]
AttributeEnd
Material "matte" "color Kd" [.6 .6 .6]
Shape "trianglemesh" "point P" [-9 0 -9  9 0 -9  9 0 9  -9 0 9]
  "integer indices" [0 2 1  0 3 2]
WorldEnd
"""


@pytest.fixture(scope="module")
def light_jobs():
    job = tpurt_build_job(tpurt_load_scene_string(LIGHTS_SCENE))
    return job, job_from_tables(scene_from_tpurt(job), "cpu")


def test_distant_and_spot_rows_equal_tpurt_build(light_jobs):
    """The port's own build of the light table, bit for bit tpurt's."""
    from tpurt_torch.render.driver import host_tables
    from tpurt_torch.scene import load_scene_string

    job, _ = light_jobs
    tab = host_tables(load_scene_string(LIGHTS_SCENE))["lights"]
    want = scene_from_tpurt(job)["lights"]
    assert tab.keys() == want.keys()
    for k in tab:
        if isinstance(tab[k], np.ndarray):
            assert tab[k].tobytes() == want[k].tobytes(), k
        else:
            assert tab[k] == want[k], k
    kinds = tab["rows"][:, 0].astype(int).tolist()
    assert kinds == [plights.LIGHT_DISTANT, plights.LIGHT_SPOT,
                     plights.LIGHT_POINT, plights.LIGHT_AREA_SPHERE]
    assert tab["spat_res"] > 1  # the distant light is not positional


# ------------------------------------------------------------- bsdf slots

def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


SPEC_SCENE = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "point from" [0 4 0]
Material "mirror" "color Kr" [.9 .8 .7]
Shape "sphere" "float radius" [1]
Material "glass" "color Kr" [.9 .9 .9] "color Kt" [.8 .9 .7] "float eta" [1.4]
Shape "sphere" "float radius" [1]
Material "glass" "color Kr" [.5 .9 .9] "color Kt" [.8 .6 .7]
  "float uroughness" [.2] "float vroughness" [.05]
Shape "sphere" "float radius" [1]
Material "plastic" "color Kd" [.3 .4 .5] "color Ks" [.4 .4 .4]
Shape "sphere" "float radius" [1]
Material "matte" "color Kd" [.3 .4 .5] "float sigma" [25]
Shape "sphere" "float radius" [1]
WorldEnd
"""


@pytest.fixture(scope="module")
def spec_lobes():
    from tpurt_torch.render.driver import host_tables
    from tpurt_torch.scene import load_scene_string

    job = tpurt_build_job(tpurt_load_scene_string(SPEC_SCENE))
    table = np.asarray(job.scene.mt_table)
    own = host_tables(load_scene_string(SPEC_SCENE))["mt_table"]
    assert own.tobytes() == table.tobytes()  # the port's build, bit for bit
    kinds = table[:, pmat.C_KIND].astype(int).tolist()
    assert sorted(kinds) == [pmat.MAT_MATTE, pmat.MAT_PLASTIC,
                             pmat.MAT_MIRROR, pmat.MAT_GLASS, pmat.MAT_GLASS]
    assert pmat.lobe_slots(table) == pbsdf.ALL_SLOTS[:5]
    rng = np.random.default_rng(3)
    n = 6000
    mat = rng.integers(-1, len(kinds), n).astype(np.int32)
    want = tmat.fetch_lobes(job.scene.mt_table, jnp.asarray(mat))
    got = pmat.fetch_lobes(_t(table), _t(mat))
    return rng, want, got


# ------------------------------------------------------------ interaction
