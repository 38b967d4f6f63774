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

from tpurt.render import bsdf as tbsdf
from tpurt.render import filters as tfilters
from tpurt.render import interaction as tint
from tpurt.render import intersect as tix
from tpurt.render import lights as tlights
from tpurt.render import materials_build as tmat
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt.scene.paramset import ParamSet as TParamSet
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import filters as pfilters
from tpurt_torch.render import interaction as pint
from tpurt_torch.render import lights as plights
from tpurt_torch.render import materials_build as pmat
from tpurt_torch.render.driver import job_from_tables
from tpurt_torch.render.film import Film
from tpurt_torch.render.intersect import Hit
from tpurt_torch.scene.paramset import ParamSet
from tpurt_torch.testscenes import textured_scene, write_grid_texture

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


@pytest.mark.parametrize("strategy", ["spatial", "power"])
def test_sample_li_distant_spot_match_tpurt(light_jobs, strategy):
    job, pjob = light_jobs
    lt, plt = job.scene.lights, pjob.scene.lights
    rng = np.random.default_rng(4)
    n = 4096
    p = rng.uniform([-4, 0, -4], [4, 3, 4], (n, 3)).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    idx, pmf = tlights.choose_light(lt, jnp.asarray(u), strategy,
                                    p=jnp.asarray(p))
    pidx, ppmf = plights.choose_light(plt, _t(u), strategy, p=_t(p))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    _close(ppmf, pmf, rtol=0, atol=0)
    assert len(np.unique(np.asarray(idx))) == 4
    want = tlights.sample_li(lt, idx, jnp.asarray(p), jnp.asarray(u2))
    got = plights.sample_li(plt, pidx, _t(p), _t(u2))
    delta = np.asarray(want.is_delta)
    np.testing.assert_array_equal(got.is_delta.numpy(), delta)
    for f in ("wi", "li", "p_light"):
        _close(getattr(got, f).numpy()[delta], np.asarray(getattr(want, f))[delta])
    _close(got.pdf.numpy()[delta], np.asarray(want.pdf)[delta])
    spot = np.asarray(idx) == 1
    li = np.asarray(want.li)[spot]
    # lanes inside the cone, in its falloff band and outside it
    assert (li.max(-1) == 0).any() and (li.max(-1) > 0).any()


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


def test_lobe_slots_follow_the_material_kinds():
    """The slots the BSDF may skip: by kind, and for glass by roughness."""
    from tpurt_torch.render.driver import host_tables
    from tpurt_torch.scene import load_scene_string

    def slots(materials):
        text = SPEC_SCENE[:SPEC_SCENE.index('Material "mirror"')] + "".join(
            f'Material {m}\nShape "sphere"\n' for m in materials) + "WorldEnd"
        return pmat.lobe_slots(host_tables(load_scene_string(text))["mt_table"])

    assert slots(['"matte"']) == (pbsdf.SLOT_DIFFUSE,)
    assert slots(['"matte"', '"plastic"']) == (pbsdf.SLOT_DIFFUSE,
                                               pbsdf.SLOT_GLOSSY)
    assert slots(['"mirror"']) == (pbsdf.SLOT_MIRROR,)
    assert slots(['"glass"']) == (pbsdf.SLOT_FS,)
    assert slots(['"glass" "float uroughness" [.1]']) == (pbsdf.SLOT_GLOSSY,
                                                          pbsdf.SLOT_GTRANS)


def test_fetch_lobes_mirror_glass_match_tpurt(spec_lobes):
    _, want, got = spec_lobes
    for f in pbsdf.LobeParams._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "active" or g is None:  # None: a field no material needs
            continue
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, rtol=1e-6, atol=0)
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), act)
    assert not act[:, 5:].any() and act[:, :5].any(axis=0).all()


def test_bsdf_with_skipped_slots_equals_all_slots(spec_lobes):
    """On lanes whose lobes lie within a subset of the slots, the BSDF
    told to skip the others returns exactly what it returns when it
    computes them all and masks."""
    rng, _, lp = spec_lobes
    n = lp.kd.shape[0]
    wo, wi = _t(_unit(rng, n)), _t(_unit(rng, n))
    u = [_t(x) for x in rng.uniform(size=(3, n)).astype(np.float32)]
    for slots in map(pbsdf.LobeSet, ((0, 1), (2,), (3,), (1, 4), (0, 1, 2))):
        outside = [k for k in pbsdf.ALL_SLOTS if k not in slots]
        keep = ~lp.active[:, outside].any(dim=-1)
        assert keep.sum() > 500
        sub = pbsdf.LobeParams(*[None if f is None else f[keep] for f in lp])
        w, i = wo[keep], wi[keep]
        assert torch.equal(pbsdf.bsdf_f(sub, w, i, slots),
                           pbsdf.bsdf_f(sub, w, i))
        assert torch.equal(pbsdf.bsdf_pdf(sub, w, i, slots),
                           pbsdf.bsdf_pdf(sub, w, i))
        uk = [x[keep] for x in u]
        for a, b in zip(pbsdf.bsdf_sample(sub, w, *uk, slots),
                        pbsdf.bsdf_sample(sub, w, *uk)):
            assert torch.equal(a, b)


def test_bsdf_sample_mirror_glass_match_tpurt(spec_lobes):
    """f, pdf and the specular / transmission flags of every lobe, for wo
    on both sides of the surface (glass is entered and left)."""
    rng, want_lp, got_lp = spec_lobes
    n = want_lp.kd.shape[0]
    wo, wi = _unit(rng, n), _unit(rng, n)
    _close(pbsdf.bsdf_f(got_lp, _t(wo), _t(wi)),
           tbsdf.bsdf_f(want_lp, jnp.asarray(wo), jnp.asarray(wi)))
    _close(pbsdf.bsdf_pdf(got_lp, _t(wo), _t(wi)),
           tbsdf.bsdf_pdf(want_lp, jnp.asarray(wo), jnp.asarray(wi)))
    u = rng.uniform(size=(3, n)).astype(np.float32)
    want = tbsdf.bsdf_sample(want_lp, jnp.asarray(wo), *map(jnp.asarray, u))
    got = pbsdf.bsdf_sample(got_lp, _t(wo), *map(_t, u))
    ok = np.asarray(want[2]) > 0
    assert ok.mean() > 0.4
    _close(got[0].numpy()[ok], np.asarray(want[0])[ok], atol=2e-6)  # wi
    _close(got[1], want[1], rtol=1e-4)  # f: 1/|cos| near grazing
    _close(got[2], want[2])  # pdf
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    spec, trans = np.asarray(want[3]), np.asarray(want[4])
    assert (spec & ok).any() and (trans & ok & spec).any()
    assert (trans & ok & ~spec).any()  # rough glass transmission


# ------------------------------------------------------------ interaction

def test_interaction_uv_derivatives_match_tpurt(tmp_path):
    """uv, dpdu and dpdv on triangles with and without uvs and on a
    sphere."""
    text = textured_scene("small", write_grid_texture(
        str(tmp_path / "grid_i.png")))
    job = tpurt_build_job(tpurt_load_scene_string(text))
    pjob = job_from_tables(scene_from_tpurt(job), "cpu")
    assert job.scene.has_texfilter and pjob.scene.has_texfilter
    rng = np.random.default_rng(2)
    n = 3000
    p_film = (rng.uniform(size=(n, 2)) * 32).astype(np.float32)
    p_lens = rng.uniform(size=(n, 2)).astype(np.float32)
    o, d, _ = job.camera.generate_rays(jnp.asarray(p_film),
                                       jnp.asarray(p_lens), None)
    hit = tix.intersect_closest(job.scene.geo, o, d, jnp.inf)
    want = tint.compute_interaction(job.scene.geo, hit, o, d, dpduv=True)
    got = pint.compute_interaction(
        pjob.scene.geo, Hit(_t(hit.t), _t(hit.prim), _t(hit.b0), _t(hit.b1)),
        _t(o), _t(d), dpduv=True)
    valid = np.asarray(want.valid)
    assert 0.3 < valid.mean() < 1.0
    for f in ("uv", "dpdu", "dpdv"):
        _close(getattr(got, f).numpy()[valid],
               np.asarray(getattr(want, f))[valid], atol=1e-5)
    assert abs(pjob.camera.fp_slope - job.camera.fp_slope) < 1e-9
