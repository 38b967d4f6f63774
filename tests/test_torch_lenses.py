"""The realistic camera's lens system against tpurt on the CPU
(tpurt_torch/render/lenses.py, camera.py's realistic branch): the lens
table, the thick-lens focus and the exit-pupil bounds to 1e-12, the
float32 lens trace and the camera's rays, and the raises for a missing
or unreadable lens file.  Inputs: tpurt's biconvex test lens and seeded
numpy rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.render.lenses as tl
from tpurt.render.camera import _trace_lenses_from_film
from tpurt_torch.render import lenses as pl
from tpurt_torch.render.lenses import trace_lenses_from_film
from tpurt_torch.testscenes import write_lens

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture()
def lens_path(tmp_path):
    return write_lens(str(tmp_path / "biconvex.dat"))


def _focused(mod, path, aperture=10.0, focus=1.0):
    el = mod.load_lens_file(path, aperture)
    el[-1, 1] = mod.focus_thick_lens(el, focus, 0.035)
    return el


def test_lens_tables_match_tpurt(lens_path):
    """The table (bit-equal), the focus at 1 m and at frame L's 15.2 m, the
    film-side and scene-side traces (float64: the film side runs as torch,
    whose CPU sqrt may differ from numpy's by an ulp, so 1e-14 of the
    largest coordinate)
    and the exit-pupil bounds of 8 zones at 2^12 rays a zone, traced as
    float64 torch, to 1e-12."""
    np.testing.assert_array_equal(pl.load_lens_file(lens_path, 10.0),
                                  tl.load_lens_file(lens_path, 10.0))
    for aperture, focus in ((10.0, 1.0), (8.0, 15.2)):
        el_t = _focused(tl, lens_path, aperture, focus)
        el_p = _focused(pl, lens_path, aperture, focus)
        np.testing.assert_allclose(el_p, el_t, rtol=0, atol=1e-12)
        rng = np.random.default_rng(1)
        o = np.stack([rng.uniform(-0.01, 0.01, 512),
                      rng.uniform(-0.01, 0.01, 512), np.zeros(512)], -1)
        d = np.stack([rng.uniform(-0.01, 0.01, 512),
                      rng.uniform(-0.01, 0.01, 512),
                      np.full(512, -el_t[-1, 1])], -1) - o
        for fn in ("trace_from_film_np", "_trace_from_scene_np"):
            want = getattr(tl, fn)(el_t, o, d * (1 if fn[0] == "t" else -1))
            got = getattr(pl, fn)(el_p, o, d * (1 if fn[0] == "t" else -1))
            np.testing.assert_array_equal(got[0], want[0])
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=1e-14 * np.abs(w).max())
        ls = pl.build_lens_system(lens_path, aperture, focus, 0.035,
                                  n_zones=8, device="cpu",
                                  n_samples=1 << 12)
        for z in range(8):
            r0, r1 = z / 8 * 0.0175, (z + 1) / 8 * 0.0175
            want = tl.bound_exit_pupil(el_t, r0, r1, 1 << 12)
            got = pl.bound_exit_pupil(el_p, r0, r1, 1 << 12, "cpu")
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
            np.testing.assert_array_equal(ls.exit_pupil[z],
                                          want.astype(np.float32))
        assert abs(ls.rear_z - float(el_t[-1, 1])) <= 1e-12


def test_lens_trace_and_camera_rays_match_tpurt(lens_path, monkeypatch):
    """The device trace on 4,096 seeded film rays: equal ok masks, o
    within 1e-6 and unit d within 1e-5.  Then the camera of a realistic
    scene (8 zones on both sides): its rays, weights (0 where vignetted)
    and ray differentials against tpurt's on the same film and lens
    samples; the shutter time and an animated camera-to-world are
    ignored, as in tpurt."""
    from tpurt.render.integrator import camera_ray_differentials as t_diff
    from tpurt.render.driver import build_job as t_build
    from tpurt.scene import load_scene_string as t_load
    from tpurt_torch.render.driver import host_tables
    from tpurt_torch.render.camera import camera_from_tables
    from tpurt_torch.render.integrator import camera_ray_differentials
    from tpurt_torch.scene import load_scene_string
    from torch_lens_fourier_scenes import realistic_tiny, tpurt_lens_zones

    el = _focused(pl, lens_path)
    lens_el = tuple(tuple(float(v) for v in row) for row in el)
    rng = np.random.default_rng(2)
    n = 4096
    o = np.stack([rng.uniform(-0.01, 0.01, n), rng.uniform(-0.01, 0.01, n),
                  np.zeros(n)], -1).astype(np.float32)
    d = (np.stack([rng.uniform(-0.012, 0.012, n),
                   rng.uniform(-0.012, 0.012, n),
                   np.full(n, -el[-1, 1])], -1) - o).astype(np.float32)
    ok_t, o_t, d_t = map(np.asarray, _trace_lenses_from_film(
        lens_el, jnp.asarray(o), jnp.asarray(d)))
    ok_p, o_p, d_p = (x.numpy() for x in trace_lenses_from_film(
        lens_el, torch.tensor(o), torch.tensor(d)))
    np.testing.assert_array_equal(ok_p, ok_t)
    assert 0.2 < ok_t.mean() < 1.0
    np.testing.assert_allclose(o_p[ok_t], o_t[ok_t], rtol=0, atol=1e-6)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    np.testing.assert_allclose(unit(d_p[ok_t]), unit(d_t[ok_t]), rtol=0,
                               atol=1e-5)

    tpurt_lens_zones(monkeypatch)
    text = realistic_tiny(dict(lens=lens_path), res=24).replace(
        "LookAt", "ActiveTransform EndTime\nTranslate 0 0 1\n"
        "ActiveTransform All\nLookAt", 1)
    tcam = t_build(t_load(text)).camera
    tab = host_tables(load_scene_string(text), device="cpu")["camera"]
    assert tab["animated"] and tab["kind"] == "realistic"
    cam = camera_from_tables(tab, "cpu")
    pf = (rng.uniform(0, 24, (n, 2))).astype(np.float32)
    pls = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    tm = rng.uniform(0, 1, n).astype(np.float32)
    want = [np.asarray(x) for x in tcam.generate_rays(
        jnp.asarray(pf), jnp.asarray(pls), jnp.asarray(tm))]
    got = [x.numpy() for x in cam.generate_rays(
        torch.tensor(pf), torch.tensor(pls), torch.tensor(tm))]
    still = [x.numpy() for x in cam.generate_rays(torch.tensor(pf),
                                                  torch.tensor(pls))]
    for g, s in zip(got, still):
        np.testing.assert_array_equal(g, s)
    live = want[2] > 0
    np.testing.assert_array_equal(got[2] > 0, live)
    assert 0.3 < live.mean() < 1.0
    np.testing.assert_allclose(got[0][live], want[0][live], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[1][live], want[1][live], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-9)
    diff_t = t_diff(tcam, None, jnp.asarray(pf), jnp.asarray(pls),
                    jnp.asarray(tm), 4)
    diff_p = camera_ray_differentials(
        cam, torch.tensor(pf), torch.tensor(pls), torch.tensor(got[0]),
        torch.tensor(got[1]), 4, torch.tensor(tm))
    both = live & (np.asarray(tcam.generate_rays(
        jnp.asarray(pf + [1, 0]), jnp.asarray(pls))[2]) > 0) & (
        np.asarray(tcam.generate_rays(jnp.asarray(pf + [0, 1]),
                                      jnp.asarray(pls))[2]) > 0)
    for g, w in zip(diff_p, diff_t):
        np.testing.assert_allclose(g.numpy()[both], np.asarray(w)[both],
                                   rtol=0, atol=1e-5)


def test_missing_or_bad_lens_file_raises(tmp_path, lens_path, monkeypatch):
    """No lens file, a missing one, one whose values do not make rows of
    4, and a focus the lens cannot reach each raise ValueError naming
    Camera "realistic" (and the file); tpurt warns and renders a
    45-degree perspective camera."""
    from tpurt_torch.render.camera import camera_tables
    from tpurt_torch.scene.paramset import ParamSet
    from tpurt_torch.geom.transform import Transform

    def tables(**params):
        ps = ParamSet()
        for k, v in params.items():
            ps.add("string" if isinstance(v, str) else "float", k, [v])
        return camera_tables("realistic", ps, Transform(), 8, 8,
                             device="cpu")

    with pytest.raises(ValueError, match='Camera "realistic": no'):
        tables()
    missing = str(tmp_path / "missing.dat")
    with pytest.raises(ValueError, match=f'Camera "realistic".*{missing}'):
        tables(lensfile=missing)
    bad = tmp_path / "bad.dat"
    bad.write_text("35.0 4.0 1.5\n")
    with pytest.raises(ValueError, match="not divisible by 4"):
        tables(lensfile=str(bad))
    with pytest.raises(ValueError, match="too short"):
        tables(lensfile=lens_path, focusdistance=0.01)
    monkeypatch.setattr(pl, "N_PUPIL_SAMPLES", 1 << 12)
    tab = tables(lensfile=lens_path, focusdistance=15.2,
                 aperturediameter=8.0)
    assert tab["kind"] == "realistic" and tab["exit_pupil"].shape == (64, 4)
    assert tab["fp_slope"] == 0.0 and tab["fp_base"] == 0.0
