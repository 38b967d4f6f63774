"""The port's tabulated-BSSRDF host part (tpurt_torch/render/bssrdf.py)
and subsurface material table against tpurt's on the CPU: the measured
presets, the Fresnel moments, the beam-diffusion terms and the
(rho x radius) profile tables bit for bit (both run the same numpy), and
subsurface_from_diffuse within 1e-6 relative (tpurt's spline runs in
jnp float32, the port's in torch); the material table of a scene with
both materials, a preset, a second (g, eta) and a textured slot: the
fused rows, bss, bss_tix and each table, bit for bit.
"""

import logging

import numpy as np
import torch

import tpurt.render.bssrdf as tb
import tpurt_torch.render.bssrdf as pb

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

# (g, eta) pairs: a subsurface preset's, a scattering one's, eta < 1
KEYS = ((0.0, 1.33), (0.3, 1.5), (0.0, 0.8))

SCENE = """
Film "image" "integer xresolution" [4] "integer yresolution" [4]
Camera "perspective"
WorldBegin
Texture "checks" "spectrum" "checkerboard"
Material "subsurface" "string name" "Skin1" "float scale" [10]
Shape "sphere" "float radius" [1]
Material "subsurface" "color sigma_a" [0.01 0.02 0.05]
  "color sigma_s" [1 2 3] "float g" [0.3] "float eta" [1.5]
Shape "sphere" "float radius" [2]
Material "kdsubsurface" "color Kd" [0.8 0.5 0.3] "float mfp" [0.1]
  "float eta" [1.5]
Shape "sphere" "float radius" [3]
Material "kdsubsurface" "color Kd" [0.2 0.9 0.6] "float mfp" [2]
Shape "sphere" "float radius" [4]
Material "subsurface" "string name" "Unobtainium" "texture sigma_a" "checks"
Shape "sphere" "float radius" [5]
Material "matte"
Shape "sphere" "float radius" [6]
WorldEnd
"""


def test_host_tables_equal_tpurt():
    assert pb.MEASURED_SS == tb.MEASURED_SS and len(pb.MEASURED_SS) == 47
    for name in list(tb.MEASURED_SS) + ["nope"]:
        want = tb.get_medium_scattering_properties(name)
        got = pb.get_medium_scattering_properties(name)
        assert (got is None) == (want is None)
        if want is not None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    eta = np.linspace(0.5, 2.5, 101)
    for f in ("fresnel_moment1", "fresnel_moment2"):
        np.testing.assert_allclose(getattr(pb, f)(eta), getattr(tb, f)(eta),
                                   rtol=1e-12, atol=1e-12)
    r = np.geomspace(1e-4, 50, 37)
    for g, e in KEYS:
        for f in ("beam_diffusion_ms", "beam_diffusion_ss"):
            np.testing.assert_array_equal(getattr(pb, f)(0.7, 0.3, g, e, r),
                                          getattr(tb, f)(0.7, 0.3, g, e, r))
        got = pb.compute_beam_diffusion_table(g, e)
        want = tb.compute_beam_diffusion_table(g, e)
        assert pb.compute_beam_diffusion_table(g, e) is got  # cached
        for k in ("rho_samples", "radius_samples", "profile", "rho_eff",
                  "profile_cdf"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        kd = np.array([0.0, 0.05, 0.3, 0.6, 0.9, 0.999])
        mfp = np.array([0.1, 1.0, 0.5, 2.0, 0.01, 1.0])
        for a, b in zip(pb.subsurface_from_diffuse(got, kd, mfp),
                        tb.subsurface_from_diffuse(want, kd, mfp)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def _records(load, text):
    """The scene's distinct material records in first-use order."""
    out, seen = [], set()
    for pr in load(text).primitives:
        if id(pr.material) not in seen:
            seen.add(id(pr.material))
            out.append(pr.material)
    return out


def test_material_table_matches_tpurt(caplog):
    from tpurt.render.materials_build import (
        build_material_table as t_build, fuse_material_rows as t_fuse)
    from tpurt.scene import load_scene_string as t_load
    from tpurt_torch.render.materials_build import (
        MAT_GLASS, build_material_table, fuse_material_rows)
    from tpurt_torch.scene import load_scene_string

    want = t_build(_records(t_load, SCENE))
    with caplog.at_level(logging.WARNING):
        got = build_material_table(_records(load_scene_string, SCENE))
    assert 'named scattering preset "Unobtainium" not found' in caplog.text
    assert 'subsurface: textured "sigma_a" not supported' in caplog.text
    assert got.has_bssrdf and len(got.bss_tables) == 3
    assert (got.kinds[:5] == MAT_GLASS).all()
    np.testing.assert_array_equal(fuse_material_rows(got), t_fuse(want))
    np.testing.assert_array_equal(got.bss, want.bss)
    np.testing.assert_array_equal(got.bss_tix, want.bss_tix)
    assert got.bss_tix.tolist() == [0, 1, 2, 0, 0, -1]
    assert got.textured == want.textured
    for a, b in zip(got.bss_tables, want.bss_tables, strict=True):
        for k in ("profile", "rho_eff", "profile_cdf"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    stacks = pb.stack_tables(got.bss_tables)
    dev = pb.tables_to_device(stacks, "cpu")
    assert dev.profile.shape == (3, 100, 64) and dev.rho.shape == (100,)
