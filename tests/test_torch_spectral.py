"""Sampled-spectrum mode (--spectrum sampled) of the port against tpurt's,
on the CPU: the tables, the lifts and the knob here; one integrator's
spectral render a file in test_torch_spectral_<k>.py (each one cold tpurt
jit), through the helpers below.

Both packages find no pbrt-v3 source tree here, so both build tpurt's
analytic fallback basis; the port is held to tpurt's spectral renders,
never to RGB mode, from which the fallback basis departs by design.

Bounds: the tables bit-equal to tpurt's ``tables()``; the device lifts
within 1e-6 of tpurt's on 4,096 seeded colours (the six min-orderings and
their ties included: float32 products of 7 terms, summed in another order
by XLA and by torch), the RGB conversion and luminance of their bins
within 1e-6 + 1e-6 relative (60 terms, values up to ~2.5, where 1e-6 is
8 ulp; measured 1.07e-6 on one of 12,288 values), the seven-coefficient
split exactly equal.  Renders: test_torch_media.py's standing bounds
(means within 1e-3 relative, >= 99% of pixels within 1e-3 abs + 1e-3
rel).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.spectrum_sampled as tss
from tpurt.config import set_config
from tpurt.render.driver import render as tpurt_render
from tpurt.scene import load_scene_string as tpurt_load_scene_string
import tpurt_torch.spectrum_sampled as pss
from tpurt_torch import cli
from tpurt_torch.io.image import read_image
from tpurt_torch.render.driver import make_integrator_config, spectral_mode
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import spectral_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def tpurt_spectral(render_fn, *args, **kw):
    """``render_fn`` of tpurt under spectrum_mode "sampled", reset after
    (as tests/test_spectral.py does)."""
    set_config(spectrum_mode="sampled")
    try:
        return render_fn(*args, **kw)
    finally:
        set_config(spectrum_mode="rgb")


def render_spectral_pair(text, tmp_path):
    """(tpurt's sampled-spectrum image, the port CLI's with --spectrum
    sampled) of the scene ``text``, both on the CPU."""
    want, _ = tpurt_spectral(tpurt_render, tpurt_load_scene_string(text),
                             progress=False)
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    out = tmp_path / "port.pfm"
    assert cli.main([str(path), "--device", "cpu", "--outfile", str(out),
                     "--quiet", "--spectrum", "sampled"]) == 0
    return np.asarray(want), read_image(str(out))


def assert_standing_bounds(got, want):
    """Means within 1e-3 relative, >= 99% of pixels within 1e-3 abs +
    1e-3 rel (test_torch_render.py's bounds)."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0.01
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    ok = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99


def seeded_colours(n: int = 4096) -> np.ndarray:
    """Colours in [0, 2) with each of the six min-orderings, two- and
    three-way ties, zeros and one negative component among the first
    rows."""
    rng = np.random.default_rng(12)
    c = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    c[:6] = [[.2, .5, .9], [.2, .9, .5], [.5, .2, .9], [.9, .2, .5],
             [.5, .9, .2], [.9, .5, .2]]
    c[6:12] = [[.3, .3, .8], [.8, .3, .3], [.3, .8, .3], [.4, .4, .4],
               [0, 0, 0], [-.1, .5, .2]]
    # ties drawn at random too
    c[12:512, 1] = c[12:512, 0]
    c[512:1024, 2] = c[512:1024, 1]
    return c


def test_tables_equal_tpurt():
    want, got = tss.tables(), pss.tables()
    assert got.source == want.source
    for k in ("basis_refl", "basis_illum", "to_xyz", "to_rgb", "y_weight",
              "cie_bins"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    np.testing.assert_array_equal(pss.bin_centers(), tss.bin_centers())
    lam = np.linspace(380, 720, 37)
    np.testing.assert_array_equal(pss.spd_to_bins(lam, np.sin(lam / 40)),
                                  tss.spd_to_bins(lam, np.sin(lam / 40)))
    np.testing.assert_array_equal(pss.blackbody_bins(5500.0),
                                  tss.blackbody_bins(5500.0))


def test_lifts_and_rgb_match_tpurt():
    c = seeded_colours()
    np.testing.assert_array_equal(pss.rgb_to_coeff7(torch.tensor(c)).numpy(),
                                  np.asarray(tss.rgb_to_coeff7(
                                      jnp.asarray(c))))
    np.testing.assert_array_equal(pss.rgb_to_coeff7(c), tss.rgb_to_coeff7(c))
    for name in ("lift_refl", "lift_illum", "lift_refl_raw"):
        got = getattr(pss, name)(torch.tensor(c)).numpy()
        want = np.asarray(getattr(tss, name)(jnp.asarray(c)))
        assert got.shape == (len(c), 60)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
    bins = pss.lift_illum(torch.tensor(c))
    np.testing.assert_allclose(
        pss.to_rgb(bins).numpy(),
        np.asarray(jnp.asarray(bins.numpy()) @ tss.to_rgb_matrix()),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pss.luminance_bins(bins).numpy(),
        np.asarray(tss.luminance_bins(jnp.asarray(bins.numpy()))),
        rtol=1e-6, atol=1e-6)


def test_spectrum_knob(tmp_path, caplog):
    """spectrum "sampled" sets IntegratorConfig.spectral on path,
    volpath, directlighting, whitted, bdpt, mlt and sppm (60 channels);
    rpf renders RGB and warns in tpurt's words, ao says nothing; an RGB
    config is unchanged; the CLI renders a spectral path frame."""
    caplog.set_level(logging.WARNING, logger="tpurt_torch.render")
    for name in ("path", "volpath", "directlighting", "whitted", "bdpt",
                 "mlt", "sppm", "rpf", "ao"):
        sd = load_scene_string(spectral_scene(name))
        cfg = make_integrator_config(sd, "sampled")
        rgb = make_integrator_config(sd)
        assert not rgb.spectral and rgb.nch == 3
        assert cfg.spectral == (name not in ("rpf", "ao")), name
        assert cfg.nch == (60 if cfg.spectral else 3)
    warned = [r.getMessage() for r in caplog.records]
    assert warned == ['spectrum_mode "sampled": integrator "rpf" renders '
                      "in RGB mode (sampled spectra cover path/volpath/"
                      "directlighting/whitted/bdpt/mlt/sppm)"]
    with pytest.raises(ValueError, match="spectrum"):
        spectral_mode("path", "xyz")
    path = tmp_path / "s.pbrt"
    path.write_text(spectral_scene("path", res=8, spp=2))
    out = {}
    for spectrum in ("rgb", "sampled"):
        out[spectrum] = tmp_path / f"{spectrum}.pfm"
        assert cli.main([str(path), "--device", "cpu", "--outfile",
                         str(out[spectrum]), "--quiet", "--spectrum",
                         spectrum]) == 0
    rgb, spec = (read_image(str(out[k])) for k in ("rgb", "sampled"))
    assert np.isfinite(spec).all() and spec.mean() > 0
    # the fallback basis promotes colours away from RGB mode (the reason
    # the port is held to tpurt's spectral renders, not to RGB mode)
    assert not np.array_equal(rgb, spec)
