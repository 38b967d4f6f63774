"""Sampled-spectrum mode on the card: the device lifts and the RGB
conversion against the CPU's, and a small spectral render of each
integrator that carries the bins, card against CPU.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_spectral_cuda.py``.

Bounds: the lifts and the conversion within 1e-6 + 1e-6 relative (a
float32 product of 7 or 60 terms with TF32 off, summed in another order
by cuBLAS); the renders within the standing bounds (means within 1e-3
relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel).
"""

import numpy as np
import pytest
import torch

from tpurt_torch import spectrum_sampled as ss
from tpurt_torch.render.driver import render
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import (SPECTRAL_SPECULAR_WORLD,
                                    spectral_media_world, spectral_scene)

pytestmark = pytest.mark.cuda


def test_lifts_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = torch.rand((4096, 3), generator=torch.Generator().manual_seed(3)) * 2
    for fn in (ss.lift_refl, ss.lift_illum, ss.lift_refl_raw):
        got, want = fn(c.cuda()).cpu(), fn(c)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    b = ss.lift_illum(c)
    torch.testing.assert_close(ss.to_rgb(b.cuda()).cpu(), ss.to_rgb(b),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("integrator,kw", [
    ("path", {}), ("directlighting", {}),
    ("whitted", dict(maxdepth=4, world=SPECTRAL_SPECULAR_WORLD)),
    ("volpath", dict(world=None)), ("bdpt", dict(maxdepth=2)),
    ("sppm", dict(maxdepth=2, extra=' "integer iterations" [2] '
                  '"float radius" [0.5]'))])
def test_spectral_render_card_matches_cpu(integrator, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if integrator == "volpath":
        kw = dict(world=spectral_media_world())
    text = spectral_scene(integrator, **kw)
    g, job = render(load_scene_string(text), "cuda", spectrum="sampled")
    h, _ = render(load_scene_string(text), "cpu", spectrum="sampled")
    assert job.cfg.spectral
    assert np.isfinite(g).all() and h.mean() > 0.01
    assert abs(g.mean() - h.mean()) <= 1e-3 * h.mean()
    ok = np.abs(g - h) <= 1e-3 + 1e-3 * np.abs(h)
    assert ok.all(axis=-1).mean() >= 0.99
