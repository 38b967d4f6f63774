"""SPPM on the card: the hash grid's candidate pairs against brute force
(the card-side analog of tpurt's tests/test_sppm.py grid test), and the
small caustic frame (tpurt_torch.testscenes.write_caustic "small": 48x48,
4 iterations) rendered on the card equal to the CPU.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_sppm_cuda.py``.

Bounds: the (photon, visible point) pairs with d^2 <= r^2 found through
the grid equal to the brute-force set, and photons outside the grid
having no such pair; the render's mean within 1e-3 relative and >= 99%
of pixels within 1e-3 abs + 1e-3 rel (chip_smoke.py's phase 9).
"""

import numpy as np
import pytest
import torch

from tpurt_torch.render import sppm
from tpurt_torch.render.driver import load_scene, render
from tpurt_torch.testscenes import write_caustic

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def grid_pairs_against_brute_force(vp_p, vp_valid, radius, ph, hash_size):
    """(found, brute) sets of pair keys photon * n_vp + vp: through the
    grid (_build_grid, _cell_runs, _pair_slice, as the deposit finds
    them) and by testing every pair; and the brute-force pairs of the
    photons outside the grid (must be none)."""
    n_vp = vp_p.shape[0]
    grid = sppm._build_grid(vp_p, vp_valid, radius, hash_size)
    rid, start, count, ends = sppm._cell_runs(grid, ph, hash_size)
    total = int(ends[-1]) if ends.numel() else 0
    k, vp = sppm._pair_slice(grid[1], start, count, ends, 0, total)
    rec = rid[k]
    dp = ph[rec] - vp_p[vp]
    ok = ((dp * dp).sum(-1) <= radius[vp] * radius[vp]) & vp_valid[vp]
    found = torch.unique(rec[ok] * n_vp + vp[ok])
    brute = []
    for a in range(0, ph.shape[0], 4096):
        dp = ph[a:a + 4096, None, :] - vp_p[None, :, :]
        hit = (((dp * dp).sum(-1) <= (radius * radius)[None, :])
               & vp_valid[None, :])
        i, j = torch.nonzero(hit, as_tuple=True)
        brute.append((i + a) * n_vp + j)
    brute = torch.unique(torch.cat(brute))
    inside = torch.zeros(ph.shape[0], dtype=torch.bool, device=ph.device)
    inside[rid] = True
    outside = (~inside[brute // n_vp]).sum()
    return found, brute, int(outside)


def test_grid_pairs_equal_brute_force(cuda):
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    n_vp, n_ph = 20000, 1 << 16
    vp_p = torch.rand((n_vp, 3), generator=g, device="cuda") * 4 - 2
    vp_valid = torch.rand(n_vp, generator=g, device="cuda") > 0.2
    radius = torch.rand(n_vp, generator=g, device="cuda") * 0.05 + 0.01
    ph = torch.rand((n_ph, 3), generator=g, device="cuda") * 5 - 2.5
    found, brute, outside = grid_pairs_against_brute_force(
        vp_p, vp_valid, radius, ph, n_vp)
    assert brute.numel() > 1000 and outside == 0
    assert torch.equal(found, brute)


def test_small_caustic_card_equals_cpu(cuda, tmp_path):
    path = write_caustic(str(tmp_path / "c.pbrt"), "small")
    g, job = render(load_scene(path), "cuda")
    h, _ = render(load_scene(path), "cpu")
    assert job.cfg.name == "sppm"
    d = np.abs(g - h)
    frac = (d <= 1e-3 + 1e-3 * np.abs(h)).all(axis=-1).mean()
    mrel = abs(g.mean() - h.mean()) / h.mean()
    assert np.isfinite(g).all() and mrel < 1e-3 and frac >= 0.99, (mrel,
                                                                   frac)
