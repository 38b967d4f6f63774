"""The seven-slot BSDF of every material kind the slice adds against tpurt:
part 3 of the cases of test_torch_materials.py, in files of at most three
cases so that xdist's loadfile queue runs them beside the suite's long
files.  Helpers, fixtures and bounds are those of test_torch_materials.py.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.render import bsdf as pbsdf
from test_torch_materials import (  # noqa: F401  (fixtures among them)
    CONSISTENCY,
    _albedo_pair,
    _lobes,
    _t,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(CONSISTENCY))
def test_sampling_consistency(name):
    """Importance-sampled and uniform-sphere albedo estimates agree
    (tpurt's test_bsdf.py, bsdfs.cpp:484-556)."""
    imp, uni = _albedo_pair(CONSISTENCY[name])
    assert np.all(imp > 0.02) and np.all(imp < 1.0), imp
    np.testing.assert_allclose(imp, uni, rtol=0.08)


def test_disney_metallic_energy():
    imp, uni = _albedo_pair(dict(
        disney=True, metallic=1.0, r0=[.9, .6, .3], ks=[1., 1., 1.],
        alpha_x=.1, alpha_y=.1, fresnel_kind=pbsdf.FRESNEL_DISNEY, eta=1.5))
    np.testing.assert_allclose(imp, uni, rtol=0.08)
    assert imp[0] > imp[1] > imp[2] and np.all(imp < 1.0), imp


def test_lambertian_transmission_flips_hemisphere():
    n = 1 << 13
    lp = _lobes(n, kd_t=[.5, .5, .5])
    rng = np.random.default_rng(0)
    wo = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    u = [_t(rng.uniform(size=n).astype(np.float32)) for _ in range(3)]
    wi, f, pdf, _, is_trans = pbsdf.bsdf_sample(lp, wo, *u)
    assert bool((wi[:, 2] < 0).all()) and bool(is_trans.all())
    est = float((f[:, 0] * wi[:, 2].abs() / pdf).mean())
    np.testing.assert_allclose(est, 0.5, rtol=0.02)
