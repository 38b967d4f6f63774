"""Catmull-Rom interpolation against tpurt on the CPU
(tpurt_torch/sampling/interpolation.py): the host weights and integral
bit-equal, and the device weights, evaluation, inversion and 2D sampling
on 4,096 seeded lanes within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.sampling import interpolation as ti
from tpurt_torch.sampling import interpolation as pi

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

N = 4096


def _nodes(rng, n):
    return np.sort(np.concatenate([[-1.0, 1.0],
                                   rng.uniform(-1, 1, n - 2)]))


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_host_weights_and_integral_match_tpurt():
    rng = np.random.default_rng(0)
    nodes = _nodes(rng, 13)
    for x in np.concatenate([rng.uniform(-1.1, 1.1, 64), nodes]):
        want = ti.catmull_rom_weights_np(nodes, x)
        got = pi.catmull_rom_weights_np(nodes, x)
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    values = rng.uniform(0, 2, (5, 13))
    for g, w in zip(pi.integrate_catmull_rom_np(nodes, values),
                    ti.integrate_catmull_rom_np(nodes, values)):
        np.testing.assert_array_equal(g, w)


def test_weights_eval_and_inversion_match_tpurt():
    """catmull_rom_weights (ok, offset, w), catmull_rom_eval with shared
    and per-lane tables, invert_catmull_rom on monotone per-lane tables."""
    rng = np.random.default_rng(1)
    nodes = _nodes(rng, 17).astype(np.float32)
    x = rng.uniform(-1.05, 1.05, N).astype(np.float32)
    jn, jx = jnp.asarray(nodes), jnp.asarray(x)
    tn, tx = torch.tensor(nodes), torch.tensor(x)
    want = ti.catmull_rom_weights(jn, jx)
    got = pi.catmull_rom_weights(tn, tx)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2])
    shared = rng.uniform(0, 3, 17).astype(np.float32)
    lanes = rng.uniform(0, 3, (N, 17)).astype(np.float32)
    for vals in (shared, lanes):
        _close(pi.catmull_rom_eval(tn, torch.tensor(vals), tx),
               ti.catmull_rom_eval(jn, jnp.asarray(vals), jx))
    mono = np.cumsum(rng.uniform(0.05, 1, (N, 17)), -1).astype(np.float32)
    u = (rng.uniform(-0.1, 1.1, N) * mono[:, -1]).astype(np.float32)
    got = pi.invert_catmull_rom(tn, torch.tensor(mono),
                                torch.tensor(u)).numpy()
    want = np.asarray(ti.invert_catmull_rom(jn, jnp.asarray(mono),
                                            jnp.asarray(u)))
    # where the spline is flat, an ulp of F(x) - u moves the root by
    # ulp / F'(x): 1e-6 on >= 99.9% of lanes, 1e-5 on all
    err = np.abs(got - want)
    assert (err <= 1e-6).mean() >= 0.999 and err.max() <= 1e-5, err.max()


def test_sample_catmull_rom_2d_matches_tpurt():
    """Sampled values, spline values and pdfs of SampleCatmullRom2D over a
    seeded positive table and its cdf (integrate_catmull_rom_np)."""
    rng = np.random.default_rng(2)
    n1, n2 = 11, 19
    nodes1 = _nodes(rng, n1)
    nodes2 = _nodes(rng, n2)
    values = rng.uniform(0.1, 2.0, (n1, n2))
    _, cdf = pi.integrate_catmull_rom_np(nodes2, values)
    args = [a.astype(np.float32) for a in (nodes1, nodes2, values, cdf)]
    alpha = rng.uniform(-1.02, 1.02, N).astype(np.float32)
    u = rng.uniform(0, 1, N).astype(np.float32)
    want = ti.sample_catmull_rom_2d(*[jnp.asarray(a) for a in args],
                                    jnp.asarray(alpha), jnp.asarray(u))
    got = pi.sample_catmull_rom_2d(*[torch.tensor(a) for a in args],
                                   torch.tensor(alpha), torch.tensor(u))
    for g, w in zip(got, want):
        _close(g, w)
    assert (got[2] > 0).float().mean() > 0.9
