"""The hair BSDF (render/hair.py) against tpurt's on the CPU, and the
reference's white-furnace tests (hair.cpp TEST WhiteFurnace and
WhiteFurnaceSampled; tpurt's tests/test_hair.py) on the port's.

Bounds, the scheme of test_torch_materials.py for a transcendental-heavy
BSDF: >= 99% of lanes within rtol 1e-5 / atol 1e-6 and every lane within
rtol 1e-4 / atol 1e-6 (a one-ulp difference of exp, log, asin or atan2 between XLA and torch
grows through the Bessel series and the logistic; measured worst lanes
are named at each check); demux_float bit-equal.  The furnaces as tpurt's:
within 5% (f) and 2% (sampled).  Inputs come from numpy with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.render import hair as th
from tpurt_torch.render import hair as ph

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

_YW = np.asarray([0.212671, 0.715160, 0.072169])


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _params(rng, n):
    """(tpurt's, the port's) HairParams of random lanes over the
    parameter ranges pbrt's hair takes."""
    p = dict(h=rng.uniform(-1, 1, n), eta=rng.uniform(1.3, 1.8, n),
             sigma_a=np.abs(rng.normal(size=(n, 3))) * 2,
             beta_m=rng.uniform(0.05, 0.95, n),
             beta_n=rng.uniform(0.05, 0.95, n), alpha=rng.uniform(0, 4, n))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (th.HairParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            ph.HairParams(**{k: torch.as_tensor(v) for k, v in p.items()}))


def check(got, want, rtol_all=1e-4):
    """>= 99% of lanes at rtol 1e-5 / atol 1e-6, every lane at rtol
    ``rtol_all`` (1e-4) / atol 1e-6."""
    g, w = got.numpy(), np.asarray(want)
    near = np.isclose(g, w, rtol=1e-5, atol=1e-6)
    assert near.reshape(len(g), -1).all(-1).mean() >= 0.99
    np.testing.assert_allclose(g, w, rtol=rtol_all, atol=1e-6)


def test_hair_f_and_pdf_match_tpurt():
    """Measured on the CPU (8,192 lanes): f within 3.0e-5 relative on
    every lane, pdf within 2.8e-5; >= 99.8% of lanes within 1e-5."""
    rng = np.random.default_rng(61)
    n = 8192
    thp, php = _params(rng, n)
    wo, wi = _unit(rng, n), _unit(rng, n)
    check(ph.hair_f(php, torch.as_tensor(wo), torch.as_tensor(wi)),
          th.hair_f(thp, jnp.asarray(wo), jnp.asarray(wi)))
    check(ph.hair_pdf(php, torch.as_tensor(wo), torch.as_tensor(wi)),
          th.hair_pdf(thp, jnp.asarray(wo), jnp.asarray(wi)))


def test_hair_sample_matches_tpurt():
    """The sampled direction under the scheme; f and pdf of the sample,
    and at tpurt's sampled direction, at >= 99% of lanes within 1e-5 and
    every lane within rtol 1e-3: a sampled direction sits on a lobe's
    peak, where the longitudinal term is steepest (beta_m near 0.05: Mp's
    exponent is ~1/v ~ 800), so a one-ulp difference of a transcendental
    or of wi moves f and pdf by ~1e-4 there, while at random directions
    every lane is within 3e-5.  Measured on the CPU (8,192 lanes): the
    sample's f 3.4e-4 relative on its worst lane (6 values in 24,576 above
    1e-4), its pdf 2.4e-4 (1 lane), f at tpurt's direction 2.4e-4 (1
    lane), wi within 1e-4; demux_float bit-equal."""
    rng = np.random.default_rng(62)
    n = 8192
    thp, php = _params(rng, n)
    wo = _unit(rng, n)
    u1, u2 = rng.uniform(size=(2, n)).astype(np.float32)
    for a, b in zip(ph.demux_float(torch.as_tensor(u1)),
                    th.demux_float(jnp.asarray(u1))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = ph.hair_sample(php, torch.as_tensor(wo), torch.as_tensor(u1),
                         torch.as_tensor(u2))
    want = th.hair_sample(thp, jnp.asarray(wo), jnp.asarray(u1),
                          jnp.asarray(u2))
    check(got[0], want[0])
    check(got[1], want[1], rtol_all=1e-3)
    check(got[2], want[2], rtol_all=1e-3)
    wi = torch.as_tensor(np.array(want[0]))
    check(ph.hair_f(php, torch.as_tensor(wo), wi), want[1], rtol_all=1e-3)
    check(ph.hair_pdf(php, torch.as_tensor(wo), wi),
          th.hair_pdf(thp, jnp.asarray(wo), want[0]), rtol_all=1e-3)


def _sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2),
                     z], axis=-1).astype(np.float32)


def test_white_furnace():
    """Absorption-free hair reflects all its energy: the uniform-sphere
    estimate of f |cos| integrates to 1, and so does the sampled estimate
    f |cos| / pdf, for light, medium and heavy roughness."""
    rng = np.random.default_rng(63)
    n = 100_000
    for beta in (0.1, 0.5, 0.9):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa
        full = lambda v: t(np.full(n, v))  # noqa
        hp = ph.HairParams(h=t(-1 + 2 * rng.random(n)), eta=full(1.55),
                           sigma_a=t(np.zeros((n, 3))), beta_m=full(beta),
                           beta_n=full(beta), alpha=full(0.0))
        wo = t(np.tile(_sphere(rng.random(), rng.random()), (n, 1)))
        wi = t(_sphere(rng.random(n), rng.random(n)))
        f = ph.hair_f(hp, wo, wi).numpy()
        y = (f * _YW).sum(-1) * np.abs(wi.numpy()[:, 2])
        assert 0.95 <= y.mean() * 4 * np.pi <= 1.05, (beta, y.mean())
        wi_s, f_s, pdf = ph.hair_sample(hp, wo, t(rng.random(n)),
                                        t(rng.random(n)))
        y = ((f_s.numpy() * _YW).sum(-1) * np.abs(wi_s.numpy()[:, 2]))
        pdf = pdf.numpy()
        est = np.where(pdf > 0, y / np.maximum(pdf, 1e-20), 0.0)
        assert 0.98 <= est.mean() <= 1.02, (beta, est.mean())
