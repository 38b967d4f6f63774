"""The three light kinds the slice adds against tpurt on the CPU: part 2 of the
cases of test_torch_lights_env.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_lights_env.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.render import lights as tl
from tpurt_torch.render import lights as pl
from test_torch_lights_env import (  # noqa: F401  (fixtures among them)
    N,
    _close,
    _close_most,
    _t,
    env,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_env_pdf_and_le_match_tpurt(env):
    tlt, plt, _ = env
    rng = np.random.default_rng(2)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    _close(pl.env_pdf(plt, _t(d)), tl.env_pdf(tlt, jnp.asarray(d)))
    _close_most(pl.env_le(plt, _t(d)), tl.env_le(tlt, jnp.asarray(d)))


def test_env_mc_integral_matches_direct_sum(env):
    _, plt, img = env
    rng = np.random.default_rng(1)
    n = 20000
    wi, li, pdf = pl.env_sample(plt, _t(rng.uniform(size=n).astype(
        np.float32)), _t(rng.uniform(size=n).astype(np.float32)))
    est = torch.where(pdf[:, None] > 0, li / pdf[:, None], 0.0).mean(0)
    he, we = img.shape[:2]
    theta = np.pi * (np.arange(he) + 0.5) / he
    dw = (np.pi / he) * (2 * np.pi / we)
    direct = (img * np.sin(theta)[:, None, None] * dw).sum((0, 1))
    np.testing.assert_allclose(est.numpy(), direct, rtol=0.05)


def test_env_pdf_matches_sample_pdf(env):
    _, plt, _ = env
    rng = np.random.default_rng(2)
    u = [_t(rng.uniform(size=512).astype(np.float32)) for _ in range(2)]
    wi, _, pdf = pl.env_sample(plt, *u)
    _close(pl.env_pdf(plt, wi), pdf, rtol=1e-3, atol=1e-5)
