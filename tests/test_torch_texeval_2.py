"""The port's texture evaluation against tpurt's, on the CPU: part 2 of the
cases of test_torch_texeval.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_texeval.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.config import get_config
from tpurt.render import texeval as TT
from tpurt_torch.render import texeval as PT
from test_torch_texeval import (  # noqa: F401  (fixtures among them)
    N,
    _footprints,
    _t,
    image,
    taps_oracle,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("wrap", ["repeat", "clamp", "black"])
def test_ewa_first_tier_matches_tpurt_taps_oracle(image, taps_oracle, wrap):
    rng = np.random.default_rng(21)
    u = (rng.random(N) * 1.6 - 0.3).astype(np.float32)  # overshoots [0,1]
    v = (rng.random(N) * 1.6 - 0.3).astype(np.float32)
    d0, d1 = _footprints(rng, N, 12.0)
    want = np.asarray(TT._ewa_sample(image, False, jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(d0),
                                     jnp.asarray(d1), wrap))
    got = PT._ewa_sample(image, False, _t(u), _t(v), _t(d0), _t(d1), wrap,
                         max_aniso=PT._EWA_MAX_ANISO).numpy()
    ok = (np.abs(got - want) <= 2e-5).all(-1)
    assert ok.mean() >= 0.999, np.abs(got - want).max()
    assert np.ptp(want) > 0.2


def test_ewa_level_taps_chunks_equal_one_pass(image, monkeypatch):
    rng = np.random.default_rng(23)
    u, v = rng.random((2, N)).astype(np.float32)
    d0, d1 = _footprints(rng, N, 4.0)
    pyr = PT._device_pyramid(image, False, "cpu")
    li = _t(rng.integers(0, 3, N))
    args = (pyr, _t(u), _t(v), _t(d0), _t(d1), li, "repeat")
    whole = PT._ewa_level_taps(*args)
    monkeypatch.setattr(PT, "_EWA_CHUNK_ELEMS", 169 * 50)
    np.testing.assert_array_equal(PT._ewa_level_taps(*args).numpy(),
                                  whole.numpy())


def test_ewa_both_tiers_match_tpurt_default_on_grazing_plane(image):
    """A plane seen at a grazing angle: du/dx stays small while dv/dy
    grows toward the horizon, so the far rows exceed the 2.9 ratio and
    take the wide pass on both sides.  tpurt's budget for 256 lanes is
    128; the plane is set so that fewer lanes need the pass."""
    assert get_config().ewa_blocked
    rng = np.random.default_rng(25)
    row = np.repeat(np.arange(16), 16).astype(np.float32)
    u = rng.random(N).astype(np.float32)
    v = (0.2 + 0.04 * row + 0.01 * rng.random(N)).astype(np.float32)
    du = (0.004 * (1 + 0.1 * rng.random(N))).astype(np.float32)
    dv = (du * np.maximum(1.0, 2.9 * np.exp(0.3 * (row - 9.5)))
          ).astype(np.float32)
    tilt = (0.2 * rng.normal(size=N)).astype(np.float32)
    d0 = np.stack([du, tilt * du], -1).astype(np.float32)
    d1 = np.stack([tilt * dv, dv], -1).astype(np.float32)
    ratio = np.maximum(np.linalg.norm(d0, axis=1), np.linalg.norm(d1, axis=1)) \
        / np.minimum(np.linalg.norm(d0, axis=1), np.linalg.norm(d1, axis=1))
    n_hi = int((ratio > 2.95).sum())
    budget = max(min(N, 128), N // TT._EWA_WIDE_FRAC)
    assert 40 < n_hi < budget and (ratio > 8).sum() > 10
    want = np.asarray(TT._ewa_sample(image, False, jnp.asarray(u),
                                     jnp.asarray(v), jnp.asarray(d0),
                                     jnp.asarray(d1), "repeat"))
    got = PT._ewa_sample(image, False, _t(u), _t(v), _t(d0), _t(d1),
                         "repeat").numpy()
    ok = (np.abs(got - want) <= 2e-5).all(-1)
    assert ok.mean() >= 0.999, np.abs(got - want).max()
    first = PT._ewa_sample(image, False, _t(u), _t(v), _t(d0), _t(d1),
                           "repeat", max_aniso=PT._EWA_MAX_ANISO).numpy()
    # the wide pass changed the lanes it took, and only those
    changed = np.abs(got - first).max(-1) > 1e-4
    assert changed.sum() > 20 and not changed[ratio < 2.85].any()
