"""The three light kinds the slice adds against tpurt on the CPU: part 3 of the
cases of test_torch_lights_env.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_lights_env.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import lights as tl
from tpurt_torch.render import lights as pl
from test_torch_lights_env import (  # noqa: F401  (fixtures among them)
    KIND_NAMES,
    N,
    _close_most,
    _t,
    all_lights,
    env,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_env_le_lookup(env):
    """Escaped radiance through the centre of texel (8, 12) is that texel
    (the light is turned 30 degrees: the lookup goes through w2l)."""
    _, plt, img = env
    theta, phi = np.pi * 8.5 / 16, 2 * np.pi * 12.5 / 32
    wl = np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                   np.cos(theta)])
    d = plt.env_l2w.numpy()[:3, :3].astype(np.float64) @ wl
    got = pl.env_le(plt, _t(d[None].astype(np.float32)))[0]
    np.testing.assert_allclose(got.numpy(), img[8, 12], rtol=1e-3)


def test_light_tables_match_tpurt(all_lights):
    tlt, _, tab = all_lights
    for k, v in tab.items():
        if isinstance(v, np.ndarray):
            assert v.tobytes() == np.asarray(getattr(tlt, k)).tobytes(), k
        else:
            assert v == getattr(tlt, k), k


@pytest.mark.parametrize("kind", sorted(KIND_NAMES),
                         ids=lambda k: KIND_NAMES[k])
def test_sample_li_matches_tpurt(all_lights, kind):
    tlt, plt, _ = all_lights
    row = plt.rows[:, 0].tolist().index(kind)
    rng = np.random.default_rng(kind)
    ref = np.stack([rng.uniform(-4, 4, N), rng.uniform(-1, 2, N),
                    rng.uniform(-1, 8, N)], -1).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    idx = np.full(N, row, np.int32)
    want = tl.sample_li(tlt, jnp.asarray(idx), jnp.asarray(ref),
                        jnp.asarray(u2))
    got = pl.sample_li(plt, _t(idx).long(), _t(ref), _t(u2))
    for f in ("wi", "li", "pdf", "p_light"):
        _close_most(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.is_delta.numpy(),
                                  np.asarray(want.is_delta))
    if kind in (pl.LIGHT_PROJECTION, pl.LIGHT_GONIO):
        li = got.li.numpy()
        assert (li == 0).all(-1).mean() > 0.05 or kind == pl.LIGHT_GONIO
        assert np.ptp(li[:, 0] * np.sum((ref - got.p_light.numpy()) ** 2,
                                        -1)) > 1.0  # direction-dependent
    # the MIS pdf of a BSDF-sampled direction toward the light
    wi = got.wi.numpy()
    p_hit = got.p_light.numpy()
    ng = -wi
    want_pdf = tl.pdf_li_from_hit(tlt, jnp.asarray(idx), jnp.asarray(ref),
                                  jnp.asarray(wi), jnp.asarray(p_hit),
                                  jnp.asarray(ng))
    got_pdf = pl.pdf_li_from_hit(plt, _t(idx).long(), _t(ref), _t(wi),
                                 _t(p_hit), _t(ng))
    _close_most(got_pdf, want_pdf)
