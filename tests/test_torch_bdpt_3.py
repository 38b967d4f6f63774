"""bdpt's density helpers against tpurt's on the CPU (render/bdpt.py's
_convert_density, _pdf_light and _pdf_light_origin against
tpurt/render/bdpt.py:111-124, :352-382), and the projection and
goniometric lights' emission, which tpurt samples through its infinite
light's branch (a quirk of tpurt's the port copies on purpose: ROADMAP,
Queue 3; pbrt's ProjectionLight::Sample_Le and
GonioPhotometricLight::Sample_Le start at the light's position).  Inputs
come from numpy with fixed seeds; helpers and bounds are
test_torch_bdpt.py's.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.render import bdpt as tb
from tpurt_torch.render import bdpt as pb
from tpurt_torch.render import lights as pl
from test_torch_bdpt import N, _close_most, _t, lane_inputs, light_tables

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_convert_density_matches_tpurt():
    """Surface, medium and escaped receivers."""
    rng = np.random.default_rng(3)
    pdf = rng.exponential(size=N).astype(np.float32)
    a = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    b[:8] = a[:8]  # coincident points: the 1e-18 floor
    ng = _unit(rng, N)
    esc = rng.uniform(size=N) < 0.2
    med = rng.uniform(size=N) < 0.3
    args = [pdf, a, b, ng]
    want = tb._convert_density(*map(jnp.asarray, args))
    _close_most(pb._convert_density(*map(_t, args)), want)
    want = tb._convert_density(*map(jnp.asarray, args),
                               to_escaped=jnp.asarray(esc),
                               to_medium=jnp.asarray(med))
    got = pb._convert_density(*map(_t, args), to_escaped=_t(esc),
                              to_medium=_t(med))
    _close_most(got, want)


def test_pdf_light_matches_tpurt(tmp_path):
    """_pdf_light from light points toward receivers (area, escaped and
    rowless vertices, medium receivers) and _pdf_light_origin under the
    power pmf, over every light kind."""
    tlt, plt = light_tables(tmp_path)
    idx, u = lane_inputs(plt.n_lights, seed=4)
    le = pl.sample_le(plt, _t(idx), *map(_t, u))
    rng = np.random.default_rng(5)
    lrow = np.where(rng.uniform(size=N) < 0.1, -1, idx).astype(np.int32)
    esc = rng.uniform(size=N) < 0.15
    to_p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    to_ng = _unit(rng, N)
    med = rng.uniform(size=N) < 0.2
    p, n = le.p.numpy(), le.n.numpy()
    want = tb._pdf_light(tlt, jnp.asarray(lrow), jnp.asarray(esc),
                         jnp.asarray(p), jnp.asarray(n), jnp.asarray(to_p),
                         jnp.asarray(to_ng), tlt.world_radius,
                         to_medium=jnp.asarray(med))
    got = pb._pdf_light(plt, _t(lrow), _t(esc), _t(p), _t(n), _t(to_p),
                        _t(to_ng), plt.world_radius, to_medium=_t(med))
    _close_most(got, want)
    w_esc = _unit(rng, N)
    want = tb._pdf_light_origin(tlt, jnp.asarray(lrow), jnp.asarray(esc),
                                jnp.asarray(p), jnp.asarray(w_esc),
                                tlt.power_pmf)
    got = pb._pdf_light_origin(plt, _t(lrow), _t(esc), _t(p), _t(w_esc),
                               plt.power_pmf)
    _close_most(got, want)


def test_projection_and_gonio_emit_through_the_infinite_branch(tmp_path):
    """Pinned quirk: a projection or goniometric row's emitted ray is the
    infinite light's (origin on the world-radius disk behind the sampled
    direction, normal = direction, position pdf 1 / (pi r^2)), its
    direction pdf the area lights' cosine one, and it is not a delta
    position; the environment-mapped and the constant sky alike."""
    for sky in ("mapped", "constant"):
        _, plt = light_tables(tmp_path, sky)
        idx, u = lane_inputs(plt.n_lights, seed=6)
        kind = plt.rows[:, 0].to(torch.int64)[idx].numpy()
        le = pl.sample_le(plt, _t(idx), *map(_t, u))
        inf_row = int(np.nonzero(plt.rows[:, 0].numpy()
                                 == pl.LIGHT_INFINITE)[0][0])
        inf = pl.sample_le(plt, torch.full((N,), inf_row), *map(_t, u))
        for k in (pl.LIGHT_PROJECTION, pl.LIGHT_GONIO):
            m = kind == k
            assert m.sum() > 100
            np.testing.assert_array_equal(le.p.numpy()[m], inf.p.numpy()[m])
            np.testing.assert_array_equal(le.d.numpy()[m], inf.d.numpy()[m])
            np.testing.assert_array_equal(le.n.numpy()[m], le.d.numpy()[m])
            r = plt.world_radius
            np.testing.assert_allclose(le.pdf_pos.numpy()[m],
                                       1 / (np.pi * r * r), rtol=1e-6)
            assert not le.is_delta_pos.numpy()[m].any()
            assert not le.is_infinite.numpy()[m].any()
            # the cosine hemisphere pdf of u3, u4 (one-sided rows)
            z = np.sqrt(np.clip(1 - _disk_r2(u[2][m], u[3][m]), 0, None))
            # (within the rounding of 1 - x^2 - y^2 at the disk's rim)
            np.testing.assert_allclose(le.pdf_dir.numpy()[m], z / np.pi,
                                       atol=1e-4)
            # tpurt's distance from the world centre: on the disk r away
            off = le.p.numpy()[m] - plt.world_center.numpy()
            along = (off * -le.d.numpy()[m]).sum(-1)
            np.testing.assert_allclose(along, r, rtol=1e-5)


def _disk_r2(u1, u2):
    """Squared radius of the concentric disk warp of (u1, u2)."""
    ux, uy = 2 * u1 - 1, 2 * u2 - 1
    return np.maximum(ux * ux, uy * uy)
