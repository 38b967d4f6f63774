"""The port's SPPM grid, photon dimensions and pixel update against
tpurt's (tpurt_torch/render/sppm.py against tpurt/render/sppm.py), on the
CPU, with inputs made by numpy from a seed.

Bounds: the grid's tables (es_keys, es_vals, lo, diag, res, max_occ), the
cells, in-bounds flags and hashes of photon points exactly equal, with
visible points placed on and one ulp beside cell edges; the photon
dimensions (dims 0-4 through the static-base radical inverse, the bounce
dims through _ri_dyn) and the camera pass's Halton dims bit-equal for
indices up to 2^31 - 1; the pixel update within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpurt.render import sppm as tsppm
from tpurt.sampling.samplers import make_halton
from tpurt_torch.render import sppm as psppm
from tpurt_torch.render.integrator import SceneData
from tpurt_torch.sampling import lowdiscrepancy as ld
from tpurt_torch.sampling.samplers import halton_from_tables, halton_tables

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

HASH_SIZE = 997


def _tpurt_grid(vp_p, vp_valid, radius):
    out = jax.jit(lambda p, v, r: tsppm._build_grid(p, v, r, HASH_SIZE))(
        jnp.asarray(vp_p), jnp.asarray(vp_valid), jnp.asarray(radius))
    return [np.asarray(a) for a in out]


def _port_grid(vp_p, vp_valid, radius):
    out = psppm._build_grid(torch.tensor(vp_p), torch.tensor(vp_valid),
                            torch.tensor(radius), HASH_SIZE)
    return [a.numpy() for a in out]


def _visible_points():
    """Seeded visible points, then points whose +-r windows end on a cell
    edge of the first set's grid and one ulp either side of it (inside
    its bounds, at its largest radius or less, so the grid keeps its
    bounds and resolution)."""
    rng = np.random.default_rng(11)
    n = 400
    vp_p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    vp_valid = rng.uniform(size=n) > 0.15
    radius = rng.uniform(0.05, 0.3, n).astype(np.float32)
    _, _, lo, diag, res, _ = _tpurt_grid(vp_p, vp_valid, radius)
    cell = diag / res.astype(np.float32)
    r = np.float32(0.05)
    k = rng.integers(1, res - 1, (64, 3))
    edge = (lo + k.astype(np.float32) * cell + r).astype(np.float32)
    edges = [edge, np.nextafter(edge, np.float32(np.inf)),
             np.nextafter(edge, np.float32(-np.inf)),
             (edge - 2 * r).astype(np.float32)]
    extra = np.concatenate(edges).astype(np.float32)
    return (np.concatenate([vp_p, extra]),
            np.concatenate([vp_valid, np.ones(len(extra), bool)]),
            np.concatenate([radius, np.full(len(extra), r, np.float32)]))


def test_grid_tables_equal_tpurt():
    vp_p, vp_valid, radius = _visible_points()
    want = _tpurt_grid(vp_p, vp_valid, radius)
    got = _port_grid(vp_p, vp_valid, radius)
    for name, w, g in zip(("es_keys", "es_vals", "lo", "diag", "res",
                           "max_occ"), want, got):
        assert w.shape == g.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    # visible points span several cells, and cells hold several points
    assert int(want[5]) > 1 and (want[0] < HASH_SIZE).sum() > 2 * vp_valid.sum()

    # photon points: cells, in-bounds flags and hashes, inside and outside
    rng = np.random.default_rng(12)
    ph = rng.uniform(-2.6, 2.6, (2000, 3)).astype(np.float32)
    ph = np.concatenate([ph, vp_p]).astype(np.float32)
    lo, diag, res = want[2:5]
    tc, tin = tsppm._to_grid(jnp.asarray(ph), jnp.asarray(lo),
                             jnp.asarray(diag), jnp.asarray(res))
    th = tsppm._cell_hash(tc, HASH_SIZE)
    pc, pin = psppm._to_grid(torch.tensor(ph), torch.tensor(lo),
                             torch.tensor(diag), torch.tensor(res))
    ph_hash = psppm._cell_hash(pc, HASH_SIZE)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(tc))
    np.testing.assert_array_equal(pin.numpy(), np.asarray(tin))
    np.testing.assert_array_equal(ph_hash.numpy(), np.asarray(th))
    assert 0 < pin.numpy().mean() < 1


def test_photon_and_camera_dims_bit_equal_tpurt():
    rng = np.random.default_rng(13)
    a = np.concatenate([[0, 1, 2, 16, 17, 288, (1 << 31) - 1],
                        rng.integers(0, 1 << 31, 4000)]).astype(np.int32)
    ta, pa = jnp.asarray(a), torch.tensor(a.astype(np.int64))
    # tpurt's render runs them jitted, where XLA fuses each digit's
    # multiply-add (eager, 4% of these lanes differ by an ulp)
    # photon dims 0-4: primes 2-11 through the static radical inverse
    for k in range(5):
        base = int(ld.PRIMES[k])
        want = np.asarray(jax.jit(lambda x: tsppm._radical_inverse(
            x, base))(ta))
        got = psppm._radical_inverse(pa, base).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"dim {k}")
    # the bounce dims 6 + 4b .. 9 + 4b, b < 5: a traced base in tpurt
    ri = jax.jit(tsppm._ri_dyn, static_argnums=2)
    n_digits = tsppm._digits_needed(17, 1 << 31)
    for d in range(6, 26):
        base = int(ld.PRIMES[d])
        want = np.asarray(ri(ta, jnp.int32(base), n_digits))
        got = psppm._ri_dyn(pa, base, n_digits).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"dim {d}")
    # the int32 wrap of the photon index
    wide = torch.tensor([(1 << 31) - 1, 1 << 31, (1 << 32) + 5])
    assert psppm._wrap_i32(wide).tolist() == [(1 << 31) - 1, -(1 << 31), 5]

    # the camera pass: the port's static dims equal tpurt's dim_dyn for
    # sppm's spp (the number of iterations) on every pixel it samples
    n_iters, res = 64, 700
    ts = make_halton(n_iters, res, res)
    ps = halton_from_tables(dict(halton_tables(n_iters, res, res), fma=True),
                            "cpu")
    px = rng.integers(0, res, 3000)
    py = rng.integers(0, res, 3000)
    si = rng.integers(0, n_iters, 3000)
    tctx = ts.lane_ctx(jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32),
                       jnp.asarray(si, jnp.int32))
    pctx = ps.lane_ctx(torch.tensor(px), torch.tensor(py), torch.tensor(si))
    dyn = jax.jit(lambda c, d: ts.dim_dyn(None, None, None, d, c))
    for d in range(5, 5 + 7 * 6):
        want = np.asarray(dyn(tctx, jnp.int32(d)))
        got = ps.dim(None, None, None, d, pctx).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"camera dim {d}")


def test_update_pixels_matches_tpurt():
    rng = np.random.default_rng(14)
    n = 257
    f = lambda *s: rng.uniform(0.1, 2.0, (n,) + s).astype(np.float32)
    M = np.where(rng.uniform(size=n) > 0.3,
                 rng.integers(0, 20, n), 0).astype(np.float32)
    fields = dict(radius=f(), N=np.floor(f() * 10), tau=f(3), Phi=f(3), M=M,
                  vp_beta=f(3), vp_valid=rng.uniform(size=n) > 0.5)
    tpix = tsppm._init_pixels(n, 1.0)._replace(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    scene = SceneData(geo=None, lights=None,
                      mt_table=torch.zeros((1, 53)))
    ppix = psppm._init_pixels(n, 1.0, scene, "cpu")
    for k, v in fields.items():
        setattr(ppix, k, torch.tensor(v))
    want = tsppm._update_pixels(tpix)
    got = psppm._update_pixels(ppix)
    for k in ("radius", "N", "tau", "Phi", "M", "vp_valid", "vp_beta"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   err_msg=k)
    assert (got.M.numpy() == 0).all() and not got.vp_valid.numpy().any()
