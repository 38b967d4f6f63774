"""The port's Halton sampler (affine scramble) against tpurt's.

Every (pixel, sample, dim) value for dims 0-40 on a 37x29 film.  tpurt's
sampler runs eagerly, one XLA op at a time, for the static-dimension
values, and jitted (``dim_dyn`` with a traced dimension, as its bounce
loop runs it) for the bounce dims.  Both must equal the port's values
exactly: the digit loops are integer math plus one rounding per float
op, taken in the same order on both sides.  The jitted path would be
allowed 1 ulp if XLA's CPU backend contracted ``acc + digit * scale`` into
an FMA; the assertion records whether it did.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.sampling import lowdiscrepancy as ld
from tpurt.sampling.samplers import HaltonSampler as TpurtHalton
from tpurt_torch.sampling.samplers import halton_from_tables, halton_tables

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

RES_X, RES_Y, SPP = 37, 29, 3
DIMS = range(41)


@pytest.fixture(scope="module")
def samplers():
    tab = halton_tables(SPP, RES_X, RES_Y)
    port = halton_from_tables(tab, "cpu")
    # tpurt's HaltonSampler built from the same Halton geometry (the
    # affine scramble never reads the pbrt permutation tables, so a
    # placeholder stands in for them)
    tp = TpurtHalton(
        spp=SPP, perms=jnp.zeros(1, jnp.int32),
        offsets=jnp.asarray(tab["offsets"].astype(np.int32)),
        stride=tab["stride"], exp_x=tab["exp_x"], scale_y=tab["scale_y"],
        primes=jnp.asarray(ld.PRIMES.astype(np.int32)),
        prime_sums=jnp.asarray(ld.PRIME_SUMS.astype(np.int32)),
        max_index=tab["max_index"], scramble="affine")
    py, px, s = np.meshgrid(np.arange(RES_Y), np.arange(RES_X),
                            np.arange(SPP), indexing="ij")
    lanes = [a.ravel().astype(np.int32) for a in (px, py, s)]
    return tp, port, lanes, jax.jit(tp.dim_dyn)


def test_halton_tables_match_tpurt_make_halton():
    from tpurt.sampling.samplers import make_halton

    tp = make_halton(SPP, RES_X, RES_Y, sample_bounds=(0, RES_X, 0, RES_Y))
    tab = halton_tables(SPP, RES_X, RES_Y, sample_bounds=(0, RES_X, 0, RES_Y))
    np.testing.assert_array_equal(tab["offsets"], np.asarray(tp.offsets))
    assert (tab["stride"], tab["exp_x"], tab["scale_y"], tab["max_index"]) == (
        tp.stride, tp.exp_x, tp.scale_y, tp.max_index)


@pytest.mark.parametrize("d", DIMS)
def test_halton_dim_equals_tpurt(samplers, d):
    tp, port, (px, py, s), dim_dyn = samplers
    want = np.asarray(tp.dim(jnp.asarray(px), jnp.asarray(py),
                             jnp.asarray(s), d))
    tpx, tpy, ts = (torch.as_tensor(a).long() for a in (px, py, s))
    got = port.dim(tpx, tpy, ts, d).numpy()
    assert got.dtype == np.float32 and (got >= 0).all() and (got < 1).all()
    np.testing.assert_array_equal(got, want)
    if d >= 5:  # bounce dims: tpurt's jitted traced-dimension path
        dyn = np.asarray(dim_dyn(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(s), jnp.int32(d)))
        ulps = np.abs(got.view(np.int32) - dyn.view(np.int32))
        assert ulps.max() <= 1, ulps.max()
