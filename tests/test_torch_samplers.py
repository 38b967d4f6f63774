"""Every sampler of the port against tpurt's, bit for bit.

Tolerance: none.  ``lane_ctx``, ``dim`` and ``film_offset`` are integer
math plus float32 roundings taken in the same order on both sides, so the
values must be equal.  Lanes are random (pixel, sample) pairs from a numpy
seed on a 700x700 film, so that most pixels lie beyond the point where
the random sampler's uint32 lane counter ``(py*res_x + px)*16384 + sidx``
wraps (2^32 / 16384 = pixel 262,144 of 490,000), plus the film's corners.
Halton (pbrt scramble) and Sobol' are also held under a crop window,
whose sample bounds move their index geometry.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.sampling import samplers as ts
from tpurt.scene.paramset import ParamSet
from tpurt_torch.sampling import samplers as ps
from tpurt_torch.scene.paramset import ParamSet as PortParamSet

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

RES = 700
N = 1500
DIMS = [0, 1, 2, 3, 4, 5, 6, 7, 11, 12, 18, 19, 25, 33, 40, 46]


def _lanes(spp, bounds=(0, RES, 0, RES), seed=4):
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = bounds
    px = rng.integers(x0, x1, N)
    py = rng.integers(y0, y1, N)
    px[:4] = [x0, x1 - 1, x0, x1 - 1]
    py[:4] = [y0, y0, y1 - 1, y1 - 1]
    s = rng.integers(0, spp, N)
    return [a.astype(np.int32) for a in (px, py, s)]


def _params(cls, **kw):
    p = cls()
    for k, v in kw.items():
        p.add("bool" if isinstance(v, bool) else "integer", k, [v])
    return p


CASES = {
    "random": ("random", dict(pixelsamples=8), None),
    "stratified": ("stratified", dict(), None),
    "stratified3x2": ("stratified", dict(xsamples=3, ysamples=2), None),
    "stratified_nojitter": ("stratified", dict(jitter=False), None),
    "02sequence": ("02sequence", dict(pixelsamples=8), None),
    "02sequence_round": ("lowdiscrepancy", dict(pixelsamples=6), None),
    "sobol": ("sobol", dict(pixelsamples=8), None),
    "sobol_crop": ("sobol", dict(pixelsamples=4), (120, 333, 410, 699)),
    "maxmindist": ("maxmindist", dict(pixelsamples=16), None),
    "halton_pbrt": ("halton", dict(pixelsamples=8), None),
    "halton_pbrt_crop": ("halton", dict(pixelsamples=4), (120, 333, 410, 699)),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    name, kw, bounds = CASES[request.param]
    old = os.environ.get("TPURT_HALTON_SCRAMBLE")
    if request.param.startswith("halton_pbrt"):
        os.environ["TPURT_HALTON_SCRAMBLE"] = "pbrt"
    try:
        tp = ts.make_sampler(name, _params(ParamSet, **kw), RES, RES,
                             sample_bounds=bounds)
        tab = ps.sampler_tables(name, _params(PortParamSet, **kw), RES, RES,
                                sample_bounds=bounds)
    finally:
        if old is None:
            os.environ.pop("TPURT_HALTON_SCRAMBLE", None)
        else:
            os.environ["TPURT_HALTON_SCRAMBLE"] = old
    port = ps.sampler_from_tables(tab, "cpu")
    assert port.spp == tp.spp and port.name == tp.name
    lanes = _lanes(tp.spp, bounds or (0, RES, 0, RES))
    return tp, port, lanes


def _both(lanes):
    return ([jnp.asarray(a) for a in lanes],
            [torch.as_tensor(a).long() for a in lanes])


def test_lane_ctx_equal(pair):
    tp, port, lanes = pair
    j, t = _both(lanes)
    want, got = tp.lane_ctx(*j), port.lane_ctx(*t)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(
        got.numpy().astype(np.uint32), np.asarray(want).astype(np.uint32))


def test_random_counter_wraps_on_this_film():
    px, py, s = (a.astype(np.int64) for a in _lanes(8))
    assert ((py * RES + px) * 16384 + s >= 1 << 32).mean() > 0.3


@pytest.mark.parametrize("d", DIMS)
def test_dim_equal(pair, d):
    tp, port, lanes = pair
    j, t = _both(lanes)
    for ctx in (False, True):
        want = np.asarray(tp.dim(*j, d, tp.lane_ctx(*j) if ctx else None))
        got = port.dim(*t, d, port.lane_ctx(*t) if ctx else None).numpy()
        assert got.dtype == np.float32
        assert (got >= 0).all() and (got < 1).all()
        np.testing.assert_array_equal(got, want)
