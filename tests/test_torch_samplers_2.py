"""Every sampler of the port against tpurt's, bit for bit: part 2 of the cases
of test_torch_samplers.py, in files of at most three cases so that xdist's
loadfile queue runs them beside the suite's long files.  Helpers, fixtures
and bounds are those of test_torch_samplers.py.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.sampling import samplers as ps
from tpurt_torch.scene.paramset import ParamSet as PortParamSet
from test_torch_samplers import (  # noqa: F401  (fixtures among them)
    _both,
    _params,
    pair,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_film_offset_equal(pair):
    tp, port, lanes = pair
    j, t = _both(lanes)
    want = tp.film_offset(*j, tp.lane_ctx(*j))
    got = port.film_offset(*t, port.lane_ctx(*t))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sampler_tables_defaults_and_unknown_name():
    tab = ps.sampler_tables("stratified", PortParamSet(), 8, 8)
    assert (tab["nx"], tab["ny"], tab["spp"], tab["jitter"]) == (4, 4, 16, True)
    assert ps.sampler_tables("random", PortParamSet(), 8, 8)["spp"] == 4
    assert ps.sampler_tables("sobol", _params(PortParamSet, pixelsamples=5),
                             8, 8)["spp"] == 8
    assert ps.sampler_tables("random", PortParamSet(), 8, 8,
                             quick=True)["spp"] == 1
    with pytest.raises(NotImplementedError, match="adaptive"):
        ps.sampler_tables("adaptive", PortParamSet(), 8, 8)
