"""The gather probe's plain version against tpurt's ``run_xla``, on the CPU.

tpurt's Pallas kernel runs on the CPU only in interpret mode, where one
million scalar steps are too slow for a test; ``run_xla`` computes the
same sum with ``jnp.take``.  Importing tpurt's module runs its probe loop
(a few seconds), which is why this file imports it inside the test.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.kernels import gather_bench as gb

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_plain_gather_rows_sum_matches_tpurt_run_xla():
    """At the probe's sizes (M=16384 x 128 f32, B=8192, R=128) and inputs.
    Both are float32 sums of 2^20 rows taken in different orders; the
    first measured run put each within 6.5e-9 of the column's sum of
    |rows| from the float64 sum.  Bound: 1e-7 of that sum of |rows|."""
    import tpurt.kernels.gather_bench as tg

    idx, table = gb.probe_inputs()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(tg.idx0))
    np.testing.assert_array_equal(table.numpy(), np.asarray(tg.table))
    launches = gb.gather_rows_sum.launches
    got = gb.gather_rows_sum(idx, table, gb.R)  # a CPU tensor: the plain sum
    assert gb.gather_rows_sum.launches == launches
    assert got.shape == (1, gb.REC) and got.dtype == torch.float32
    want = np.asarray(tg.run_xla(tg.idx0, tg.table))
    abs_sum = gb.gather_rows_sum_reference(idx, table.abs(), gb.R,
                                           dtype=torch.float64).numpy()
    exact = gb.gather_rows_sum_reference(idx, table, gb.R,
                                         dtype=torch.float64).numpy()
    for x in (got.numpy(), want):
        assert (np.abs(x - exact) <= 1e-7 * abs_sum).all()
    assert (np.abs(got.numpy() - want) <= 1e-7 * abs_sum).all()


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("width", gb.WIDTHS)
def test_plain_widths_and_patterns_match_float64_numpy(width, group):
    """Every row width and access pattern of the sweep, through the
    wrapper on the CPU, against a float64 numpy sum of the same rows
    (float32 sums of 4,000 rows: 1e-6 of the column's sum of |rows|)."""
    rng = np.random.default_rng(width + group)
    m, b, rounds = 257, 200, 20
    idx = rng.integers(0, m, b).astype(np.int32)
    table = rng.normal(size=(m, width)).astype(np.float32)
    lanes = idx[np.arange(b) // group * group].astype(np.int64)
    rows = np.concatenate([(lanes + r * gb.STRIDE) % m for r in range(rounds)])
    want = table.astype(np.float64)[rows].sum(0)
    scale = np.abs(table).astype(np.float64)[rows].sum(0)
    np.testing.assert_array_equal(
        gb.row_indices(torch.as_tensor(idx), m, rounds, group).numpy(), rows)
    for variant in gb.VARIANTS:  # one function, whatever the fetch
        got = gb.gather_rows_sum(torch.as_tensor(idx), torch.as_tensor(table),
                                 rounds, variant, group)
        assert got.shape == (1, width) and got.dtype == torch.float32
        assert (np.abs(got.numpy()[0] - want) <= 1e-6 * scale).all()
    with pytest.raises(ValueError):
        gb.gather_rows_sum(torch.as_tensor(idx), torch.as_tensor(table),
                           rounds, "staged", group)


def test_row_indices_and_library_sum_are_the_same_function():
    """The materialised row list is the kernel's (round, lane) order, and
    the one-call yardstick sums the same rows (float64 here: exact)."""
    rng = np.random.default_rng(3)
    m, b, rounds = 37, 11, 5
    idx = torch.as_tensor(rng.integers(0, m, b).astype(np.int32))
    table = torch.as_tensor(rng.normal(size=(m, gb.REC)))
    rows = gb.row_indices(idx, m, rounds)
    want = np.array([(int(i) + r * gb.STRIDE) % m
                     for r in range(rounds) for i in idx.tolist()])
    np.testing.assert_array_equal(rows.numpy(), want)
    ref = gb.gather_rows_sum_reference(idx, table, rounds)
    np.testing.assert_allclose(gb.library_gather_sum(rows, table).numpy(),
                               ref.numpy(), rtol=1e-12)
    np.testing.assert_allclose(ref.numpy()[0], table.numpy()[want].sum(0),
                               rtol=1e-12)
