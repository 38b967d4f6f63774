"""The CUDA gather-probe kernel against its plain PyTorch version, on the
card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_gather_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine
does not have).

Tolerance: the kernel sums 2^20 float32 rows per column (sequentially in
each warp, then by block, then over the blocks); the plain version here
sums in float64.  Bound: 1e-6 of the column's sum of |rows|, some 50x
below the worst-case float32 bound of that summation tree.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.kernels import gather_bench as gb

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check(idx, table, rounds, variant="direct", group=1):
    launches = gb.gather_rows_sum.launches
    got = gb.gather_rows_sum(idx, table, rounds, variant, group)
    torch.cuda.synchronize()
    assert gb.gather_rows_sum.launches == launches + 1
    exact = gb.gather_rows_sum_reference(idx, table, rounds,
                                         dtype=torch.float64, group=group)
    abs_sum = gb.gather_rows_sum_reference(idx, table.abs(), rounds,
                                           dtype=torch.float64, group=group)
    err = (got.double() - exact).abs()
    assert got.shape == (1, table.shape[1])
    assert bool((err <= 1e-6 * abs_sum).all())
    return got


def test_kernel_matches_plain_at_probe_sizes():
    _need_cuda()
    idx, table = gb.probe_inputs("cuda")
    a = _check(idx, table, gb.R)
    b = gb.gather_rows_sum(idx, table, gb.R)
    assert torch.equal(a, b)  # no atomics: the same sum every run


@pytest.mark.parametrize("m,b,rounds", [(777, 1000, 3), (16384, 5, 1),
                                        (300, 8192, 0)])
def test_kernel_matches_plain_at_other_shapes(m, b, rounds):
    _need_cuda()
    rng = np.random.default_rng(m + b)
    idx = torch.as_tensor(rng.integers(0, m, b).astype(np.int32),
                          device="cuda")
    table = torch.as_tensor(rng.normal(size=(m, gb.REC)).astype(np.float32),
                            device="cuda")
    _check(idx, table, rounds)


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("variant", sorted(gb.VARIANTS))
@pytest.mark.parametrize("width", gb.WIDTHS)
def test_kernel_widths_variants_patterns(width, variant, group):
    """Narrow rows and the staged fetches at the probe's sizes, and at a
    ragged size whose last chunk and last ring stages are partly empty."""
    _need_cuda()
    idx, table = gb.probe_inputs("cuda")
    tab = table[:, :width].contiguous()
    a = _check(idx, tab, gb.R, variant, group)
    assert torch.equal(a, gb.gather_rows_sum(idx, tab, gb.R, variant, group))
    _check(idx[:1001].contiguous(), tab[:777].contiguous(), 3, variant, group)
    _check(idx[:5].contiguous(), tab, 1, variant, group)


def test_wrapper_rejects_bad_inputs():
    _need_cuda()
    idx, table = gb.probe_inputs("cuda")
    with pytest.raises(TypeError):
        gb.gather_rows_sum(idx.long(), table, 2)
    with pytest.raises(ValueError):
        gb.gather_rows_sum(idx, table[:, :48].contiguous(), 2)
    with pytest.raises(ValueError):
        gb.gather_rows_sum(idx, table, 2, variant="staged")
    with pytest.raises(ValueError):
        gb.gather_rows_sum(idx.cpu(), table, 2)
    with pytest.raises(ValueError):
        gb.gather_rows_sum(idx, table.t().contiguous().t(), 2)
