"""The whole ported slice against tpurt on the mixed scene: the cases of
test_torch_render.py's scene fixture for "mixed", in a file of their own
(each scene is a cold tpurt jit).  Bounds are those of
test_torch_render.py.
"""

import pytest
import torch

from test_torch_render import (  # noqa: F401  (collected here too)
    render_both,
    test_port_cli_render_matches_tpurt,
    test_render_from_tpurt_tables_equals_cli_render,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["mixed"])
def renders(request, tmp_path_factory):
    return render_both(request.param, tmp_path_factory)
