"""Multi-device rendering of the port (tpurt_torch/parallel/mesh.py) on
the CPU: 2 and 3 gloo processes (tests/torch_parallel_worker.py, one a
rank, joined through a ``file://`` rendezvous under ``tmp_path``; 3 for
ragged film and buffer rows).  The sharded render, its film rows
reduce-scattered or all-reduced, equals the port's single-device render
within 2e-5, tpurt's own bound (tests/test_parallel.py:45); a volpath
render through a grid medium and a textured wall equals tpurt's
render_sharded at the standing render bounds; the sharded
RPF filter at box 5, and at box 7 whose halo is wider than a block, equals
tpurt's rpf_filter_sharded on the same buffer and mesh size within 2e-5.
Like tpurt's test, each case needs as many JAX devices as ranks (the
test process has 8 CPU devices).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_media import assert_standing_bounds
from torch_parallel_worker import (FILTER_CASES, SCENE, filter_buffer,
                                   volpath_scene)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"


def run_ranks(n: int, d: Path) -> dict:
    """Run the worker as n processes; rank 0's results."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(d / "init"),
                               str(r), str(n), str(d)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return dict(np.load(d / "results.npz"))


@pytest.fixture(scope="module", params=[2, 3])
def ranks(request, tmp_path_factory):
    n = request.param
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return n, run_ranks(n, tmp_path_factory.mktemp(f"ranks{n}"))


def test_sharded_render_matches_single_device(ranks):
    from tpurt_torch.render.driver import render
    from tpurt_torch.scene import load_scene_string

    _n, got = ranks
    want, _ = render(load_scene_string(SCENE), "cpu")
    assert want.mean() > 0.01
    for scatter in (1, 0):
        np.testing.assert_allclose(got[f"render_scatter_{scatter}"], want,
                                   atol=2e-5)


def test_sharded_volpath_matches_tpurt(ranks):
    """What the sharded render copies from tpurt and the single-device
    render does not do: the grid medium's tracking hash numbers the lanes
    within each shard, and the textured wall shades from the material
    table's constants.  The port's image against tpurt's render_sharded
    on a mesh of as many devices, at the standing render bounds (volpath's
    tracking decisions may flip on float rounding); a global lane number
    or a texture evaluator would move most pixels of the sphere or the
    wall.  One cold tpurt jit a mesh size."""
    from tpurt.parallel.mesh import make_mesh, render_sharded
    from tpurt.scene import load_scene_string

    n, got = ranks
    want, job = render_sharded(load_scene_string(volpath_scene()),
                               mesh=make_mesh(n))
    assert job.scene.has_grid_media and job.film.width == 16
    assert_standing_bounds(got["volpath"], np.asarray(want))


def test_sharded_rpf_filter_matches_tpurt(ranks):
    """Box 5 over 7 rows (blocks of 4 and 3 rows, ragged), and box 7 over
    4 rows, whose 3-row halo is wider than a 2-row block: tpurt then
    filters its padded buffer on one device, and so does every rank."""
    from tpurt.parallel.mesh import make_mesh, rpf_filter_sharded

    n, got = ranks
    for h, box in FILTER_CASES:
        want = np.asarray(rpf_filter_sharded(
            make_mesh(n), jnp.asarray(filter_buffer(h)), box))
        assert want.shape == got[f"filter_{h}_{box}"].shape
        np.testing.assert_allclose(got[f"filter_{h}_{box}"], want,
                                   atol=2e-5, rtol=0)


def test_sharded_render_refuses_what_tpurt_does_not_shard():
    """render_sharded runs tpurt's RADIANCE_FNS integrators only: bdpt,
    mlt and sppm raise NotImplementedError by name (tpurt: a KeyError)
    before any process group is needed."""
    from tpurt_torch.parallel.mesh import render_sharded
    from tpurt_torch.scene import load_scene_string

    for name in ("bdpt", "mlt", "sppm"):
        text = SCENE.replace('Integrator "path"', f'Integrator "{name}"')
        with pytest.raises(NotImplementedError, match=f'Integrator "{name}"'):
            render_sharded(load_scene_string(text), device="cpu")
