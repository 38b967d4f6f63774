"""The port's geometry upload and ray queries against tpurt's: part 4 of the
cases of test_torch_intersect.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_intersect.py.
"""

import jax.numpy as jnp
import numpy as np
import re
import torch

from tpurt.geom.wbvh import LEAF_K
from tpurt.geom.wbvh import REC
from tpurt.geom.wbvh import SLOT_KIND
from tpurt.geom.wbvh import WIDTH
from tpurt.render import intersect as tix
from tpurt_torch.kernels import build as kbuild
from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render import intersect as pix
from test_torch_intersect import (  # noqa: F401  (fixtures among them)
    T_ATOL,
    _rays,
    scenes,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_traverse_twin_matches_pallas_kernel_interpret(scenes):
    from tpurt.kernels.traverse import BLOCK, traverse_closest_pallas

    _, job, pjob = scenes["kernels"]
    rng = np.random.default_rng(7)
    o, d = _rays(rng, BLOCK)
    tm = np.full(BLOCK, np.inf, np.float32)
    _, p0, _, _ = traverse_closest_pallas(
        job.scene.geo.wnodes, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tm), stack_depth=job.scene.geo.wstack_depth,
        interpret=True)
    p0 = np.asarray(p0)
    _, p1, _, _ = ktr.traverse_wide_reference(
        pjob.scene.geo, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(tm), any_hit=False)
    p1 = p1.numpy()
    np.testing.assert_array_equal(p1 >= 0, p0 >= 0)
    both = (p0 >= 0) & (p1 >= 0)
    np.testing.assert_array_equal(p1[both], p0[both])


def test_intersect_queries_match_tpurt(scenes):
    """intersect_closest / intersect_any, spheres included, on scene rays."""
    _, job, pjob = scenes["mesh"]
    rng = np.random.default_rng(8)
    n = 2048
    o, d = _rays(rng, n, aim=np.array([1.0, 1.0, 0.0]))
    tm = np.where(rng.uniform(size=n) < 0.3, 3.0, np.inf).astype(np.float32)
    h0 = tix.intersect_closest(job.scene.geo, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tm))
    h1 = pix.intersect_closest(pjob.scene.geo, torch.as_tensor(o),
                               torch.as_tensor(d), torch.as_tensor(tm),
                               ktr.traverse_wide)
    p0 = np.asarray(h0.prim)
    assert (p0 >= job.scene.geo.n_tris).sum() > 20  # sphere hits
    np.testing.assert_array_equal(h1.prim.numpy(), p0)
    tri = (p0 >= 0) & (p0 < job.scene.geo.n_tris)
    sph = p0 >= job.scene.geo.n_tris
    t0, t1 = np.asarray(h0.t), h1.t.numpy()
    np.testing.assert_allclose(t1[tri], t0[tri], rtol=2e-5, atol=T_ATOL)
    # sphere t: tpurt's jitted quadric pass loses the compensated
    # discriminant's error terms to XLA's FMA contraction; op by op the
    # two agree to 1e-6 (test_ray_sphere_matches_tpurt_ray_quadric)
    np.testing.assert_allclose(t1[sph], t0[sph], rtol=1e-4)
    occ0 = np.asarray(tix.intersect_any(job.scene.geo, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(tm)))
    occ1 = pix.intersect_any(pjob.scene.geo, torch.as_tensor(o),
                             torch.as_tensor(d), torch.as_tensor(tm),
                             ktr.traverse_wide).numpy()
    np.testing.assert_array_equal(occ1, occ0)


def test_cuda_source_sort_network_is_tpurts():
    """The comparator list compiled into traverse.cu is tpurt's _SORT8, and
    its layout constants are the table's."""
    src = (kbuild.CSRC / ktr.SOURCE).read_text()
    pairs = tuple((int(a), int(b))
                  for a, b in re.findall(r"CSWAP\((\d), (\d)\)", src))
    assert pairs == tix._SORT8 == pix.SORT8
    assert re.search(rf"#define TPURT_STACK_MAX {ktr.STACK_MAX}\b", src)
    assert (WIDTH, LEAF_K, REC, SLOT_KIND) == (8, 12, 128, 126)
    assert pix._BOX_T_SCALE == float(tix._BOX_T_SCALE)
