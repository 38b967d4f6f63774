"""The port's geometry upload and ray queries against tpurt's: part 2 of the
cases of test_torch_intersect.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_intersect.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.geom.wbvh import LEAF_K
from tpurt.geom.wbvh import REC
from tpurt.geom.wbvh import WIDTH
from tpurt.render import intersect as tix
from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render import intersect as pix
from test_torch_intersect import (  # noqa: F401  (fixtures among them)
    _rays,
    scenes,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["kernels", "mesh", "standin"])
def test_traversal_tables_decode_back_to_wnodes(scenes, name):
    """The derived tables decode back to the host records: boxes, vertices
    and prim rows bit for bit, and every rewritten child reference leads
    to the child's row."""
    _, _, pjob = scenes[name]
    wn = pjob.scene.geo.wnodes.numpy()
    tab = pix.derive_traversal_tables(wn)
    inodes, leaves = tab["inodes"], tab["leaves"]
    irow, lrow = tab["irow"], tab["lrow"]
    # leaves: the records as they are; interior: the 48 bounds
    assert leaves[:len(lrow)].tobytes() == wn[lrow].tobytes()
    assert (inodes[:len(irow), :6 * WIDTH].tobytes()
            == wn[irow, :6 * WIDTH].tobytes())
    # child references: 2 * packed row + kind, 0 where the child is absent
    ref = np.ascontiguousarray(
        inodes[:len(irow), 6 * WIDTH:7 * WIDTH]).view(np.int32)
    host = np.ascontiguousarray(wn[irow, 6 * WIDTH:7 * WIDTH]).view(np.int32)
    there = ~np.isnan(wn[irow, :WIDTH])
    back = np.where(ref & 1, lrow[np.minimum(ref >> 1, len(lrow) - 1)],
                    irow[np.minimum(ref >> 1, max(len(irow) - 1, 0))]
                    if len(irow) else 0)
    np.testing.assert_array_equal(back[there], host[there])
    assert not ref[~there].any()
    root = tab["root_ref"]
    assert (lrow if root & 1 else irow)[root >> 1] == 0


def test_traverse_twin_stack_overflow_stops_at_the_step_guard(scenes):
    """With fewer stack slots than the tree needs, dropped pushes read back
    as row 0 and a lane could restart at the root for ever; the twin stops
    every lane after one step per table row plus one, as the kernel does,
    and lanes that never overflow keep their results."""
    import dataclasses

    _, _, pjob = scenes["standin"]  # the smallest table with a deep tree
    geo = pjob.scene.geo
    rng = np.random.default_rng(9)
    n = 64
    o, d = (torch.as_tensor(x) for x in _rays(rng, n,
                                              aim=np.array([0.0, 1.0, 0.0])))
    tm = torch.full((n,), np.inf)
    full = ktr.traverse_wide_reference(geo, o, d, tm, any_hit=False)
    small = dataclasses.replace(geo, wstack_depth=1)
    work = {}
    cut = ktr.traverse_wide_reference(small, o, d, tm, any_hit=False,
                                      stats=work)
    steps = work["leaf_steps"] + work["interior_steps"]
    assert steps <= n * (geo.wnodes.shape[0] + 1)
    # the work counters: at most 8 children and one sort an interior read,
    # 12 triangles a leaf read, every record a row of the table
    assert 0 < work["children"] <= WIDTH * work["interior_steps"]
    assert 0 < work["triangles"] <= LEAF_K * work["leaf_steps"]
    assert work["sorts"] <= work["interior_steps"]
    assert work["hit_leaves"] <= work["leaf_records"] <= work["leaf_steps"]
    assert (work["interior_records"] + work["leaf_records"]
            <= geo.wnodes.shape[0])
    assert not torch.equal(cut[1], full[1])  # the short stack lost hits
    # a hit found with a short stack is a real hit, never closer than the
    # closest one
    hit = cut[1] >= 0
    assert hit.any() and (full[1][hit] >= 0).all()
    assert (cut[0][hit] >= full[0][hit]).all()


def test_tri_bundle_test_matches_tpurt():
    rng = np.random.default_rng(11)
    n = 512
    o, d = _rays(rng, n)
    rec = np.zeros((n, REC), np.float32)
    rec[:, :9 * LEAF_K] = rng.uniform(-2, 2, (n, 9 * LEAF_K))
    rec[:, 8 * LEAF_K + 10:9 * LEAF_K] = np.nan  # last slots are NaN pads
    for i in range(9):
        rec[:, i * LEAF_K + 10:(i + 1) * LEAF_K] = np.nan
    t_max = np.where(rng.uniform(size=n) < 0.3, np.inf,
                     rng.uniform(0.5, 6, n)).astype(np.float32)
    want = [np.asarray(x) for x in tix._tri_bundle_test(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(rec))]
    got = [x.numpy() for x in pix._tri_bundle_test(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        torch.as_tensor(rec))]
    assert want[0].any() and not want[0][:, 10:].any()  # NaN pads never hit
    np.testing.assert_array_equal(got[0], want[0])
    h = want[0]
    # rtol 1e-6: both sides round each op once in the same order
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[h], w[h], rtol=1e-6)
