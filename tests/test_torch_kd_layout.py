"""The kd walk's kernel tables (render/intersect.py: derive_kd_tables)
decode back, row for row, to the kd record table the plain twin reads
(geom/kdtree.py): split, axis, children, kind, continuation and the
triangle and prim slots, and the motion delta rows.

Scenes: the stand-in at "small" size under the kd-tree with leaves forced
past 12 triangles (``maxprims`` 20, ``maxdepth`` 6: chained leaves), and
frame E's small scene under the kd-tree (moving meshes, delta rows).
The bound is bit equality.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.geom.kdtree import (SLOT_ABOVE, SLOT_AXIS, SLOT_BELOW,
                                     SLOT_CONT, SLOT_SPLIT)
from tpurt_torch.geom.wbvh import SLOT_KIND
from tpurt_torch.render.driver import build_job
from tpurt_torch.render.intersect import derive_kd_tables
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import (motion_hair_scene, standin_scene,
                                    with_accelerator)

torch.set_num_threads(1)


def decode(knodes, delta):
    """Check every reachable row of knodes against its packed row."""
    t = derive_kd_tables(knodes, delta)
    ints = knodes.view(np.int32)
    kin = t["kinodes"].view(np.int32)
    kl = t["kleaves"]
    irow, lrow = t["kirow"], t["klrow"]
    assert (knodes[irow, SLOT_KIND] == 0).all()
    assert (knodes[lrow, SLOT_KIND] > 0).all()
    # each reachable row has one reference, of its kind
    row_of = {2 * i: r for i, r in enumerate(irow)}
    row_of.update({2 * i + 1: r for i, r in enumerate(lrow)})
    assert row_of[t["kroot_ref"]] == 0
    for i, r in enumerate(irow):
        assert t["kinodes"][i, 0].tobytes() == knodes[r, SLOT_SPLIT].tobytes()
        assert kin[i, 1] == ints[r, SLOT_AXIS]
        assert row_of[kin[i, 2]] == ints[r, SLOT_BELOW]
        assert row_of[kin[i, 3]] == ints[r, SLOT_ABOVE]
    cont = kl.view(np.int32)[:, SLOT_CONT]
    for i, r in enumerate(lrow):
        other = np.arange(knodes.shape[1]) != SLOT_CONT
        assert kl[i, other].tobytes() == knodes[r, other].tobytes()
        want = ints[r, SLOT_CONT]
        assert (cont[i] == -1) if want < 0 else (row_of[cont[i]] == want)
        if delta is not None:
            assert (t["kleaves_delta"][i].tobytes()
                    == delta[r].tobytes())
    # nothing reachable is left out: children and continuations of the
    # packed rows are packed rows
    kids = set(ints[irow][:, [SLOT_BELOW, SLOT_ABOVE]].ravel().tolist())
    kids |= {c for c in ints[lrow, SLOT_CONT].tolist() if c >= 0}
    assert kids <= set(irow.tolist()) | set(lrow.tolist())
    return t


@pytest.mark.parametrize("scene", ["chained", "motion"])
def test_kd_tables_decode_to_the_row_table(scene):
    text = (with_accelerator(standin_scene("small"), "kdtree", maxprims=20,
                             maxdepth=6) if scene == "chained"
            else with_accelerator(motion_hair_scene("small"), "kdtree"))
    geo = build_job(load_scene_string(text), "cpu").scene.geo
    knodes = geo.knodes.numpy()
    delta = None if geo.knodes_delta is None else geo.knodes_delta.numpy()
    assert (delta is not None) == (scene == "motion")
    t = decode(knodes, delta)
    if scene == "chained":
        assert (t["kleaves"].view(np.int32)[:, SLOT_CONT] >= 0).any()
    # the upload carries the same tables
    assert torch.equal(geo.kinodes, torch.as_tensor(t["kinodes"]))
    assert torch.equal(geo.kleaves.view(torch.int32),
                       torch.as_tensor(t["kleaves"]).view(torch.int32))
    assert geo.kroot_ref == t["kroot_ref"]
    if delta is not None:
        assert torch.equal(geo.kleaves_delta,
                           torch.as_tensor(t["kleaves_delta"]))
