"""The kd walk's kernel bodies (K1k, K1km) against their plain PyTorch
twin (traverse_kd_reference), on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_kdtree_cuda.py``.

Bounds: prims (or occlusion) equal on >= 99.99% of lanes, t of the lanes
that agree within rtol 1e-5 (the walk and the watertight test round each
operation once, in the twin's order, under -fmad=false).  Scenes: the
stand-in at "small" size under the kd-tree with leaves forced past 12
triangles (continuation rows), and frame E's small scene under the
kd-tree (moving meshes); rays seeded, a quarter of them starting on a
split plane.
"""

import pytest
import torch

from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render.driver import build_job
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import (motion_hair_scene, standin_scene,
                                    with_accelerator)

pytestmark = pytest.mark.cuda


def _rays(geo, n, seed):
    gen = torch.Generator().manual_seed(seed)
    lo, hi = geo.kbounds.cpu()
    o = lo - 1 + (hi - lo + 2) * torch.rand((n, 3), generator=gen)
    d = lo + (hi - lo) * torch.rand((n, 3), generator=gen) - o
    knodes = geo.knodes.cpu()
    interior = torch.nonzero(knodes[:, 126] == 0).squeeze(1)
    pick = interior[torch.randint(len(interior), (n // 4,), generator=gen)]
    axis = knodes[pick, 121].contiguous().view(torch.int32).long()
    o[torch.arange(n // 4), axis] = knodes[pick, 120]
    tm = torch.full((n,), float("inf"))
    tm[::7] = 0.5 + 20 * torch.rand(tm[::7].shape, generator=gen)
    time = torch.rand(n, generator=gen)
    return [x.cuda().contiguous() for x in (o, d, tm, time)]


def _check(got, want, any_hit):
    if any_hit:
        agree = ((got[1] >= 0) == (want[1] >= 0)).float().mean().item()
        assert agree >= 0.9999, agree
        return
    same = got[1] == want[1]
    assert same.float().mean().item() >= 0.9999
    both = same & (want[1] >= 0)
    torch.testing.assert_close(got[0][both], want[0][both], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("any_hit", [False, True])
def test_k1k_matches_twin_with_continuation_rows(any_hit):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    job = build_job(load_scene_string(with_accelerator(
        standin_scene("small"), "kdtree", maxprims=20, maxdepth=6)), "cuda")
    geo = job.scene.geo
    assert (geo.knodes[:, 124].contiguous().view(torch.int32) >= 0).any()
    o, d, tm, _ = _rays(geo, 1 << 16, 1)
    ktr.reset_launches()
    got = ktr.traverse_wide(geo, o, d, tm, any_hit)
    assert ktr.traverse_wide.kernel_launches["K1k"] == 1
    _check(got, ktr.traverse_kd_reference(geo, o, d, tm, any_hit), any_hit)


def test_k1km_matches_twin_on_moving_meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    job = build_job(load_scene_string(with_accelerator(
        motion_hair_scene("small"), "kdtree")), "cuda")
    geo = job.scene.geo
    o, d, tm, time = _rays(geo, 1 << 16, 2)
    ktr.reset_launches()
    for any_hit in (False, True):
        got = ktr.traverse_wide(geo, o, d, tm, any_hit, time=time)
        _check(got, ktr.traverse_kd_reference(geo, o, d, tm, any_hit,
                                              time=time), any_hit)
    assert ktr.traverse_wide.kernel_launches["K1km"] == 2
