"""The traversal kernel's motion and curve leaf bodies (K1m, K1c) against
their plain PyTorch versions, on the card, on frame E's geometry.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda
tests/test_torch_traverse_motion_cuda.py``.

Bounds: prims equal on >= 99.99% of lanes, t of the lanes that agree
within rtol 1e-5 (K1m: the lerp and the watertight test round each
operation once, in the plain version's order, under -fmad=false; K1c:
sinf of a ribbon's slerp may differ from torch's by an ulp).
"""

import numpy as np
import pytest
import torch

from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render.driver import build_job
from tpurt_torch.render.integrator import _camera_setup
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import motion_hair_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def job():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # frame E's camera at 700x700 over the medium geometry
    return build_job(load_scene_string(motion_hair_scene("medium", res=700)),
                     "cuda")


def _camera_rays(job, n):
    """n camera rays of the 700x700 frame, 8 spp, with their times."""
    ids = torch.arange(n, device="cuda") * (700 * 700 * 8) // n
    pid = ids // 8
    _, _, _, o, d, _, _, time = _camera_setup(
        job.sampler, job.camera, pid % 700, pid // 700, ids % 8, (0, 0),
        draw_time=True)
    return o.contiguous(), d.contiguous(), time.contiguous()


def _check(got, want, any_hit):
    if any_hit:
        assert ((got[1] >= 0) == (want[1] >= 0)).float().mean() >= 0.9999
        return
    same = got[1] == want[1]
    assert same.float().mean().item() >= 0.9999
    both = same & (want[1] >= 0)
    for g, w in zip(got[0::2] + got[3:], want[0::2] + want[3:]):
        np.testing.assert_allclose(g[both].cpu().numpy(),
                                   w[both].cpu().numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
def test_motion_body_matches_plain(job, any_hit):
    geo = job.scene.geo
    assert geo.leaves_delta is not None
    o, d, time = _camera_rays(job, 1 << 16)
    tm = torch.full_like(time, float("inf"))
    if any_hit:
        tm = torch.full_like(time, 14.0)
    ktr.reset_launches()
    got = ktr.traverse_wide(geo, o, d, tm, any_hit, time=time)
    assert ktr.traverse_wide.kernel_launches == {"K1": 0, "K1m": 1, "K1c": 0,
                                                 "K1k": 0, "K1km": 0}
    want = ktr.traverse_wide_reference(geo, o, d, tm, any_hit, time=time)
    assert 0.05 < (want[1] >= 0).float().mean().item() < 0.999
    _check(got, want, any_hit)
    if not any_hit:
        # the lerp moves hits: the static walk of the same rays differs
        static = ktr.traverse_wide_reference(geo, o, d, tm, any_hit)
        assert not torch.equal(static[0], want[0])


@pytest.mark.parametrize("any_hit", [False, True])
def test_curve_body_matches_plain(job, any_hit):
    geo = job.scene.geo
    assert geo.cleaves_aux is not None  # the frame holds ribbons
    o, d, _ = _camera_rays(job, 1 << 16)
    tm = torch.full((o.shape[0],), float("inf"), device="cuda")
    ktr.reset_launches()
    got = ktr.traverse_wide(geo, o, d, tm, any_hit, tree="curve")
    assert ktr.traverse_wide.kernel_launches == {"K1": 0, "K1m": 0, "K1c": 1,
                                                 "K1k": 0, "K1km": 0}
    want = ktr.traverse_wide_reference(geo, o, d, tm, any_hit, tree="curve")
    assert 0.001 < (want[1] >= 0).float().mean().item() < 0.9
    _check(got, want, any_hit)


def test_curve_body_ribbon_and_flat_spans(job):
    """Rays aimed at the ribbon and flat patches' spans from above: every
    curve subtype's spans are hit, and equal to the plain version."""
    geo = job.scene.geo
    rows = geo.shade_rows.cpu()
    base = geo.n_tris + geo.n_quads
    cp = rows[base:base + geo.n_curves, 7:19].reshape(-1, 4, 3)
    sub = rows[base:base + geo.n_curves, 23].contiguous().view(torch.int32)
    rng = np.random.default_rng(3)
    pick = torch.as_tensor(rng.integers(0, len(cp), 1 << 14))
    target = cp[pick].mean(dim=1)
    o = target + torch.tensor([0.3, 2.0, -1.0])
    d = target - o + torch.as_tensor(rng.normal(0, 0.01, (len(pick), 3)),
                                     dtype=torch.float32)
    o, d = o.cuda().contiguous(), d.cuda().contiguous()
    tm = torch.full((len(pick),), float("inf"), device="cuda")
    got = ktr.traverse_wide(geo, o, d, tm, False, tree="curve")
    want = ktr.traverse_wide_reference(geo, o, d, tm, False, tree="curve")
    hit_sub = sub[want[1][want[1] >= 0].cpu().long() - base]
    assert set(hit_sub.tolist()) == {0, 1, 2}
    _check(got, want, False)


def test_static_frame_launches_only_k1(job):
    """Without times the triangle walk is the static body, even on a
    scene with motion."""
    geo = job.scene.geo
    o, d, _ = _camera_rays(job, 1 << 12)
    tm = torch.full((o.shape[0],), float("inf"), device="cuda")
    ktr.reset_launches()
    got = ktr.traverse_wide(geo, o, d, tm, False)
    assert ktr.traverse_wide.kernel_launches == {"K1": 1, "K1m": 0, "K1c": 0,
                                                 "K1k": 0, "K1km": 0}
    want = ktr.traverse_wide_reference(geo, o, d, tm, False)
    _check(got, want, False)
