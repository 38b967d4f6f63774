"""The CUDA traversal kernel against its plain PyTorch twin, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_traverse_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine
does not have).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render.driver import build_job, load_scene
from tpurt_torch.testscenes import mixed_scene, standin_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def geo(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = tmp_path_factory.mktemp("s") / "mixed.pbrt"
    path.write_text(mixed_scene())
    return build_job(load_scene(str(path)), "cuda").scene.geo


def _rays(n, seed, aim):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = aim + rng.normal(scale=0.8, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = np.where(rng.uniform(size=n) < 0.2, 2.5, np.inf).astype(np.float32)
    tm[:32] = 0.0
    return [torch.as_tensor(a, device="cuda") for a in (o, d, tm)]


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_matches_plain_twin(geo, any_hit):
    o, d, tm = _rays(1 << 16, 5, np.array([0.0, 1.0, 0.0]))
    launches = ktr.traverse_wide.launches
    got = ktr.traverse_wide(geo, o, d, tm, any_hit=any_hit)
    torch.cuda.synchronize()
    assert ktr.traverse_wide.launches == launches + 1
    want = ktr.traverse_wide_reference(geo, o, d, tm, any_hit=any_hit)
    gp, wp = got[1].cpu().numpy(), want[1].cpu().numpy()
    assert 0.05 < (wp >= 0).mean() < 0.95 and not (gp[:32] >= 0).any()
    if any_hit:
        np.testing.assert_array_equal(gp >= 0, wp >= 0)
        return
    np.testing.assert_array_equal(gp, wp)
    hit = wp >= 0
    # both round every op once in the same order (-fmad=false)
    for g, w in zip(got[0::2] + got[3:], want[0::2] + want[3:]):
        np.testing.assert_allclose(g.cpu().numpy()[hit], w.cpu().numpy()[hit],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("depth", [1, 3])
def test_kernel_stack_overflow_matches_plain_twin(geo, depth, any_hit):
    """Fewer stack slots than the tree needs: pushes past the depth are
    dropped and read back as the root, and the step guard ends lanes that
    would restart for ever, in the kernel as in the twin."""
    o, d, tm = _rays(1 << 12, 8, np.array([0.0, 1.0, 0.0]))
    small = dataclasses.replace(geo, wstack_depth=depth)
    got = ktr.traverse_wide(small, o, d, tm, any_hit=any_hit)
    want = ktr.traverse_wide_reference(small, o, d, tm, any_hit=any_hit)
    full = ktr.traverse_wide_reference(geo, o, d, tm, any_hit=any_hit)
    assert not torch.equal(want[1], full[1])  # the overflow was exercised
    if any_hit:
        assert torch.equal(got[1] >= 0, want[1] >= 0)
        return
    assert torch.equal(got[1], want[1])
    hit = want[1] >= 0
    for g, w in zip(got[0::2] + got[3:], want[0::2] + want[3:]):
        np.testing.assert_allclose(g[hit].cpu().numpy(), w[hit].cpu().numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000])
def test_kernel_ragged_ray_counts(geo, n):
    """Ray counts that fill no warp or block exactly."""
    o, d, tm = (x[:n].contiguous()
                for x in _rays(1024, 9, np.array([0.0, 1.0, 0.0])))
    got = ktr.traverse_wide(geo, o, d, tm, any_hit=False)
    want = ktr.traverse_wide_reference(geo, o, d, tm, any_hit=False)
    assert got[1].shape == (n,) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def standin_job(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = tmp_path_factory.mktemp("standin") / "standin.pbrt"
    path.write_text(standin_scene("full"))
    return build_job(load_scene(str(path)), "cuda")


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_on_standin_incoherent_rays(standin_job, any_hit):
    """Rays as a bounce leaves them: origins on the surfaces the camera
    sees, directions uniform over the sphere, neighbours unrelated."""
    from tpurt_torch.render.integrator import _camera_setup

    n = 1 << 17
    geo_ = standin_job.scene.geo
    ids = torch.arange(n, device="cuda") * (700 * 700 * 8) // n
    pid = ids // 8
    _, _, _, o, d, _, _, _ = _camera_setup(
        standin_job.sampler, standin_job.camera, pid % 700, pid // 700,
        ids % 8, (0, 0))
    inf = torch.full((n,), float("inf"), device="cuda")
    t0 = ktr.traverse_wide(geo_, o.contiguous(), d.contiguous(), inf, False)[0]
    keep = torch.isfinite(t0)
    rng = np.random.default_rng(11)
    w = rng.normal(size=(n, 3))
    w = torch.as_tensor((w / np.linalg.norm(w, axis=1, keepdims=True)
                         ).astype(np.float32), device="cuda")
    o2 = (o + (torch.where(keep, t0, 1.0) * 0.999)[:, None] * d).contiguous()
    tm = torch.where(keep, float("inf"), 0.0)
    if any_hit:
        tm = torch.where(keep, 6.0, 0.0)
    got = ktr.traverse_wide(geo_, o2, w, tm, any_hit)
    want = ktr.traverse_wide_reference(geo_, o2, w, tm, any_hit)
    assert 0.05 < (want[1] >= 0).float().mean().item() < 0.98
    if any_hit:
        assert torch.equal(got[1] >= 0, want[1] >= 0)
    else:
        assert (got[1] == want[1]).float().mean().item() >= 0.9999
        both = (got[1] == want[1]) & (want[1] >= 0)
        np.testing.assert_allclose(got[0][both].cpu().numpy(),
                                   want[0][both].cpu().numpy(), rtol=1e-5)


def test_kernel_on_standin_primary_rays(standin_job):
    from tpurt_torch.render.integrator import _camera_setup

    job = standin_job
    n = 1 << 18
    ids = torch.arange(n, device="cuda") * (700 * 700 * 8) // n
    pid = ids // 8
    _, _, _, o, d, _, _, _ = _camera_setup(job.sampler, job.camera,
                                           pid % 700, pid // 700, ids % 8,
                                           (0, 0))
    tm = torch.full((n,), float("inf"), device="cuda")
    geo_ = job.scene.geo
    got = ktr.traverse_wide(geo_, o.contiguous(), d.contiguous(), tm, False)
    want = ktr.traverse_wide_reference(geo_, o, d, tm, False)
    assert (got[1] == want[1]).float().mean().item() >= 0.9999


def test_wrapper_rejects_bad_inputs(geo):
    o, d, tm = _rays(256, 6, np.zeros(3))
    with pytest.raises(TypeError):
        ktr.traverse_wide(geo, o.double(), d, tm, False)
    with pytest.raises(ValueError):
        ktr.traverse_wide(geo, o[:, :2].contiguous(), d, tm, False)
    with pytest.raises(ValueError):
        ktr.traverse_wide(geo, o.t().contiguous().t(), d, tm, False)
    with pytest.raises(ValueError):
        ktr.traverse_wide(geo, o, d, tm.cpu(), False)
