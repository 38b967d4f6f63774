"""The motion leaf body K1m (the warp-wide motion leaf turn behind the group
cull) and the kd walk's motion body K1km (the same cull on one lane)
against their plain PyTorch twins on the card, bit for bit.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda
tests/test_torch_motion_redesign_cuda.py``.

Bounds: t, prim, b0 and b1 equal on every lane (the kernels round every
operation once, in the twins' order, under -fmad=false; the cull drops
only groups the twin cannot hit).  Rays are seeded: "grazing" rays aimed
at frame E's moving triangles as the twin lerps them to each ray's time
(0, 1, 0.5, -0.5 or 2.0: tpurt lerps by the raw shutter time), exactly at
a vertex or an edge point, or 4 or 64 ulps either side of the edge, an
eighth of them edge-on, a quarter with t_max at the aimed point; the same
under any-hit and with the stack cut to one slot; and frame E's camera
rays at 700x700, 8 spp (2^16 of them, spread over the frame).  Each case
runs K1m on the wide BVH and K1km on the kd-tree of the same scene.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render.driver import build_job
from tpurt_torch.render.integrator import _camera_setup
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import motion_hair_scene, with_accelerator

pytestmark = pytest.mark.cuda

TIMES = np.array([0.0, 1.0, 0.5, -0.5, 2.0], np.float32)


@pytest.fixture(scope="module")
def jobs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    text = motion_hair_scene("full")
    return {"K1m": build_job(load_scene_string(text), "cuda"),
            "K1km": build_job(load_scene_string(
                with_accelerator(text, "kdtree")), "cuda")}


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _grazing(geo, n, seed):
    """(o, d, t_max, time) on the card (see the module docstring)."""
    rng = np.random.default_rng(seed)
    rows = geo.shade_rows[:geo.n_tris].cpu().numpy()
    delta = geo.shade_delta[:geo.n_tris, :9].cpu().numpy()
    moving = np.nonzero(np.abs(delta).sum(1) > 0)[0]
    pick = moving[rng.integers(0, len(moving), n)]
    time = TIMES[rng.integers(0, len(TIMES), n)]
    tri = (rows[pick, 7:16] + time[:, None] * delta[pick]).astype(
        np.float32).astype(np.float64).reshape(n, 3, 3)
    ar = np.arange(n)
    k = rng.integers(0, 3, n)
    a, b, opp = tri[ar, k], tri[ar, (k + 1) % 3], tri[ar, (k + 2) % 3]
    u = np.where(rng.uniform(0, 1, n) < 0.3, 0.0, rng.uniform(0, 1, n))
    point = a + u[:, None] * (b - a)
    normal = _unit(np.cross(b - a, opp - a))
    across = _unit(np.cross(normal, b - a))
    across *= np.sign(((point - opp) * across).sum(1))[:, None]
    eps = np.finfo(np.float32).eps
    ulps = rng.choice([0.0, 4.0, -4.0, 64.0, -64.0], n)
    point = point + across * (ulps * eps * np.abs(point).max(1))[:, None]
    d = _unit(rng.normal(0, 1, (n, 3)))
    d[:n // 8] = -across[:n // 8]  # edge-on
    dist = rng.uniform(0.5, 6.0, n)
    o = point - d * dist[:, None]
    t_max = np.full(n, np.inf)
    q = slice(n // 4, n // 2)
    t_max[q] = dist[q] * (1 + rng.choice([-4, 0, 4], n // 4) * eps)

    def card(x):
        return torch.as_tensor(x, dtype=torch.float32).cuda().contiguous()

    return card(o), card(d), card(t_max), card(time)


def _camera_rays(job, n):
    """n camera rays of frame E (700x700, 8 spp) with their times."""
    res, spp = job.film.width, job.sampler.spp
    ids = torch.arange(n, device="cuda") * (res * res * spp) // n
    pid = ids // spp
    _, _, _, o, d, _, _, time = _camera_setup(
        job.sampler, job.camera, pid % res, pid // res, ids % spp, (0, 0),
        draw_time=True)
    tm = torch.full_like(time, float("inf"))
    return o.contiguous(), d.contiguous(), tm, time.contiguous()


@pytest.mark.parametrize("case", ["grazing", "any_hit", "one_slot",
                                  "camera"])
@pytest.mark.parametrize("body", ["K1m", "K1km"])
def test_motion_body_equals_twin_bit_for_bit(jobs, body, case):
    job = jobs[body]
    geo = job.scene.geo
    if case == "one_slot":
        geo = dataclasses.replace(geo, wstack_depth=1, kstack_depth=1)
    if case == "camera":
        o, d, tm, time = _camera_rays(job, 1 << 16)
    else:
        o, d, tm, time = _grazing(geo, (1 << 15) + 5, 21)
    any_hit = case == "any_hit"
    ktr.reset_launches()
    got = ktr.traverse_wide(geo, o, d, tm, any_hit, time=time)
    assert ktr.traverse_wide.kernel_launches[body] == 1
    want = ktr.traverse_reference(geo, o, d, tm, any_hit, time=time)
    assert (want[1] >= 0).float().mean().item() > 0.2
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (
            g.view(torch.int32) != w.view(torch.int32)).sum().item()
