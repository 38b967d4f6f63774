"""The curve leaf body K1c (the warp-wide curve turn with its span cull)
and the kd walk K1k / K1km (on K1's scheduler, over the derived kd tables)
against their plain PyTorch twins on the card, bit for bit.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda
tests/test_torch_leaf_redesign_cuda.py``.

Bounds: t, prim, b0 and b1 equal on every lane (the kernels round every
operation once, in the twins' order, under -fmad=false).  Rays are seeded:
for K1c, aimed at frame E's curve spans (the medium scene) and moved
across each span to exactly +-hw/2 and a few ulps either side (grazing),
at ribbons, and with a t_max short of the span (the depth cull); for the
kd walk, a quarter start on a split plane and half of those run inside
it, the count is not a multiple of the kernel's 32-ray chunk, under
closest and any-hit, and with the interval stack cut to one slot.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render.driver import build_job
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import (motion_hair_scene, standin_scene,
                                    with_accelerator)

pytestmark = pytest.mark.cuda


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g != w).sum().item()


def _span_rays(geo, n, seed, ribbons_only=False):
    """Rays aimed across random curve spans of geo (see the docstring):
    (o, d, distance to the aimed point) on the card."""
    rng = np.random.default_rng(seed)
    rows = geo.shade_rows.cpu().numpy().astype(np.float64)
    base = geo.n_tris + geo.n_quads
    span = rows[base:base + geo.n_curves]
    sub = span[:, 23].astype(np.float32).view(np.int32)
    ribbon = np.linalg.norm(span[:, 24:27], axis=1) > 0.5
    pool = np.nonzero(ribbon)[0] if ribbons_only else np.arange(len(span))
    pick = pool[rng.integers(0, len(pool), n)]
    cp = span[pick, 7:19].reshape(n, 4, 3)
    u = rng.uniform(0, 1, n)[:, None]
    a = [cp[:, i] + u * (cp[:, i + 1] - cp[:, i]) for i in range(3)]
    b = [a[i] + u * (a[i + 1] - a[i]) for i in range(2)]
    p, tan = b[0] + u * (b[1] - b[0]), b[1] - b[0]
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    across = np.cross(d, tan)
    across /= np.linalg.norm(across, axis=1, keepdims=True)
    w0, w1 = span[pick, 19], span[pick, 20]
    hw = 0.5 * (w0 + (w1 - w0) * u[:, 0])
    rib = ribbon[pick]
    n0, n1 = span[pick, 24:27], span[pick, 27:30]
    nn = (1 - u) * n0 + u * n1
    nn /= np.maximum(np.linalg.norm(nn, axis=1, keepdims=True), 1e-12)
    hw = np.where(rib, hw * np.abs((nn * d).sum(1)), hw)
    eps = np.finfo(np.float32).eps
    k = rng.choice([-1.0, 1.0], n) * rng.choice(
        [1.0, 1 - 4 * eps, 1 + 4 * eps, 1 - 64 * eps, 1 + 64 * eps, 0.5], n)
    dist = rng.uniform(0.2, 3.0, n)
    o = p + across * (k * hw)[:, None] - d * dist[:, None]
    assert set(np.unique(sub[pick]).tolist()) <= {0, 1, 2}

    def card(x):
        return torch.as_tensor(x, dtype=torch.float32).cuda().contiguous()

    return card(o), card(d), card(dist)


@pytest.mark.parametrize("case", ["grazing", "ribbon", "short", "any_hit"])
def test_k1c_equals_twin_bit_for_bit(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    job = build_job(load_scene_string(motion_hair_scene("medium", res=64)),
                    "cuda")
    geo = job.scene.geo
    o, d, dist = _span_rays(geo, (1 << 15) + 5, 11,
                            ribbons_only=case == "ribbon")
    tm = torch.full_like(dist, float("inf"))
    if case == "short":
        tm = dist * 0.97  # every aimed point lies past t_max
    any_hit = case == "any_hit"
    ktr.reset_launches()
    got = ktr.traverse_wide(geo, o, d, tm, any_hit, tree="curve")
    assert ktr.traverse_wide.kernel_launches["K1c"] == 1
    want = ktr.traverse_wide_reference(geo, o, d, tm, any_hit, tree="curve")
    if case != "short":
        assert (want[1] >= 0).float().mean().item() > 0.2
    _equal(got, want)


@pytest.mark.parametrize("scene,any_hit,depth", [
    ("chained", False, None), ("chained", True, None), ("chained", False, 1),
    ("motion", False, None), ("motion", True, 1)])
def test_kd_walk_equals_twin_bit_for_bit(scene, any_hit, depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    text = (with_accelerator(standin_scene("small"), "kdtree", maxprims=20,
                             maxdepth=6) if scene == "chained"
            else with_accelerator(motion_hair_scene("small"), "kdtree"))
    geo = build_job(load_scene_string(text), "cuda").scene.geo
    if depth is not None:
        geo = dataclasses.replace(geo, kstack_depth=depth)
    n = 40_000 + 13  # not a multiple of the 32-ray chunk
    gen = torch.Generator().manual_seed(5)
    lo, hi = geo.kbounds.cpu()
    o = lo - 1 + (hi - lo + 2) * torch.rand((n, 3), generator=gen)
    d = lo + (hi - lo) * torch.rand((n, 3), generator=gen) - o
    knodes = geo.knodes.cpu()
    interior = torch.nonzero(knodes[:, 126] == 0).squeeze(1)
    q = n // 4
    pick = interior[torch.randint(len(interior), (q,), generator=gen)]
    axis = knodes[pick, 121].contiguous().view(torch.int32).long()
    o[torch.arange(q), axis] = knodes[pick, 120]   # on a split plane
    d[torch.arange(q // 2), axis[:q // 2]] = 0.0   # and along it
    tm = torch.full((n,), float("inf"))
    tm[::7] = 0.5 + 20 * torch.rand(tm[::7].shape, generator=gen)
    time = torch.rand(n, generator=gen)
    o, d, tm, time = [x.cuda().contiguous() for x in (o, d, tm, time)]
    time = time if scene == "motion" else None
    ktr.reset_launches()
    got = ktr.traverse_wide(geo, o, d, tm, any_hit, time=time)
    body = "K1km" if scene == "motion" else "K1k"
    assert ktr.traverse_wide.kernel_launches[body] == 1
    want = ktr.traverse_kd_reference(geo, o, d, tm, any_hit, time=time)
    assert (want[1] >= 0).float().mean().item() > 0.05
    _equal(got, want)
