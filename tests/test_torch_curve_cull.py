"""The curve span cull (render/intersect.py: curve_span_cull, the plain
copy of K1c's ``span_near`` in traverse.cu) against tpurt's
_curve_bundle_test on the CPU: every (ray, span) that tpurt reports a hit
for passes the cull, and the cull rejects most of the misses.

Leaf records of 8 spans (some slots NaN pads) are made from a numpy seed,
one per case: flat spans without a ribbon table, cylinder spans beside an
empty ribbon table, and ribbons with twisting normals.  Rays: aimed at a
point of a random span of their record, offset across the span to exactly
+-hw/2 and a few ulps either side of it, or well inside; a share start on
the span itself (inside its hull) or run along its chord, and a share has
a t_max short of the span (the z cull).  tpurt runs op by op
(jax.disable_jit), as the port's twin does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import intersect as tix
from tpurt_torch.geom.wbvh import REC, WIDTH
from tpurt_torch.render.intersect import (CURVE_AUX, _curve_bundle_test,
                                          curve_span_cull)

torch.set_num_threads(1)

N = 2048


def bezier(cp, u):
    """Points and tangents of cubic Beziers cp (M, 4, 3) at u (M,)."""
    u = u[:, None]
    a = [cp[:, i] + u * (cp[:, i + 1] - cp[:, i]) for i in range(3)]
    b = [a[i] + u * (a[i + 1] - a[i]) for i in range(2)]
    return b[0] + u * (b[1] - b[0]), b[1] - b[0]


def unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_case(kind: str, seed: int):
    """(o, d, t_max, rec, aux) as f32 numpy: one leaf record a ray."""
    rng = np.random.default_rng(seed)
    # 8 spans a record around the origin, each a short bent segment
    start = rng.uniform(-1, 1, (N, WIDTH, 1, 3))
    step = rng.normal(0, 0.3, (N, WIDTH, 1, 3))
    bend = rng.normal(0, 0.05, (N, WIDTH, 4, 3))
    cp = start + step * np.arange(4)[None, None, :, None] + bend
    w0 = rng.uniform(0.005, 0.08, (N, WIDTH))
    w1 = w0 * rng.uniform(0.5, 1.5, (N, WIDTH))
    live = rng.integers(3, WIDTH + 1, N)  # spans fill a leaf from slot 0
    pad = np.arange(WIDTH)[None, :] >= live[:, None]
    rec = np.zeros((N, REC), np.float32)
    for i in range(4):
        for c in range(3):
            rec[:, (3 * i + c) * WIDTH:(3 * i + c + 1) * WIDTH] = np.where(
                pad, np.nan, cp[:, :, i, c])
    rec[:, 12 * WIDTH:13 * WIDTH] = np.where(pad, np.nan, w0)
    rec[:, 13 * WIDTH:14 * WIDTH] = np.where(pad, np.nan, w1)
    aux = None
    if kind != "flat":
        aux = np.zeros((N, CURVE_AUX), np.float32)
    if kind == "ribbon":
        n0 = unit(rng.normal(0, 1, (N, WIDTH, 3)))
        twist = rng.uniform(0, 2.5, (N, WIDTH))
        twist[:, ::3] = rng.uniform(0, 5e-5, twist[:, ::3].shape)  # linear
        perp = unit(np.cross(n0, rng.normal(0, 1, (N, WIDTH, 3))))
        n1 = (n0 * np.cos(twist)[..., None]
              + perp * np.sin(twist)[..., None])
        for c in range(3):
            aux[:, c * WIDTH:(c + 1) * WIDTH] = n0[..., c]
            aux[:, (3 + c) * WIDTH:(4 + c) * WIDTH] = n1[..., c]
        aux[:, 6 * WIDTH:7 * WIDTH] = twist
        aux[:, 7 * WIDTH:8 * WIDTH] = 1.0 / np.sin(twist)

    # aim every ray at a live span: a curve point moved across the span
    slot = (rng.integers(0, 1 << 20, N) % live).astype(np.int64)
    ar = np.arange(N)
    u = rng.uniform(0, 1, N)
    p, tan = bezier(cp[ar, slot], u)
    d = unit(rng.normal(0, 1, (N, 3)))
    across = unit(np.cross(d, tan))
    hw = (w0[ar, slot] + (w1[ar, slot] - w0[ar, slot]) * u) * 0.5
    if kind == "ribbon":
        nn = unit((1 - u)[:, None] * n0[ar, slot] + u[:, None] * n1[ar, slot])
        hw = hw * np.abs((nn * d).sum(1))
    eps = np.finfo(np.float32).eps
    k = rng.choice([-1.0, 1.0], N) * rng.choice(
        [1.0, 1 - 4 * eps, 1 + 4 * eps, 1 - 64 * eps, 1 + 64 * eps, 0.5], N)
    target = p + across * (k * hw)[:, None]
    dist = rng.uniform(0.5, 4.0, N)
    o = target - d * dist[:, None]
    q = N // 8
    o[:q] = p[:q]                     # starting on the span, inside its hull
    d[q:2 * q] = unit(tan[q:2 * q])   # along the span
    o[q:2 * q] = p[q:2 * q] - d[q:2 * q] * 0.2
    t_max = np.full(N, np.inf, np.float32)
    t_max[2 * q:3 * q] = dist[2 * q:3 * q] * rng.uniform(0.9, 1.0, q)
    f32 = np.float32
    return (o.astype(f32), d.astype(f32), t_max, rec,
            None if aux is None else aux.astype(f32))


@pytest.mark.parametrize("kind", ["flat", "cylinder", "ribbon"])
def test_cull_keeps_every_tpurt_hit(kind):
    o, d, t_max, rec, aux = make_case(kind, {"flat": 0, "cylinder": 1,
                                              "ribbon": 2}[kind])
    with jax.disable_jit():
        hit = np.asarray(tix._curve_bundle_test(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jnp.asarray(rec), None if aux is None else jnp.asarray(aux))[0])
    tt = [torch.as_tensor(x) for x in (o, d, t_max, rec)]
    ta = None if aux is None else torch.as_tensor(aux)
    near = curve_span_cull(*tt, ta).numpy()
    # the port's twin agrees with tpurt on what it hits
    assert (_curve_bundle_test(*tt, ta)[0].numpy() == hit).all()
    live = ~np.isnan(rec[:, :WIDTH])
    assert hit.sum() >= N // 8, hit.sum()
    # sound: no hit is culled
    missed = hit & ~near
    assert not missed.any(), np.argwhere(missed)[:10]
    assert not (near & ~live).any()  # pad slots never pass
    # not vacuous: most live spans that miss are culled
    miss = live & ~hit
    assert (~near[miss]).mean() >= 0.75, (~near[miss]).mean()
