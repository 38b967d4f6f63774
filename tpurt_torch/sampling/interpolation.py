"""Catmull-Rom spline interpolation, integration, sampling and inversion
(port of tpurt/sampling/interpolation.py: catmull_rom_weights_np,
integrate_catmull_rom_np, _find_interval, catmull_rom_weights,
_segment_derivs, _invert_segment_integral, sample_catmull_rom_2d,
catmull_rom_eval, invert_catmull_rom; core/interpolation.cpp
CatmullRom :39, CatmullRomWeights :61, SampleCatmullRom2D :172,
IntegrateCatmullRom :260, InvertCatmullRom :288).  The Fourier BSDF
(render/fourier.py) and the tabulated BSSRDF (render/bssrdf.py) read it.

The host versions are numpy (table precompute at scene build).  The
device versions are torch over (N,) lanes: the interval search is
torch.searchsorted over the node vector, and the reference's
Newton-bisection solvers run tpurt's fixed 24 iterations (its
``fori_loop``s are Python loops of the same trip counts), where the
reference stops at 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch

_NEWTON_ITERS = 24


# ---------------------------------------------------------------------------
# host (numpy) versions
# ---------------------------------------------------------------------------

def catmull_rom_weights_np(nodes: np.ndarray, x: float):
    """CatmullRomWeights (interpolation.cpp:61).  Returns (ok, offset,
    w[4])."""
    n = len(nodes)
    if not (x >= nodes[0] and x <= nodes[-1]):
        return False, 0, np.zeros(4)
    idx = np.searchsorted(nodes, x, side="right") - 1
    idx = min(max(idx, 0), n - 2)
    w = np.zeros(4)
    x0, x1 = nodes[idx], nodes[idx + 1]
    t = (x - x0) / (x1 - x0)
    t2, t3 = t * t, t * t * t
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if idx > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[idx - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if idx + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[idx + 2] - x0)
        w[1] -= w3
        w[3] = w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
    return True, idx - 1, w


def integrate_catmull_rom_np(x: np.ndarray, values: np.ndarray):
    """IntegrateCatmullRom (interpolation.cpp:260) over the last axis of
    ``values`` (..., n).  Returns (sum, cdf), cdf of values' shape."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    n = x.shape[-1]
    cdf = np.zeros_like(v)
    total = np.zeros(v.shape[:-1])
    for i in range(n - 1):
        x0, x1 = x[i], x[i + 1]
        f0, f1 = v[..., i], v[..., i + 1]
        width = x1 - x0
        if i > 0:
            d0 = width * (f1 - v[..., i - 1]) / (x1 - x[i - 1])
        else:
            d0 = f1 - f0
        if i + 2 < n:
            d1 = width * (v[..., i + 2] - f0) / (x[i + 2] - x0)
        else:
            d1 = f1 - f0
        total = total + ((d0 - d1) * (1.0 / 12.0) + (f0 + f1) * 0.5) * width
        cdf[..., i + 1] = total
    return total, cdf


# ---------------------------------------------------------------------------
# device (torch) versions
# ---------------------------------------------------------------------------

def _find_interval(nodes, x):
    """FindInterval: the last i with nodes[i] <= x, clamped to [0, n-2]."""
    idx = torch.searchsorted(nodes, x.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, nodes.shape[0] - 2)


def catmull_rom_weights(nodes, x):
    """CatmullRomWeights over lanes: nodes (S,), x (N,).  Returns
    (ok (N,), offset (N,), w (N, 4)); the rows of w address
    nodes[offset .. offset + 3] (gathers clamp; rows outside the nodes
    weigh 0)."""
    n = nodes.shape[0]
    ok = (x >= nodes[0]) & (x <= nodes[-1])
    idx = _find_interval(nodes, x)
    x0 = nodes[idx]
    x1 = nodes[idx + 1]
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-20)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    base = t3 - 2 * t2 + t
    has_prev = idx > 0
    xm1 = nodes[torch.clamp(idx - 1, min=0)]
    w0p = base * (x1 - x0) / torch.clamp(x1 - xm1, min=1e-20)
    w0 = torch.where(has_prev, -w0p, 0.0)
    w1 = torch.where(has_prev, w1, w1 - base)
    w2 = w2 + torch.where(has_prev, w0p, base)
    last = t3 - t2
    has_next = idx + 2 < n
    xp2 = nodes[torch.clamp(idx + 2, max=n - 1)]
    w3n = last * (x1 - x0) / torch.clamp(xp2 - x0, min=1e-20)
    w3 = torch.where(has_next, w3n, 0.0)
    w1 = w1 - torch.where(has_next, w3n, last)
    w2 = w2 + torch.where(has_next, 0.0, last)
    w = torch.stack([w0, w1, w2, w3], dim=-1)
    return ok, idx - 1, torch.where(ok[:, None], w, 0.0)


def _segment_derivs(f0, f1, fm1, fp2, x0, x1, xm1, xp2, has_prev, has_next):
    width = x1 - x0
    d0 = torch.where(has_prev,
                     width * (f1 - fm1) / torch.clamp(x1 - xm1, min=1e-20),
                     f1 - f0)
    d1 = torch.where(has_next,
                     width * (fp2 - f0) / torch.clamp(xp2 - x0, min=1e-20),
                     f1 - f0)
    return d0, d1


def _newton_step(t, a, b, big_f, small_f, u):
    """One safeguarded Newton step on F(t) = u: the bracket [a, b] moves
    to the side of the root, t steps by -(F - u) / f."""
    lo = big_f - u < 0
    a = torch.where(lo, t, a)
    b = torch.where(lo, b, t)
    safe = torch.where(small_f.abs() > 1e-20, small_f,
                       torch.where(small_f >= 0, 1e-20, -1e-20))
    return t - (big_f - u) / safe, a, b


def _invert_segment_integral(u, f0, f1, d0, d1):
    """The fixed-iteration Newton-bisection inverting the definite
    integral of one Hermite segment (interpolation.cpp:127-160); u is the
    target integral normalized by the segment width.  Returns (t, f(t))."""
    lin = (f0 - f1).abs() > 1e-12
    t = torch.where(
        lin, (f0 - torch.sqrt(torch.clamp(f0 * f0 + 2.0 * u * (f1 - f0),
                                          min=0.0)))
        / torch.where(lin, f0 - f1, 1.0),
        u / torch.clamp(f0, min=1e-20))
    a = torch.zeros_like(u)
    b = torch.ones_like(u)

    def f_hat(t):
        return f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))

    for _ in range(_NEWTON_ITERS):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        big_f = t * (f0 + t * (0.5 * d0 + t * ((1.0 / 3.0) * (-2 * d0 - d1)
                                               + f1 - f0
                                               + t * (0.25 * (d0 + d1)
                                                      + 0.5 * (f0 - f1)))))
        t, a, b = _newton_step(t, a, b, big_f, f_hat(t), u)
    t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
    return t, f_hat(t)


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u, tix=None):
    """SampleCatmullRom2D (interpolation.cpp:172) over lanes.  nodes1
    (S1,), nodes2 (S2,), values and cdf (S1, S2); alpha (N,) the
    first-axis coordinate, u (N,) uniforms.  With ``tix`` (N,) int, values
    and cdf are a stack (T, S1, S2) of tables on the same nodes and each
    lane reads its own, tix[lane] (one gather; the tabulated BSSRDF's
    tables of each (g, eta)).  Returns (x, f(x), pdf), each (N,)."""
    s2 = nodes2.shape[0]
    ok, off1, w1 = catmull_rom_weights(nodes1, alpha)
    rows = torch.clamp(off1[:, None] + torch.arange(4, device=alpha.device),
                       0, nodes1.shape[0] - 1)  # (N, 4)

    def interp(tbl, idx):
        # sum_i w1[i] * tbl[rows[i], idx]; idx (N,) int
        col = torch.clamp(idx, 0, s2 - 1)[:, None]
        g = tbl[rows, col] if tix is None else tbl[tix[:, None], rows, col]
        return (g * w1).sum(dim=-1)  # g (N, 4)

    maximum = interp(cdf, torch.full_like(off1, s2 - 1))
    us = u * maximum
    # binary search for the interval with interp(cdf, i) <= us
    lo = torch.zeros_like(off1)
    hi = torch.full_like(off1, s2 - 1)
    for _ in range(int(np.ceil(np.log2(max(s2, 2)))) + 1):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        below = interp(cdf, mid) <= us
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid - 1)
    idx = torch.clamp(lo, 0, s2 - 2)

    f0 = interp(values, idx)
    f1 = interp(values, idx + 1)
    x0 = nodes2[idx]
    x1 = nodes2[idx + 1]
    width = x1 - x0
    d0, d1 = _segment_derivs(f0, f1, interp(values, idx - 1),
                             interp(values, idx + 2), x0, x1,
                             nodes2[torch.clamp(idx - 1, min=0)],
                             nodes2[torch.clamp(idx + 2, max=s2 - 1)],
                             idx > 0, idx + 2 < s2)
    u_seg = (us - interp(cdf, idx)) / torch.clamp(width, min=1e-20)
    t, fhat = _invert_segment_integral(u_seg, f0, f1, d0, d1)
    x = x0 + width * t
    pdf = torch.where(ok & (maximum > 0),
                      fhat / torch.clamp(maximum, min=1e-20), 0.0)
    return torch.where(ok, x, 0.0), torch.where(ok, fhat, 0.0), pdf


def _lane_values(values, i, n: int):
    """values[i] of a shared (S,) table, or each lane's own of (N, S)."""
    i = torch.clamp(i, 0, n - 1)
    if values.dim() == 1:
        return values[i]
    return torch.gather(values, 1, i[:, None])[:, 0]


def _spline_segment(nodes, values, idx):
    """(x0, x1, f0, f1, d0, d1) of the segment idx of a spline."""
    n = nodes.shape[0]
    f0 = _lane_values(values, idx, n)
    f1 = _lane_values(values, idx + 1, n)
    x0 = nodes[idx]
    x1 = nodes[idx + 1]
    d0, d1 = _segment_derivs(f0, f1, _lane_values(values, idx - 1, n),
                             _lane_values(values, idx + 2, n), x0, x1,
                             nodes[torch.clamp(idx - 1, min=0)],
                             nodes[torch.clamp(idx + 2, max=n - 1)],
                             idx > 0, idx + 2 < n)
    return x0, x1, f0, f1, d0, d1


def catmull_rom_eval(nodes, values, x):
    """CatmullRom (interpolation.cpp:39) at x (N,); values (S,) or per
    lane (N, S).  0 outside the nodes."""
    ok = (x >= nodes[0]) & (x <= nodes[-1])
    x0, x1, f0, f1, d0, d1 = _spline_segment(nodes, values,
                                             _find_interval(nodes, x))
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-20)
    t2 = t * t
    t3 = t2 * t
    out = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
           + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
    return torch.where(ok, out, 0.0)


def invert_catmull_rom(nodes, values, u):
    """InvertCatmullRom (interpolation.cpp:288): the x with spline(x) == u
    for monotone per-lane tables values (N, S)."""
    n = nodes.shape[0]
    v0 = values[:, 0]
    vl = values[:, -1]
    # interval search on the per-lane monotone values
    lo = torch.zeros(values.shape[0], dtype=torch.int64, device=u.device)
    hi = torch.full_like(lo, n - 1)
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        below = _lane_values(values, mid, n) <= u
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid - 1)
    x0, x1, f0, f1, d0, d1 = _spline_segment(nodes, values,
                                             torch.clamp(lo, 0, n - 2))
    t = torch.full_like(u, 0.5)
    a = torch.zeros_like(u)
    b = torch.ones_like(u)
    for _ in range(_NEWTON_ITERS):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        t2 = t * t
        t3 = t2 * t
        big_f = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
                 + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
        small_f = ((6 * t2 - 6 * t) * f0 + (-6 * t2 + 6 * t) * f1
                   + (3 * t2 - 4 * t + 1) * d0 + (3 * t2 - 2 * t) * d1)
        t, a, b = _newton_step(t, a, b, big_f, small_f, u)
    t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
    x = x0 + t * (x1 - x0)
    return torch.where(u <= v0, nodes[0], torch.where(u >= vl, nodes[-1], x))
