"""The comparison that decides ``correct``: the program's frames against
the plain reference at pixels drawn from the seed.

``pick(seed, res, count, size)`` draws ``count`` square blocks of
``size`` x ``size`` pixels of the frame (a block's pixels share most of
the samples their RPF boxes need, so the reference traces far fewer
samples than for as many scattered pixels); after the window each block
is read from one of the window's frames, drawn from the seed too
(``frame_of``), so that every frame of the window may be judged.  The
relative error of a channel is |P - R| / (|R| + 0.01 mean|R|): the floor
keeps black pixels from dividing by zero and counts an error there
against the image's scale.  The numbers, over all channels of the drawn
pixels:

- ``rel_p50``, ``rel_p90``, ``rel_p99``: quantiles of the relative error;
- ``off_share``: the share of channels whose relative error passes 1e-3;
- ``filter_miss``: over the pixels where the RPF filter acts (it moves
  the pixel from its samples' mean U by more than ACT_TOL of the pixel's
  scale), the lower quartile of max|P - R| / max|R - U|: the share of
  the filter's action the program misses; 0 (not read) where it acts on
  fewer than MIN_ACTED drawn pixels.  At the filter's published
  bandwidth it moves only a few percent of the pixels, too few for the
  quantiles above to see it skipped; the lower quartile stays clear of
  the odd pixel whose box holds a path that turned on a knife edge;
- ``acted_share``: the share of drawn pixels where the filter acts;
- ``mean_rel``: |mean P - mean R| / mean R.

A configuration's ``limits`` name the numbers that are held and the
limit of each; PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import numpy as np

OFF_TOL = 1e-3
ACT_TOL = 1e-2
MIN_ACTED = 8
NAMES = ("rel_p50", "rel_p90", "rel_p99", "off_share", "filter_miss",
         "acted_share", "mean_rel")


def pick(seed: int, res, count: int, size: int):
    """``count`` blocks of ``size`` x ``size`` pixels inside a res = (x,
    y) frame, from the seed: (pixels (K, 2) as (y, x), the block of each
    pixel (K,)).  Blocks may overlap; a pixel is taken once, in its first
    block."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    size = min(size, res[0], res[1])
    y0 = rng.integers(0, res[1] - size + 1, size=count)
    x0 = rng.integers(0, res[0] - size + 1, size=count)
    dy, dx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    yy = (y0[:, None] + dy.ravel()[None]).ravel()
    xx = (x0[:, None] + dx.ravel()[None]).ravel()
    block = np.repeat(np.arange(count), size * size)
    _, first = np.unique(yy * res[0] + xx, return_index=True)
    first = np.sort(first)
    return np.stack([yy[first], xx[first]], -1), block[first]


def frame_of(seed: int, count: int, n_frames: int) -> np.ndarray:
    """The window frame each of ``count`` drawn blocks is read from."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    return rng.integers(0, n_frames, size=count)


def numbers(values, ref, unfiltered) -> dict:
    """The comparison's numbers for program ``values`` against ``ref``,
    the reference's values, with ``unfiltered`` the reference's pixel
    means before the filter (all (K, 3)); values of another shape or a
    non-finite value read inf on every number."""
    v = np.asarray(values, np.float64)
    r = np.asarray(ref, np.float64)
    u = np.asarray(unfiltered, np.float64)
    if v.shape != r.shape or not np.isfinite(v).all():
        return {k: float("inf") for k in NAMES}
    scale = np.abs(r).mean()
    floor = np.abs(r) + 0.01 * scale
    rel = np.abs(v - r) / floor
    p50, p90, p99 = np.quantile(rel, (0.5, 0.9, 0.99))
    act = np.abs(r - u).max(-1)
    acted = act > ACT_TOL * floor.max(-1)
    miss = np.abs(v - r).max(-1)[acted] / act[acted]
    return dict(rel_p50=float(p50), rel_p90=float(p90), rel_p99=float(p99),
                off_share=float((rel > OFF_TOL).mean()),
                filter_miss=(float(np.quantile(miss, 0.25))
                             if len(miss) >= MIN_ACTED else 0.0),
                acted_share=float(acted.mean()),
                mean_rel=float(abs(v.mean() - r.mean()) / scale))


def held(nums: dict, limits: dict) -> bool:
    """True when every held number is within its limit."""
    return all(nums[k] <= lim for k, lim in limits.items())
