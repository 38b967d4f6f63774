"""The port's grid-medium and shadow-walk functions against tpurt's, part
2 of test_torch_media.py: the trilinear density lookup (also against
test_media.py's oracle), delta and ratio tracking and the distance
sampling that wraps them, and the shadow walk through null boundaries.
Both packages run on one scene build (tpurt's tables carried across by
scene_from_tpurt), from the same numpy rays.

Bounds: the density within 1e-6 relative of tpurt's and test_media.py's
oracle bound (2e-4 rel, 2e-6 abs); tracking decisions (scattered or not,
killed or not, occluded or not) equal on >= 99.9% of lanes, and where
they agree, distances within 1e-5 relative and transmittances and
throughputs within 1e-5 abs + 1e-5 rel; the overflow counts equal.  The
loops compare their floats against the hash's uniforms, so a one-ulp
difference of a log or of an XLA-contracted product can flip a decision:
that is what the 99.9% allows, and the values are compared only where
the decisions agree.
"""

import numpy as np
import torch

import jax.numpy as jnp

from tpurt.render import integrator as tint
from tpurt.utils.stats import STATS
from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render import volpath as pvol
from test_media import _trilerp_oracle
from test_torch_media import _t, both_scenes, grid_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _overflows(fn):
    """(fn's result, the grid-tracking overflow count it reported):
    tpurt's through STATS, the port's through TRACK_STATS."""
    STATS.counters.pop(pvol.GRID_OVERFLOW, None)
    pvol.TRACK_STATS.reset()
    out = fn()
    return out, (STATS.counters.get(pvol.GRID_OVERFLOW, 0)
                 + pvol.TRACK_STATS.read().get(pvol.GRID_OVERFLOW, 0))


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_grid_density_matches_tpurt_and_oracle():
    rng = np.random.default_rng(7)
    density = rng.uniform(0.0, 2.0, (3, 4, 5)).astype(np.float32)
    ts, ps = both_scenes(grid_scene_string(density, (-1, -1, 0), (1, 1, 4),
                                           0.3, 0.2))
    pts = rng.uniform(-0.1, 1.1, (512, 3)).astype(np.float32)
    want = np.asarray(tint._grid_density_at(ts, jnp.zeros(512, jnp.int32),
                                            jnp.asarray(pts)))
    got = pvol._grid_density_at(ps, torch.zeros(512, dtype=torch.long),
                                _t(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    oracle = np.array([_trilerp_oracle(density, p) for p in pts])
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-6)


def test_grid_tracking_matches_tpurt():
    """Delta tracking, ratio tracking and _sample_medium_distance on 4096
    rays through a grid whose majorant puts ~256 steps on a chord (a
    sparse density under one dense voxel), so that some lanes exhaust
    tpurt's 256-step budget and some miss the box.  Lanes are numbered
    above 2^31."""
    rng = np.random.default_rng(3)
    density = np.full((4, 4, 4), 0.004, np.float32)
    density[1, 2, 1] = 1.0
    ts, ps = both_scenes(grid_scene_string(density, (-1, -1, 0), (1, 1, 2),
                                           0.5, 127.5))
    n = 4096
    o = np.stack([rng.uniform(-1.3, 1.3, n), rng.uniform(-1.3, 1.3, n),
                  np.full(n, -1.0)], -1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.15, n), rng.normal(0, 0.15, n),
                  np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_surf = rng.uniform(1.5, 6.0, n).astype(np.float32)
    lane = (np.arange(n) + (1 << 31) - 7).astype(np.int64)
    u_ch, u_dist = rng.random((2, n)).astype(np.float32)
    jt = dict(med=jnp.zeros(n, jnp.int32), lane=jnp.asarray(
        lane.astype(np.uint32)), o=jnp.asarray(o), d=jnp.asarray(d),
        t=jnp.asarray(t_surf))
    pt = dict(med=torch.zeros(n, dtype=torch.int32), lane=_t(lane), o=_t(o),
              d=_t(d), t=_t(t_surf))

    (s_t, t_t, w_t), of_t = _overflows(lambda: tint._grid_sample_medium(
        ts, jt["med"], jt["lane"], jnp.uint32(2), jt["o"], jt["d"], jt["t"],
        salt=0x6A1D))
    (s_p, t_p, w_p), of_p = _overflows(lambda: pvol._grid_sample_medium(
        ps, pt["med"], pt["lane"], 2, pt["o"], pt["d"], pt["t"],
        salt=0x6A1D))
    s_t, s_p = np.asarray(s_t), s_p.numpy()
    assert 0 < of_t < n // 2 and of_p == of_t, (of_t, of_p)
    assert 0.05 < s_t.mean() < 0.95
    assert _agree(s_p, s_t) >= 0.999
    same = s_p == s_t
    np.testing.assert_allclose(t_p.numpy()[same], np.asarray(t_t)[same],
                               rtol=1e-5)
    np.testing.assert_allclose(w_p.numpy()[same], np.asarray(w_t)[same],
                               rtol=1e-5, atol=1e-5)

    tr_t, of_t = _overflows(lambda: tint._grid_tr(
        ts, jt["med"], jt["lane"], jnp.uint32(9), jt["o"], jt["d"], jt["t"],
        salt=0x51AD))
    tr_p, of_p = _overflows(lambda: pvol._grid_tr(
        ps, pt["med"], pt["lane"], 9, pt["o"], pt["d"], pt["t"],
        salt=0x51AD))
    tr_t, tr_p = np.asarray(tr_t), tr_p.numpy()
    assert of_p == of_t
    assert _agree(tr_p == 0, tr_t == 0) >= 0.999
    same = (tr_p == 0) == (tr_t == 0)
    np.testing.assert_allclose(tr_p[same], tr_t[same], rtol=1e-5, atol=1e-5)

    # the wrapper: all lanes in the grid medium (so both count the same
    # lanes), the channel and distance uniforms of the sampler
    out_t, of_t = _overflows(lambda: tint._sample_medium_distance(
        ts, jt["med"], jt["o"], jt["d"], jt["t"], jnp.asarray(u_ch),
        jnp.asarray(u_dist), jt["lane"], jnp.int32(4), 3))
    out_p, of_p = _overflows(lambda: pvol._sample_medium_distance(
        ps, pt["med"], pt["o"], pt["d"], pt["t"], _t(u_ch), _t(u_dist),
        pt["lane"], 4))
    (sc_t, tm_t, th_t, g_t) = (np.asarray(x) for x in out_t)
    (sc_p, tm_p, th_p, g_p) = (x.numpy() for x in out_p)
    assert of_p == of_t
    assert _agree(sc_p, sc_t) >= 0.999
    same = sc_p == sc_t
    np.testing.assert_allclose(tm_p[same], tm_t[same], rtol=1e-5)
    np.testing.assert_allclose(th_p[same], th_t[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(g_p, g_t)


def test_shadow_tr_walk_matches_tpurt():
    """The walk on test_media.py's interface scene: shadow segments from
    the lit wall toward the point light at the origin, through the
    null-material smoke sphere (two crossings, homogeneous smoke) or
    beside it, with a fifth of the lanes unusable."""
    sigma = 0.4
    text = f"""
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    Sampler "random" "integer pixelsamples" [1]
    Integrator "volpath" "integer maxdepth" [6]
    MakeNamedMedium "smoke" "string type" "homogeneous"
      "rgb sigma_a" [{sigma} {sigma} {sigma}] "rgb sigma_s" [0 0 0]
    Camera "perspective" "float fov" [40]
    WorldBegin
    LightSource "point" "color I" [40 40 40] "point from" [0 0 0]
    AttributeBegin
      Material "none"
      MediumInterface "smoke" ""
      Translate 0 0 3
      Shape "sphere" "float radius" [0.6]
    AttributeEnd
    Material "matte" "color Kd" [.6 .6 .6]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-3 -3 6  3 -3 6  3 3 6  -3 3 6]
    WorldEnd
    """
    ts, ps = both_scenes(text)
    assert ts.has_null_boundaries and ps.has_null_boundaries
    rng = np.random.default_rng(12)
    n = 2048
    p_wall = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.6, 1.6, n),
                       np.full(n, 6.0 - 1e-3)], -1).astype(np.float32)
    p_wall[:4, :2] = [[0, 0], [1e-3, 0], [0, -2e-3], [3e-3, 3e-3]]
    to_l = -p_wall
    dist = np.linalg.norm(to_l, axis=1).astype(np.float32)
    d = (to_l / dist[:, None]).astype(np.float32)
    t_max = (dist * (1 - 1e-4) - 2e-3 * 6).astype(np.float32)
    usable = rng.random(n) > 0.2
    usable[:4] = True
    lane = np.arange(n, dtype=np.int64)
    occ_t, tr_t = tint._shadow_tr_walk(
        ts, jnp.asarray(p_wall), jnp.asarray(d), jnp.asarray(t_max),
        jnp.full(n, -1, jnp.int32), jnp.asarray(lane.astype(np.uint32)),
        jnp.int32(1), jnp.asarray(usable))
    pvol.TRACK_STATS.reset()
    occ_p, tr_p = pvol._shadow_tr_walk(
        ps, _t(p_wall), _t(d), _t(t_max), torch.full((n,), -1,
                                                     dtype=torch.int32),
        _t(lane), 1, _t(usable), traverse_wide)
    occ_t, tr_t = np.asarray(occ_t), np.asarray(tr_t)
    occ_p, tr_p = occ_p.numpy(), tr_p.numpy()
    assert pvol.TRACK_STATS.read()[pvol.WALK_OVERFLOW] == 0
    crossed = (tr_t[:, 0] < 0.999) & usable
    assert crossed.mean() > 0.1 and not occ_t[usable].any()
    assert _agree(occ_p, occ_t) >= 0.999
    np.testing.assert_allclose(tr_p, tr_t, rtol=1e-5, atol=1e-5)
    # through the sphere's centre: both chords, exp(-sigma * 2 * 0.6) a
    # crossing pair
    np.testing.assert_allclose(tr_p[:4], np.exp(-sigma * 1.2), rtol=1e-3)
