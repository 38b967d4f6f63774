"""The port's Metropolis stage against tpurt's on the CPU: render_mlt of
both packages on one small scene under one seed (maxdepth 1: depth 0,
the light seen directly, and depth 1, direct lighting, carry comparable
energy, so each depth's chains and w_scale matter).  Both draw the
bootstrap rows from Threefry under the seed, so b_d, and with it the
image's scale, are the same; the chains' draws differ (tpurt's
jax.random, the port's torch.Generator), so the chains are held
statistically: the two images' means, and each depth's acceptance rate.

Bounds, from seeds 0-3 of this scene on a CPU: the port's mean over
tpurt's lay within 0.9981-1.0031, each depth's acceptance within 0.0075
of tpurt's (depth 0 near 0.49, depth 1 near 0.73).  The bounds are 2%
and 0.025.  What they catch (the same runs on broken copies of the
port): a dropped w_old splat puts the mean ~40% low, a global instead of
a per-depth w_scale ~50% low, chain seeds drawn uniformly instead of by
the bootstrap luminance ~68% low, and pbrt's constant sigma in place of
tpurt's widened small step raises depth 0's acceptance by ~0.045.
"""

import logging

import numpy as np
import torch

from tpurt.render.mlt import render_mlt as tpurt_render_mlt
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.render import mlt as pmlt
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

SCENE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "mlt" "integer maxdepth" [1] "integer mutationsperpixel" [100]
  "integer seed" [0]
Camera "perspective" "float fov" [60]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [8 8 8]
  Translate 0 2.5 4
  Shape "sphere" "float radius" [0.4]
AttributeEnd
Material "matte" "color Kd" [.7 .6 .5]
Shape "trianglemesh" "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]
  "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [.5 .7 .6]
Shape "trianglemesh" "point P" [-10 -1 7  10 -1 7  10 9 7  -10 9 7]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""
N_CHAINS = 1 << 10
N_BOOTSTRAP = 1 << 14


def test_mlt_chains_match_tpurt(caplog):
    caplog.set_level(logging.INFO, logger="tpurt.mlt")
    want, _ = tpurt_render_mlt(tpurt_load_scene_string(SCENE),
                               n_chains=N_CHAINS, n_bootstrap=N_BOOTSTRAP)
    # tpurt logs each depth's acceptance (render_mlt's "MLT depth" line)
    acc_want = {r.args[0]: r.args[3] / 100.0 for r in caplog.records
                if r.name == "tpurt.mlt" and r.msg.startswith("MLT depth")}
    stats = {}
    got, job = pmlt.render_mlt(load_scene_string(SCENE), "cpu",
                               n_chains=N_CHAINS, n_bootstrap=N_BOOTSTRAP,
                               stats=stats)
    want = np.asarray(want)
    assert job.cfg.name == "mlt" and got.shape == want.shape
    assert np.isfinite(got).all()
    ratio = got.mean() / want.mean()
    assert abs(ratio - 1.0) < 0.02, (got.mean(), want.mean())
    acc_got = {d: v["acceptance"] for d, v in stats["depths"].items()}
    assert sorted(acc_got) == sorted(acc_want) == [0, 1], (acc_got, acc_want)
    for d in acc_got:
        assert abs(acc_got[d] - acc_want[d]) < 0.025, (d, acc_got, acc_want)
