"""The port's bdpt on its own, as tpurt's tests/test_bdpt.py holds
tpurt's: the closed-form furnace, bdpt against path on an area-lit floor,
and the per-strategy harness (every unweighted (s, t) strategy of depth 1
is an unbiased estimator of the same transport, so their means agree;
tests/test_bdpt.py:92-105).  No tpurt render: the scenes are tpurt's
test scenes and the bounds its tests' (0.02 absolute on the furnace, 3%
against path, 8% between strategies).
"""

import numpy as np
import torch

from tpurt_torch.kernels.traverse import traverse_wide
from tpurt_torch.render.bdpt import bdpt_radiance
from tpurt_torch.render.driver import build_job, render
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

FURNACE = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "halton" "integer pixelsamples" [4]
Integrator "bdpt" "integer maxdepth" [5]
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "color I" [3.1415926 3.1415926 3.1415926]
Material "matte" "color Kd" [.5 .5 .5] "float sigma" [0]
ReverseOrientation
Shape "sphere" "float radius" [1]
WorldEnd
"""

AREA_SCENE = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Sampler "random" "integer pixelsamples" [{spp}]
Integrator "{integ}" "integer maxdepth" [{md}]
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
WorldEnd
"""


def test_bdpt_furnace_closed_form():
    img, _ = render(load_scene_string(FURNACE), "cpu")
    want = sum(0.5 ** k for k in range(1, 6))
    assert np.isfinite(img).all()
    assert abs(float(img.mean()) - want) < 0.02, (img.mean(), want)


def test_bdpt_matches_path_area_light():
    p, _ = render(load_scene_string(
        AREA_SCENE.format(integ="path", md=5, spp=128)), "cpu")
    b, _ = render(load_scene_string(
        AREA_SCENE.format(integ="bdpt", md=5, spp=128)), "cpu")
    assert np.isfinite(b).all()
    rel = abs(p.mean() - b.mean()) / p.mean()
    assert rel < 0.03, (p.mean(), b.mean(), rel)


def _strategy_mean(job, strategy):
    """The film mean of one unweighted strategy over the whole frame."""
    film, spp = job.film, job.sampler.spp
    state = film.initial_state("cpu", splats=True)
    total = film.width * film.height * spp
    for start in range(0, total, 1 << 14):
        ids = torch.arange(start, min(start + (1 << 14), total))
        pid = ids // spp
        out = bdpt_radiance(job.scene, job.sampler, job.camera,
                            pid % film.width, pid // film.width, ids % spp,
                            job.cfg, traverse_wide,
                            debug_strategy=strategy, debug_unweighted=True)
        film.add_samples(state, out["p_film_crop"], out["L"], out["ray_w"])
        if "splat_p" in out:
            film.add_splats(state, out["splat_p"], out["splat_L"])
    return float(film.to_image(state, splat_scale=1.0 / spp).mean())


def test_bdpt_strategies_agree_unweighted():
    """Each depth-1 strategy (BSDF hit (0,3), light sampling (1,2), light
    tracing (2,1)) is an unbiased estimator of the same one-bounce
    transport; their unweighted means agree."""
    job = build_job(load_scene_string(
        AREA_SCENE.format(integ="bdpt", md=1, spp=256)), "cpu")
    means = {st: _strategy_mean(job, st) for st in [(0, 3), (1, 2), (2, 1)]}
    ref = np.mean(list(means.values()))
    assert ref > 0
    for v in means.values():
        assert abs(v - ref) / ref < 0.08, means
