"""The whole ported slice against tpurt: the same scene rendered by
tpurt's ``render`` and by the port's CLI, both on the CPU, from the same
Halton samples.

Bounds (set from the first measured run, then frozen): image means agree
within 1e-3 relative and >= 99% of pixels within 1e-3 abs + 1e-3 rel.
The first run measured identical means and a largest pixel difference of
3.4e-6 on the stand-in: the only differences are float rounding (XLA's
FMA contraction, transcendental ulps) and the order of film sums.
"""

import numpy as np
import pytest
import torch

from tpurt.io.image import read_image
from tpurt.render.driver import render as tpurt_render
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch import cli
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render.driver import job_from_tables, render_job
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import mixed_scene, standin_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

SCENES = {"standin": lambda: standin_scene("small"),
          "mixed": lambda: mixed_scene()}


def render_both(name, tmp_path_factory):
    """(tpurt image, tpurt job, port CLI image) for the scene ``name``."""
    d = tmp_path_factory.mktemp(name)
    path = d / "scene.pbrt"
    path.write_text(SCENES[name]())
    want, job = tpurt_render(tpurt_load_scene_string(path.read_text()),
                             progress=False)
    out = d / "port.pfm"
    assert cli.main([str(path), "--device", "cpu", "--outfile", str(out),
                     "--quiet"]) == 0
    return want, job, read_image(str(out))


# one scene a file (each is a cold tpurt jit): "mixed" runs in
# test_torch_render_4.py
@pytest.fixture(scope="module", params=["standin"])
def renders(request, tmp_path_factory):
    return render_both(request.param, tmp_path_factory)


def test_port_cli_render_matches_tpurt(renders):
    want, _, got = renders
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0.01
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    ok = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99


def test_render_from_tpurt_tables_equals_cli_render(renders):
    """The port's render of tpurt's own tables is the port's render of the
    scene: the two builds are identical (test_torch_intersect checks the
    tables bit for bit)."""
    _, job, got = renders
    img = render_job(job_from_tables(scene_from_tpurt(job), "cpu"))
    np.testing.assert_array_equal(img, got)


def test_feature_capture_records_first_two_hits():
    """With capture_features on, the path state carries the geometric
    normal and position of each lane's bounce-0 and bounce-1 hits (the
    RPF features, rpf.cpp:851-857), and zeros where a lane had no hit."""
    import dataclasses

    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render import integrator as pinteg
    from tpurt_torch.render.driver import build_job
    from tpurt_torch.render.interaction import compute_interaction
    from tpurt_torch.render.intersect import Hit

    job = build_job(load_scene_string(mixed_scene()), "cpu")
    cfg = dataclasses.replace(job.cfg, capture_features=True)
    n = job.film.width * job.film.height
    ids = torch.arange(n)
    st = pinteg.path_bounce_init(job.scene, job.sampler, job.camera,
                                 ids % job.film.width, ids // job.film.width,
                                 torch.zeros_like(ids), cfg, traverse_wide)
    hits = []
    for bounce in range(2):
        hit = Hit(st["hit_t"], st["hit_prim"], st["hit_b0"], st["hit_b1"])
        hits.append((compute_interaction(job.scene.geo, hit, st["o"],
                                         st["d"]), st["alive"]))
        st = pinteg.path_bounce_step(job.scene, job.sampler, cfg, st,
                                     bounce, traverse_wide)
    for (si, alive), kn, kp in zip(hits, ("n0", "n1"), ("p0", "p1")):
        m = (alive & si.valid)[:, None]
        assert 0.1 < m.float().mean() < 1.0
        assert torch.equal(st[kn], torch.where(m, si.ng, 0.0))
        assert torch.equal(st[kp], torch.where(m, si.p, 0.0))


BASE = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Camera "{camera}" "float fov" [45]
Sampler "{sampler}" "integer pixelsamples" [1]
Integrator "{integrator}"
PixelFilter "{filter}"
{accel}
WorldBegin
LightSource "{light}" "point from" [0 4 0]
{medium}
Material "{material}" {kd}
Shape "{shape}" "float radius" [1]
Translate 0 0 3
Shape "trianglemesh" "point P" [-5 -1 -5  5 -1 -5  0 -1 5]
  "integer indices" [0 1 2]
WorldEnd
"""
OK = dict(camera="perspective", sampler="halton", integrator="path",
          filter="box", accel="", light="point", medium="",
          material="matte", kd='"color Kd" [0.5 0.5 0.5]', shape="sphere")
