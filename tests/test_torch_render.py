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
from tpurt_torch.config import resolve_device
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render.driver import job_from_tables, render, render_job
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import mixed_scene, standin_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

SCENES = {"standin": lambda: standin_scene("small"),
          "mixed": lambda: mixed_scene()}


@pytest.fixture(scope="module", params=sorted(SCENES))
def renders(request, tmp_path_factory):
    """(tpurt image, tpurt job, port CLI image) for one scene."""
    d = tmp_path_factory.mktemp(request.param)
    path = d / "scene.pbrt"
    path.write_text(SCENES[request.param]())
    want, job = tpurt_render(tpurt_load_scene_string(path.read_text()),
                             progress=False)
    out = d / "port.pfm"
    assert cli.main([str(path), "--device", "cpu", "--outfile", str(out),
                     "--quiet"]) == 0
    return want, job, read_image(str(out))


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


def test_supported_base_scene_renders_on_cpu():
    img, _ = render(load_scene_string(BASE.format(**OK)), device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("key,value,feature", [
    ("integrator", "bdpt", 'Integrator "bdpt"'),
    ("integrator", "volpath", 'Integrator "volpath"'),
    ("integrator", "ao", 'Integrator "ao"'),
    ("sampler", "adaptive", 'Sampler "adaptive"'),
    ("integrator", "sppm", 'Integrator "sppm"'),
    ("material", "hair", 'Material "hair"'),
    ("material", "fourier", 'Material "fourier"'),
    ("material", "subsurface", 'Material "subsurface"'),
    ("material", "kdsubsurface", 'Material "kdsubsurface"'),
    ("shape", "curve", 'Shape "curve"'),
    ("accel", 'Accelerator "kdtree"', 'Accelerator "kdtree"'),
    ("filter", "catmullrom", 'PixelFilter "catmullrom"'),
    ("camera", "realistic", 'Camera "realistic"'),
    ("kd", '"texture Kd" "checks"', 'Texture "ptex"'),
    ("medium", 'MakeNamedMedium "fog" "string type" "homogeneous"\n'
               'MediumInterface "" "fog"', "media"),
])
def test_outside_the_slice_raises(key, value, feature):
    text = BASE.format(**dict(OK, **{key: value}))
    if "ptex" in feature:
        text = text.replace("WorldBegin", 'WorldBegin\nTexture "checks" '
                            '"spectrum" "ptex" "string filename" "faces.ptx"')
    elif value == "curve":
        text = text.replace('Shape "curve" "float radius" [1]',
                            'Shape "curve" "point P" [0 0 0 1 1 0 2 -1 0 '
                            '3 0 0] "float width" [0.1]')
    with pytest.raises(NotImplementedError, match=feature):
        render(load_scene_string(text), device="cpu")


@pytest.mark.parametrize("key,value", [
    ("integrator", "directlighting"), ("integrator", "whitted"),
    ("sampler", "sobol"), ("sampler", "random"), ("sampler", "stratified"),
    ("sampler", "02sequence"), ("sampler", "maxmindist"),
    ("material", "glass"), ("material", "mirror"), ("light", "spot"),
    ("light", "distant"), ("filter", "gaussian"), ("filter", "mitchell"),
    ("filter", "triangle"), ("filter", "sinc"),
    ("kd", '"texture Kd" "checks"'),
    ("material", "metal"), ("material", "uber"), ("material", "substrate"),
    ("material", "translucent"), ("material", "disney"),
    ("light", "infinite"), ("light", "goniometric"), ("light", "projection"),
    ("shape", "cylinder"), ("shape", "disk"), ("shape", "cone"),
    ("shape", "paraboloid"), ("shape", "hyperboloid"),
    ("camera", "orthographic"), ("camera", "environment"),
])
def test_what_earlier_slices_refused_now_renders(key, value):
    """Each feature this slice added, one at a time in the base scene."""
    text = "LookAt 0 1 -5  0 0 0  0 1 0\n" + BASE.format(
        **dict(OK, **{key: value})).replace(
        "WorldBegin", 'WorldBegin\nTexture "checks" "spectrum" '
        '"checkerboard" "float uscale" [4] "float vscale" [4]')
    if value == "spot":  # aim it at the sphere from the light's place
        text = text.replace('"point from" [0 4 0]',
                            '"point from" [0 4 0] "point to" [0 0 0]')
    if value in ("goniometric", "projection"):  # placed by the CTM: above,
        text = text.replace(  # looking down
            f'LightSource "{value}" "point from" [0 4 0]',
            f'AttributeBegin\nTranslate 0 4 0\nRotate 90 1 0 0\n'
            f'LightSource "{value}" "color I" [20 20 20]\nAttributeEnd')
    if value == "environment":  # most of its rays escape: give them sky
        text = text.replace("WorldBegin", 'WorldBegin\nLightSource '
                            '"infinite" "color L" [.5 .5 .5]')
    img, job = render(load_scene_string(text), device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    # (every surface specular under a point light: nothing to see)
    assert img.mean() > 0 or key == "material"


def test_halton_pbrt_scramble_selected_by_environment(monkeypatch):
    from tpurt_torch.render.driver import build_job

    monkeypatch.setenv("TPURT_HALTON_SCRAMBLE", "pbrt")
    job = build_job(load_scene_string(BASE.format(**OK)), "cpu")
    assert job.sampler.scramble == "pbrt" and job.sampler.perms is not None
    monkeypatch.delenv("TPURT_HALTON_SCRAMBLE")
    job = build_job(load_scene_string(BASE.format(**OK)), "cpu")
    assert job.sampler.scramble == "affine" and job.sampler.perms is None


def test_cli_sampled_spectrum_raises():
    with pytest.raises(NotImplementedError, match="sampled"):
        cli.main(["x.pbrt", "--device", "cpu", "--spectrum", "sampled"])


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
