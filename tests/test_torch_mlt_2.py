"""The port's MLT on its own: its counterpart of tpurt's
test_mlt_matches_path (tests/test_bdpt.py:124-139: the same scene,
parameters and 15% bound against the path tracer's mean), and the CLI's
``Integrator "mlt"`` dispatch on the CPU (tpurt's cli.py:109-113), with
``Integrator "sppm"`` rendered through the CLI too, in RGB and under
``--spectrum sampled``, and a feature still outside the port (``Camera
"realistic"``) refused by name.  The CLI case shrinks the
bootstrap to 2^12 rows a depth (render/mlt.py's N_BOOTSTRAP, read at the
call) so that it runs in seconds.  Also bdpt's endpoint shading context
(zero_shade_ctx), whose structure must be make_shade_ctx's, hair
included, for the vertex lists to line up.
"""

import numpy as np
import pytest
import torch

from tpurt_torch import cli
from tpurt_torch.io.image import read_image
from tpurt_torch.render import mlt as pmlt
from tpurt_torch.render.driver import build_job, load_scene, render
from tpurt_torch.render.integrator import make_shade_ctx, zero_shade_ctx
from tpurt_torch.render.interaction import compute_interaction
from tpurt_torch.render.intersect import intersect_closest
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import write_motion_hair, write_standin

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

MLT_SCENE = """
Film "image" "integer xresolution" [24] "integer yresolution" [24]
Integrator "mlt" "integer maxdepth" [2] "integer mutationsperpixel" [400]
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


def test_mlt_matches_path():
    """MLT converges to the path tracer's result (tpurt's tolerance: the
    image scales linearly with the bootstrap's b estimate)."""
    img, job = pmlt.render_mlt(load_scene_string(MLT_SCENE), "cpu",
                               n_chains=1 << 11, n_bootstrap=1 << 16)
    path_sd = load_scene_string(
        MLT_SCENE.replace('Integrator "mlt" "integer maxdepth" [2]',
                          'Integrator "path" "integer maxdepth" [2]\n'
                          'Sampler "random" "integer pixelsamples" [128]'))
    ref, _ = render(path_sd, "cpu")
    assert np.isfinite(img).all() and job.cfg.name == "mlt"
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.15, (img.mean(), ref.mean(), rel)


def test_cli_renders_mlt_and_refuses_sppm(tmp_path, monkeypatch):
    monkeypatch.setattr(pmlt, "N_BOOTSTRAP", 1 << 12)
    scene = write_standin(str(tmp_path / "h.pbrt"), "small",
                          integrator="mlt", res=16, maxdepth=2, mutations=4)
    out = tmp_path / "h.pfm"
    assert cli.main([scene, "--device", "cpu", "--outfile", str(out),
                     "--quiet"]) == 0
    img = read_image(str(out))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    # sppm renders through the CLI too, in RGB and in sampled spectra;
    # what the CLI still refuses is a feature outside the port, by name
    sppm = tmp_path / "s.pbrt"
    sppm.write_text(open(scene).read().replace(
        'Integrator "mlt"', 'Integrator "sppm" "integer numiterations" [2]'))
    for spectrum in ("rgb", "sampled"):
        assert cli.main([str(sppm), "--device", "cpu", "--outfile", str(out),
                         "--quiet", "--spectrum", spectrum]) == 0
        img = read_image(str(out))
        assert img.shape == (16, 16, 3) and np.isfinite(img).all()
        assert img.mean() > 0
    # the realistic camera renders too; a lens file it cannot read
    # raises by name (tpurt renders a 45-degree perspective camera)
    realistic = tmp_path / "r.pbrt"
    lens = tmp_path / "bad.dat"
    lens.write_text("35.0 4.0 1.5\n")
    realistic.write_text(sppm.read_text().replace(
        'Camera "perspective"',
        f'Camera "realistic" "string lensfile" "{lens}"'))
    with pytest.raises(ValueError, match=f'Camera "realistic".*{lens}'):
        cli.main([str(realistic), "--device", "cpu", "--quiet", "--spectrum",
                  "sampled"])


def test_zero_shade_ctx_has_make_shade_ctx_structure(tmp_path):
    """On frame E's small scene (hair, mesh tangents): the same fields
    None or not, the same shapes, and no lobe active."""
    from tpurt_torch.kernels.traverse import traverse_wide

    job = build_job(load_scene(write_motion_hair(str(tmp_path / "e.pbrt"),
                                                 "small")), "cpu")
    n = 64
    o = torch.zeros((n, 3))
    d = torch.nn.functional.normalize(torch.randn(
        (n, 3), generator=torch.Generator().manual_seed(0)), dim=-1)
    si = compute_interaction(job.scene.geo, intersect_closest(
        job.scene.geo, o, d, float("inf"), traverse_wide), o, d,
        tangents=job.scene.has_tangents)
    got = zero_shade_ctx(job.scene, n, "cpu")
    want = make_shade_ctx(job.scene, si, job.texture_eval)
    assert want.hair is not None

    def shapes(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else tuple(x.shape)
        return tuple(shapes(y) for y in x)

    assert shapes(got) == shapes(want)
    assert not got.lobes.active.any() and not got.hair[0].any()
