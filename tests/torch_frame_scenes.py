"""The direct-lighting textured slice as a whole against tpurt, on the CPU:
20- to 24-pixel-square frames of the textured scene under
``Integrator "directlighting"`` and of its variant with a glass sphere
and a mirror under ``Integrator "whitted"`` and a gaussian filter, through
the port's CLI and through tpurt's own tables.  Shared by
test_torch_direct_frames.py and test_torch_whitted_frames.py: one file a
frame, since each frame is a cold tpurt jit of about half a minute.

Bounds: the standing ones of the port's render tests, means within 1e-3
relative and >= 99% of pixels within 1e-3 abs + 1e-3 rel.  The first
measured runs gave largest pixel differences of 6.1e-6 (directlighting)
and 4.3e-6 (whitted).
"""

import numpy as np

from tpurt.render.driver import render as tpurt_render
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch import cli
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.io.image import read_image
from tpurt_torch.render.driver import job_from_tables, render_job
from tpurt_torch.testscenes import textured_scene, write_grid_texture

CASES = {
    "directlighting": dict(variant="directlighting", res=24),
    "whitted": dict(variant="whitted", pixel_filter="gaussian", res=20),
}


def render_both(name: str, d):
    """(tpurt image, tpurt job, port CLI image) for the frame ``name``,
    with its files under the directory ``d``."""
    tex = write_grid_texture(str(d / f"grid_{name}.png"))
    path = d / "scene.pbrt"
    path.write_text(textured_scene("small", tex, str(d / "out.exr"),
                                   **CASES[name]))
    want, job = tpurt_render(tpurt_load_scene_string(path.read_text()),
                             progress=False)
    out = d / "port.pfm"
    assert cli.main([str(path), "--device", "cpu", "--outfile", str(out),
                     "--quiet"]) == 0
    return np.asarray(want), job, read_image(str(out))


def _check_close(got, want):
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    ok = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99


def check_cli_matches_tpurt(renders):
    want, _job, got = renders
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0.01
    _check_close(got, want)


def check_from_tpurt_tables_matches_tpurt(renders):
    """tpurt's own tables (sampler, lights, material rows, texture
    records) carried across by convert.py render to tpurt's image."""
    want, job, _ = renders
    tab = scene_from_tpurt(job)
    assert tab["materials"]["has_texfilter"]
    assert [s for _i, s in tab["materials"]["textured"]] == ["Kd", "Kd"]
    _check_close(render_job(job_from_tables(tab, "cpu")), want)
