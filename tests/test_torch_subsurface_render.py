"""Frame N in miniature against tpurt on the CPU: the tiny scene of both
subsurface materials (tests/torch_subsurface_scenes.py) rendered by
tpurt and by the port's CLI under path, at the standing render bounds
(means within 1e-3 relative, >= 99% of pixels within 1e-3 abs + 1e-3
rel), from tpurt's own tables too (tpurt_torch.convert carries the
BSSRDF columns and diffusion tables), with the probe chain's overflow
counter equal to tpurt's.  Port-only, where a tpurt render would add a
second compile: the sampler stride of 15 dimensions a bounce on a
BSSRDF scene under path, rpf, directlighting and whitted (tpurt's
integrator.py:986-987), and the RGB fallback of --spectrum sampled with
tpurt's warning.
"""

import logging

import numpy as np
import pytest
import torch

from torch_material_scenes import check_close, check_from_tpurt_tables
from torch_subsurface_scenes import subsurface_tiny

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

OVERFLOW = "Subsurface/Probe chain budget exhausted"


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    """(tpurt image, tpurt job, tpurt's overflow count, port CLI image,
    the port's overflow count)."""
    import jax
    from tpurt.render.driver import render as tpurt_render
    from tpurt.scene import load_scene_string as tpurt_load
    from tpurt.utils.stats import STATS as T_STATS
    from tpurt_torch import cli
    from tpurt_torch.io.image import read_image
    from tpurt_torch.utils.stats import STATS

    d = tmp_path_factory.mktemp("subsurface")
    text = subsurface_tiny()
    (d / "scene.pbrt").write_text(text)
    T_STATS.clear()
    want, job = tpurt_render(tpurt_load(text), progress=False)
    want = np.asarray(want)
    jax.effects_barrier()  # the overflow callbacks have run
    STATS.clear()
    out = d / "port.pfm"
    assert cli.main([str(d / "scene.pbrt"), "--device", "cpu", "--outfile",
                     str(out), "--quiet"]) == 0
    return (want, job, T_STATS.counters.get(OVERFLOW, 0), read_image(str(out)),
            STATS.counters.get(OVERFLOW, 0))


def test_subsurface_frame_matches_tpurt(renders):
    want, job, t_over, got, p_over = renders
    assert job.scene.has_bssrdf and job.scene.n_bss_tables == 2
    check_close(got, want)
    assert p_over == t_over > 0
    check_from_tpurt_tables(job, got)


@pytest.mark.parametrize("integrator", ["path", "rpf", "directlighting",
                                        "whitted"])
def test_bssrdf_scene_strides_15_dims_a_bounce(integrator, monkeypatch):
    """Each bounce step's first dimension is CAMERA_DIMS + 15 * bounce
    (7 + BSS_DIMS): a stride of 7 fails.  path and rpf draw the hop's
    dims d0+7..d0+14; directlighting and whitted, which skip the hop,
    draw none of them."""
    from tpurt_torch.render import driver
    from tpurt_torch.render.driver import build_job, render_job
    from tpurt_torch.rpf.driver import render_rpf_job
    from tpurt_torch.scene import load_scene_string

    job = build_job(load_scene_string(subsurface_tiny(integrator)), "cpu")
    assert job.scene.dims_per_bounce == 15
    drawn, bounce = {}, [None]
    dim, step = job.sampler.dim, driver.path_bounce_step

    def rec_dim(px, py, sidx, d, ctx=None):
        if bounce[0] is not None:
            drawn.setdefault(bounce[0], set()).add(d)
        return dim(px, py, sidx, d, ctx)

    def rec_step(scene, sampler, cfg, st, b, *a, **kw):
        bounce[0] = b
        return step(scene, sampler, cfg, st, b, *a, **kw)

    job.sampler.dim = rec_dim
    monkeypatch.setattr(driver, "path_bounce_step", rec_step)
    if integrator == "rpf":
        render_rpf_job(job, write_feature_exrs=False)
    else:
        render_job(job)
    assert len(drawn) >= 2, drawn
    hop = integrator in ("path", "rpf")
    for b, dims in drawn.items():
        offsets = {d - (5 + 15 * b) for d in dims}
        assert min(offsets) == 0, (b, sorted(dims))
        assert max(offsets) <= (14 if hop else 6), (b, sorted(dims))
    assert hop == (set(range(7, 15)) <= {d - 5 for d in drawn[0]})


def test_sampled_spectrum_renders_bssrdf_in_rgb(renders, caplog):
    """tpurt's driver.py:305-310: under --spectrum sampled a BSSRDF scene
    renders in RGB, with its warning: the image is the RGB render's."""
    from tpurt_torch.render.driver import render
    from tpurt_torch.scene import load_scene_string

    _want, _job, _t, got, _p = renders
    with caplog.at_level(logging.WARNING):
        img, job = render(load_scene_string(subsurface_tiny()), "cpu",
                          spectrum="sampled")
    assert ('spectrum_mode "sampled": scene uses BSSRDF materials; '
            "rendering in RGB mode") in caplog.text
    assert not job.cfg.spectral and job.cfg.nch == 3
    np.testing.assert_array_equal(img, got)
