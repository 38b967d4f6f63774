"""Subsurface scattering and the multi-device module on the card: the
traversal kernel K1 against its plain version on every call of frame N's
camera rays and first bounce step (the subsurface hop's 8 probe-chain
calls and its exit point's any-hit call among them), frame N at 32x32
card against CPU under path, rpf and directlighting, and the sharded
render and RPF filter at world size 1 over NCCL against one device.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_subsurface_cuda.py``.

Bounds: K1's prims (or occlusion) equal to the plain version's on
>= 99.99% of lanes, t within rtol 1e-5 where both hit; the renders'
means within 1e-3 relative and >= 99% of pixels within 1e-3 abs +
1e-3 rel; the sharded results within 2e-5 of one device's.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.testscenes import write_subsurface

pytestmark = pytest.mark.cuda


def _skip_without_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close(g, h):
    assert np.isfinite(g).all()
    assert abs(g.mean() - h.mean()) <= 1e-3 * h.mean()
    ok = (np.abs(g - h) <= 1e-3 + 1e-3 * np.abs(h)).all(axis=-1)
    assert ok.mean() >= 0.99


def test_k1_on_subsurface_calls_matches_plain(tmp_path):
    """Every traversal call of path_bounce_init and one path_bounce_step
    on frame N at 128x128, 8 spp."""
    _skip_without_cuda()
    from tpurt_torch.kernels.traverse import (traverse_reference,
                                              traverse_wide)
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.render.integrator import (path_bounce_init,
                                               path_bounce_step)

    job = build_job(load_scene(write_subsurface(
        str(tmp_path / "n.pbrt"), "full", res=128)), "cuda")
    calls = []

    def recording(geo, o, d, t_max, any_hit, time=None, tree="tri"):
        calls.append((o, d, t_max, any_hit))
        return traverse_wide(geo, o, d, t_max, any_hit, time=time, tree=tree)

    film, spp = job.film, job.sampler.spp
    ids = torch.arange(film.width * film.height * spp, device="cuda")
    px, py = (ids // spp) % film.width, (ids // spp) // film.width
    st = path_bounce_init(job.scene, job.sampler, job.camera, px, py,
                          ids % spp, job.cfg, recording)
    alive = st["alive"]
    st = {k: None if v is None else v[alive] for k, v in st.items()}
    path_bounce_step(job.scene, job.sampler, job.cfg, st, 0, recording,
                     camera=job.camera, texture_eval=job.texture_eval)
    assert [c[3] for c in calls] == [False] * 9 + [True, True, False]
    geo = job.scene.geo
    for o, d, tm, any_hit in calls:
        t_k, p_k = traverse_wide(geo, o, d, tm, any_hit)[:2]
        t_r, p_r = traverse_reference(geo, o, d, tm, any_hit)[:2]
        assert (p_k == p_r).float().mean().item() >= 0.9999
        both = (p_k >= 0) & (p_k == p_r)
        if not any_hit:
            torch.testing.assert_close(t_k[both], t_r[both], rtol=1e-5,
                                       atol=0)
    # the probe chain finds crossings: its first call hits on most lanes
    assert (traverse_wide(geo, *calls[1][:3], False)[1] >= 0).float(
    ).mean().item() > 0.5


@pytest.mark.parametrize("integrator", ["path", "rpf", "directlighting"])
def test_small_subsurface_card_matches_cpu(integrator, tmp_path):
    _skip_without_cuda()
    from tpurt_torch.render.driver import load_scene, render
    from tpurt_torch.rpf.driver import render_rpf

    small = write_subsurface(str(tmp_path / "n.pbrt"), "small",
                             integrator=integrator)
    if integrator == "rpf":
        g, h = (render_rpf(load_scene(small), dev,
                           write_feature_exrs=False)[0]
                for dev in ("cuda", "cpu"))
    else:
        g, h = (render(load_scene(small), dev)[0] for dev in ("cuda", "cpu"))
    _close(g, h)


def test_sharded_world_size_1_on_nccl_matches_one_device(tmp_path):
    _skip_without_cuda()
    import torch.distributed as dist

    from tpurt_torch.parallel.mesh import (gather_rows, make_group,
                                           render_sharded,
                                           rpf_filter_sharded, shard_rows)
    from tpurt_torch.render.driver import load_scene, render
    from tpurt_torch.rpf.filter import apply_rpf_filter
    from tpurt_torch.testscenes import write_standin

    small = write_standin(str(tmp_path / "a.pbrt"), "small")
    group = make_group("cuda", init_method=f"file://{tmp_path / 'init'}",
                       rank=0, world_size=1)
    try:
        assert dist.get_backend(group) == "nccl"
        want, _ = render(load_scene(small), "cuda")
        for scatter in (True, False):
            got, _ = render_sharded(load_scene(small), group,
                                    scatter_film=scatter, device="cuda")
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        gen = torch.Generator().manual_seed(5)
        buf = torch.rand((16, 16, 4, 19), generator=gen).cuda()
        got = gather_rows(rpf_filter_sharded(shard_rows(buf, group), 5, 16,
                                             group), 16, group)
        torch.testing.assert_close(got, apply_rpf_filter(buf, 5), rtol=0,
                                   atol=2e-5)
    finally:
        dist.destroy_process_group()
