"""The realistic camera and the fourier BSDF on the card: the traversal
kernel K1 against its plain version on every call of frame L's camera
rays and first bounce step, the exit-pupil trace and the camera's rays
card against CPU, and the fourier BSDF's sample, f and pdf on CUDA
tensors against the CPU.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the test, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_lens_fourier_cuda.py``.

Bounds: K1's prims (or occlusion) equal to the plain version's on
>= 99.99% of lanes, t within rtol 1e-5 where both hit; the exit-pupil
bounds equal to 1e-12 (float64, numpy's operation order on both); the
camera's rays within 1e-5 and the same vignetted lanes on >= 99.9%
(float32 transcendentals of another library); the fourier values within
1e-5 relative on >= 99.9% of lanes, with the same azimuth cell on
>= 99.9% of lanes.  The rest are lanes where the zenith's Newton
inversion meets a flat stretch of the spline: there an ulp of the
interpolated cdf, summed in another order on the card, moves the root
by ulp / F'(x), as tpurt's own CPU run differs from the port's
(tests/test_torch_interpolation.py).
"""

import numpy as np
import pytest
import torch

from tpurt_torch.testscenes import glossy_fourier_table, write_realistic

pytestmark = pytest.mark.cuda


def _skip_without_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_k1_on_realistic_frame_calls_matches_plain(tmp_path):
    """Every traversal call of path_bounce_init and one path_bounce_step
    on frame L at 128x128 (camera rays from the front lens element,
    weighted, vignetted lanes included; the first bounce's shadow and
    bounce rays)."""
    _skip_without_cuda()
    from tpurt_torch.kernels.traverse import (traverse_reference,
                                              traverse_wide)
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.render.integrator import (path_bounce_init,
                                               path_bounce_step)

    job = build_job(load_scene(write_realistic(
        str(tmp_path / "l.pbrt"), "full", res=128)), "cuda")
    calls = []

    def recording(geo, o, d, t_max, any_hit, time=None, tree="tri"):
        calls.append((o, d, t_max, any_hit))
        return traverse_wide(geo, o, d, t_max, any_hit, time=time, tree=tree)

    film, spp = job.film, job.sampler.spp
    n = film.width * film.height * spp
    ids = torch.arange(n, device="cuda")
    px, py = (ids // spp) % film.width, (ids // spp) // film.width
    st = path_bounce_init(job.scene, job.sampler, job.camera, px, py,
                          ids % spp, job.cfg, recording)
    assert 0.0 < (st["ray_w"] == 0).float().mean().item() < 0.5
    alive = st["alive"]
    st = {k: None if v is None else v[alive] for k, v in st.items()}
    path_bounce_step(job.scene, job.sampler, job.cfg, st, 0, recording,
                     camera=job.camera, texture_eval=job.texture_eval)
    assert [c[3] for c in calls] == [False, True, False]
    geo = job.scene.geo
    for o, d, tm, any_hit in calls:
        t_k, p_k = traverse_wide(geo, o, d, tm, any_hit)[:2]
        t_r, p_r = traverse_reference(geo, o, d, tm, any_hit)[:2]
        assert (p_k == p_r).float().mean().item() >= 0.9999
        both = (p_k >= 0) & (p_k == p_r)
        if not any_hit:
            assert both.float().mean().item() > 0.3
            torch.testing.assert_close(t_k[both], t_r[both], rtol=1e-5,
                                       atol=0)


def test_lens_build_and_camera_rays_card_match_cpu(tmp_path):
    _skip_without_cuda()
    from tpurt_torch.render import lenses
    from tpurt_torch.render.camera import camera_from_tables
    from tpurt_torch.render.driver import host_tables, load_scene

    lens = str(tmp_path / "l.dat")
    scene = write_realistic(str(tmp_path / "l.pbrt"), "small", res=64)
    for zones in (8, lenses.N_ZONES):
        gpu = lenses.build_lens_system(lens, 8.0, 15.2, 0.035,
                                       n_zones=zones, device="cuda")
        cpu = lenses.build_lens_system(lens, 8.0, 15.2, 0.035,
                                       n_zones=zones, device="cpu")
        np.testing.assert_array_equal(gpu.exit_pupil, cpu.exit_pupil)
    tab = host_tables(load_scene(scene), device="cuda")["camera"]
    cams = [camera_from_tables(tab, dev) for dev in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(7)
    pf = torch.rand((1 << 16, 2), generator=gen) * 64
    pl = torch.rand((1 << 16, 2), generator=gen)
    (og, dg, wg), (oc, dc, wc) = (
        [x.cpu() for x in c.generate_rays(pf.to(c.exit_pupil.device),
                                          pl.to(c.exit_pupil.device))]
        for c in cams)
    assert ((wg > 0) == (wc > 0)).float().mean().item() >= 0.999
    live = (wg > 0) & (wc > 0)
    for g, c in ((og, oc), (dg, dc)):
        torch.testing.assert_close(g[live], c[live], rtol=0, atol=1e-5)
    torch.testing.assert_close(wg[live], wc[live], rtol=1e-5, atol=0)


def test_fourier_on_the_card_matches_cpu():
    _skip_without_cuda()
    from tpurt_torch.render import fourier as pf

    baked = pf.bake_fourier_table(glossy_fourier_table())
    tg, tc = (pf.table_to_device(baked, dev) for dev in ("cuda", "cpu"))
    gen = torch.Generator().manual_seed(9)
    n = 1 << 16
    wo = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                       dim=-1)
    wo[:, 2] = wo[:, 2].abs()
    wi = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                       dim=-1)
    u0, u1 = torch.rand((2, n), generator=gen)

    def rel(g, c):
        """Within 1e-5 relative to c's scale on >= 99.9% of lanes."""
        g, c = g.cpu(), c
        scale = c.abs().max().item()
        ok = (g - c).abs() <= 1e-5 * (c.abs() + scale)
        ok = ok if ok.dim() == 1 else ok.all(dim=-1)
        assert ok.float().mean().item() >= 0.999, ok.float().mean()

    rel(pf.fourier_f(tg, 1.33, wo.cuda(), wi.cuda()),
        pf.fourier_f(tc, 1.33, wo, wi))
    rel(pf.fourier_pdf(tg, wo.cuda(), wi.cuda()), pf.fourier_pdf(tc, wo, wi))
    got = pf.fourier_sample(tg, 1.33, wo.cuda(), u0.cuda(), u1.cuda())
    want = pf.fourier_sample(tc, 1.33, wo, u0, u1)

    def cell(w):
        phi = torch.arccos(pf._cos_dphi(-w, wo))
        return torch.floor(phi / (np.pi / (pf.N_PHI - 1)))

    same = cell(got[0].cpu()) == cell(want[0])
    assert same.float().mean().item() >= 0.999
    for g, c in zip(got, want):
        rel(g.cpu()[same], c[same])
