"""The port's tabulated-BSSRDF device functions against tpurt's on the
CPU: bss_sr, bss_pdf_sr, bss_sample_sr and bss_sw on seeded lanes, each
lane on one of two tables (the port gathers from the stack by table
index, tpurt evaluates every table and selects, integrator.py:526-556).
The lanes cover r = 0, radii beyond the table's last node and
sigma_t = 0.  Tolerance found: 2e-6 relative to each function's largest
value (the spline weights, einsum and Newton steps round differently in
XLA and torch; measured worst 5.3e-7, bss_sw's).

Outside the path step tpurt never takes the hop (integrator.py:1053): a
subsurface surface is glass under bdpt, sppm and volpath on a scene with
media (ROADMAP Queue 3), and so it is in the port: the tiny subsurface
scene renders under each exactly as the scene with both materials
written as glass of the same eta.  tpurt's side of that: its own material
table of the scene has the glass scene's kinds and gives the same lobes
through its fetch_lobes (the rows differ only in the kdsubsurface's Kd,
which a glass kind does not read), and its bdpt, sppm and volpath read
the rows through fetch_lobes only and read no bss, bss_tix or has_bssrdf,
so no tpurt render is needed; the port's glass under each
integrator is held against tpurt's in that integrator's own tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.render.bssrdf as tb
import tpurt_torch.render.bssrdf as pb

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

KEYS = ((0.0, 1.33), (0.3, 1.5))
N = 4096
RTOL = 2e-6


def _lanes(seed=0):
    rng = np.random.default_rng(seed)
    sigma_t = rng.uniform(0.5, 20.0, (N, 3)).astype(np.float32)
    sigma_t[::17] = 0.0  # sigma_t = 0
    rho = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    rho[::13] = 1.0
    r = (rng.uniform(0, 1, N) ** 3 * 2.0).astype(np.float32)
    r[::7] = 0.0  # r = 0
    r[3::11] = rng.uniform(50, 500, len(r[3::11]))  # beyond the table
    u = rng.uniform(0, 1, N).astype(np.float32)
    tix = rng.integers(0, len(KEYS), N)
    return sigma_t, rho, r, u, tix


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def test_device_functions_match_tpurt():
    hosts = [tb.compute_beam_diffusion_table(g, e) for g, e in KEYS]
    t_tbls = [tb.BSSTable(h) for h in hosts]
    p_tbl = pb.tables_to_device(pb.stack_tables(
        [pb.compute_beam_diffusion_table(g, e) for g, e in KEYS]), "cpu")
    sigma_t, rho, r, u, tix = _lanes()
    pt = torch.tensor(tix)
    j = jnp.asarray

    def select(fn, extra_axis=False):
        """tpurt's value of table tix on each lane."""
        outs = [np.asarray(fn(t)) for t in t_tbls]
        m = tix[:, None] if extra_axis else tix
        return np.where(m == 1, outs[1], outs[0])

    want = select(lambda t: tb.bss_sr(t, j(sigma_t), j(rho), j(r)), True)
    got = pb.bss_sr(p_tbl, pt, torch.tensor(sigma_t), torch.tensor(rho),
                    torch.tensor(r))
    assert (want > 0).mean() > 0.3 and (want == 0).any()
    _close(got, want)
    for ch in range(3):
        s, rh = sigma_t[:, ch], rho[:, ch]
        want = select(lambda t: tb.bss_pdf_sr(t, j(s), j(rh), j(r)))
        got = pb.bss_pdf_sr(p_tbl, pt, torch.tensor(s), torch.tensor(rh),
                            torch.tensor(r))
        _close(got, want)
        want = select(lambda t: tb.bss_sample_sr(t, j(s), j(rh), j(u)))
        got = pb.bss_sample_sr(p_tbl, pt, torch.tensor(s), torch.tensor(rh),
                               torch.tensor(u))
        assert (want == -1).sum() == (s == 0).sum()
        _close(got, want)
    rng = np.random.default_rng(1)
    eta = rng.uniform(1.0, 2.0, N).astype(np.float32)
    cos_w = rng.uniform(-1, 1, N).astype(np.float32)
    _close(pb.bss_sw(torch.tensor(eta), torch.tensor(cos_w)),
           tb.bss_sw(j(eta), j(cos_w)))


FOG = ('WorldBegin\nMakeNamedMedium "fog" "string type" "homogeneous" '
       '"color sigma_a" [0.01 0.01 0.01] "color sigma_s" [0.02 0.02 0.02]\n'
       'MediumInterface "" "fog"')


@pytest.mark.parametrize("integrator", ["bdpt", "sppm", "volpath"])
def test_subsurface_is_glass_outside_the_path_step(integrator):
    from torch_subsurface_scenes import subsurface_tiny
    from tpurt_torch import testscenes as ts
    from tpurt_torch.render.driver import render
    from tpurt_torch.scene import load_scene_string

    text = subsurface_tiny(integrator, res=8)
    if integrator == "volpath":  # volpath's own step runs with media
        text = text.replace("WorldBegin", FOG, 1)
    if integrator == "sppm":
        text = text.replace('Integrator "sppm"', 'Integrator "sppm" '
                            '"integer numiterations" [2] "float radius" [0.3]')
    glass = text.replace(ts.SUBSURFACE_SKIN,
                         'Material "glass" "float eta" [1.33]').replace(
        ts.SUBSURFACE_KD, 'Material "glass" "float eta" [1.5]')
    from tpurt.render.materials_build import (
        build_material_table as t_build, fetch_lobes, fuse_material_rows)
    from tpurt.scene import load_scene_string as t_load

    def t_table(t):
        mats = []
        for pr in t_load(t).primitives:
            if all(m is not pr.material for m in mats):
                mats.append(pr.material)
        return t_build(mats)

    t_sub, t_glass = t_table(text), t_table(glass)
    assert t_sub.has_bssrdf and not t_glass.has_bssrdf
    np.testing.assert_array_equal(t_sub.kinds, t_glass.kinds)
    ids = jnp.arange(t_sub.n(), dtype=jnp.int32)
    for a, b in zip(*(fetch_lobes(jnp.asarray(fuse_material_rows(t)), ids)
                      for t in (t_sub, t_glass))):
        np.testing.assert_array_equal(a, b)
    img, job = render(load_scene_string(text), "cpu")
    assert job.scene.has_bssrdf and img.mean() > 0.01
    assert job.scene.has_media == (integrator == "volpath")
    np.testing.assert_array_equal(
        img, render(load_scene_string(glass), "cpu")[0])
