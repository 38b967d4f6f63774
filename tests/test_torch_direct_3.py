"""The direct-lighting textured slice against tpurt, on the CPU: part 3 of the
cases of test_torch_direct.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_direct.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.render import bsdf as tbsdf
from tpurt.render import interaction as tint
from tpurt.render import intersect as tix
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import interaction as pint
from tpurt_torch.render.driver import job_from_tables
from tpurt_torch.render.intersect import Hit
from tpurt_torch.testscenes import textured_scene
from tpurt_torch.testscenes import write_grid_texture
from test_torch_direct import (  # noqa: F401  (fixtures among them)
    _close,
    _t,
    _unit,
    spec_lobes,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_bsdf_with_skipped_slots_equals_all_slots(spec_lobes):
    """On lanes whose lobes lie within a subset of the slots, the BSDF
    told to skip the others returns exactly what it returns when it
    computes them all and masks."""
    rng, _, lp = spec_lobes
    n = lp.kd.shape[0]
    wo, wi = _t(_unit(rng, n)), _t(_unit(rng, n))
    u = [_t(x) for x in rng.uniform(size=(3, n)).astype(np.float32)]
    for slots in map(pbsdf.LobeSet, ((0, 1), (2,), (3,), (1, 4), (0, 1, 2))):
        outside = [k for k in pbsdf.ALL_SLOTS if k not in slots]
        keep = ~lp.active[:, outside].any(dim=-1)
        assert keep.sum() > 500
        sub = pbsdf.LobeParams(*[None if f is None else f[keep] for f in lp])
        w, i = wo[keep], wi[keep]
        assert torch.equal(pbsdf.bsdf_f(sub, w, i, slots),
                           pbsdf.bsdf_f(sub, w, i))
        assert torch.equal(pbsdf.bsdf_pdf(sub, w, i, slots),
                           pbsdf.bsdf_pdf(sub, w, i))
        uk = [x[keep] for x in u]
        for a, b in zip(pbsdf.bsdf_sample(sub, w, *uk, slots),
                        pbsdf.bsdf_sample(sub, w, *uk)):
            assert torch.equal(a, b)


def test_bsdf_sample_mirror_glass_match_tpurt(spec_lobes):
    """f, pdf and the specular / transmission flags of every lobe, for wo
    on both sides of the surface (glass is entered and left)."""
    rng, want_lp, got_lp = spec_lobes
    n = want_lp.kd.shape[0]
    wo, wi = _unit(rng, n), _unit(rng, n)
    _close(pbsdf.bsdf_f(got_lp, _t(wo), _t(wi)),
           tbsdf.bsdf_f(want_lp, jnp.asarray(wo), jnp.asarray(wi)))
    _close(pbsdf.bsdf_pdf(got_lp, _t(wo), _t(wi)),
           tbsdf.bsdf_pdf(want_lp, jnp.asarray(wo), jnp.asarray(wi)))
    u = rng.uniform(size=(3, n)).astype(np.float32)
    want = tbsdf.bsdf_sample(want_lp, jnp.asarray(wo), *map(jnp.asarray, u))
    got = pbsdf.bsdf_sample(got_lp, _t(wo), *map(_t, u))
    ok = np.asarray(want[2]) > 0
    assert ok.mean() > 0.4
    _close(got[0].numpy()[ok], np.asarray(want[0])[ok], atol=2e-6)  # wi
    _close(got[1], want[1], rtol=1e-4)  # f: 1/|cos| near grazing
    _close(got[2], want[2])  # pdf
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    spec, trans = np.asarray(want[3]), np.asarray(want[4])
    assert (spec & ok).any() and (trans & ok & spec).any()
    assert (trans & ok & ~spec).any()  # rough glass transmission


def test_interaction_uv_derivatives_match_tpurt(tmp_path):
    """uv, dpdu and dpdv on triangles with and without uvs and on a
    sphere."""
    text = textured_scene("small", write_grid_texture(
        str(tmp_path / "grid_i.png")))
    job = tpurt_build_job(tpurt_load_scene_string(text))
    pjob = job_from_tables(scene_from_tpurt(job), "cpu")
    assert job.scene.has_texfilter and pjob.scene.has_texfilter
    rng = np.random.default_rng(2)
    n = 3000
    p_film = (rng.uniform(size=(n, 2)) * 32).astype(np.float32)
    p_lens = rng.uniform(size=(n, 2)).astype(np.float32)
    o, d, _ = job.camera.generate_rays(jnp.asarray(p_film),
                                       jnp.asarray(p_lens), None)
    hit = tix.intersect_closest(job.scene.geo, o, d, jnp.inf)
    want = tint.compute_interaction(job.scene.geo, hit, o, d, dpduv=True)
    got = pint.compute_interaction(
        pjob.scene.geo, Hit(_t(hit.t), _t(hit.prim), _t(hit.b0), _t(hit.b1)),
        _t(o), _t(d), dpduv=True)
    valid = np.asarray(want.valid)
    assert 0.3 < valid.mean() < 1.0
    for f in ("uv", "dpdu", "dpdv"):
        _close(getattr(got, f).numpy()[valid],
               np.asarray(getattr(want, f))[valid], atol=1e-5)
    assert abs(pjob.camera.fp_slope - job.camera.fp_slope) < 1e-9
