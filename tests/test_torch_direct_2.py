"""The direct-lighting textured slice against tpurt, on the CPU: part 2 of the
cases of test_torch_direct.py, in files of at most three cases so that
xdist's loadfile queue runs them beside the suite's long files.  Helpers,
fixtures and bounds are those of test_torch_direct.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import lights as tlights
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import lights as plights
from tpurt_torch.render import materials_build as pmat
from test_torch_direct import (  # noqa: F401  (fixtures among them)
    SPEC_SCENE,
    _close,
    _t,
    light_jobs,
    spec_lobes,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("strategy", ["spatial", "power"])
def test_sample_li_distant_spot_match_tpurt(light_jobs, strategy):
    job, pjob = light_jobs
    lt, plt = job.scene.lights, pjob.scene.lights
    rng = np.random.default_rng(4)
    n = 4096
    p = rng.uniform([-4, 0, -4], [4, 3, 4], (n, 3)).astype(np.float32)
    u = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)
    idx, pmf = tlights.choose_light(lt, jnp.asarray(u), strategy,
                                    p=jnp.asarray(p))
    pidx, ppmf = plights.choose_light(plt, _t(u), strategy, p=_t(p))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    _close(ppmf, pmf, rtol=0, atol=0)
    assert len(np.unique(np.asarray(idx))) == 4
    want = tlights.sample_li(lt, idx, jnp.asarray(p), jnp.asarray(u2))
    got = plights.sample_li(plt, pidx, _t(p), _t(u2))
    delta = np.asarray(want.is_delta)
    np.testing.assert_array_equal(got.is_delta.numpy(), delta)
    for f in ("wi", "li", "p_light"):
        _close(getattr(got, f).numpy()[delta], np.asarray(getattr(want, f))[delta])
    _close(got.pdf.numpy()[delta], np.asarray(want.pdf)[delta])
    spot = np.asarray(idx) == 1
    li = np.asarray(want.li)[spot]
    # lanes inside the cone, in its falloff band and outside it
    assert (li.max(-1) == 0).any() and (li.max(-1) > 0).any()


def test_lobe_slots_follow_the_material_kinds():
    """The slots the BSDF may skip: by kind, and for glass by roughness."""
    from tpurt_torch.render.driver import host_tables
    from tpurt_torch.scene import load_scene_string

    def slots(materials):
        text = SPEC_SCENE[:SPEC_SCENE.index('Material "mirror"')] + "".join(
            f'Material {m}\nShape "sphere"\n' for m in materials) + "WorldEnd"
        return pmat.lobe_slots(host_tables(load_scene_string(text))["mt_table"])

    assert slots(['"matte"']) == (pbsdf.SLOT_DIFFUSE,)
    assert slots(['"matte"', '"plastic"']) == (pbsdf.SLOT_DIFFUSE,
                                               pbsdf.SLOT_GLOSSY)
    assert slots(['"mirror"']) == (pbsdf.SLOT_MIRROR,)
    assert slots(['"glass"']) == (pbsdf.SLOT_FS,)
    assert slots(['"glass" "float uroughness" [.1]']) == (pbsdf.SLOT_GLOSSY,
                                                          pbsdf.SLOT_GTRANS)


def test_fetch_lobes_mirror_glass_match_tpurt(spec_lobes):
    _, want, got = spec_lobes
    for f in pbsdf.LobeParams._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "active" or g is None:  # None: a field no material needs
            continue
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, rtol=1e-6, atol=0)
    act = np.asarray(want.active)
    np.testing.assert_array_equal(got.active.numpy(), act)
    assert not act[:, 5:].any() and act[:, :5].any(axis=0).all()
