"""The seven-slot BSDF of every material kind the slice adds against tpurt:
part 2 of the cases of test_torch_materials.py, in files of at most three
cases so that xdist's loadfile queue runs them beside the suite's long
files.  Helpers, fixtures and bounds are those of test_torch_materials.py.
"""

import numpy as np
import pytest
import torch

from torch_material_scenes import KINDS
from torch_material_scenes import kinds_scene
from torch_material_scenes import unit
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import materials_build as pmat
from tpurt_torch.render.driver import host_tables
from tpurt_torch.scene import load_scene_string
from test_torch_materials import (  # noqa: F401  (fixtures among them)
    _t,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("kind", KINDS)
def test_gated_bsdf_equals_all_slots(kind):
    """A table of one kind: fetch_lobes and the BSDF told what the table
    can activate (its LobeSet: slots, Fresnel kinds, Disney, mix) return
    exactly what they return computing every slot and term."""
    text = kinds_scene((kind,))
    table = host_tables(load_scene_string(text))["mt_table"]
    slots = pmat.lobe_slots(table)
    assert len(slots) < len(pbsdf.ALL_SLOTS)
    rng = np.random.default_rng(4)
    n = 2048
    mat = _t(np.zeros(n, np.int32))
    gated = pmat.fetch_lobes(_t(table), mat, None, slots)
    full = pmat.fetch_lobes(_t(table), mat, None, pbsdf.ALL_SLOTS)
    wo, wi = _t(unit(rng, n)), _t(unit(rng, n))
    u = [_t(x) for x in rng.uniform(size=(3, n)).astype(np.float32)]
    assert torch.equal(pbsdf.bsdf_f(gated, wo, wi, slots),
                       pbsdf.bsdf_f(full, wo, wi))
    assert torch.equal(pbsdf.bsdf_pdf(gated, wo, wi, slots),
                       pbsdf.bsdf_pdf(full, wo, wi))
    for a, b in zip(pbsdf.bsdf_sample(gated, wo, *u, slots),
                    pbsdf.bsdf_sample(full, wo, *u)):
        assert torch.equal(a, b)


def test_lobe_sets_follow_the_kinds():
    def lobe_set(kind):
        text = kinds_scene((kind,))
        return pmat.lobe_slots(host_tables(load_scene_string(text))[
            "mt_table"])

    S = pbsdf
    metal = lobe_set("metal")
    assert metal == (S.SLOT_GLOSSY,) and not metal.disney and not metal.mix
    assert S.FRESNEL_CONDUCTOR in metal.fresnel
    assert lobe_set("substrate").fresnel == (S.FRESNEL_SCHLICK,)
    assert lobe_set("uber") == (S.SLOT_DIFFUSE, S.SLOT_GLOSSY, S.SLOT_MIRROR,
                                S.SLOT_FS)
    assert lobe_set("translucent") == (S.SLOT_DIFFUSE, S.SLOT_GLOSSY,
                                       S.SLOT_GTRANS, S.SLOT_DTRANS)
    thick = lobe_set("disney")
    assert thick.disney and S.SLOT_CLEARCOAT in thick
    assert S.SLOT_DTRANS not in thick  # not thin
    assert S.SLOT_DTRANS in lobe_set("disney_thin")
    mix = lobe_set("mix")  # the union of metal's and matte's
    assert mix == (S.SLOT_DIFFUSE, S.SLOT_GLOSSY) and mix.mix


def test_mix_blends_submaterials_in_closed_form():
    """tpurt's test_mix_material_blends_submaterials (test_render.py:223)
    for the port: a mix of two mattes is the amount-weighted blend of
    their Kd, and the blended lobe is the matte of that Kd."""
    text = """Film "image" "integer xresolution" [4] "integer yresolution" [4]
Camera "perspective"
WorldBegin
MakeNamedMaterial "a" "string type" "matte" "color Kd" [.8 .2 .1]
MakeNamedMaterial "b" "string type" "matte" "color Kd" [.1 .3 .9]
Material "mix" "string namedmaterial1" "a" "string namedmaterial2" "b"
  "color amount" [.25 .5 .75]
Translate 0 0 4
Shape "sphere"
WorldEnd
"""
    table = host_tables(load_scene_string(text))["mt_table"]
    lp = pmat.fetch_lobes(_t(table), _t(np.zeros(4, np.int32)), None,
                          pmat.lobe_slots(table))
    amt = np.array([.25, .5, .75], np.float32)
    want = amt * np.array([.8, .2, .1], np.float32) + (1 - amt) * np.array(
        [.1, .3, .9], np.float32)
    np.testing.assert_allclose(lp.kd.numpy(), np.tile(want, (4, 1)),
                               rtol=1e-6)
    assert lp.active[:, pbsdf.SLOT_DIFFUSE].all()
    assert not lp.active[:, 1:].any()
