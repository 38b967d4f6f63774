"""The seven-slot BSDF of every material kind the slice adds (metal,
uber, substrate, translucent, thick and thin Disney, mix) against tpurt
on the CPU: the fused material table bit for bit, fetch_lobes field by
field, and bsdf_f / bsdf_pdf / bsdf_sample on each kind's lanes; then
the port's own checks: the gated BSDF equals the all-slots one, the slot
sets follow the kinds, the mix blend's closed form, and the sampling
consistency and energy checks of tpurt's test_bsdf.py.

Bounds: bsdf_f and bsdf_pdf at random directions and at tpurt's sampled
ones, and bsdf_sample's wi (where both sides sampled one), f and pdf,
within rtol 1e-5 / atol 1e-6 on >= 99% of a kind's lanes and within
rtol 1e-4 / atol 1e-6 on all, 2.5 times the worst lane measured (the test
names those lanes and why they differ); is_spec / is_trans equal.
Inputs come from numpy with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_material_scenes import KINDS, kinds_scene, unit
from tpurt.render import bsdf as tbsdf
from tpurt.render import materials_build as tmat
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.render import bsdf as pbsdf
from tpurt_torch.render import materials_build as pmat
from tpurt_torch.render.driver import host_tables
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

N = 8192
M = 640  # lanes of one kind compared


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def lobes():
    text = kinds_scene()
    job = tpurt_build_job(tpurt_load_scene_string(text))
    table = np.asarray(job.scene.mt_table)
    own = host_tables(load_scene_string(text))
    assert own["mt_table"].tobytes() == table.tobytes()  # bit for bit
    # tpurt lists metal's None slots as textured (and never evaluates
    # them); so does the port
    from tpurt_torch.convert import scene_from_tpurt

    textured = own["materials"]["textured"]
    assert textured == scene_from_tpurt(job)["materials"]["textured"]
    assert {s for _i, s in textured} == {"uroughness", "vroughness"}
    rng = np.random.default_rng(11)
    mat = rng.integers(-1, len(KINDS), N).astype(np.int32)
    want = tmat.fetch_lobes(job.scene.mt_table, jnp.asarray(mat),
                            has_mix=True)
    slots = pmat.lobe_slots(table)
    got = pmat.fetch_lobes(_t(table), _t(mat), None, slots)
    wo, wi = unit(rng, N), unit(rng, N)
    wi[::3, 2] = np.abs(wi[::3, 2]) * np.sign(wo[::3, 2])  # same side
    u = rng.uniform(size=(3, N)).astype(np.float32)
    return dict(table=table, mat=mat, want=want, got=got, slots=slots,
                wo=wo, wi=wi, u=u)


def test_table_holds_every_kind_and_the_mix_rows(lobes):
    table = lobes["table"]
    kinds = table[:, pmat.C_KIND].astype(int).tolist()
    assert kinds[:len(KINDS)] == [
        pmat.MAT_METAL, pmat.MAT_METAL, pmat.MAT_UBER, pmat.MAT_SUBSTRATE,
        pmat.MAT_TRANSLUCENT, pmat.MAT_DISNEY, pmat.MAT_DISNEY,
        pmat.MAT_MIX, pmat.MAT_MIX]
    # the mix sub-records are appended rows, their ids in C_MIX0
    mix = table[len(KINDS) - 2:len(KINDS), pmat.C_MIX0:pmat.C_MIX0 + 2]
    assert (mix >= len(KINDS)).all()
    assert table[len(KINDS) - 2, pmat.C_TR0] == np.float32(0.3)
    # copper k rides the fused row; metal's absent u/v roughness reads -1
    np.testing.assert_array_equal(table[0, pmat.C_FK30:pmat.C_FK30 + 3],
                                  pmat.COPPER_K_RGB.astype(np.float32))
    assert table[0, pmat.C_UROUGH] == table[0, pmat.C_VROUGH] == -1
    assert pmat.lobe_slots(table) == pbsdf.ALL_SLOTS


def test_fetch_lobes_matches_tpurt(lobes):
    got, want = lobes["got"], lobes["want"]
    for f in pbsdf.LobeParams._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g is not None, f  # every kind is in the table
        if g.dtype in (torch.int32, torch.bool):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), f)
        else:
            _close(g, w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_bsdf_matches_tpurt(lobes, kind):
    """bsdf_f, bsdf_pdf and bsdf_sample on the lanes of one kind (the
    first M of them: one lane count for every kind, so that JAX compiles
    each eager op of tpurt's BSDF once for all kinds)."""
    sel = np.nonzero(lobes["mat"] == KINDS.index(kind))[0]
    assert len(sel) >= M
    sel = sel[:M]
    keep = torch.as_tensor(sel)
    lp = pbsdf.LobeParams(*[None if f is None else f[keep]
                            for f in lobes["got"]])
    wlp = tbsdf.LobeParams(*[f[jnp.asarray(sel)] for f in lobes["want"]])
    wo, wi = lobes["wo"][sel], lobes["wi"][sel]
    slots = lobes["slots"]
    f_rand = (pbsdf.bsdf_f(lp, _t(wo), _t(wi), slots),
              tbsdf.bsdf_f(wlp, jnp.asarray(wo), jnp.asarray(wi)))
    pdf_rand = (pbsdf.bsdf_pdf(lp, _t(wo), _t(wi), slots),
                tbsdf.bsdf_pdf(wlp, jnp.asarray(wo), jnp.asarray(wi)))
    u = lobes["u"][:, sel]
    want = tbsdf.bsdf_sample(wlp, jnp.asarray(wo), *map(jnp.asarray, u))
    got = pbsdf.bsdf_sample(lp, _t(wo), *map(_t, u), slots)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    ok = (np.asarray(want[2]) > 0) & (got[2].numpy() > 0)
    assert ok.mean() > 0.2
    # f and pdf at random and at tpurt's sampled directions, and the
    # samples: a one-ulp difference of a transcendental or a norm (pow,
    # log, the VNDF's sqrt(1 - p1^2 - p2^2) near u1 = 1, GTR1's
    # 1 + (a2 - 1) cos^2 near its peak) grows where a sample is grazing or
    # sits on a sharp peak.  Measured at atol 1e-6: thin Disney's wi 1 lane
    # in 580 at 4.0e-5 relative, thick Disney's pdf (at its clearcoat peak)
    # 6 lanes in 640 at 3.1e-5, mix's f 1 lane in 640 at 2.1e-5; every
    # other kind and quantity within 1e-5 on every lane
    w_wi = np.asarray(want[0])
    f_at = (pbsdf.bsdf_f(lp, _t(wo), _t(w_wi), slots),
            tbsdf.bsdf_f(wlp, jnp.asarray(wo), want[0]))
    pdf_at = (pbsdf.bsdf_pdf(lp, _t(wo), _t(w_wi), slots),
              tbsdf.bsdf_pdf(wlp, jnp.asarray(wo), want[0]))
    for g, w, sel_ in ((got[0], want[0], ok), (got[1], want[1], None),
                       (got[2], want[2], None), f_rand + (None,),
                       pdf_rand + (None,), f_at + (None,),
                       pdf_at + (None,)):
        g, w = g.numpy(), np.asarray(w)
        if sel_ is not None:
            g, w = g[sel_], w[sel_]
        near = np.isclose(g, w, rtol=1e-5, atol=1e-6)
        assert near.reshape(len(g), -1).all(-1).mean() >= 0.99
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


# -- tpurt's test_bsdf.py checks, for the port ---------------------------------

def _lobes(n, **kw):
    """Port LobeParams of one lane's parameters (tpurt's zero_lobes
    defaults), broadcast to n lanes, with their activity."""
    z3, z1 = torch.zeros(n, 3), torch.zeros(n)
    f = dict(kd=z3, oren_a=z1 + 1, oren_b=z1, ks=z3, alpha_x=z1 + 1e-3,
             alpha_y=z1 + 1e-3, fresnel_kind=torch.zeros(n, dtype=torch.int32),
             eta=z1 + 1.5, eta3=z3 + 1, k3=z3, kr=z3, kt=z3, fs_kr=z3,
             kt_g=z3, t_alpha_x=z1 + 1e-3, t_alpha_y=z1 + 1e-3, cc=z1,
             cc_gloss=z1 + 0.1, kd_t=z3,
             disney=torch.zeros(n, dtype=torch.bool), metallic=z1,
             r0=z3 + 0.04, sheen=z3, retro=z3, kd_ss=z3, d_rough=z1 + 0.5)
    for k, v in kw.items():
        f[k] = torch.as_tensor(v, dtype=f[k].dtype).expand(f[k].shape)
    act = pbsdf.lobe_activity(**{k: f[k] for k in (
        "kd", "ks", "kr", "fs_kr", "kt", "kt_g", "cc", "kd_t", "retro",
        "sheen", "kd_ss")})
    return pbsdf.LobeParams(active=act, **f)


def _albedo_pair(kw, wo_z=0.7, seed=3, n=1 << 16, chunk=1 << 13):
    """(importance-sampled albedo, uniform-sphere albedo) of the lobe
    parameters ``kw`` over n directions, tpurt's test_bsdf._albedo_pair,
    in chunks small enough that torch runs each op on one thread."""
    rng = np.random.default_rng(seed)
    lp = _lobes(chunk, **kw)
    wo = torch.tensor([np.sqrt(1 - wo_z ** 2), 0.0, wo_z],
                      dtype=torch.float32).expand(chunk, 3)
    imp, uni = 0.0, 0.0
    for _ in range(n // chunk):
        u = [_t(rng.uniform(size=chunk).astype(np.float32)) for _ in range(3)]
        wi, f, pdf, _, _ = pbsdf.bsdf_sample(lp, wo, *u)
        est = torch.where((pdf > 0)[:, None], f * (wi[:, 2].abs()
                          / pdf.clamp(min=1e-20))[:, None], 0.0)
        z = rng.uniform(-1, 1, chunk).astype(np.float32)
        phi = rng.uniform(0, 2 * np.pi, chunk).astype(np.float32)
        r = np.sqrt(np.maximum(0, 1 - z * z))
        wiu = _t(np.stack([r * np.cos(phi), r * np.sin(phi), z], -1))
        fu = pbsdf.bsdf_f(lp, wo, wiu)
        imp = imp + est.mean(0).numpy()
        uni = uni + (fu * wiu[:, 2:3].abs()).mean(0).numpy() * 4 * np.pi
    return imp / (n // chunk), uni / (n // chunk)


CONSISTENCY = {
    "translucent": dict(kd=[.3, .3, .3], kd_t=[.3, .3, .3], ks=[.2, .2, .2],
                        kt_g=[.2, .2, .2], alpha_x=.2, alpha_y=.2,
                        t_alpha_x=.2, t_alpha_y=.2),
    "disney_diffuse_clearcoat": dict(
        kd=[.4, .2, .1], retro=[.4, .2, .1], sheen=[.1, .1, .1], disney=True,
        metallic=0.0, r0=[.04, .04, .04], d_rough=.5, ks=[1., 1., 1.],
        alpha_x=.25, alpha_y=.25, fresnel_kind=pbsdf.FRESNEL_DISNEY, cc=1.0,
        cc_gloss=.05, eta=1.5),
    "conductor": dict(ks=[1., 1., 1.], alpha_x=.15, alpha_y=.4,
                      fresnel_kind=pbsdf.FRESNEL_CONDUCTOR,
                      eta3=[.2, .92, 1.1], k3=[3.9, 2.45, 2.14]),
    "substrate": dict(kd=[.4, .3, .2], ks=[.2, .2, .2], alpha_x=.1,
                      alpha_y=.3, fresnel_kind=pbsdf.FRESNEL_SCHLICK),
}
