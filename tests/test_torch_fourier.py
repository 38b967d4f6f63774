"""The Fourier tabulated BSDF against tpurt on the CPU
(tpurt_torch/render/fourier.py): .bsdf files across both packages, the
baked tables, and fourier_f, fourier_pdf and fourier_sample on the
synthetic glossy table of frame M (3 channels, up to 8 orders a cell) on
seeded directions; the raise for a missing or unreadable .bsdf file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import fourier as tf
from tpurt_torch.render import fourier as pf
from tpurt_torch.testscenes import glossy_fourier_table

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope="module")
def tables():
    """(tpurt's FourierTableDev, the port's, the host table) of the
    glossy table at 24 mu nodes."""
    host = glossy_fourier_table(n_mu=24)
    assert host.m.max() == 8 and (host.m == 1).any()
    return (tf.bake_fourier_table(host),
            pf.table_to_device(pf.bake_fourier_table(host), "cpu"), host)


def _dirs(rng, n, lower=False):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) * (-1 if lower else 1)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rel_close(got, want, rtol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_bsdf_files_and_baking_match_tpurt(tmp_path, tables):
    """A table written by either package reads back equal in the other;
    the baked values and cumulative tables are tpurt's; the Lambertian
    table is tpurt's; a missing, foreign or absent .bsdf file raises
    ValueError naming Material "fourier" (tpurt renders it black)."""
    from tpurt_torch.render.materials_build import build_material_table
    from tpurt_torch.scene.records import MaterialRecord

    t_dev, p_dev, host = tables
    for name, writer, reader in (("port", pf, tf), ("tpurt", tf, pf)):
        p = str(tmp_path / f"{name}.bsdf")
        writer.write_bsdf_file(p, host)
        got = reader.read_bsdf_file(p)
        for k in ("mu", "cdf", "a0", "m", "a_offset", "a"):
            want = np.asarray(getattr(host, k))
            if want.dtype.kind == "f":  # the file holds float32
                want = want.astype(np.float32)
            np.testing.assert_array_equal(getattr(got, k).astype(want.dtype),
                                          want)
        assert got.eta == np.float32(host.eta) and got.n_channels == 3
    for k in t_dev._fields:
        np.testing.assert_array_equal(getattr(p_dev, k).numpy(),
                                      np.asarray(getattr(t_dev, k)))
    lam_t, lam_p = tf.make_lambertian_table(0.6), pf.make_lambertian_table(0.6)
    for k in ("mu", "cdf", "a0", "m", "a_offset", "a"):
        np.testing.assert_array_equal(getattr(lam_p, k), getattr(lam_t, k))

    def build(fname):
        return build_material_table([MaterialRecord(
            "fourier", {"bsdffile": ("constant", fname)})])

    ok = str(tmp_path / "port.bsdf")
    mt = build(ok)
    assert mt.fourier_tix.tolist() == [0] and len(mt.fourier_tables) == 1
    missing = str(tmp_path / "missing.bsdf")
    foreign = tmp_path / "foreign.bsdf"
    foreign.write_bytes(b"NOTSCAT" + b"\0" * 80)
    for fname in (missing, str(foreign)):
        with pytest.raises(ValueError, match=f'Material "fourier".*{fname}'):
            build(fname)
    with pytest.raises(ValueError, match='Material "fourier": no'):
        build("")


def test_fourier_f_and_pdf_match_tpurt(tables):
    """f and pdf on 4,096 seeded direction pairs, reflection and
    transmission, within 1e-5 relative."""
    t_dev, p_dev, host = tables
    rng = np.random.default_rng(0)
    wo = _dirs(rng, N)
    wi = np.concatenate([_dirs(rng, N // 2, lower=True),
                         _dirs(rng, N // 2)])
    # half the pairs about the mirror direction, where the lobe is
    wi[: N // 4] = -wo[: N // 4] * [1, 1, -1] + rng.normal(
        0, 0.05, (N // 4, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    f_t = tf.fourier_f(t_dev, host.eta, jnp.asarray(wo), jnp.asarray(wi))
    f_p = pf.fourier_f(p_dev, host.eta, torch.tensor(wo), torch.tensor(wi))
    _rel_close(f_p.numpy(), f_t)
    assert (f_p > 0).all(-1).float().mean() > 0.5
    pdf_t = tf.fourier_pdf(t_dev, jnp.asarray(wo), jnp.asarray(wi))
    pdf_p = pf.fourier_pdf(p_dev, torch.tensor(wo), torch.tensor(wi))
    _rel_close(pdf_p.numpy(), pdf_t)


def test_fourier_sample_matches_tpurt(tables):
    """Sampled directions, f and pdf on 4,096 seeded lanes within 1e-5
    relative, and the azimuth's bisection cell (of the 511 between the
    baked phi nodes) equal on >= 99.9% of lanes."""
    t_dev, p_dev, host = tables
    rng = np.random.default_rng(1)
    wo = _dirs(rng, N)
    u0, u1 = rng.uniform(0, 1, (2, N)).astype(np.float32)
    want = tf.fourier_sample(t_dev, host.eta, jnp.asarray(wo),
                             jnp.asarray(u0), jnp.asarray(u1))
    got = pf.fourier_sample(p_dev, host.eta, torch.tensor(wo),
                            torch.tensor(u0), torch.tensor(u1))
    wi_t, wi_p = np.asarray(want[0]), got[0].numpy()

    def cell(wi):
        phi = np.arccos(np.clip(np.asarray(tf._cos_dphi(
            jnp.asarray(-wi), jnp.asarray(wo))), -1, 1))
        return np.floor(phi / (np.pi / (pf.N_PHI - 1))).astype(int)

    assert (cell(wi_p) == cell(wi_t)).mean() >= 0.999
    ok = np.asarray(want[2]) > 0
    assert ok.mean() > 0.9
    same = cell(wi_p) == cell(wi_t)
    _rel_close(wi_p[ok & same], wi_t[ok & same])
    _rel_close(got[1].numpy()[same], np.asarray(want[1])[same])
    _rel_close(got[2].numpy()[same], np.asarray(want[2])[same])
