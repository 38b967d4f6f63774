"""The port's texture evaluation against tpurt's, on the CPU.

The same TextureRecords (each package parses the same scene text) are
evaluated over the same lanes, made from a numpy seed.  tpurt's functions
run eagerly, one XLA op at a time.  Tolerances:

- every texture class, the slot overrides and bump: 1e-5 abs (float32
  arithmetic in the same order; sin, exp and log2 differ in the last ulp);
- trilinear and EWA lookups: 2e-5 abs on >= 99.9% of lanes.  The weighted
  tap sums are taken in another order (one reduction here, an unrolled
  running sum there), and a tap whose ellipse radius lies within an ulp of
  1 may fall on the other side on a rare lane.

EWA is held against tpurt twice.  With ``set_config(ewa_blocked=False)``
tpurt runs its 13-tap oracle at the 2.9 anisotropy clamp, which is the
port's first tier (all of it at ``max_aniso=2.9``).  With tpurt's default it adds the
wide pass at anisotropy 8, but only for as many lanes of a batch as its
budget allows (max(min(n, 128), n // 8)); the port has no such budget, so
that comparison uses a grazing plane on which the lanes over 2.9 stay
under tpurt's budget, and asserts that they do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.config import get_config, set_config
from tpurt.render import interaction as tint
from tpurt.render import texeval as TT
from tpurt.render.materials_build import (MaterialIndexer,
                                          build_material_table,
                                          fuse_material_rows)
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.io.image import write_image
from tpurt_torch.render import interaction as pint
from tpurt_torch.render import materials_build as pmat
from tpurt_torch.render import texeval as PT
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

N = 256  # 16x16 lanes: tpurt's tap oracle unrolls 169 gathers


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)))


def _si(cls, conv, n=N, seed=0, **extra):
    """The same random lanes as either package's SurfaceInteraction."""
    rng = np.random.default_rng(seed)
    f = dict(p=rng.uniform(-3, 3, (n, 3)), uv=rng.uniform(-0.5, 2.5, (n, 2)),
             ng=np.tile([0.0, 0.0, 1.0], (n, 1)),
             ns=np.tile([0.0, 0.0, 1.0], (n, 1)), wo=np.zeros((n, 3)))
    f = {k: conv(v.astype(np.float32)) for k, v in f.items()}
    f.update(material_id=conv(np.zeros(n, np.int32)),
             arealight_id=conv(np.full(n, -1, np.int32)),
             prim=conv(np.zeros(n, np.int32)), valid=conv(np.ones(n, bool)))
    f.update({k: conv(np.asarray(v)) for k, v in extra.items()})
    return cls(**f)


def _pair(seed=0, **extra):
    return (_si(tint.SurfaceInteraction, jnp.asarray, seed=seed, **extra),
            _si(pint.SurfaceInteraction, _t, seed=seed, **extra))


TEXTURES = """
Texture "t_const" "spectrum" "constant" "color value" [.2 .5 .7]
Texture "t_scale" "spectrum" "scale" "texture tex1" "t_const" "color tex2" [.5 2 1]
Texture "t_fbm" "float" "fbm" "integer octaves" [4] "float roughness" [.6]
Texture "t_mix" "spectrum" "mix" "texture tex1" "t_const" "color tex2" [.9 .1 .1]
  "texture amount" "t_fbm"
Texture "t_bilerp" "spectrum" "bilerp" "color v00" [1 0 0] "color v01" [0 1 0]
  "color v10" [0 0 1] "color v11" [1 1 0]
Texture "t_uv" "spectrum" "uv" "float uscale" [3] "float vdelta" [.25]
Texture "t_check" "spectrum" "checkerboard" "float uscale" [6] "float vscale" [5]
  "color tex1" [.9 .9 .9] "color tex2" [.15 .2 .3]
Texture "t_check3" "spectrum" "checkerboard" "integer dimension" [3]
  "color tex1" [.9 .1 .9] "texture tex2" "t_const"
Texture "t_dots" "spectrum" "dots" "float uscale" [4] "float vscale" [4]
  "color inside" [1 .5 0] "texture outside" "t_const"
Texture "t_planar" "spectrum" "checkerboard" "string mapping" "planar"
  "vector v1" [1 0 .5] "vector v2" [0 1 0]
Texture "t_sph" "spectrum" "uv" "string mapping" "spherical"
Texture "t_cyl" "spectrum" "uv" "string mapping" "cylindrical"
TransformBegin
Scale 2 3 1.5
Rotate 30 0 1 1
Texture "t_wrinkled" "float" "wrinkled" "integer octaves" [3]
Texture "t_windy" "float" "windy"
Texture "t_marble" "spectrum" "marble" "float scale" [1.5] "float variation" [.3]
TransformEnd
Texture "t_image" "spectrum" "imagemap" "string filename" "{img}"
  "float uscale" [2] "float scale" [.8]
Texture "t_image_clamp" "spectrum" "imagemap" "string filename" "{img}"
  "string wrap" "clamp"
Texture "t_image_black" "spectrum" "imagemap" "string filename" "{img}"
  "string wrap" "black" "float maxanisotropy" [2]
"""
SPECTRUM = ["t_const", "t_scale", "t_mix", "t_bilerp", "t_uv", "t_check",
            "t_check3", "t_dots", "t_planar", "t_sph", "t_cyl", "t_marble",
            "t_image", "t_image_clamp", "t_image_black"]
FLOAT = ["t_fbm", "t_wrinkled", "t_windy"]


def _scene_text(img):
    mats = "".join(
        f'Material "matte" "texture Kd" "{n}"\nShape "sphere"\n'
        for n in SPECTRUM) + "".join(
        f'Material "matte" "texture sigma" "{n}" "texture bumpmap" "{n}"\n'
        f'Shape "sphere"\n' for n in FLOAT)
    return ('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
            'Camera "perspective"\nWorldBegin\n'
            + TEXTURES.format(img=img) + mats + "WorldEnd\n")


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """A non-square random image with smooth structure (so that filtered
    lookups differ by level); 37x53 halves to 1x1 in the same number of
    steps on both axes, which the pyramid code of both packages needs."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:37, 0:53]
    img = (0.5 + 0.3 * np.sin(xx / 3.0)[..., None] * np.cos(yy / 5.0)[..., None]
           + 0.2 * rng.random((37, 53, 3))).astype(np.float32)
    p = str(tmp_path_factory.mktemp("tex") / "texeval_rand.pfm")
    write_image(p, img)
    return p


@pytest.fixture(scope="module")
def records(image):
    text = _scene_text(image)
    out = {}
    for tag, load in (("tpurt", tpurt_load_scene_string),
                      ("port", load_scene_string)):
        sd = load(text)
        mats = [pr.material for pr in sd.primitives]
        recs = {n: m.slots["Kd"][1] for n, m in zip(SPECTRUM, mats)}
        recs.update({n: m.slots["sigma"][1]
                     for n, m in zip(FLOAT, mats[len(SPECTRUM):])})
        out[tag] = (recs, mats)
    return out


# (image maps under derivative vectors are EWA lookups: tested below)
EVAL_CASES = [(n, f) for f in ("none", "widths", "derivatives")
              for n in SPECTRUM + FLOAT
              if not (f == "derivatives" and "image" in n)]


@pytest.mark.parametrize("name,footprint", EVAL_CASES)
def test_eval_texture_matches_tpurt(records, name, footprint):
    extra = {}
    rng = np.random.default_rng(11)
    if footprint != "none":
        extra = dict(tex_wu=rng.uniform(1e-4, 0.2, N).astype(np.float32),
                     tex_wv=rng.uniform(1e-4, 0.2, N).astype(np.float32))
    if footprint == "derivatives":
        extra.update(
            tex_dst0=rng.normal(scale=0.05, size=(N, 2)).astype(np.float32),
            tex_dst1=rng.normal(scale=0.05, size=(N, 2)).astype(np.float32))
    tsi, psi = _pair(seed=3, **extra)
    for want3 in (True, False):
        want = np.asarray(TT.eval_texture(records["tpurt"][0][name], tsi,
                                          want3))
        got = PT.eval_texture(records["port"][0][name], psi, want3).numpy()
        assert got.shape == want.shape == ((N, 3) if want3 else (N,))
        if "image" in name and footprint == "widths":  # trilinear
            ok = np.abs(got - want) <= 2e-5
            assert ok.mean() >= 0.999
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.ptp(want) > 0 or name in ("t_const", "t_scale")


def test_texture_overrides_and_bump_match_tpurt(records):
    """make_texture_eval over lanes of mixed material ids: each slot's
    override where the material has the texture, the table's constant
    elsewhere; and the bump-mapped shading normals."""
    trecs = records["tpurt"][1]
    precs = records["port"][1]
    idx = MaterialIndexer()
    for m in trecs:
        idx(m)
    mt = build_material_table(idx.materials)
    table = fuse_material_rows(mt)
    pmt = pmat.build_material_table(precs)
    ptextured = pmt.textured
    assert pmat.fuse_material_rows(pmt).tobytes() == table.tobytes()
    assert ptextured == [(int(i), s) for i, s in mt.textured]
    rng = np.random.default_rng(5)
    mat = rng.integers(-1, len(precs), N).astype(np.int32)
    dp = rng.normal(size=(2, N, 3)).astype(np.float32)
    tsi, psi = _pair(seed=6, material_id=mat, dpdu=dp[0], dpdv=dp[1])
    teval = TT.make_texture_eval(mt, jnp.asarray(table))
    peval = PT.make_texture_eval(precs, ptextured, _t(table))
    want, got = teval(tsi), peval(psi)
    assert sorted(got) == sorted(want) == ["Kd", "sigma"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    wns = np.asarray(teval.bump(tsi).ns)
    gns = peval.bump(psi).ns.numpy()
    moved = np.abs(wns - np.asarray(tsi.ns)).max(-1) > 1e-3
    assert moved.sum() > 10 and not moved[mat < len(SPECTRUM)].any()
    # the finite difference divides noise by 5e-4: 1e-5 of noise is 2e-2
    # of slope, so hold the normals to 2e-3 where tpurt's own step is
    # resolved and to the same lanes moved
    np.testing.assert_allclose(gns, wns, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(
        np.abs(gns - psi.ns.numpy()).max(-1) > 1e-3, moved)


def test_unported_texture_class_raises(records):
    """A texture class the port does not evaluate raises
    NotImplementedError by name.  Every class tpurt knows is ported, ptex
    last: a ptex texture passes the check and, evaluated without its
    file's table (make_texture_eval loads it a job), raises ValueError
    naming the texture and the file."""
    rec = records["port"][0]["t_const"]
    bad = type(rec)("noise", "spectrum", {})
    with pytest.raises(NotImplementedError, match="noise"):
        PT.check_texture(bad)
    with pytest.raises(NotImplementedError, match="noise"):
        PT.eval_texture(bad, _pair()[1], True)
    ptex = type(rec)("ptex", "spectrum", {"filename": "x.ptx", "gamma": 2.2})
    PT.check_texture(ptex)
    with pytest.raises(ValueError, match='Texture "ptex".*x.ptx'):
        PT.eval_texture(ptex, _pair()[1], True)


def _footprints(rng, n, max_ratio):
    """uv derivative vectors from sub-texel to anisotropic."""
    mag0 = rng.random(n) * 0.08 + 1e-4
    mag1 = mag0 / (1.0 + rng.random(n) * (max_ratio - 1.0))
    ang = rng.random(n) * np.pi
    d0 = np.stack([np.cos(ang), np.sin(ang)], -1) * mag0[:, None]
    d1 = np.stack([-np.sin(ang), np.cos(ang)], -1) * mag1[:, None]
    swap = rng.random(n) < 0.5
    return (np.where(swap[:, None], d1, d0).astype(np.float32),
            np.where(swap[:, None], d0, d1).astype(np.float32))


@pytest.fixture
def taps_oracle():
    old = get_config().ewa_blocked
    set_config(ewa_blocked=False)
    yield
    set_config(ewa_blocked=old)
