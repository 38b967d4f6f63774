"""The port's geometry upload and ray queries against tpurt's.

Inputs come from numpy.random.default_rng and go through both packages on
the CPU: tpurt's functions (jax) and the port's plain versions (torch).
tpurt functions called eagerly run one XLA op at a time, so they round
exactly like the port's one-op-at-a-time torch code; inside tpurt's jitted
while-loop traversal XLA's CPU backend contracts a*b+c into FMAs (the port
never does), which is the reason for the atol on traversal t values:
four ulp of the scenes' largest coordinate (10), where a contracted edge
function rounds differently.

Both packages have two SAH builders, the C++ one (built with g++ at first
use) and a numpy fallback.  They give the same tree shape, but the C++ one
stores every node box one float wider (``nextafterf`` outward on each
bound) while the fallback stores the exact float32 bounds, and primitives
with identical boxes may land in each other's leaves (the C++ partition
is not stable).  The bit-for-bit table test therefore makes the port
build with the same one of the two as tpurt did.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.geom.wbvh import LEAF_K, REC, SLOT_KIND, WIDTH
from tpurt.render import intersect as tix
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.render.geometry_build import PT_SPHERE
from tpurt.scene import load_scene_string as tpurt_load_scene_string
import tpurt.native as tpurt_native
import tpurt_torch.native as port_native
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.geom.bvh import build_bvh
from tpurt_torch.kernels import build as kbuild
from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render import intersect as pix
from tpurt_torch.render.driver import host_tables, job_from_tables
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import mixed_scene, standin_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

T_ATOL = 4 * float(np.spacing(np.float32(10.0)))

KERNELS_SCENE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [60]
WorldBegin
Material "matte" "color Kd" [.5 .5 .5]
Shape "trianglemesh"
  "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10
             -1 -1 -1  1 -1 -1  0 1 0]
  "integer indices" [0 1 2 2 3 0 4 5 6]
WorldEnd
"""


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, text in (("kernels", KERNELS_SCENE), ("mesh", mixed_scene()),
                       ("standin", standin_scene("small"))):
        job = tpurt_build_job(tpurt_load_scene_string(text))
        out[name] = (text, job,
                     job_from_tables(scene_from_tpurt(job), "cpu"))
    return out


def _rays(rng, n, lo=-3.0, hi=3.0, aim=None):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    if aim is None:
        d = rng.normal(size=(n, 3))
    else:
        d = aim + rng.normal(scale=0.6, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _assert_same_tables(a, b, path="tables"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_tables(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path  # bit for bit, NaNs too
    else:
        assert a == b, path


def _fallback_widened(lo, hi, max_leaf=1):
    """The C++ builder's result from the numpy builder: the same tree with
    every bound moved one float outward (build_bvh_native's signature)."""
    b = build_bvh(lo, hi, max_leaf, use_native=False)
    return (np.nextafter(b.bounds_lo, np.float32(-np.inf)),
            np.nextafter(b.bounds_hi, np.float32(np.inf)), b.right_child,
            b.prim_offset, b.n_prims, b.axis, b.prim_order)


def _build_like_tpurt(monkeypatch):
    """Make the port's SAH build use the same kind of builder as tpurt's
    did for its jobs (its library is loaded once a process; reading it
    changes nothing)."""
    if tpurt_native.get_lib() is None:
        monkeypatch.setattr(port_native, "build_bvh_native",
                            lambda *a, **k: None)
    elif port_native.get_lib() is None:
        pytest.skip("tpurt built with its C++ builder and the port has "
                    "none (no g++ now): nothing of the port's to compare")


@pytest.mark.parametrize("name", ["kernels", "mesh", "standin"])
def test_scene_from_tpurt_tables_equal_port_build(scenes, name, monkeypatch):
    text, job, _ = scenes[name]
    _build_like_tpurt(monkeypatch)
    _assert_same_tables(scene_from_tpurt(job),
                        host_tables(load_scene_string(text)))


def test_port_sah_builders_agree_within_one_ulp(monkeypatch):
    """The port's C++ builder against its numpy fallback on the mesh
    scene: every table equal bit for bit once the fallback's boxes are
    widened by one float, so the two differ in the boxes only and by one
    ulp."""
    if port_native.get_lib() is None:
        pytest.skip("needs g++ (the port's native builder)")
    sd = load_scene_string(mixed_scene())
    native = host_tables(sd)
    with monkeypatch.context() as mp:
        mp.setattr(port_native, "build_bvh_native", _fallback_widened)
        _assert_same_tables(native, host_tables(sd))
    monkeypatch.setattr(port_native, "build_bvh_native", lambda *a, **k: None)
    fallback = host_tables(sd)
    a, b = native["geo"].pop("wnodes"), fallback["geo"].pop("wnodes")
    _assert_same_tables(native, fallback)
    interior = a[:, SLOT_KIND] == 0
    assert interior.any() and (~interior).any()
    boxes = np.zeros(a.shape, bool)
    boxes[interior, :6 * WIDTH] = True
    assert a[~boxes].tobytes() == b[~boxes].tobytes()  # topology, leaves
    lo, hi = a[interior, :3 * WIDTH], a[interior, 3 * WIDTH:6 * WIDTH]
    flo, fhi = b[interior, :3 * WIDTH], b[interior, 3 * WIDTH:6 * WIDTH]
    np.testing.assert_array_equal(np.isnan(lo), np.isnan(flo))
    ok = ~np.isnan(lo)
    np.testing.assert_array_equal(
        lo[ok], np.nextafter(flo[ok], np.float32(-np.inf)))
    np.testing.assert_array_equal(
        hi[ok], np.nextafter(fhi[ok], np.float32(np.inf)))


@pytest.mark.parametrize("name", ["kernels", "mesh", "standin"])
def test_traversal_tables_hold_the_reachable_records(scenes, name):
    """The tables the CUDA kernel reads hold exactly the records reachable
    from row 0 of the host table, split by kind, and the uploaded geometry
    carries them."""
    _, _, pjob = scenes[name]
    geo = pjob.scene.geo
    wn = geo.wnodes.numpy()
    tab = pix.derive_traversal_tables(wn)
    irow, lrow = tab["irow"], tab["lrow"]
    # an independent walk of the host table from row 0
    seen, todo = set(), [0]
    while todo:
        row = todo.pop()
        seen.add(row)
        if wn[row, SLOT_KIND] == 0:
            kids = wn[row, 6 * WIDTH:7 * WIDTH].view(np.int32)
            todo += [int(k) for k, x in zip(kids, wn[row, :WIDTH])
                     if not np.isnan(x)]
    assert len(seen) == len(irow) + len(lrow)
    assert seen == set(irow.tolist()) | set(lrow.tolist())
    assert (wn[irow, SLOT_KIND] == 0).all() and (wn[lrow, SLOT_KIND] > 0).all()
    assert tab["inodes"].shape == (max(len(irow), 1), pix.INTERIOR_REC)
    assert tab["leaves"].shape == (max(len(lrow), 1), REC)
    assert geo.root_ref == tab["root_ref"]
    assert geo.inodes.numpy().tobytes() == tab["inodes"].tobytes()
    assert geo.leaves.numpy().tobytes() == tab["leaves"].tobytes()


@pytest.mark.parametrize("name", ["kernels", "mesh", "standin"])
def test_traversal_tables_decode_back_to_wnodes(scenes, name):
    """The derived tables decode back to the host records: boxes, vertices
    and prim rows bit for bit, and every rewritten child reference leads
    to the child's row."""
    _, _, pjob = scenes[name]
    wn = pjob.scene.geo.wnodes.numpy()
    tab = pix.derive_traversal_tables(wn)
    inodes, leaves = tab["inodes"], tab["leaves"]
    irow, lrow = tab["irow"], tab["lrow"]
    # leaves: the records as they are; interior: the 48 bounds
    assert leaves[:len(lrow)].tobytes() == wn[lrow].tobytes()
    assert (inodes[:len(irow), :6 * WIDTH].tobytes()
            == wn[irow, :6 * WIDTH].tobytes())
    # child references: 2 * packed row + kind, 0 where the child is absent
    ref = np.ascontiguousarray(
        inodes[:len(irow), 6 * WIDTH:7 * WIDTH]).view(np.int32)
    host = np.ascontiguousarray(wn[irow, 6 * WIDTH:7 * WIDTH]).view(np.int32)
    there = ~np.isnan(wn[irow, :WIDTH])
    back = np.where(ref & 1, lrow[np.minimum(ref >> 1, len(lrow) - 1)],
                    irow[np.minimum(ref >> 1, max(len(irow) - 1, 0))]
                    if len(irow) else 0)
    np.testing.assert_array_equal(back[there], host[there])
    assert not ref[~there].any()
    root = tab["root_ref"]
    assert (lrow if root & 1 else irow)[root >> 1] == 0


def test_traverse_twin_stack_overflow_stops_at_the_step_guard(scenes):
    """With fewer stack slots than the tree needs, dropped pushes read back
    as row 0 and a lane could restart at the root for ever; the twin stops
    every lane after one step per table row plus one, as the kernel does,
    and lanes that never overflow keep their results."""
    import dataclasses

    _, _, pjob = scenes["standin"]  # the smallest table with a deep tree
    geo = pjob.scene.geo
    rng = np.random.default_rng(9)
    n = 64
    o, d = (torch.as_tensor(x) for x in _rays(rng, n,
                                              aim=np.array([0.0, 1.0, 0.0])))
    tm = torch.full((n,), np.inf)
    full = ktr.traverse_wide_reference(geo, o, d, tm, any_hit=False)
    small = dataclasses.replace(geo, wstack_depth=1)
    work = {}
    cut = ktr.traverse_wide_reference(small, o, d, tm, any_hit=False,
                                      stats=work)
    steps = work["leaf_steps"] + work["interior_steps"]
    assert steps <= n * (geo.wnodes.shape[0] + 1)
    # the work counters: at most 8 children and one sort an interior read,
    # 12 triangles a leaf read, every record a row of the table
    assert 0 < work["children"] <= WIDTH * work["interior_steps"]
    assert 0 < work["triangles"] <= LEAF_K * work["leaf_steps"]
    assert work["sorts"] <= work["interior_steps"]
    assert work["hit_leaves"] <= work["leaf_records"] <= work["leaf_steps"]
    assert (work["interior_records"] + work["leaf_records"]
            <= geo.wnodes.shape[0])
    assert not torch.equal(cut[1], full[1])  # the short stack lost hits
    # a hit found with a short stack is a real hit, never closer than the
    # closest one
    hit = cut[1] >= 0
    assert hit.any() and (full[1][hit] >= 0).all()
    assert (cut[0][hit] >= full[0][hit]).all()


def test_tri_bundle_test_matches_tpurt():
    rng = np.random.default_rng(11)
    n = 512
    o, d = _rays(rng, n)
    rec = np.zeros((n, REC), np.float32)
    rec[:, :9 * LEAF_K] = rng.uniform(-2, 2, (n, 9 * LEAF_K))
    rec[:, 8 * LEAF_K + 10:9 * LEAF_K] = np.nan  # last slots are NaN pads
    for i in range(9):
        rec[:, i * LEAF_K + 10:(i + 1) * LEAF_K] = np.nan
    t_max = np.where(rng.uniform(size=n) < 0.3, np.inf,
                     rng.uniform(0.5, 6, n)).astype(np.float32)
    want = [np.asarray(x) for x in tix._tri_bundle_test(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(rec))]
    got = [x.numpy() for x in pix._tri_bundle_test(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        torch.as_tensor(rec))]
    assert want[0].any() and not want[0][:, 10:].any()  # NaN pads never hit
    np.testing.assert_array_equal(got[0], want[0])
    h = want[0]
    # rtol 1e-6: both sides round each op once in the same order
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[h], w[h], rtol=1e-6)


def test_box8_test_matches_tpurt():
    rng = np.random.default_rng(12)
    n = 512
    o, d = _rays(rng, n)
    d[::7, 0] = 0.0  # axis-parallel rays: 1/d is +-inf, (lo-o)*inf may be NaN
    rec = np.zeros((n, REC), np.float32)
    lo = rng.uniform(-3, 2, (n, 3, WIDTH))
    hi = lo + rng.uniform(0.01, 2, (n, 3, WIDTH))
    rec[:, :3 * WIDTH] = lo.reshape(n, -1)
    rec[:, 3 * WIDTH:6 * WIDTH] = hi.reshape(n, -1)
    rec[:, [6, 7, 14, 15, 22, 23, 30, 31, 38, 39, 46, 47]] = np.nan  # absent
    t_max = np.where(rng.uniform(size=n) < 0.5, np.inf,
                     rng.uniform(0.5, 6, n)).astype(np.float32)
    inv_d = np.asarray(jnp.where(jnp.asarray(d) != 0, 1.0 / jnp.asarray(d),
                                 jnp.where(jnp.asarray(d) >= 0, np.inf,
                                           -np.inf)))
    np.testing.assert_array_equal(
        pix.safe_inv_dir(torch.as_tensor(d)).numpy(), inv_d)
    wh, wt = (np.asarray(x) for x in tix._box8_test(
        jnp.asarray(rec), jnp.asarray(o), jnp.asarray(inv_d),
        jnp.asarray(t_max)))
    gh, gt = (x.numpy() for x in pix._box8_test(
        torch.as_tensor(rec), torch.as_tensor(o), torch.as_tensor(inv_d),
        torch.as_tensor(t_max)))
    assert wh.any() and not wh[:, 6:].any()  # NaN boxes never hit
    np.testing.assert_array_equal(gh, wh)
    np.testing.assert_allclose(gt[wh], wt[wh], rtol=1e-6)


def test_ray_sphere_matches_tpurt_ray_quadric():
    rng = np.random.default_rng(13)
    n = 1024
    o, d = _rays(rng, n, aim=np.zeros(3))
    o[:64] *= 0.1  # some origins inside the sphere
    t_max = np.full(n, np.inf, np.float32)
    t_max[::5] = 1.5
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (0.3, -0.2, 0.1)
    m[:3, :3] *= 1 / 1.3
    params = np.zeros(16, np.float32)
    params[:4] = (1.0, -1.0, 1.0, 2 * np.pi)
    # disable_jit: lax.switch would otherwise compile the sphere branch as
    # one XLA computation, whose FMA contraction breaks the compensated
    # discriminant's error terms; op by op it rounds like the port
    with jax.disable_jit():
        want = [np.asarray(x) for x in jax.vmap(
            lambda oo, dd, tt: tix.ray_quadric(
                oo, dd, tt, jnp.int32(PT_SPHERE), jnp.asarray(m),
                jnp.asarray(params))
        )(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))]
    got = [x.numpy() for x in pix.ray_quadric(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        PT_SPHERE, torch.as_tensor(m), torch.as_tensor(params))]
    h = want[0]
    assert h.mean() > 0.3
    np.testing.assert_array_equal(got[0], h)
    # rtol 1e-6 on t; u, v also pass through atan2/acos, whose XLA and
    # torch implementations may differ by an ulp or two (atol 1e-6)
    np.testing.assert_allclose(got[1][h], want[1][h], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g[h], w[h], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,aim", [("kernels", None),
                                      ("mesh", np.array([0.0, 1.5, 0.0]))])
def test_traverse_twin_matches_tpurt_traverse_wide(scenes, name, aim):
    _, job, pjob = scenes[name]
    geo, pgeo = job.scene.geo, pjob.scene.geo
    rng = np.random.default_rng(7)
    n = 4096
    o, d = _rays(rng, n, aim=aim)
    tm = np.where(rng.uniform(size=n) < 0.2, 2.0, np.inf).astype(np.float32)
    tm[:16] = 0.0  # t_max <= 0: dead from the start
    for any_hit in (False, True):
        t0, p0, b00, b10 = (np.asarray(x) for x in tix._traverse_wide(
            geo, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            any_hit=any_hit))
        calls = ktr.traverse_wide_reference.calls
        t1, p1, b01, b11 = (x.numpy() for x in ktr.traverse_wide(
            pgeo, torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(tm), any_hit=any_hit))
        # the wrapper runs the plain twin because the tensors are on the CPU
        assert ktr.traverse_wide_reference.calls == calls + 1
        hit = p0 >= 0
        assert 0.05 < hit.mean() < 0.95 and not hit[:16].any()
        if any_hit:
            np.testing.assert_array_equal(p1 >= 0, hit)  # occlusion
            continue
        np.testing.assert_array_equal(p1, p0)
        # rtol 2e-5 as in tests/test_kernels.py; T_ATOL for XLA's FMA
        # contraction in the jitted loop at near-zero t (module docstring)
        np.testing.assert_allclose(t1[hit], t0[hit], rtol=2e-5, atol=T_ATOL)
        np.testing.assert_allclose(b01[hit], b00[hit], atol=1e-5)
        np.testing.assert_allclose(b11[hit], b10[hit], atol=1e-5)


def test_traverse_twin_matches_pallas_kernel_interpret(scenes):
    from tpurt.kernels.traverse import BLOCK, traverse_closest_pallas

    _, job, pjob = scenes["kernels"]
    rng = np.random.default_rng(7)
    o, d = _rays(rng, BLOCK)
    tm = np.full(BLOCK, np.inf, np.float32)
    _, p0, _, _ = traverse_closest_pallas(
        job.scene.geo.wnodes, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tm), stack_depth=job.scene.geo.wstack_depth,
        interpret=True)
    p0 = np.asarray(p0)
    _, p1, _, _ = ktr.traverse_wide_reference(
        pjob.scene.geo, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(tm), any_hit=False)
    p1 = p1.numpy()
    np.testing.assert_array_equal(p1 >= 0, p0 >= 0)
    both = (p0 >= 0) & (p1 >= 0)
    np.testing.assert_array_equal(p1[both], p0[both])


def test_intersect_queries_match_tpurt(scenes):
    """intersect_closest / intersect_any, spheres included, on scene rays."""
    _, job, pjob = scenes["mesh"]
    rng = np.random.default_rng(8)
    n = 2048
    o, d = _rays(rng, n, aim=np.array([1.0, 1.0, 0.0]))
    tm = np.where(rng.uniform(size=n) < 0.3, 3.0, np.inf).astype(np.float32)
    h0 = tix.intersect_closest(job.scene.geo, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tm))
    h1 = pix.intersect_closest(pjob.scene.geo, torch.as_tensor(o),
                               torch.as_tensor(d), torch.as_tensor(tm),
                               ktr.traverse_wide)
    p0 = np.asarray(h0.prim)
    assert (p0 >= job.scene.geo.n_tris).sum() > 20  # sphere hits
    np.testing.assert_array_equal(h1.prim.numpy(), p0)
    tri = (p0 >= 0) & (p0 < job.scene.geo.n_tris)
    sph = p0 >= job.scene.geo.n_tris
    t0, t1 = np.asarray(h0.t), h1.t.numpy()
    np.testing.assert_allclose(t1[tri], t0[tri], rtol=2e-5, atol=T_ATOL)
    # sphere t: tpurt's jitted quadric pass loses the compensated
    # discriminant's error terms to XLA's FMA contraction; op by op the
    # two agree to 1e-6 (test_ray_sphere_matches_tpurt_ray_quadric)
    np.testing.assert_allclose(t1[sph], t0[sph], rtol=1e-4)
    occ0 = np.asarray(tix.intersect_any(job.scene.geo, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(tm)))
    occ1 = pix.intersect_any(pjob.scene.geo, torch.as_tensor(o),
                             torch.as_tensor(d), torch.as_tensor(tm),
                             ktr.traverse_wide).numpy()
    np.testing.assert_array_equal(occ1, occ0)


def test_cuda_source_sort_network_is_tpurts():
    """The comparator list compiled into traverse.cu is tpurt's _SORT8, and
    its layout constants are the table's."""
    src = (kbuild.CSRC / ktr.SOURCE).read_text()
    pairs = tuple((int(a), int(b))
                  for a, b in re.findall(r"CSWAP\((\d), (\d)\)", src))
    assert pairs == tix._SORT8 == pix.SORT8
    assert re.search(rf"#define TPURT_STACK_MAX {ktr.STACK_MAX}\b", src)
    assert (WIDTH, LEAF_K, REC, SLOT_KIND) == (8, 12, 128, 126)
    assert pix._BOX_T_SCALE == float(tix._BOX_T_SCALE)
