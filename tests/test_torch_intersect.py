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

import numpy as np
import pytest
import torch

from tpurt.geom.wbvh import REC, SLOT_KIND, WIDTH
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
import tpurt.native as tpurt_native
import tpurt_torch.native as port_native
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.geom.bvh import build_bvh
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
