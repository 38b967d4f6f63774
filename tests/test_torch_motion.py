"""Motion blur's transforms against tpurt on the CPU:
interp_quad_transform (an animated quadric's frame at a ray's time), the
animated camera (camera_tables' decomposed endpoints against
make_camera's, generate_rays at a time against tpurt's _interp_c2w path),
(test_torch_motion_2.py holds the motion walk and a quirk of tpurt's
that the port shares).

Bounds: the host tables bit for bit; matrices, origins and directions
within rtol 1e-5 / atol 2e-6 (tpurt runs jitted, where XLA may contract
products into FMAs and inverts by LU; the port inverts by torch.linalg).
Inputs come from numpy with fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.geom import transform as txf
from tpurt.render import intersect as tix
from tpurt.render.camera import make_camera
from tpurt.scene.paramset import ParamSet as TParamSet
from tpurt_torch.geom import transform as pxf
from tpurt_torch.render import intersect as pix
from tpurt_torch.render.camera import camera_from_tables, camera_tables
from tpurt_torch.scene.paramset import ParamSet

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _trs_pairs(rng, n):
    """n endpoint pairs (2, 16) of random rotate-scale-translate transforms,
    decomposed by the port's copy of decompose_trs (equal to tpurt's)."""
    out = []
    for _ in range(n):
        pair = []
        for _ in range(2):
            m = (txf.translate(rng.uniform(-2, 2, 3))
                 * txf.rotate(rng.uniform(-180, 180), rng.normal(size=3))
                 * txf.scale(*rng.uniform(0.5, 2.0, 3))).m
            t, q, s = pxf.decompose_trs(m)
            assert all(np.array_equal(a, b) for a, b in
                       zip((t, q, s), txf.decompose_trs(m)))
            pair.append(np.concatenate([t, q, s.reshape(-1)]))
        out.append(np.stack(pair))
    return np.asarray(out, np.float32)


def test_interp_quad_transform_matches_tpurt():
    rng = np.random.default_rng(21)
    n = 512
    trs = _trs_pairs(rng, n)
    dt = rng.uniform(-0.2, 1.2, n).astype(np.float32)  # clipped to [0, 1]
    dt[:4] = (0.0, 1.0, 0.5, 1e-3)
    want = [np.asarray(x) for x in tix.interp_quad_transform(
        jnp.asarray(trs), jnp.asarray(dt))]
    got = [x.numpy() for x in pix.interp_quad_transform(
        torch.as_tensor(trs), torch.as_tensor(dt))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6)
    # one shared pair for every lane, as a static quadric's row
    want = tix.interp_quad_transform(jnp.asarray(trs[0]), jnp.asarray(dt))
    got = pix.interp_quad_transform(torch.as_tensor(trs[0]),
                                    torch.as_tensor(dt))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("times", [(0.0, 1.0), (0.25, 2.0)])
def test_animated_camera_matches_tpurt(times):
    """camera_tables of an animated camera against make_camera, and its
    rays at random film points, lens points and shutter times."""
    eye, at, up = [1.0, 2.0, -5.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0]
    w2c0 = txf.look_at(eye, at, up)
    end = txf.look_at(eye, at, up) * txf.translate([0.4, -0.2, 0.7]) \
        * txf.rotate(25.0, [0.2, 1.0, 0.1])
    tps, pps = TParamSet(), ParamSet()
    for ps in (tps, pps):
        ps.add("float", "fov", [50.0])
        ps.add("float", "lensradius", [0.1])
        ps.add("float", "focaldistance", [4.0])
        ps.add("float", "shutteropen", [times[0]])
        ps.add("float", "shutterclose", [times[1]])
    want = make_camera("perspective", tps, w2c0.inverse(), 48, 32,
                       camera_to_world_end=end.inverse(),
                       transform_times=times)
    tab = camera_tables("perspective", pps,
                        pxf.Transform(w2c0.m, w2c0.m_inv).inverse(), 48, 32,
                        camera_to_world_end=pxf.Transform(
                            end.m, end.m_inv).inverse(),
                        transform_times=times)
    for k, v in tab.items():
        w = getattr(want, k)
        if isinstance(v, np.ndarray):
            assert v.tobytes() == np.asarray(w).tobytes(), k
        else:
            assert v == w, k
    assert tab["animated"]
    rng = np.random.default_rng(22)
    n = 1024
    p_film = (rng.uniform(0, 1, (n, 2)) * [48, 32]).astype(np.float32)
    p_lens = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    time = rng.uniform(times[0] - 0.1, times[1] + 0.1, n).astype(np.float32)
    w_o, w_d, _ = want.generate_rays(jnp.asarray(p_film), jnp.asarray(p_lens),
                                     jnp.asarray(time))
    cam = camera_from_tables(tab, "cpu")
    g_o, g_d, _ = cam.generate_rays(torch.as_tensor(p_film),
                                    torch.as_tensor(p_lens),
                                    torch.as_tensor(time))
    np.testing.assert_allclose(g_o.numpy(), np.asarray(w_o), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(g_d.numpy(), np.asarray(w_d), rtol=1e-5,
                               atol=2e-6)
