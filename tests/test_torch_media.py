"""The port's media functions against tpurt's (render/volpath.py against
tpurt/render/integrator.py:1187-1479), on the CPU: the Henyey-Greenstein
phase function and its sampling, the tracking loops' counter hash and the
lane-chunk rule it reads, on the same numpy inputs made from a seed.

Bounds: the phase values and sampled directions within 1e-6 (float32
rounding of the same operations); the hash and the chunk rule bit for
bit.  The helpers here (the grid scene, the two builds of one scene, the
render pair and the standing image bounds) serve the other media files:
test_torch_media_2.py, test_torch_volpath_*.py and test_torch_ao.py.
"""

import numpy as np
import torch

import jax.numpy as jnp

from tpurt.io.image import read_image
from tpurt.render import integrator as tint
from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.render.driver import render as tpurt_render
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch import cli
from tpurt_torch.config import TPURT_WAVEFRONT_SIZE, tpurt_chunk
from tpurt_torch.convert import scene_from_tpurt
from tpurt_torch.render import volpath as pvol
from tpurt_torch.render.driver import job_from_tables

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def grid_scene_string(density, p0, p1, sig_a, sig_s, extra=""):
    """A volpath scene holding one grid medium (test_media.py's
    _grid_scene_string)."""
    nz, ny, nx = density.shape
    dens = " ".join("%g" % v for v in density.ravel())
    return f"""
    Film "image" "integer xresolution" [8] "integer yresolution" [8]
    Sampler "random" "integer pixelsamples" [1]
    Integrator "volpath" "integer maxdepth" [3]
    MakeNamedMedium "smoke" "string type" "heterogeneous"
      "integer nx" [{nx}] "integer ny" [{ny}] "integer nz" [{nz}]
      "float density" [{dens}]
      "point p0" [{p0[0]} {p0[1]} {p0[2]}] "point p1" [{p1[0]} {p1[1]} {p1[2]}]
      "rgb sigma_a" [{sig_a} {sig_a} {sig_a}]
      "rgb sigma_s" [{sig_s} {sig_s} {sig_s}]
    {extra}
    Camera "perspective" "float fov" [40]
    WorldBegin
    LightSource "point" "color I" [1 1 1] "point from" [0 5 0]
    WorldEnd
    """


def both_scenes(text):
    """(tpurt SceneData, the port's SceneData of the same tables)."""
    job = tpurt_build_job(tpurt_load_scene_string(text))
    return job.scene, job_from_tables(scene_from_tpurt(job), "cpu").scene


def render_pair(text, tmp_path):
    """(tpurt's image, tpurt's job, the port CLI's image) of the scene
    ``text``, both on the CPU."""
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    want, job = tpurt_render(tpurt_load_scene_string(text), progress=False)
    out = tmp_path / "port.pfm"
    assert cli.main([str(path), "--device", "cpu", "--outfile", str(out),
                     "--quiet"]) == 0
    return want, job, read_image(str(out))


def assert_standing_bounds(got, want):
    """The slice bounds (test_torch_render.py): image means within 1e-3
    relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0.01
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    ok = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_hg_phase_and_sample_match_tpurt():
    """_hg_phase and _hg_sample on the same cosines, directions and
    uniforms, g spread over [-0.9, 0.9] with values within 1e-3 of 0 (the
    isotropic branch) and exactly 0."""
    rng = np.random.default_rng(11)
    n = 4096
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    g[:256] = rng.uniform(-2e-3, 2e-3, 256)
    g[256:264] = 0.0
    cos_t = rng.uniform(-1, 1, n).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    u1, u2 = rng.random((2, n)).astype(np.float32)
    want = np.asarray(tint._hg_phase(jnp.asarray(cos_t), jnp.asarray(g)))
    got = pvol._hg_phase(_t(cos_t), _t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    wi_t, ph_t = tint._hg_sample(jnp.asarray(d), jnp.asarray(g),
                                 jnp.asarray(u1), jnp.asarray(u2))
    wi_p, ph_p = pvol._hg_sample(_t(d), _t(g), _t(u1), _t(u2))
    np.testing.assert_allclose(wi_p.numpy(), np.asarray(wi_t), atol=1e-6)
    np.testing.assert_allclose(ph_p.numpy(), np.asarray(ph_t), rtol=1e-6,
                               atol=1e-6)


def test_track_u_bit_equal_to_tpurt():
    """The tracking hash on random lanes, bounces, steps and salts, half
    of each above 2^31 (uint32 values an int64 product would overflow on),
    as tensors and as Python ints."""
    rng = np.random.default_rng(5)
    n = 1 << 16
    lane, bounce, step = rng.integers(0, 1 << 32, (3, n), dtype=np.uint64)
    for salt in (0x6A1D, 0x6A1D + 0x1234, 0x51AD, 0x51AD + 0x77,
                 0xFFFFFFFF):
        want = np.asarray(tint._track_u(
            jnp.asarray(lane.astype(np.uint32)),
            jnp.asarray(bounce.astype(np.uint32)),
            jnp.asarray(step.astype(np.uint32)), salt))
        got = pvol._track_u(_t(lane.astype(np.int64)),
                            _t(bounce.astype(np.int64)),
                            _t(step.astype(np.int64)), salt).numpy()
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes(), salt
    # bounce and step as the loops pass them: Python ints
    for b, k in ((0, 0), (3, 255), (4 * 5 + 3, 17), ((1 << 32) - 1, 7)):
        want = np.asarray(tint._track_u(
            jnp.asarray(lane.astype(np.uint32)), jnp.uint32(b),
            jnp.full(n, k, jnp.uint32), 0x6A1D))
        got = pvol._track_u(_t(lane.astype(np.int64)), b, k, 0x6A1D).numpy()
        assert got.tobytes() == want.tobytes(), (b, k)


def test_tpurt_chunk_rule_matches_tpurt_driver():
    """config.tpurt_chunk against the arithmetic of tpurt's scan driver
    (driver.py:470-482), written out here from its source with tpurt's
    own wavefront size, for every total from 1 to 2^16 and around each
    power of two up to 2^23 (the rule is constant between them); F's
    3.92 M lanes take 2^18-lane chunks."""
    from tpurt.config import get_config

    assert get_config().wavefront_size == TPURT_WAVEFRONT_SIZE

    def tpurt_rule(total):
        min_chunk = 1 << 14
        bucket = min_chunk
        while bucket < total:
            bucket *= 2
        chunk = min(bucket, TPURT_WAVEFRONT_SIZE, 1 << 20)
        return max(chunk, min_chunk)

    totals = set(range(1, (1 << 16) + 1))
    for k in range(15, 24):
        totals |= {(1 << k) + j for j in (-1, 0, 1)}
    totals |= {700 * 700 * 8, 64 * 64 * 2, 32 * 32 * 2, 1 << 23}
    for total in sorted(totals):
        assert tpurt_chunk(total) == tpurt_rule(total), total
    assert tpurt_chunk(700 * 700 * 8) == 1 << 18
    assert tpurt_chunk(32 * 32 * 2) == 1 << 14
