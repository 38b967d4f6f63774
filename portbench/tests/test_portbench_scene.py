"""The scene writer: the published killeroo-simple.pbrt word for word but
for the seeded stand-in of its mesh; the same text from the same seed,
66,052 triangles at every seed, the seed moving the vertices and nothing
else, the stand-in inside its assumed bounds; and the reference's own
reader of the text."""

import re

import numpy as np

from portbench import run
from portbench.reference import pbrt
from portbench.scene import blob_mesh, scene_text, standin_mesh, write_scene


def _triangles(text):
    n = 0
    for block in re.findall(r'"integer indices" \[([^\]]*)\]', text):
        n += len(block.split()) // 3
    return n


def test_scene_deterministic_with_66052_triangles():
    cell = run.load_cell("killeroo-rpf.halton8")
    cfg, traffic = cell["config"], cell["traffic"]
    seeds = (0, 7, 2**31 + 5, 2**40 + 1)
    texts = [scene_text(cfg, traffic, s) for s in seeds]
    assert texts[1] == scene_text(cfg, traffic, 7)
    assert len(set(texts)) == len(seeds)
    assert all(_triangles(t) == 66_052 for t in texts)
    strip = [re.sub(r'"point P" \[[^\]]*\]', "", t) for t in texts]
    assert len(set(strip)) == 1  # only the vertices move
    t = texts[0]
    assert 'Sampler "halton" "integer pixelsamples" [8]' in t
    assert '\nIntegrator "rpf"\n' in t
    assert '"integer xresolution" [700]' in t
    for line in ("LookAt 400 20 30   0 63 -110   0 0 1", "Rotate -5 0 0 1",
                 'Camera "perspective" "float fov" [39]',
                 '"color L" [2000 2000 2000] "integer nsamples" [8]',
                 'Material "matte" "color Kd" [.5 .5 .8]',
                 'Scale .5 .5 .5', 'Rotate -60 0 0 1',
                 'Translate 100 200 -140', 'Translate -200 0 0',
                 '"float roughness" [.025]', '"float roughness" [.15]'):
        assert line in t, line


def test_standin_fills_its_bounds():
    spec = run.load_cell("killeroo-rpf.halton8")["config"]["scene"]["standin"]
    for seed in (1, 2**33 + 7):
        v, idx = standin_mesh(spec, seed)
        assert len(idx) == 2 * 128 * 129
        assert np.allclose(v.min(0), spec["bounds"][0], atol=1e-5)
        assert np.allclose(v.max(0), spec["bounds"][1], atol=1e-5)


def test_reference_reads_the_scene(tmp_path):
    cell = run.load_cell("killeroo-rpf.random8")
    scene = write_scene(tmp_path / "s.pbrt", cell["config"], cell["traffic"],
                        3)
    sc = pbrt.read_scene(scene)
    assert sc.res == (700, 700) and sc.fov == 39 and sc.spp == 8
    assert (sc.sampler, sc.integrator, sc.maxdepth) == ("random", "rpf", 5)
    assert sc.tri_v.shape == (66_052, 3, 3)
    assert len(sc.lights) == 1 and sc.lights[0]["L"] == (2000.0,) * 3
    assert np.allclose(sc.lights[0]["center"], (150, 120, 20))
    kinds = sorted((m.kind, m.kd, m.ks) for m in sc.materials)
    assert kinds == sorted([("matte", (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
                            ("matte", (0.5, 0.5, 0.8), (0.0, 0.0, 0.0)),
                            ("plastic", (0.4, 0.2, 0.2), (0.5, 0.5, 0.5)),
                            ("plastic", (0.4, 0.5, 0.4), (0.3, 0.3, 0.3))])
    # "Rotate -5 0 0 1" after LookAt turns the world by -5 degrees about
    # z in front of the camera: the eye sits at LookAt's turned by +5
    c, s = np.cos(np.radians(5)), np.sin(np.radians(5))
    eye = (400 * c - 20 * s, 400 * s + 20 * c, 30)
    assert np.allclose(sc.camera_to_world[:3, 3], eye)
    # the two stand-ins (after the floor's and the wall's 4 triangles)
    # stand on the floor at z = -140
    assert abs(sc.tri_v[4:, :, 2].min() + 140) < 1e-3


def test_blob_matches_a_loop_build():
    """The vectorised index build equals the ring-by-ring loop."""
    n = 9
    v, idx = blob_mesh(n, 3)
    rings = n + 1
    ring = lambda i, j: i * n + j % n  # noqa: E731
    loop = []
    for i in range(rings - 1):
        for j in range(n):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            loop += [(a, c, b), (b, c, d)]
    for j in range(n):
        loop.append((rings * n, ring(0, j), ring(0, j + 1)))
        loop.append((rings * n + 1, ring(rings - 1, j + 1),
                     ring(rings - 1, j)))
    assert np.array_equal(idx, np.asarray(loop))
    assert v.shape == (rings * n + 2, 3) and v[:, 1].min() == 0
