"""The port's command line against tpurt's: a scene read from stdin
(``-``), ``--cat`` and ``--toply`` (tpurt_torch/cli.py against
tpurt/cli.py and tpurt/scene/catapi.py), on the CPU.

Bounds: the stdin render equal to the file's; the --cat text byte-equal
to tpurt's PrintingAPI output on the same scene (frame D's small scene:
textures, every light kind, quadrics, named materials) and a fixed point
(its own --cat is itself); --toply's PLY meshes equal to the scene's
meshes (indices exactly, positions to the %g text's 6 significant
digits) through the port's PLY loader.
"""

import io

import numpy as np
import torch

from tpurt.scene.catapi import PrintingAPI as TpurtPrintingAPI
from tpurt.scene.parser import parse_file as tpurt_parse_file
from tpurt_torch import cli
from tpurt_torch.io.image import read_image
from tpurt_torch.scene import load_scene, load_scene_string
from tpurt_torch.testscenes import (standin_scene, write_caustic,
                                    write_materials)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _cat(capsys, *args):
    capsys.readouterr()
    assert cli.main(list(args)) == 0
    return capsys.readouterr().out


def test_stdin_scene_renders_as_the_file(tmp_path, monkeypatch):
    path = write_caustic(str(tmp_path / "c.pbrt"), "small", res=16,
                         iterations=1)
    a, b = str(tmp_path / "file.pfm"), str(tmp_path / "stdin.pfm")
    assert cli.main([path, "--device", "cpu", "-o", a, "--quiet"]) == 0
    with open(path) as f:
        monkeypatch.setattr("sys.stdin", io.StringIO(f.read()))
    assert cli.main(["-", "--device", "cpu", "-o", b, "--quiet"]) == 0
    img = read_image(b)
    assert img.shape == (16, 16, 3) and img.mean() > 0
    np.testing.assert_array_equal(img, read_image(a))


def test_cat_equals_tpurt_and_is_a_fixed_point(tmp_path, capsys):
    path = write_materials(str(tmp_path / "d.pbrt"), "small")
    got = _cat(capsys, "--cat", path)
    buf = io.StringIO()
    tpurt_parse_file(path, TpurtPrintingAPI(out=buf))
    assert got == buf.getvalue()
    for word in ("Texture", "LightSource", "AreaLightSource", "Shape",
                 "Material", "WorldEnd"):
        assert word in got
    again = tmp_path / "d_cat.pbrt"
    again.write_text(got)
    assert _cat(capsys, "--cat", str(again)) == got


def test_toply_meshes_round_trip(tmp_path, capsys, monkeypatch):
    scene = tmp_path / "s.pbrt"
    scene.write_text(standin_scene("medium"))
    monkeypatch.chdir(tmp_path)
    text = _cat(capsys, "--toply", str(scene))
    assert text.count('Shape "plymesh"') == 2
    # (geom.shapes is imported after tpurt_torch.scene, which it needs)
    from tpurt_torch.geom.shapes import read_ply

    P, _N, _UV, F = read_ply(str(tmp_path / "mesh_00000.ply"))
    assert len(F) > 500 and len(P) > 0
    # the --toply text loads through the port's loader, its PLY meshes
    # equal to the scene's (world space)

    def meshes(sd):
        return [p.shape for p in sd.primitives
                if getattr(p.shape, "kind", "") == "trianglemesh"]

    want = meshes(load_scene(str(scene)))
    got = meshes(load_scene_string(text, base_dir=str(tmp_path)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_allclose(g.vertices, w.vertices, rtol=1e-5,
                                   atol=1e-5)
