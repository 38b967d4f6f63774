"""Tiny scenes of the realistic camera, Ptex and the fourier BSDF for the
CPU parity tests (tests/test_torch_lenses*.py, test_torch_fourier*.py):
triangles only, a triangle area light, 12x12 pixels, so that tpurt's
cold compile stays short.  Their files are written under a test's
directory by ``write_inputs``.
"""

import functools

import numpy as np

from tpurt_torch import testscenes as ts

# a triangle quad light over a matte ground and the stand-in's mesh
_WORLD = """WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "color L" [12 12 12]
  Shape "trianglemesh" "point P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd
{ground}{mesh_material}
{mesh}WorldEnd
"""

_GROUND = """Material "matte" "color Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "point P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
  "integer indices" [0 2 1  0 3 2]
"""


def _head(camera: str, integrator: str, maxdepth: int, res: int,
          spp: int) -> str:
    integ = f'Integrator "{integrator}" "integer maxdepth" [{maxdepth}]'
    if integrator == "sppm":
        integ += ' "integer numiterations" [2] "float radius" [0.3]'
    return f"""LookAt 0 1.5 -5  0 0.6 0  0 1 0
{camera}
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
  "float diagonal" [35]
Sampler "halton" "integer pixelsamples" [{spp}]
{integ}
"""


@functools.lru_cache(maxsize=1)
def _mesh() -> str:
    v, idx = ts.blob_mesh(6, seed=2)
    return ts._mesh_text(v * 0.8, idx)


def write_inputs(d) -> dict:
    """The lens, Ptex and .bsdf files under the directory ``d``."""
    from tpurt_torch.io.ptex import write_ptex
    from tpurt_torch.render.fourier import write_bsdf_file

    files = dict(lens=str(d / "lens.dat"), ptx=str(d / "faces.ptx"),
                 bsdf=str(d / "glossy.bsdf"))
    ts.write_lens(files["lens"])
    write_ptex(files["ptx"], ts.ptex_faces(4))
    write_bsdf_file(files["bsdf"], ts.glossy_fourier_table(n_mu=24))
    return files


def _realistic_camera(files: dict) -> str:
    return (f'Camera "realistic" "string lensfile" ["{files["lens"]}"]\n'
            '  "float focusdistance" [5.1] "float aperturediameter" [8]')


def realistic_tiny(files: dict, integrator: str = "path", maxdepth: int = 2,
                   res: int = 12, spp: int = 4) -> str:
    """Frame L in miniature: Camera "realistic" through the biconvex
    lens, focused on the mesh, at aperture 8 mm."""
    cam = _realistic_camera(files)
    mat = ('Material "plastic" "color Kd" [0.4 0.2 0.2] "color Ks" '
           '[0.5 0.5 0.5] "float roughness" [0.05]')
    return (_head(cam, integrator, maxdepth, res, spp)
            + _WORLD.format(ground=_GROUND, mesh_material=mat, mesh=_mesh()))


def ptex_fourier_tiny(files: dict, integrator: str = "path",
                      maxdepth: int = 2, res: int = 12, spp: int = 4,
                      realistic: bool = False) -> str:
    """Frame M in miniature: the mesh under the glossy fourier table, the
    ground as 4 Ptex faces (2 x 2 quads) under a matte Kd; seen through
    realistic_tiny's camera with ``realistic``."""
    ground = (f'Texture "faces" "spectrum" "ptex" "string filename" '
              f'["{files["ptx"]}"]\nMaterial "matte" "texture Kd" "faces"\n'
              + ts.ptex_ground(grid=2, half=6.0))
    mat = f'Material "fourier" "string bsdffile" ["{files["bsdf"]}"]'
    cam = ('Camera "perspective" "float fov" [39]' if not realistic
           else _realistic_camera(files))
    return (_head(cam, integrator, maxdepth, res, spp)
            + _WORLD.format(ground=ground, mesh_material=mat, mesh=_mesh()))


def tpurt_lens_zones(monkeypatch, zones: int = 8, samples: int = 1 << 14):
    """Both packages build the realistic camera's exit pupil over
    ``zones`` zones of ``samples`` rays (the default 64 x 2^18 costs
    tpurt ~20 s of numpy)."""
    import tpurt.render.lenses as tl

    from tpurt_torch.render import lenses

    monkeypatch.setattr(tl, "build_lens_system", functools.partial(
        tl.build_lens_system, n_zones=zones))
    monkeypatch.setattr(tl, "bound_exit_pupil", functools.partial(
        tl.bound_exit_pupil, n_samples=samples))
    monkeypatch.setattr(lenses, "N_ZONES", zones)
    monkeypatch.setattr(lenses, "N_PUPIL_SAMPLES", samples)


def frac_close(got, want) -> float:
    """The share of pixels within 1e-3 abs + 1e-3 rel on every channel."""
    ok = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    return float(ok.all(axis=-1).mean())
