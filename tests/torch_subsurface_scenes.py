"""A tiny scene of both subsurface materials for the CPU parity tests
(tests/test_torch_subsurface_render.py): triangles only, a triangle area
light, two small blobs, one under frame N's subsurface preset and one
under its kdsubsurface (two diffusion tables), so that tpurt's cold
compile stays as short as a subsurface render allows.  In front of them
lies a stack of nine thin horizontal sheets of the preset, 0.06 apart: a
probe chain along their normal crosses more surfaces than its 8 steps
reach, so the "Subsurface/Probe chain budget exhausted" counter counts.
"""

import functools

from tpurt_torch import testscenes as ts

_WORLD = """WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "color L" [12 12 12]
  Shape "trianglemesh" "point P" [-1 3 -1  1 3 -1  1 3 1  -1 3 1]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd
Material "matte" "color Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "point P" [-6 0 -6  6 0 -6  6 0 6  -6 0 6]
  "integer indices" [0 2 1  0 3 2]
{skin}
AttributeBegin
  Translate -0.9 0 0
  {mesh}AttributeEnd
{sheets}
{kd}
AttributeBegin
  Translate 0.9 0 0.3
  {mesh}AttributeEnd
WorldEnd
"""


def _sheets(n: int = 9) -> str:
    """n horizontal quads over x in [-0.6, 0.6], z in [-2, -1.2], from
    y = 0.04 up, 0.06 apart."""
    quads = []
    for k in range(n):
        y = 0.04 + 0.06 * k
        quads.append(f'Shape "trianglemesh" "point P" [-0.6 {y:g} -2  0.6 '
                     f'{y:g} -2  0.6 {y:g} -1.2  -0.6 {y:g} -1.2]\n'
                     '  "integer indices" [0 2 1  0 3 2]\n')
    return "".join(quads)


@functools.lru_cache(maxsize=1)
def _mesh() -> str:
    v, idx = ts.blob_mesh(6, seed=2)
    return ts._mesh_text(v * 0.7, idx)


def subsurface_tiny(integrator: str = "path", maxdepth: int = 3,
                    res: int = 12, spp: int = 2) -> str:
    """Frame N in miniature: its two materials on two blobs over a matte
    ground, under a quad light."""
    return f"""LookAt 0 1.5 -5  0 0.6 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "{integrator}" "integer maxdepth" [{maxdepth}]
""" + _WORLD.format(skin=ts.SUBSURFACE_SKIN, kd=ts.SUBSURFACE_KD,
                    mesh=_mesh(), sheets=_sheets())
