"""In-repo stand-in for the killeroo-simple frame (pure Python + numpy).

``standin_scene(size)`` returns ``.pbrt`` text with killeroo-simple's
structure: a perspective camera, a box filter, the Halton sampler, the
path integrator at maxdepth 5, a sphere area light, two matte quads (floor
and back wall) and two plastic instances of a generated closed mesh.  The
mesh is a displaced sphere made deterministically from ``seed``.

Sizes:
  "full":  700x700, 8 spp, 2 x 33,024 triangles (~66k, the frame the
           JAX package's bench.py times with killeroo)
  "small": 32x32, 2 spp, 2 x 312 triangles (CPU tests)

``integrator="rpf"`` gives the same scene through ``Integrator "rpf"``
(sample.pbrt's structure: the frame bench.py times second), and
``sampler=`` picks the Sampler directive (bench.py's sampler sweep runs
the RPF frame under random, stratified and halton).

``textured_scene(size, texpng)`` is the direct-lighting textured frame
that bench.py times as its config 5: ``Integrator "directlighting"``, a
sphere area light and a distant light, a ground quad with a checkerboard
``Kd`` and a plastic sphere whose ``Kd`` is an image map (the generated
256x256 colour grid that ``write_grid_texture`` writes), 700x700 at 8 spp
("full") or 32x32 at 2 spp ("small").  ``variant="whitted"`` swaps the
integrator for ``"whitted"`` and adds a smooth glass sphere and a mirror
quad, so that the specular continuation has lobes to follow.
"""

from __future__ import annotations

import numpy as np

SIZES = {
    "full": dict(res=700, spp=8, mesh_n=128),
    "small": dict(res=32, spp=2, mesh_n=12),
}


def blob_mesh(n: int, seed: int = 0):
    """Closed displaced-sphere mesh: n longitudes x (n+1) latitude rings
    plus two poles, 2*n*(n+1) triangles, unit-ish size, resting on y=0.
    Returns (vertices (V,3) f64, indices (T,3) i64)."""
    rng = np.random.default_rng(seed)
    rings = n + 1
    theta = np.pi * (np.arange(rings) + 1) / (rings + 1)
    phi = 2 * np.pi * np.arange(n) / n
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    dirs = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    dirs = np.concatenate([dirs, [[0, 1, 0], [0, -1, 0]]])
    freq = rng.normal(size=(6, 3)) * 2.5
    amp = rng.uniform(0.03, 0.09, 6)
    phase = rng.uniform(0, 2 * np.pi, 6)
    r = 1.0 + np.sin(dirs @ freq.T + phase) @ amp
    v = dirs * r[:, None] * np.array([1.0, 1.3, 1.0])
    idx = []
    ring = lambda i, j: i * n + j % n  # noqa: E731
    for i in range(rings - 1):
        for j in range(n):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            idx += [(a, c, b), (b, c, d)]
    top, bot = rings * n, rings * n + 1
    for j in range(n):
        idx.append((top, ring(0, j), ring(0, j + 1)))
        idx.append((bot, ring(rings - 1, j + 1), ring(rings - 1, j)))
    v[:, 1] -= v[:, 1].min()
    return v, np.asarray(idx, np.int64)


def _mesh_text(v, idx) -> str:
    pts = " ".join(f"{x:.5f}" for x in v.reshape(-1))
    ids = " ".join(str(i) for i in idx.reshape(-1))
    return f'Shape "trianglemesh"\n  "point P" [{pts}]\n  "integer indices" [{ids}]\n'


def sampler_directive(sampler: str, spp: int) -> str:
    """The Sampler line: stratified takes its default 4x4 strata, the
    others ``pixelsamples``."""
    if sampler == "stratified":
        return 'Sampler "stratified"'
    return f'Sampler "{sampler}" "integer pixelsamples" [{spp}]'


def standin_scene(size: str = "full", filename: str = "standin.exr",
                  seed: int = 0, integrator: str = "path",
                  sampler: str = "halton") -> str:
    """The stand-in scene as .pbrt text; integrator is "path" or "rpf"."""
    if integrator not in ("path", "rpf"):
        raise ValueError(f"integrator {integrator!r}")
    cfg = SIZES[size]
    v, idx = blob_mesh(cfg["mesh_n"], seed)
    v = v * 1.6
    mesh = _mesh_text(v, idx)
    res, spp = cfg["res"], cfg["spp"]
    return f"""# tpurt_torch stand-in for killeroo-simple ({size})
LookAt 0 4.5 -15  0 2.2 0  0 1 0
Camera "perspective" "float fov" [39]
{sampler_directive(sampler, spp)}
Integrator "{integrator}" "integer maxdepth" [5]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
  "string filename" "{filename}"
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [40 40 40]
  Translate 3 9 -5
  Shape "sphere" "float radius" [1.2]
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "point P" [-30 0 -30  30 0 -30  30 0 30  -30 0 30]
    "integer indices" [0 2 1  0 3 2]
  Material "matte" "color Kd" [0.55 0.45 0.35]
  Shape "trianglemesh" "point P" [-30 0 8  30 0 8  30 30 8  -30 30 8]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [0.4 0.2 0.2] "color Ks" [0.5 0.5 0.5]
    "float roughness" [0.025]
  AttributeBegin
    Translate -2.2 0 0
    {mesh}  AttributeEnd
  AttributeBegin
    Translate 2.4 0 2
    Rotate 40 0 1 0
    {mesh}  AttributeEnd
AttributeEnd
WorldEnd
"""


def mixed_scene(res=(24, 20), spp: int = 2, lens: bool = False) -> str:
    """A small scene touching every feature of the slice: a generated
    ~2k-triangle plastic mesh (2 * 31 * 32 triangles), a matte floor with
    Oren-Nayar roughness, a matte sphere, and three kinds of light (a
    point light, a sphere area light, a two-sided emissive triangle)."""
    v, idx = blob_mesh(31, seed=3)
    lens_params = ' "float lensradius" [0.1] "float focaldistance" [5]' if lens else ""
    return f"""
Film "image" "integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]
LookAt 0 2 -6  0 1 0  0 1 0
Camera "perspective" "float fov" [45]{lens_params}
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [5]
WorldBegin
LightSource "point" "point from" [2 5 -2] "color I" [8 8 8]
AttributeBegin
  AreaLightSource "diffuse" "color L" [4 4 4]
  Translate -2 4 -1
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "color L" [2 3 4] "bool twosided" "true"
  Shape "trianglemesh" "point P" [1 3 1  2 3 1  1.5 3.5 1.5]
    "integer indices" [0 1 2]
AttributeEnd
Material "plastic" "color Kd" [.3 .4 .5] "color Ks" [.4 .4 .4]
  "float roughness" [.1]
{_mesh_text(v, idx)}Material "matte" "color Kd" [.6 .6 .6] "float sigma" [20]
Shape "trianglemesh" "point P" [-9 0 -9  9 0 -9  9 0 9  -9 0 9]
  "integer indices" [0 2 1  0 3 2]
Translate 1.8 0.6 0.2
Shape "sphere" "float radius" [0.6]
WorldEnd
"""


def write_standin(path: str, size: str = "full", filename: str = None,
                  seed: int = 0, integrator: str = "path",
                  sampler: str = "halton") -> str:
    """Write the stand-in scene to ``path``; returns ``path``."""
    with open(path, "w") as f:
        f.write(standin_scene(size, filename or path.rsplit(".", 1)[0]
                              + ".exr", seed, integrator, sampler))
    return path


def write_grid_texture(path: str) -> str:
    """Write the 256x256 colour-grid texture of the textured frame
    (32-texel squares, a different phase in each channel)."""
    from tpurt_torch.io.image import write_image

    yy, xx = np.mgrid[0:256, 0:256]
    tex = np.stack([(xx // 32 % 2).astype(np.float32),
                    (yy // 32 % 2).astype(np.float32),
                    ((xx + yy) // 32 % 2).astype(np.float32)], -1)
    write_image(path, 0.2 + 0.7 * tex)
    return path


TEXTURED_SIZES = {
    "full": dict(res=700, spp=8),
    "small": dict(res=32, spp=2),
}


def textured_scene(size: str, texpng: str, filename: str = "direct_textured.exr",
                   variant: str = "directlighting", sampler: str = "halton",
                   pixel_filter: str = "box", res: int = None) -> str:
    """The direct-lighting textured frame as .pbrt text (module
    docstring); ``texpng`` is the image map's path."""
    if variant not in ("directlighting", "whitted"):
        raise ValueError(f"variant {variant!r}")
    cfg = TEXTURED_SIZES[size]
    res = res or cfg["res"]
    extra = ""
    if variant == "whitted":
        extra = """AttributeBegin
  Material "glass" "color Kr" [.9 .9 .9] "color Kt" [.9 .9 .9] "float eta" [1.5]
  Translate -2.2 0.7 1.2
  Shape "sphere" "float radius" [0.7]
AttributeEnd
AttributeBegin
  Material "mirror" "color Kr" [.85 .85 .85]
  Shape "trianglemesh" "point P" [1.6 0 -1  4 0 -3  4 3 -3  1.6 3 -1]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
"""
    return f"""LookAt 0 2.5 6  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
  "string filename" "{filename}"
{sampler_directive(sampler, cfg["spp"])}
PixelFilter "{pixel_filter}"
Integrator "{variant}" "integer maxdepth" [5]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [18 17 14]
  Translate -2 4 2
  Shape "sphere" "float radius" [0.4]
AttributeEnd
LightSource "distant" "color L" [.6 .7 .9] "point from" [3 6 4]
Texture "checks" "spectrum" "checkerboard"
  "float uscale" [16] "float vscale" [16]
  "color tex1" [.9 .9 .9] "color tex2" [.15 .2 .3]
Material "matte" "texture Kd" "checks"
Shape "trianglemesh" "point P" [-8 0 -8  8 0 -8  8 0 8  -8 0 8]
  "float uv" [0 0 1 0 1 1 0 1] "integer indices" [0 1 2 2 3 0]
{extra}Texture "grid" "spectrum" "imagemap" "string filename" "{texpng}"
Material "plastic" "texture Kd" "grid" "color Ks" [.3 .3 .3]
  "float roughness" [.02]
Translate 0 1 0
Shape "sphere" "float radius" [1]
WorldEnd
"""


def write_textured(path: str, size: str = "full", **kw) -> str:
    """Write the textured frame's scene to ``path`` and its grid texture
    beside it; returns ``path``."""
    base = path.rsplit(".", 1)[0]
    tex = write_grid_texture(base + "_grid.png")
    with open(path, "w") as f:
        f.write(textured_scene(size, tex, kw.pop("filename", base + ".exr"),
                               **kw))
    return path
