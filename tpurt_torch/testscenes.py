"""In-repo stand-in for the killeroo-simple frame (pure Python + numpy).

``standin_scene(size)`` returns ``.pbrt`` text with killeroo-simple's
structure: a perspective camera, a box filter, the Halton sampler, the
path integrator at maxdepth 5, a sphere area light, two matte quads (floor
and back wall) and two plastic instances of a generated closed mesh.  The
mesh is a displaced sphere made deterministically from ``seed``.

Sizes:
  "full":  700x700, 8 spp, 2 x 33,024 triangles (~66k, the frame the
           JAX package's bench.py times with killeroo)
  "medium": 64x64, 2 spp, 2 x 1,200 triangles (the card-vs-CPU checks)
  "small": 32x32, 2 spp, 2 x 312 triangles (CPU tests)

``integrator="rpf"`` gives the same scene through ``Integrator "rpf"``
(sample.pbrt's structure: the frame bench.py times second),
``integrator="ao"`` through ``Integrator "ao"`` (frame AO),
``integrator="bdpt"`` and ``"mlt"`` through the bidirectional path tracer
and Metropolis light transport (main paths G and H; ``mutations`` sets
mlt's mutationsperpixel, pbrt's 100 by default), and ``sampler=`` picks
the Sampler directive (bench.py's sampler sweep runs the RPF frame under
random, stratified and halton); ``res``, ``spp`` and ``maxdepth``
override the size's resolution, samples and the integrator's depth.

``textured_scene(size, texpng)`` is the direct-lighting textured frame
that bench.py times as its config 5: ``Integrator "directlighting"``, a
sphere area light and a distant light, a ground quad with a checkerboard
``Kd`` and a plastic sphere whose ``Kd`` is an image map (the generated
256x256 colour grid that ``write_grid_texture`` writes), 700x700 at 8 spp
("full") or 32x32 at 2 spp ("small").  ``variant="whitted"`` swaps the
integrator for ``"whitted"`` and adds a smooth glass sphere and a mirror
quad, so that the specular continuation has lobes to follow.

``caustic_scene(size)`` is the caustic scene of tpurt's sppm-against-C++
parity test (a glass sphere over a matte floor, lit by a sphere area
light; tests/test_cpp_parity.py's ``_CAUSTIC``) under
``Integrator "sppm"``: "full" is frame I (700x700, pbrt's 64 iterations
and maxdepth 5, radius 0.0171, the film's area of photons an
iteration), "small" 48x48 with 4 iterations at radius 0.25.
"""

from __future__ import annotations

import numpy as np

SIZES = {
    "full": dict(res=700, spp=8, mesh_n=128),
    "medium": dict(res=64, spp=2, mesh_n=24),
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
                  sampler: str = "halton", res: int = None, spp: int = None,
                  maxdepth: int = 5, mutations: int = None,
                  iterations: int = 4, radius: float = 0.25) -> str:
    """The stand-in scene as .pbrt text; integrator is "path", "rpf",
    "ao" (pbrt's defaults: 64 occlusion rays a hit, cosine-weighted),
    "bdpt", "mlt" or "sppm" (``iterations`` of photons at ``radius``)."""
    if integrator not in ("path", "rpf", "ao", "bdpt", "mlt", "sppm"):
        raise ValueError(f"integrator {integrator!r}")
    cfg = SIZES[size]
    v, idx = blob_mesh(cfg["mesh_n"], seed)
    v = v * 1.6
    mesh = _mesh_text(v, idx)
    res = res or cfg["res"]
    spp = spp or cfg["spp"]
    integ = (f'Integrator "{integrator}"' if integrator == "ao" else
             f'Integrator "{integrator}" "integer maxdepth" [{maxdepth}]')
    if integrator == "mlt" and mutations is not None:
        integ += f' "integer mutationsperpixel" [{mutations}]'
    if integrator == "sppm":
        integ += (f' "integer numiterations" [{iterations}]'
                  f' "float radius" [{radius}]')
    return f"""# tpurt_torch stand-in for killeroo-simple ({size})
LookAt 0 4.5 -15  0 2.2 0  0 1 0
Camera "perspective" "float fov" [39]
{sampler_directive(sampler, spp)}
{integ}
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


def with_accelerator(scene: str, accelerator: str = None, **params) -> str:
    """``scene`` with an ``Accelerator`` directive first (none when
    ``accelerator`` is None); ``params`` become its integer parameters,
    e.g. with_accelerator(text, "kdtree", maxprims=24, maxdepth=8)."""
    if accelerator is None:
        return scene
    ps = "".join(f' "integer {k}" [{int(v)}]' for k, v in params.items())
    return f'Accelerator "{accelerator}"{ps}\n' + scene


def box_mesh(lo, hi) -> str:
    """A closed axis-aligned box as a ``Shape "trianglemesh"``: 12
    triangles wound counter-clockwise seen from outside, so that its
    geometric normals point out (a MediumInterface's inside is inside)."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    v = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    pts = "  ".join("%g %g %g" % p for p in v)
    return (f'Shape "trianglemesh" "point P" [{pts}]\n'
            '  "integer indices" [0 3 2 0 2 1  4 5 6 4 6 7  0 1 5 0 5 4  '
            '3 7 6 3 6 2  0 4 7 0 7 3  1 2 6 1 6 5]\n')


def spectral_scene(integrator: str, maxdepth: int = 3, extra: str = "",
                   world: str = "", res: int = 16, spp: int = 4) -> str:
    """The small scene of the sampled-spectrum checks: a matte box and a
    plastic floor under a two-sided quad area light, triangles only (a
    quadric in the scene doubles tpurt's compile time of a render),
    ``Integrator`` with ``extra`` parameters, ``world`` inserted after
    WorldBegin."""
    return f"""
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "{integrator}" "integer maxdepth" [{maxdepth}]{extra}
Camera "perspective" "float fov" [55]
WorldBegin
{world}
AttributeBegin
  AreaLightSource "area" "color L" [30 25 20] "bool twosided" "true"
  Shape "trianglemesh" "point P" [-1 3 3  1 3 3  1 3 5  -1 3 5]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
Material "matte" "color Kd" [.6 .4 .3]
{box_mesh((-0.8, -1.6, 3.6), (0.2, -0.6, 4.6))}
Material "plastic" "color Kd" [.2 .5 .3] "color Ks" [.3 .3 .3]
Shape "trianglemesh" "point P" [-8 -1.6 -4  8 -1.6 -4  8 -1.6 12  -8 -1.6 12]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


# the sampled-spectrum checks' extra worlds: a glass box and a coloured
# mirror (whitted), and a homogeneous and a grid medium each in a
# Material "none" box (volpath)
SPECTRAL_SPECULAR_WORLD = f"""
AttributeBegin
  Material "glass"
  {box_mesh((0.7, -1.3, 2.6), (1.5, -0.5, 3.4))}AttributeEnd
AttributeBegin
  Material "mirror" "color Kr" [.8 .7 .9]
  Shape "trianglemesh" "point P" [-3 -1.6 7  -1 -1.6 7  -1 1 7  -3 1 7]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
"""


def spectral_media_world() -> str:
    dens = np.random.default_rng(5).uniform(0, 1, (5, 4, 3))
    values = " ".join("%g" % v for v in dens.astype(np.float32).ravel())
    return f"""
MakeNamedMedium "fog" "string type" "homogeneous"
  "color sigma_a" [.2 .3 .4] "color sigma_s" [.6 .5 .4]
MakeNamedMedium "smoke" "string type" "heterogeneous"
  "integer nx" [3] "integer ny" [4] "integer nz" [5]
  "float density" [{values}]
  "point p0" [0.3 -1.3 2.5] "point p1" [2.1 0.5 4.3]
  "rgb sigma_a" [0.3 0.5 0.2] "rgb sigma_s" [1.5 1.0 1.2]
AttributeBegin
  Material "none"
  MediumInterface "fog" ""
  {box_mesh((-2.6, -1.3, 2.6), (-1.2, 0.1, 4.0))}AttributeEnd
AttributeBegin
  Material "none"
  MediumInterface "smoke" ""
  {box_mesh((0.3, -1.3, 2.5), (2.1, 0.5, 4.3))}AttributeEnd
"""


def write_standin(path: str, size: str = "full", filename: str = None,
                  seed: int = 0, integrator: str = "path",
                  sampler: str = "halton", accelerator: str = None,
                  **kw) -> str:
    """Write the stand-in scene to ``path``; returns ``path``.  kw:
    standin_scene's ``res``, ``spp``, ``maxdepth`` and ``mutations``;
    ``accelerator`` "kdtree" adds the directive (frame K)."""
    with open(path, "w") as f:
        f.write(with_accelerator(standin_scene(
            size, filename or path.rsplit(".", 1)[0] + ".exr", seed,
            integrator, sampler, **kw), accelerator))
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


# ---------------------------------------------------------------------------
# scene D: pbrt-v3's other materials, quadrics, lights and cameras
# ---------------------------------------------------------------------------

D_SIZES = {
    "full": dict(res=700, spp=8, mesh_n=128),
    "medium": dict(res=64, spp=2, mesh_n=12),
    "small": dict(res=32, spp=2, mesh_n=12),
}
# the sun of the sky map: world direction (toward the sun) and radius
SUN_DIR = np.array([0.5, 0.77, -0.4]) / np.linalg.norm([0.5, 0.77, -0.4])
SUN_RADIUS_DEG = 8.0
SKY_WARM = (0.9, 0.55, 0.25)  # the sky where world x > 0 (image right)
SKY_COOL = (0.25, 0.45, 0.9)  # the sky where world x < 0 (image left)
# where the projector and the goniometric light stand and aim
PROJ_FROM, PROJ_TO = (4.5, 6.0, 6.0), (2.8, 0.0, -7.0)
GONIO_AT = (-1.0, 3.0, -8.5)


def write_sky_map(path: str, width: int = 512, height: int = 256) -> str:
    """A lat-long sky (infinite.cpp's parameterization in light space,
    +z up): a cool half and a warm half split by the sign of light-space
    x, a dim lower hemisphere and a sun spot of SUN_RADIUS_DEG around
    SUN_DIR (the light is rotated by ``Rotate -90 1 0 0``, so light-space
    (x, y, z) is world (x, -z, y))."""
    from tpurt_torch.io.image import write_image

    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = np.pi * v[:, None] * np.ones((1, width))
    phi = 2 * np.pi * u[None, :] * np.ones((height, 1))
    warm = np.cos(phi) >= 0
    sky = np.where(warm[..., None], SKY_WARM, SKY_COOL)
    sky = sky * (0.6 + 0.6 * np.sin(theta)[..., None])  # brighter horizon
    sky = np.where((theta > np.pi / 2)[..., None], 0.12, sky)
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                  np.cos(theta)], -1)
    sun_l = np.array([SUN_DIR[0], -SUN_DIR[2], SUN_DIR[1]])
    sun = d @ sun_l > np.cos(np.deg2rad(SUN_RADIUS_DEG))
    sky = np.where(sun[..., None], (30.0, 28.0, 25.0), sky)
    write_image(path, sky.astype(np.float32))
    return path


def write_slide_map(path: str, size: int = 128, period: int = 32) -> str:
    """The projection light's slide: vertical stripes, bright and nearly
    black, ``period`` pixels a pair."""
    from tpurt_torch.io.image import write_image

    col = (np.arange(size) // (period // 2)) % 2 == 0
    img = np.where(col[None, :, None], 1.0, 0.03) * np.ones((size, size, 3))
    write_image(path, img.astype(np.float32))
    return path


def write_gonio_map(path: str, width: int = 64, height: int = 32) -> str:
    """The goniometric light's map: bright for phi in [0, pi) (light-space
    z > 0 after the reference's y/z swap; scene D turns the light's z to
    world +x, so it lights the ground right of it), nearly dark for the
    rest, with a gentle falloff away from the light's horizontal."""
    from tpurt_torch.io.image import write_image

    u = (np.arange(width) + 0.5) / width
    v = (np.arange(height) + 0.5) / height
    lit = np.where(u < 0.5, 1.0, 0.02)[None, :]
    ramp = (0.5 + 0.5 * np.sin(np.pi * v))[:, None]
    img = (lit * ramp)[..., None] * np.array([1.0, 0.9, 0.7])
    write_image(path, img.astype(np.float32))
    return path


def _aim(frm, to) -> str:
    """Translate + Rotate directives that put the light's origin at
    ``frm`` with its +z axis toward ``to``."""
    d = np.subtract(to, frm, dtype=np.float64)
    d /= np.linalg.norm(d)
    ax = np.degrees(np.arcsin(-d[1]))
    ay = np.degrees(np.arctan2(d[0], d[2]))
    return (f"Translate {frm[0]} {frm[1]} {frm[2]}\n"
            f"  Rotate {ay:.6f} 0 1 0\n  Rotate {ax:.6f} 1 0 0")


def _d_maps(base: str) -> dict:
    return dict(sky=write_sky_map(base + "_sky.exr"),
                slide=write_slide_map(base + "_slide.exr"),
                gonio=write_gonio_map(base + "_gonio.exr"))


def materials_scene(size: str, maps: dict, filename: str = "materials.exr",
                    integrator: str = "path", res: int = None) -> str:
    """Scene D as .pbrt text: two instances of the stand-in mesh (one
    Disney with metallic, clearcoat and sheen, one copper metal at
    roughness 0.05), a substrate ground with anisotropic roughness, an
    uber cylinder, a translucent disk lit from behind by the projection
    light, a cone of mix (metal and matte, amount 0.3), a paraboloid of
    thin Disney (spectrans and difftrans), a hyperboloid of plastic with a
    checkerboard Kd, and four lights: a sphere area light, the infinite
    light with the sky map, the projection light and the goniometric
    light.  ``maps`` holds the paths of the three maps (write_materials
    writes them)."""
    if integrator not in ("path", "rpf", "bdpt"):
        raise ValueError(f"integrator {integrator!r}")
    cfg = D_SIZES[size]
    res = res or cfg["res"]
    v, idx = blob_mesh(cfg["mesh_n"], seed=0)
    mesh = _mesh_text(v * 1.6, idx)
    return f"""# tpurt_torch scene D ({size}): materials, quadrics, lights
LookAt 0 4.5 -15  0 1.5 0  0 1 0
Camera "perspective" "float fov" [50]
Sampler "halton" "integer pixelsamples" [{cfg["spp"]}]
Integrator "{integrator}" "integer maxdepth" [5]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
  "string filename" "{filename}"
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "string mapname" "{maps['sky']}"
AttributeEnd
AttributeBegin
  {_aim(PROJ_FROM, PROJ_TO)}
  LightSource "projection" "color I" [6000 6000 6000] "float fov" [30]
    "string mapname" "{maps['slide']}"
AttributeEnd
AttributeBegin
  Translate {GONIO_AT[0]} {GONIO_AT[1]} {GONIO_AT[2]}
  Rotate 90 0 1 0
  LightSource "goniometric" "color I" [250 250 250]
    "string mapname" "{maps['gonio']}"
AttributeEnd
AttributeBegin
  AreaLightSource "area" "color L" [14 14 14]
  Translate -3 8 -4
  Shape "sphere" "float radius" [0.8]
AttributeEnd
AttributeBegin
  Material "substrate" "color Kd" [.35 .32 .28] "color Ks" [.1 .1 .1]
    "float uroughness" [.04] "float vroughness" [.35]
  Shape "trianglemesh" "point P" [-14 0 -14  14 0 -14  14 0 16  -14 0 16]
    "float uv" [0 0 1 0 1 1 0 1] "integer indices" [0 2 1  0 3 2]
AttributeEnd
AttributeBegin
  Material "disney" "color color" [.75 .35 .2] "float metallic" [.4]
    "float roughness" [.35] "float clearcoat" [.8]
    "float clearcoatgloss" [.7] "float sheen" [.6] "float sheentint" [.5]
    "float speculartint" [.2] "float anisotropic" [.3]
  AttributeBegin
    Translate -2.4 0 2
    {mesh}  AttributeEnd
AttributeEnd
AttributeBegin
  Material "metal" "float roughness" [.05]
  AttributeBegin
    Translate 1.8 0 3.5
    Rotate 40 0 1 0
    {mesh}  AttributeEnd
AttributeEnd
AttributeBegin
  Material "uber" "color Kd" [.15 .3 .5] "color Ks" [.3 .3 .3]
    "color Kr" [.15 .15 .15] "float roughness" [.05]
  Translate -4.6 0 -1.5
  Rotate -90 1 0 0
  Shape "cylinder" "float radius" [.6] "float zmin" [0] "float zmax" [2.2]
AttributeEnd
AttributeBegin
  Material "translucent" "color Kd" [.7 .7 .6] "color Ks" [.1 .1 .1]
    "color reflect" [.4 .4 .4] "color transmit" [.6 .6 .6]
    "float roughness" [.2]
  Translate 3.6 1.5 -2.5
  Shape "disk" "float radius" [1]
AttributeEnd
MakeNamedMaterial "mixmetal" "string type" "metal" "float roughness" [.1]
MakeNamedMaterial "mixmatte" "string type" "matte"
  "color Kd" [.2 .5 .2]
AttributeBegin
  Material "mix" "string namedmaterial1" "mixmetal"
    "string namedmaterial2" "mixmatte" "color amount" [.3 .3 .3]
  Translate -3.4 0 -6
  Rotate -90 1 0 0
  Shape "cone" "float radius" [.8] "float height" [1.8]
AttributeEnd
AttributeBegin
  Material "disney" "color color" [.6 .8 .9] "bool thin" "true"
    "float spectrans" [.6] "float difftrans" [.8] "float flatness" [.4]
    "float roughness" [.3] "float eta" [1.4]
  Translate 0 0 -6.5
  Rotate -90 1 0 0
  Shape "paraboloid" "float radius" [.9] "float zmin" [0] "float zmax" [1.4]
AttributeEnd
AttributeBegin
  Texture "hypchecks" "spectrum" "checkerboard"
    "float uscale" [8] "float vscale" [4]
    "color tex1" [.85 .85 .8] "color tex2" [.6 .15 .1]
  Material "plastic" "texture Kd" "hypchecks" "color Ks" [.3 .3 .3]
    "float roughness" [.08]
  Translate 4.8 0 2.5
  Rotate -90 1 0 0
  Shape "hyperboloid" "point p1" [1 0 0] "point p2" [.5 .8 2.4]
AttributeEnd
WorldEnd
"""


def write_materials(path: str, size: str = "full", **kw) -> str:
    """Write scene D to ``path`` and its three maps beside it; returns
    ``path``.  kw: ``integrator`` ("path", "rpf" or "bdpt"), ``res``,
    ``filename``."""
    base = path.rsplit(".", 1)[0]
    with open(path, "w") as f:
        f.write(materials_scene(size, _d_maps(base),
                                kw.pop("filename", base + ".exr"), **kw))
    return path


def camera_scene(kind: str, maps: dict, filename: str = "camera.exr",
                 res: int = 64) -> str:
    """A small scene for the orthographic or the environment camera.
    "environment" sees the sky map alone (no geometry but one hidden
    triangle), so its image is the map's lookup; "orthographic" looks
    down at a plastic sphere and a copper box on a matte ground under a
    constant infinite light and a distant light (one quadric: the
    reference's compile grows with the quadrics)."""
    head = (f'Film "image" "integer xresolution" [{res}] '
            f'"integer yresolution" [{res}]\n'
            f'  "string filename" "{filename}"\n'
            'Sampler "halton" "integer pixelsamples" [2]\n'
            'Integrator "path" "integer maxdepth" [3]\n')
    if kind == "environment":
        return head + f"""LookAt 0 1 0  0 1 1  0 1 0
Camera "environment"
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "string mapname" "{maps['sky']}"
AttributeEnd
Material "matte"
Shape "trianglemesh" "point P" [0 -50 0  0.01 -50 0  0 -50 0.01]
  "integer indices" [0 1 2]
WorldEnd
"""
    if kind != "orthographic":
        raise ValueError(f"camera {kind!r}")
    return head + """LookAt 0 8 -6  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-4 4 -4 4]
WorldBegin
LightSource "infinite" "color L" [.4 .45 .5]
LightSource "distant" "point from" [2 5 -3] "color L" [2 2 1.8]
Material "matte" "color Kd" [.5 .5 .5]
Shape "trianglemesh" "point P" [-9 0 -9  9 0 -9  9 0 9  -9 0 9]
  "integer indices" [0 2 1  0 3 2]
AttributeBegin
  Material "plastic" "color Kd" [.6 .2 .2] "color Ks" [.3 .3 .3]
  Translate -1.5 1 0
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  Material "metal" "float roughness" [.2]
  Shape "trianglemesh" "point P" [1 0 -.5  2.5 0 -.5  2.5 0 1  1 0 1
      1 1.2 -.5  2.5 1.2 -.5  2.5 1.2 1  1 1.2 1]
    "integer indices" [4 5 6  4 6 7  0 1 5  0 5 4  1 2 6  1 6 5
      2 3 7  2 7 6  3 0 4  3 4 7]
AttributeEnd
WorldEnd
"""


def write_camera_scene(path: str, kind: str, **kw) -> str:
    """Write a camera scene to ``path`` (with the sky map beside it for
    "environment"); returns ``path``."""
    base = path.rsplit(".", 1)[0]
    maps = dict(sky=write_sky_map(base + "_sky.exr")) if (
        kind == "environment") else {}
    with open(path, "w") as f:
        f.write(camera_scene(kind, maps, kw.pop("filename", base + ".exr"),
                             **kw))
    return path


# frame E: motion blur, ray-traced curves and hair
E_SIZES = {
    "full": dict(res=700, spp=8, mesh_n=128, fibers=8192, ribbons=256,
                 flats=256),
    "medium": dict(res=64, spp=2, mesh_n=24, fibers=128, ribbons=32,
                   flats=32),
    "small": dict(res=24, spp=2, mesh_n=8, fibers=24, ribbons=4, flats=4),
}
HAIR_PATCH = ((-1.6, 1.6), (-5.2, -3.6))  # x and z extent of the roots
HAIR_HEIGHT = 1.6


def hair_fibers(n: int, seed: int = 1, segments: int = 4):
    """``n`` cubic Bezier fibers of ``segments`` segments each, rooted on
    the HAIR_PATCH rectangle of the ground and swaying in x and z as they
    rise: (n, 3 * segments + 1, 3) control points."""
    rng = np.random.default_rng(seed)
    (x0, x1), (z0, z1) = HAIR_PATCH
    root = np.stack([rng.uniform(x0, x1, n), np.zeros(n),
                     rng.uniform(z0, z1, n)], -1)
    t = np.linspace(0.0, 1.0, 3 * segments + 1)
    sway = rng.normal(0.0, 0.35, (n, 2))
    curl = rng.uniform(0.0, 2 * np.pi, n)
    h = HAIR_HEIGHT * rng.uniform(0.75, 1.0, n)
    x = (root[:, 0:1] + sway[:, 0:1] * t ** 2
         + 0.06 * np.sin(6 * t + curl[:, None]))
    y = h[:, None] * t
    z = (root[:, 2:3] + sway[:, 1:2] * t ** 2
         + 0.06 * np.cos(6 * t + curl[:, None]))
    return np.stack([x, y, z], -1)


def _curves_text(cps, ctype: str, w0: float, w1: float,
                 normals=None) -> str:
    out = []
    for i, cp in enumerate(cps):
        pts = " ".join(f"{v:.4f}" for v in cp.reshape(-1))
        line = (f'Shape "curve" "string type" "{ctype}" "point P" [{pts}] '
                f'"float width0" [{w0}] "float width1" [{w1}]')
        if normals is not None:
            nn = " ".join(f"{v:.4f}" for v in normals[i].reshape(-1))
            line += f' "normal N" [{nn}]'
        out.append(line)
    return "\n".join(out) + "\n"


def motion_hair_scene(size: str, filename: str = "motion_hair.exr",
                      integrator: str = "path", res: int = None) -> str:
    """Frame E as .pbrt text: a camera dollying over the shutter
    (``TransformTimes 0 1``, shutter 0..1, an ``ActiveTransform EndTime``
    translate), the two stand-in meshes translating over the shutter (frame
    A's triangles: K1's motion leaves), a partial sphere with an animated
    rotate and translate (the quaternion slerp), a patch of cubic-Bezier
    cylinder fibers under ``Material "hair"`` (eumelanin 1.3, the default
    beta_m, beta_n and alpha; 4 segments each at the default splitdepth 3),
    a patch of ribbons with ``"normal N"`` under a lighter hair, one of
    flat curves under matte, a quad carrying ``"vector S"`` under a metal
    whose u and v roughness differ, a matte ground, a sphere area light
    and a distant light."""
    if integrator not in ("path", "rpf", "bdpt"):
        raise ValueError(f"integrator {integrator!r}")
    cfg = E_SIZES[size]
    res = res or cfg["res"]
    v, idx = blob_mesh(cfg["mesh_n"], seed=0)
    mesh = _mesh_text(v * 1.6, idx)
    fibers = _curves_text(hair_fibers(cfg["fibers"]), "cylinder", 0.018,
                          0.008)
    rng = np.random.default_rng(2)
    nr = cfg["ribbons"]
    rx = rng.uniform(2.2, 4.2, nr)
    rz = rng.uniform(-6.5, -5.5, nr)
    rib = np.stack([np.stack([rx + 0.15 * k, 0.4 * k + 0.05 + 0 * rx,
                              rz - 0.1 * k * k], -1) for k in range(4)], 1)
    rib_n = np.zeros((nr, 2, 3))
    rib_n[:, 0] = [0.0, 0.0, -1.0]
    rib_n[:, 1] = [-0.6, 0.0, -0.8]
    ribbons = _curves_text(rib, "ribbon", 0.06, 0.03, rib_n)
    nf = cfg["flats"]
    fx = rng.uniform(-4.4, -2.6, nf)
    fz = rng.uniform(-6.4, -5.4, nf)
    flat = np.stack([np.stack([fx + 0.2 * np.sin(k + fx), 0.35 * k + 0 * fx,
                               fz], -1) for k in range(4)], 1)
    flats = _curves_text(flat, "flat", 0.05, 0.02)
    return f"""# tpurt_torch frame E ({size}): motion blur, curves and hair
TransformTimes 0 1
LookAt 0 4.5 -15  0 1.6 0  0 1 0
ActiveTransform EndTime
Translate 0 0 -0.4
ActiveTransform All
Camera "perspective" "float fov" [39] "float shutteropen" [0]
  "float shutterclose" [1]
Sampler "halton" "integer pixelsamples" [{cfg["spp"]}]
Integrator "{integrator}" "integer maxdepth" [5]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
  "string filename" "{filename}"
WorldBegin
LightSource "distant" "point from" [-2 6 -5] "point to" [0 0 0]
  "color L" [1.2 1.15 1.05]
AttributeBegin
  AreaLightSource "area" "color L" [30 30 30]
  Translate 3 9 -5
  Shape "sphere" "float radius" [1.2]
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "point P" [-30 0 -30  30 0 -30  30 0 30  -30 0 30]
    "integer indices" [0 2 1  0 3 2]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [0.4 0.2 0.2] "color Ks" [0.5 0.5 0.5]
    "float roughness" [0.025]
  AttributeBegin
    Translate -2.6 0 1
    ActiveTransform EndTime
    Translate 0.8 0 0
    ActiveTransform All
    {mesh}  AttributeEnd
  AttributeBegin
    Translate 2.4 0 3
    Rotate 40 0 1 0
    ActiveTransform EndTime
    Translate 0 0.5 0
    ActiveTransform All
    {mesh}  AttributeEnd
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.2 0.45 0.3]
  Translate 4.4 1.0 -2.5
  ActiveTransform EndTime
  Translate 0 0.4 0
  Rotate 35 0 1 0
  ActiveTransform All
  Rotate -90 1 0 0
  Shape "sphere" "float radius" [0.8] "float phimax" [250]
AttributeEnd
AttributeBegin
  Material "metal" "float uroughness" [0.02] "float vroughness" [0.3]
  Shape "trianglemesh" "point P" [-4.8 0.2 -3  -3.4 0.2 -2  -3.4 2.4 -2
    -4.8 2.4 -3]
    "integer indices" [0 1 2  0 2 3]
    "vector S" [0.81 0 0.58  0.81 0 0.58  0.81 0 0.58  0.81 0 0.58]
AttributeEnd
AttributeBegin
  Material "hair" "float eumelanin" [1.3]
{fibers}AttributeEnd
AttributeBegin
  Material "hair" "float eumelanin" [0.3]
{ribbons}AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.7 0.6 0.2]
{flats}AttributeEnd
WorldEnd
"""


def write_motion_hair(path: str, size: str = "full", **kw) -> str:
    """Write frame E to ``path``; returns ``path``.  kw: ``integrator``
    ("path", "rpf" or "bdpt"), ``res``, ``filename``, ``accelerator``
    ("kdtree": the moving meshes walk the kd-tree)."""
    base = path.rsplit(".", 1)[0]
    accel = kw.pop("accelerator", None)
    with open(path, "w") as f:
        f.write(with_accelerator(motion_hair_scene(
            size, kw.pop("filename", base + ".exr"), **kw), accel))
    return path


# frame F: participating media through Integrator "volpath"
F_SIZES = {
    "full": dict(res=700, spp=8, mesh_n=128, grid=64),
    "medium": dict(res=64, spp=2, mesh_n=12, grid=16),
    "small": dict(res=32, spp=2, mesh_n=12, grid=16),
}
FOG_SIGMA_A, FOG_SIGMA_S, FOG_G = 0.004, 0.018, 0.2  # optical depth ~0.5
SMOKE_CENTER, SMOKE_RADIUS = (0.4, 6.2, 1.0), 1.4  # the grid medium's sphere
SMOKE_SIGMA_A, SMOKE_SIGMA_S, SMOKE_G = 0.3, 2.7, 0.3
JADE_CENTER, JADE_RADIUS = (3.9, 1.0, -5.0), 1.0  # the glass sphere
SPOT_FROM, SPOT_CONE, SPOT_DELTA = (-6.0, 9.0, -6.0), 20.0, 4.0
WALL_Z = 8.0


def smoke_density(n: int, seed: int = 4) -> np.ndarray:
    """The grid medium's density, (n, n, n) float32 in [0, 1] indexed
    [z, y, x]: a ball falling off linearly from its centre to 0 at the
    inscribed sphere, modulated by four seeded plane waves."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    ball = np.clip(1.0 - np.sqrt(x * x + y * y + z * z), 0.0, 1.0)
    freq = rng.normal(size=(4, 3)) * 3.0
    phase = rng.uniform(0.0, 2 * np.pi, 4)
    noise = sum(np.sin(x * f[0] + y * f[1] + z * f[2] + ph)
                for f, ph in zip(freq, phase)) / 4.0
    return np.clip(ball * 1.6 * (0.65 + 0.35 * noise), 0.0,
                   1.0).astype(np.float32)


def media_scene(size: str, filename: str = "media.exr",
                res: int = None, integrator: str = "volpath",
                maxdepth: int = 5) -> str:
    """Frame F as .pbrt text: ``Integrator "volpath"`` at maxdepth 5, the
    camera in a thin homogeneous fog (``MediumInterface "" "fog"`` before
    the Camera), the stand-in's two meshes (matte and plastic) on a
    ground quad before a back wall, a ``Material "none"`` sphere bounding
    a grid medium (``"heterogeneous"``, smoke_density on the sphere's
    box), a glass sphere holding a scattering homogeneous medium
    ("jade"), a spot light aimed through the fog and the smoke sphere at
    the wall, and a sphere area light.  The media are declared before
    LookAt, so the grid's p0 and p1 are world points.  ``integrator``
    ("volpath" or "bdpt") and ``maxdepth`` set the Integrator."""
    if integrator not in ("volpath", "bdpt"):
        raise ValueError(f"integrator {integrator!r}")
    cfg = F_SIZES[size]
    res = res or cfg["res"]
    v, idx = blob_mesh(cfg["mesh_n"], seed=0)
    mesh = _mesh_text(v * 1.6, idx)
    n = cfg["grid"]
    dens = " ".join(f"{x:.4g}" for x in smoke_density(n).reshape(-1))
    c, r = np.asarray(SMOKE_CENTER), SMOKE_RADIUS
    p0 = " ".join(f"{x:g}" for x in c - r)
    p1 = " ".join(f"{x:g}" for x in c + r)
    spot_to = " ".join(f"{x:g}" for x in SMOKE_CENTER)
    spot_from = " ".join(f"{x:g}" for x in SPOT_FROM)
    return f"""# tpurt_torch frame F ({size}): participating media
MakeNamedMedium "fog" "string type" "homogeneous"
  "rgb sigma_a" [{FOG_SIGMA_A} {FOG_SIGMA_A} {FOG_SIGMA_A}]
  "rgb sigma_s" [{FOG_SIGMA_S} {FOG_SIGMA_S} {FOG_SIGMA_S}] "float g" [{FOG_G}]
MakeNamedMedium "jade" "string type" "homogeneous"
  "rgb sigma_a" [0.4 0.05 0.3] "rgb sigma_s" [1.5 1.5 1.5] "float g" [0]
MakeNamedMedium "smoke" "string type" "heterogeneous"
  "integer nx" [{n}] "integer ny" [{n}] "integer nz" [{n}]
  "point p0" [{p0}] "point p1" [{p1}]
  "rgb sigma_a" [{SMOKE_SIGMA_A} {SMOKE_SIGMA_A} {SMOKE_SIGMA_A}]
  "rgb sigma_s" [{SMOKE_SIGMA_S} {SMOKE_SIGMA_S} {SMOKE_SIGMA_S}]
  "float g" [{SMOKE_G}]
  "float density" [{dens}]
LookAt 0 4.5 -15  0 2.2 0  0 1 0
MediumInterface "" "fog"
Camera "perspective" "float fov" [39]
Sampler "halton" "integer pixelsamples" [{cfg["spp"]}]
Integrator "{integrator}" "integer maxdepth" [{maxdepth}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
  "string filename" "{filename}"
WorldBegin
LightSource "spot" "point from" [{spot_from}] "point to" [{spot_to}]
  "float coneangle" [{SPOT_CONE}] "float conedeltaangle" [{SPOT_DELTA}]
  "color I" [6000 6000 6000]
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
  Shape "trianglemesh" "point P" [-30 0 {WALL_Z:g}  30 0 {WALL_Z:g}
    30 30 {WALL_Z:g}  -30 30 {WALL_Z:g}]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [0.4 0.2 0.2] "color Ks" [0.5 0.5 0.5]
    "float roughness" [0.025]
  AttributeBegin
    Translate -2.2 0 0
    {mesh}  AttributeEnd
  Material "matte" "color Kd" [0.3 0.45 0.3]
  AttributeBegin
    Translate 2.4 0 2
    Rotate 40 0 1 0
    {mesh}  AttributeEnd
AttributeEnd
AttributeBegin
  MediumInterface "smoke" "fog"
  Material "none"
  Translate {SMOKE_CENTER[0]} {SMOKE_CENTER[1]} {SMOKE_CENTER[2]}
  Shape "sphere" "float radius" [{SMOKE_RADIUS}]
AttributeEnd
AttributeBegin
  MediumInterface "jade" "fog"
  Material "glass" "float eta" [1.5]
  Translate {JADE_CENTER[0]} {JADE_CENTER[1]} {JADE_CENTER[2]}
  Shape "sphere" "float radius" [{JADE_RADIUS}]
AttributeEnd
WorldEnd
"""


def write_media(path: str, size: str = "full", **kw) -> str:
    """Write frame F to ``path``; returns ``path``.  kw: ``res``,
    ``filename``, ``integrator``, ``maxdepth``."""
    base = path.rsplit(".", 1)[0]
    with open(path, "w") as f:
        f.write(media_scene(size, kw.pop("filename", base + ".exr"), **kw))
    return path


# frame I: the parity test's 0.25 at 48x48 scaled to the same footprint
# in pixels at 700x700 (0.25 * 48 / 700); pbrt's default radius of 1
# would put ~10^4 visible points in a grid cell at this resolution
CAUSTIC_SIZES = {
    "full": dict(res=700, iterations=64, radius=0.0171),
    "small": dict(res=48, iterations=4, radius=0.25),
}


def caustic_scene(size: str = "full", filename: str = "caustic.exr",
                  integrator: str = "sppm", res: int = None,
                  iterations: int = None, radius: float = None,
                  spp: int = 8) -> str:
    """The caustic scene's text (tpurt's tests/test_cpp_parity.py:314-336,
    a copy) at maxdepth 5: sppm takes numiterations and radius from the
    size (``res``, ``iterations``, ``radius`` override it); another
    integrator gets a Halton sampler of ``spp``."""
    cfg = CAUSTIC_SIZES[size]
    res = res or cfg["res"]
    iparams = '"integer maxdepth" [5]'
    if integrator == "sppm":
        iparams = (f'"integer numiterations" [{iterations or cfg["iterations"]}]'
                   f' {iparams} "float radius" [{radius or cfg["radius"]}]')
    return f"""LookAt 0 2.2 5  0 -0.3 0  0 1 0
Camera "perspective" "float fov" [42]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
  "string filename" "{filename}"
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "{integrator}" {iparams}
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [40 40 40]
  Translate 0 3.5 0.5
  Shape "sphere" "float radius" [0.4]
AttributeEnd
Material "glass"
AttributeBegin
  Translate 0 -0.2 0
  Shape "sphere" "float radius" [0.7]
AttributeEnd
Material "matte" "color Kd" [.6 .55 .5]
Shape "trianglemesh" "point P" [-8 -1 -8  8 -1 -8  8 -1 8  -8 -1 8]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def write_caustic(path: str, size: str = "full", integrator: str = "sppm",
                  **kw) -> str:
    """Write the caustic scene (frame I at size "full") to ``path``;
    returns ``path``.  kw: caustic_scene's ``filename``, ``res``,
    ``iterations``, ``radius``, ``spp``."""
    with open(path, "w") as f:
        f.write(caustic_scene(size, kw.pop("filename", path.rsplit(".", 1)[0]
                                           + ".exr"), integrator, **kw))
    return path


# ---------------------------------------------------------------------------
# frames L (the realistic camera) and M (ptex and a fourier BSDF)
# ---------------------------------------------------------------------------

# tpurt's test biconvex lens (tests/test_lenses.py:21-24; f ~ 35 mm), in
# pbrt's .dat format: rows scene side first, radius, thickness, ior and
# aperture diameter in mm
BICONVEX_LENS = """# simple biconvex
35.0    4.0   1.5   20.0
-35.0  50.0   1.0   20.0
"""


def write_lens(path: str) -> str:
    """Write the biconvex test lens to ``path``; returns ``path``."""
    with open(path, "w") as f:
        f.write(BICONVEX_LENS)
    return path


def realistic_scene(size: str, lensfile: str, filename: str = "realistic.exr",
                    integrator: str = "path", focusdistance: float = 15.2,
                    aperturediameter: float = 8.0, diagonal: float = 35.0,
                    **kw) -> str:
    """Frame L: the stand-in (standin_scene at ``size``; kw its ``res``,
    ``spp``, ``maxdepth``, ``sampler``) seen through ``Camera
    "realistic"`` with the lens file ``lensfile``, focused at 15.2, the
    distance from the eye at (0, 4.5, -15) to its target, at aperture
    8 mm on pbrt's default 35 mm film diagonal (a 35 mm lens: about A's
    39-degree view)."""
    text = standin_scene(size, filename, integrator=integrator, **kw)
    cam = (f'Camera "realistic" "string lensfile" ["{lensfile}"]\n'
           f'  "float focusdistance" [{focusdistance}]'
           f' "float aperturediameter" [{aperturediameter}]')
    text = text.replace('Camera "perspective" "float fov" [39]', cam)
    return text.replace('"string filename"',
                        f'"float diagonal" [{diagonal}] "string filename"')


def write_realistic(path: str, size: str = "full", **kw) -> str:
    """Write frame L to ``path`` and the lens beside it (``<base>.dat``);
    returns ``path``.  kw: realistic_scene's."""
    base = path.rsplit(".", 1)[0]
    lens = write_lens(base + ".dat")
    with open(path, "w") as f:
        f.write(realistic_scene(size, lens, kw.pop("filename", base + ".exr"),
                                **kw))
    return path


def glossy_fourier_table(n_mu: int = 48, m_max: int = 8, eta: float = 1.33,
                         kappa: float = 6.0, width: float = 0.08):
    """A synthetic three-channel (Y, R, B) Fourier BSDF table: a coloured
    diffuse term, a white glossy lobe about the mirror direction
    (mu_i = -mu_o, dphi = 0) whose azimuthal series runs to ``m_max``
    orders in the cells near it and fewer away from it, and a weak
    single-order diffuse transmission; the stored values are f * |mu_i|,
    the cdf integrates a0 over mu_i (integrate_catmull_rom_np).  Returns
    a render.fourier.FourierTableHost."""
    from tpurt_torch.render.fourier import FourierTableHost
    from tpurt_torch.sampling.interpolation import integrate_catmull_rom_np

    mu = np.cos(np.linspace(np.pi, 0.0, n_mu))
    mu[0], mu[-1] = -1.0, 1.0
    phi = np.linspace(0.0, np.pi, 1025)
    lobe = np.exp(kappa * (np.cos(phi) - 1.0))
    # the lobe's cosine series: a_0 its mean over [0, pi], a_k twice the
    # mean of lobe * cos(k phi)
    basis = np.cos(np.outer(np.arange(m_max), phi))
    f = lobe * basis
    series = (0.5 * (f[:, 1:] + f[:, :-1]) * np.diff(phi)).sum(-1) / np.pi
    series[1:] *= 2.0
    kd = np.asarray([0.25, 0.35, 0.15])  # Y, R, B
    coeffs, a0 = [], np.zeros((n_mu, n_mu), np.float32)
    offsets = np.zeros((n_mu, n_mu), np.int32)
    orders = np.zeros((n_mu, n_mu), np.int32)
    for o in range(n_mu):
        for i in range(n_mu):
            ai = abs(mu[i])
            if mu[o] * mu[i] < 0:
                near = np.exp(-(mu[i] + mu[o]) ** 2 / width)
                m = int(np.clip(1 + round((m_max - 1) * near), 1, m_max))
                c = np.zeros((3, m))
                c[:, 0] = kd / np.pi * ai
                c += 0.6 * near * series[:m] * ai
            else:
                m = 1
                c = np.full((3, 1), 0.05 / np.pi * ai)
            offsets[o, i] = len(coeffs)
            orders[o, i] = m
            coeffs.extend(c.reshape(-1))
            a0[o, i] = c[0, 0]
    _, cdf = integrate_catmull_rom_np(mu, a0.astype(np.float64))
    return FourierTableHost(eta=eta, m_max=m_max, n_channels=3, mu=mu,
                            cdf=cdf.astype(np.float32), a0=a0, m=orders,
                            a_offset=offsets,
                            a=np.asarray(coeffs, np.float32))


def ptex_faces(n: int = 256, seed: int = 5):
    """``n`` Ptex faces of powers-of-two resolutions up to 8x8, each a
    different colour ramp: face k's texels differ from face j's."""
    rng = np.random.default_rng(seed)
    faces = []
    for k in range(n):
        ru, rv = 1 << (1 + k % 3), 1 << (1 + (k // 3) % 3)
        c0, c1 = rng.uniform(0.1, 0.9, (2, 3))
        t = (np.arange(ru)[None, :] + np.arange(rv)[:, None]) / (ru + rv - 2)
        faces.append((c0 + t[..., None] * (c1 - c0)).astype(np.float32))
    return faces


def ptex_ground(grid: int = 16, half: float = 30.0) -> str:
    """The ground as grid x grid quads, each Ptex face k with its own
    vertices and face-local uv, both of its triangles tagged k through
    ``"integer faceIndices"``."""
    pts, uvs, ids, fis = [], [], [], []
    step = 2 * half / grid
    for k in range(grid * grid):
        x0, z0 = -half + (k % grid) * step, -half + (k // grid) * step
        b = 4 * k
        pts += [(x0, 0, z0), (x0 + step, 0, z0), (x0 + step, 0, z0 + step),
                (x0, 0, z0 + step)]
        uvs += [(0, 0), (1, 0), (1, 1), (0, 1)]
        ids += [b, b + 2, b + 1, b, b + 3, b + 2]
        fis += [k, k]
    j = " ".join
    return (f'Shape "trianglemesh" "point P" [{j(f"{v:g}" for p in pts for v in p)}]\n'
            f'    "float uv" [{j(f"{v:g}" for p in uvs for v in p)}]\n'
            f'    "integer indices" [{j(str(i) for i in ids)}]\n'
            f'    "integer faceIndices" [{j(str(i) for i in fis)}]\n')


def ptex_fourier_scene(size: str, ptx: str, bsdf: str,
                       filename: str = "ptex_fourier.exr",
                       integrator: str = "path", **kw) -> str:
    """Frame M: the stand-in (standin_scene at ``size``; kw its ``res``,
    ``spp``, ``maxdepth``) with both instances of its mesh under
    ``Material "fourier"`` (the .bsdf file ``bsdf``) and its ground as
    16 x 16 quads, each its own of the 256 Ptex faces of the file ``ptx``,
    under a matte ``"texture Kd"``."""
    text = standin_scene(size, filename, integrator=integrator, **kw)
    ground = ('Shape "trianglemesh" "point P" [-30 0 -30  30 0 -30  30 0 30'
              '  -30 0 30]\n    "integer indices" [0 2 1  0 3 2]\n')
    assert ground in text
    text = text.replace(
        '  Material "matte" "color Kd" [0.5 0.5 0.5]\n  ' + ground,
        '  Texture "faces" "spectrum" "ptex" "string filename" '
        f'["{ptx}"]\n  Material "matte" "texture Kd" "faces"\n  '
        + ptex_ground())
    plastic = ('Material "plastic" "color Kd" [0.4 0.2 0.2] "color Ks" '
               '[0.5 0.5 0.5]\n    "float roughness" [0.025]')
    assert plastic in text
    return text.replace(plastic,
                        f'Material "fourier" "string bsdffile" ["{bsdf}"]')


def write_ptex_fourier(path: str, size: str = "full", **kw) -> str:
    """Write frame M to ``path`` with its Ptex file (``<base>.ptx``,
    ptex_faces) and BSDF table (``<base>.bsdf``, glossy_fourier_table)
    beside it; returns ``path``.  kw: ptex_fourier_scene's."""
    from tpurt_torch.io.ptex import write_ptex
    from tpurt_torch.render.fourier import write_bsdf_file

    base = path.rsplit(".", 1)[0]
    write_ptex(base + ".ptx", ptex_faces())
    write_bsdf_file(base + ".bsdf", glossy_fourier_table())
    with open(path, "w") as f:
        f.write(ptex_fourier_scene(size, base + ".ptx", base + ".bsdf",
                                   kw.pop("filename", base + ".exr"), **kw))
    return path


# frame N's two subsurface materials: Skin1's measured coefficients (mm^-1)
# at "scale" 10, a mean free path 1 / sigma_t of 0.13 (red) to 0.067
# (blue) scene units, 2-4% of a blob's ~3.2-unit width; and a coloured
# kdsubsurface of mean free path 0.1 at eta 1.5, the second diffusion
# table (tpurt keys one by (g, eta))
SUBSURFACE_SKIN = 'Material "subsurface" "string name" "Skin1" "float scale" [10]'
SUBSURFACE_KD = ('Material "kdsubsurface" "color Kd" [0.8 0.5 0.3]'
                 ' "float mfp" [0.1] "float eta" [1.5]')


def subsurface_scene(size: str = "full", filename: str = "subsurface.exr",
                     integrator: str = "path", **kw) -> str:
    """Frame N: the stand-in (standin_scene at ``size``; kw its ``res``,
    ``spp``, ``maxdepth``, ``sampler``) with its first blob under
    SUBSURFACE_SKIN and its second under SUBSURFACE_KD; the ground, the
    wall and the sphere light as in frame A.  ``integrator``: one of
    standin_scene's, or "directlighting" or "whitted"."""
    direct = integrator in ("directlighting", "whitted")
    text = standin_scene(size, filename,
                         integrator="path" if direct else integrator, **kw)
    if direct:
        text = text.replace('Integrator "path"', f'Integrator "{integrator}"')
    plastic = ('  Material "plastic" "color Kd" [0.4 0.2 0.2] "color Ks" '
               '[0.5 0.5 0.5]\n    "float roughness" [0.025]\n')
    first = '  AttributeBegin\n    Translate -2.2 0 0\n'
    second = '  AttributeBegin\n    Translate 2.4 0 2\n'
    assert plastic in text and first in text and second in text
    text = text.replace(plastic, "")
    text = text.replace(first, f"  {SUBSURFACE_SKIN}\n{first}")
    return text.replace(second, f"  {SUBSURFACE_KD}\n{second}")


def write_subsurface(path: str, size: str = "full", **kw) -> str:
    """Write frame N to ``path``; returns ``path``.  kw:
    subsurface_scene's."""
    with open(path, "w") as f:
        f.write(subsurface_scene(size, kw.pop("filename",
                                              path.rsplit(".", 1)[0]
                                              + ".exr"), **kw))
    return path
