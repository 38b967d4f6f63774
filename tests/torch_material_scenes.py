"""Scenes and checks shared by the tests of the materials, quadrics, lights
and cameras slice (scene D): the material kinds one sphere each, the
whole-frame comparison against tpurt, and the standing bounds.

Bounds of a frame against tpurt: the standing ones of the port's render
tests, image means within 1e-3 relative and >= 99% of pixels within 1e-3
abs + 1e-3 rel.  The first measured run of the 32x32 scene D under path
gave means 2.2e-6 apart and every pixel within the bound.
"""

import numpy as np

# one sphere of each material kind the slice adds, in this order; the
# mix's two named sub-materials are appended to the table after them
KINDS = ("metal", "metal_uv", "uber", "substrate", "translucent", "disney",
         "disney_thin", "mix", "mix_dominant2")
KIND_MATERIALS = {
    # copper defaults, no u/v roughness (metal's None slots)
    "metal": 'Material "metal" "float roughness" [.05]',
    "metal_uv": ('Material "metal" "float uroughness" [.08] '
                 '"float vroughness" [.3] "color eta" [.2 .9 1.1] '
                 '"color k" [3.9 2.4 2.1] "bool remaproughness" "false"'),
    "uber": ('Material "uber" "color Kd" [.2 .3 .5] "color Ks" [.3 .3 .3] '
             '"color Kr" [.2 .2 .2] "color Kt" [.3 .3 .3] '
             '"float roughness" [.05] "float index" [1.4]'),
    "substrate": ('Material "substrate" "color Kd" [.4 .3 .2] '
                  '"color Ks" [.2 .2 .2] "float uroughness" [.04] '
                  '"float vroughness" [.35]'),
    "translucent": ('Material "translucent" "color Kd" [.7 .7 .6] '
                    '"color Ks" [.2 .2 .2] "color reflect" [.4 .4 .4] '
                    '"color transmit" [.6 .5 .6] "float roughness" [.2]'),
    "disney": ('Material "disney" "color color" [.75 .35 .2] '
               '"float metallic" [.4] "float roughness" [.35] '
               '"float clearcoat" [.8] "float clearcoatgloss" [.7] '
               '"float sheen" [.6] "float sheentint" [.5] '
               '"float speculartint" [.2] "float anisotropic" [.3] '
               '"float spectrans" [.3]'),
    "disney_thin": ('Material "disney" "color color" [.6 .8 .9] '
                    '"bool thin" "true" "float spectrans" [.6] '
                    '"float difftrans" [.8] "float flatness" [.4] '
                    '"float roughness" [.3] "float eta" [1.4]'),
    "mix": ('Material "mix" "string namedmaterial1" "mixmetal" '
            '"string namedmaterial2" "mixmatte" "color amount" [.3 .3 .3]'),
    "mix_dominant2": ('Material "mix" "string namedmaterial1" "mixmetal" '
                      '"string namedmaterial2" "mixplastic" '
                      '"color amount" [.8 .6 .7]'),
}


def kinds_scene(kinds=KINDS) -> str:
    """A sphere a material kind, with a point light and a sphere area
    light; the material ids follow ``kinds``."""
    spheres = "".join(
        f"AttributeBegin\n  {KIND_MATERIALS[k]}\n  Translate {2.5 * i} 0 0\n"
        f'  Shape "sphere" "float radius" [1]\nAttributeEnd\n'
        for i, k in enumerate(kinds))
    return f"""Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 2 -9  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "point from" [0 6 -3] "color I" [20 20 20]
MakeNamedMaterial "mixmetal" "string type" "metal" "float roughness" [.1]
MakeNamedMaterial "mixmatte" "string type" "matte" "color Kd" [.2 .5 .2]
MakeNamedMaterial "mixplastic" "string type" "plastic"
  "color Kd" [.5 .2 .2] "float roughness" [.2]
{spheres}WorldEnd
"""


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def check_close(got, want):
    """The standing bounds of a frame against tpurt."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0.01
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    ok = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99


def render_both(text: str, d):
    """(tpurt image, tpurt job, port CLI image) of a scene, its files
    under the directory ``d``; tpurt renders on the JAX CPU backend."""
    from tpurt.render.driver import render as tpurt_render
    from tpurt.scene import load_scene_string as tpurt_load_scene_string
    from tpurt_torch import cli
    from tpurt_torch.io.image import read_image

    path = d / "scene.pbrt"
    path.write_text(text)
    want, job = tpurt_render(tpurt_load_scene_string(text), progress=False)
    out = d / "port.pfm"
    assert cli.main([str(path), "--device", "cpu", "--outfile", str(out),
                     "--quiet"]) == 0
    return np.asarray(want), job, read_image(str(out))


def write_maps(d) -> dict:
    """Scene D's three maps under the directory ``d``."""
    from tpurt_torch.testscenes import (write_gonio_map, write_sky_map,
                                        write_slide_map)

    return dict(sky=write_sky_map(str(d / "sky.exr")),
                slide=write_slide_map(str(d / "slide.exr")),
                gonio=write_gonio_map(str(d / "gonio.exr")))


def check_from_tpurt_tables(job, got):
    """The port's render of tpurt's own tables (tpurt_torch.convert) is
    the port's render of the scene text."""
    from tpurt_torch.convert import scene_from_tpurt
    from tpurt_torch.render.driver import job_from_tables, render_job

    img = render_job(job_from_tables(scene_from_tpurt(job), "cpu"))
    check_close(img, got)
