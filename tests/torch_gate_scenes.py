"""Shared by test_torch_gates.py and test_torch_gates_specular.py.

The analytic gate scenes (a furnace, an area light seen directly, a
mirror, a plastic highlight) rendered by the port and by tpurt under the
path, directlighting and whitted integrators, on the CPU.

The scenes are those of tpurt's own end-to-end tests with their
closed-form checks; each is rendered at 16x16 by both packages from the
same samples.  Bounds: the closed-form values as tpurt's tests hold them,
and the port against tpurt with the standing image bounds (means within
1e-3 relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel).
"""

import numpy as np
from tpurt.render.driver import render as tpurt_render
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.render.driver import render
from tpurt_torch.scene import load_scene_string

HEAD = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "{sampler}" "integer pixelsamples" [{spp}]
Integrator "{integrator}" {depth}
Camera "perspective" "float fov" [{fov}]
WorldBegin
"""

FURNACE = HEAD + """
LightSource "point" "color I" [3.1415926 3.1415926 3.1415926]
Material "matte" "color Kd" [.5 .5 .5] "float sigma" [0]
ReverseOrientation
Shape "sphere" "float radius" [1]
WorldEnd
"""

AREA_LIGHT = HEAD + """
AttributeBegin
  AreaLightSource "area" "color L" [4 4 4] "bool twosided" "true"
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""

MIRROR = HEAD + """
AttributeBegin
  AreaLightSource "area" "color L" [5 5 5] "bool twosided" "true"
  Translate 0 8 0
  Shape "sphere" "float radius" [2]
AttributeEnd
Material "mirror" "color Kr" [.9 .9 .9]
Translate 0 0 6
Shape "sphere" "float radius" [2]
WorldEnd
"""

PLASTIC = HEAD + """
AttributeBegin
  AreaLightSource "area" "color L" [30 30 30]
  Translate 3 3 1
  Shape "sphere" "float radius" [.3]
AttributeEnd
Material "plastic" "color Kd" [.2 .2 .6] "color Ks" [.7 .7 .7]
  "float roughness" [.05]
Translate 0 0 4
Shape "sphere" "float radius" [1]
WorldEnd
"""

CASES = {
    "furnace-path": (FURNACE, dict(integrator="path", sampler="random",
                                   spp=8, fov=45)),
    "furnace-directlighting": (FURNACE, dict(integrator="directlighting",
                                             sampler="02sequence", spp=4,
                                             fov=45)),
    "arealight-path": (AREA_LIGHT, dict(integrator="path", spp=4, fov=45)),
    "arealight-whitted": (AREA_LIGHT, dict(integrator="whitted", spp=4,
                                           fov=45)),
    "mirror-path": (MIRROR, dict(integrator="path", spp=8, fov=40,
                                 depth='"integer maxdepth" [3]')),
    "mirror-whitted": (MIRROR, dict(integrator="whitted", spp=8, fov=40,
                                    depth='"integer maxdepth" [3]')),
    "plastic-directlighting": (PLASTIC, dict(integrator="directlighting",
                                             spp=8, fov=45)),
}




def render_both(name):
    """(tpurt image, port image) of one case, both on the CPU."""
    text, kw = CASES[name]
    text = text.format(**dict(dict(sampler="halton", depth=""), **kw))
    want, _ = tpurt_render(tpurt_load_scene_string(text), progress=False)
    got, _ = render(load_scene_string(text), device="cpu")
    return np.asarray(want), got


def check_matches_tpurt(want, got):
    assert got.shape == want.shape == (16, 16, 3) and np.isfinite(got).all()
    assert want.mean() > 1e-3
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    ok = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert ok.all(axis=-1).mean() >= 0.99


def check_closed_form(name, img):
    """tpurt's closed-form checks, on the port's image."""
    scene, integrator = name.split("-")
    if scene == "furnace":
        # camera and light at the centre of a Kd = 0.5 sphere: direct light
        # gives 0.5, each further bounce half of the one before
        want = (sum(0.5 ** k for k in range(1, 6)) if integrator == "path"
                else 0.5)
        assert abs(img.mean() - want) < 0.02
    elif scene == "arealight":
        hot = img[img[..., 0] > 3.9]  # pixels inside the emitter read L
        assert len(hot) > 12
        np.testing.assert_allclose(hot, 4.0, rtol=1e-3)
        assert (img[0, 0] == 0).all()
    elif scene == "mirror":
        # the light's reflection: through the specular chain with no MIS
        # weight, under whitted as under path
        assert img.max() > 2.0 and img.mean() > 0.001
    else:
        body = np.median(img[img.sum(-1) > 0.01].reshape(-1))
        assert img.max() > 4 * body
