"""The whole ported slice against tpurt: part 2 of the cases of
test_torch_render.py, in files of at most three cases so that xdist's
loadfile queue runs them beside the suite's long files.  Helpers, fixtures
and bounds are those of test_torch_render.py.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.render.driver import render
from tpurt_torch.scene import load_scene_string
from test_torch_render import (  # noqa: F401  (fixtures among them)
    BASE,
    OK,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_supported_base_scene_renders_on_cpu():
    img, _ = render(load_scene_string(BASE.format(**OK)), device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("key,value,feature", [
    ("sampler", "adaptive", 'Sampler "adaptive"'),
    ("material", "fourier", 'Material "fourier"'),
    ("filter", "catmullrom", 'PixelFilter "catmullrom"'),
    ("camera", "realistic", 'Camera "realistic"'),
    ("kd", '"texture Kd" "checks"', 'Texture "ptex"'),
])
def test_outside_the_slice_raises(key, value, feature):
    """A feature outside the port raises NotImplementedError by name.  The
    fourier material, the realistic camera and the ptex texture are
    ported: each raises ValueError naming the feature and its missing
    input file (.bsdf, lens, .ptx), where tpurt renders black, a
    45-degree perspective camera or 0.5 grey."""
    text = BASE.format(**dict(OK, **{key: value}))
    missing = {'Material "fourier"': ("missing.bsdf", '"string bsdffile"'),
               'Camera "realistic"': ("missing.dat", '"string lensfile"'),
               'Texture "ptex"': ("faces.ptx", None)}.get(feature)
    if "ptex" in feature:
        text = text.replace("WorldBegin", 'WorldBegin\nTexture "checks" '
                            '"spectrum" "ptex" "string filename" "faces.ptx"')
    elif missing is not None:
        text = text.replace(feature, f'{feature} {missing[1]} '
                            f'"{missing[0]}"')
    exc = NotImplementedError if missing is None else ValueError
    match = feature if missing is None else f"{feature}.*{missing[0]}"
    with pytest.raises(exc, match=match):
        render(load_scene_string(text), device="cpu")


@pytest.mark.parametrize("key,value", [
    ("integrator", "directlighting"), ("integrator", "whitted"),
    ("sampler", "sobol"), ("sampler", "random"), ("sampler", "stratified"),
    ("sampler", "02sequence"), ("sampler", "maxmindist"),
    ("material", "glass"), ("material", "mirror"), ("light", "spot"),
    ("light", "distant"), ("filter", "gaussian"), ("filter", "mitchell"),
    ("filter", "triangle"), ("filter", "sinc"),
    ("kd", '"texture Kd" "checks"'),
    ("material", "metal"), ("material", "uber"), ("material", "substrate"),
    ("material", "translucent"), ("material", "disney"),
    ("light", "infinite"), ("light", "goniometric"), ("light", "projection"),
    ("shape", "cylinder"), ("shape", "disk"), ("shape", "cone"),
    ("shape", "paraboloid"), ("shape", "hyperboloid"),
    ("camera", "orthographic"), ("camera", "environment"),
    ("material", "hair"), ("shape", "curve"),
    ("integrator", "volpath"), ("integrator", "ao"), ("material", "none"),
    ("medium", 'MakeNamedMedium "fog" "string type" "homogeneous"\n'
               'MediumInterface "" "fog"'),
    ("integrator", "bdpt"), ("integrator", "mlt"), ("integrator", "sppm"),
    ("accel", 'Accelerator "kdtree"'),
    ("material", "subsurface"), ("material", "kdsubsurface"),
])
def test_what_earlier_slices_refused_now_renders(key, value, monkeypatch):
    """Each feature this slice added, one at a time in the base scene.
    mlt's bootstrap shrinks to 2^12 rows a depth (render/mlt.py's
    N_BOOTSTRAP) and sppm runs 4 iterations so that the cases run in
    seconds."""
    from tpurt_torch.render import mlt

    monkeypatch.setattr(mlt, "N_BOOTSTRAP", 1 << 12)
    text = "LookAt 0 1 -5  0 0 0  0 1 0\n" + BASE.format(
        **dict(OK, **{key: value})).replace(
        "WorldBegin", 'WorldBegin\nTexture "checks" "spectrum" '
        '"checkerboard" "float uscale" [4] "float vscale" [4]')
    if value == "sppm":
        text = text.replace('Integrator "sppm"',
                            'Integrator "sppm" "integer numiterations" [4]')
    if value == "spot":  # aim it at the sphere from the light's place
        text = text.replace('"point from" [0 4 0]',
                            '"point from" [0 4 0] "point to" [0 0 0]')
    if value in ("goniometric", "projection"):  # placed by the CTM: above,
        text = text.replace(  # looking down
            f'LightSource "{value}" "point from" [0 4 0]',
            f'AttributeBegin\nTranslate 0 4 0\nRotate 90 1 0 0\n'
            f'LightSource "{value}" "color I" [20 20 20]\nAttributeEnd')
    if value == "curve":  # a curve takes control points, not a radius
        text = text.replace('Shape "curve" "float radius" [1]',
                            'Shape "curve" "point P" [-1 0 0 0 1 0 1 -1 0 '
                            '2 0 0] "float width" [0.4]')
    if value == "environment":  # most of its rays escape: give them sky
        text = text.replace("WorldBegin", 'WorldBegin\nLightSource '
                            '"infinite" "color L" [.5 .5 .5]')
    img, job = render(load_scene_string(text), device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    # (every surface specular under a point light: nothing to see)
    assert img.mean() > 0 or key == "material"
    if key == "medium":  # path renders a scene with media, ignoring them
        assert job.scene.has_media and job.cfg.name == "path"
