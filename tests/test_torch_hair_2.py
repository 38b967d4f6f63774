"""The hair material's table rows against tpurt's on the CPU: the
C_HAIR0 columns [sigma_a rgb, eta, beta_m, beta_n, alpha] by
CreateHairMaterial's precedence (sigma_a, then color, then the melanin
concentrations, then the default eumelanin 1.3), the gray diffuse
stand-in of the lobe columns, and a textured hair parameter, which warns
and takes its default as in tpurt; and the LobeSet's hair flag, which
keeps every hair term out of frames without hair.

Bounds: the fused rows bit for bit.
"""

import logging

import numpy as np
import torch

from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene_string as tpurt_load_scene_string
from tpurt_torch.render.driver import host_tables
from tpurt_torch.render.materials_build import lobe_slots
from tpurt_torch.scene import load_scene_string

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

HAIRS = [
    'Material "hair"',
    'Material "hair" "float eumelanin" [0.4] "float pheomelanin" [0.9]',
    'Material "hair" "rgb sigma_a" [0.2 0.5 0.9] "float eta" [1.4]',
    'Material "hair" "rgb color" [0.6 0.4 0.2] "float beta_n" [0.5]',
    'Material "hair" "float beta_m" [0.15] "float alpha" [3]',
    'Material "hair" "texture beta_m" "grid" "float eumelanin" [1.3]',
]


def _scene(materials) -> str:
    shapes = "".join(
        f'AttributeBegin\n{m}\nTranslate {i} 0 0\n'
        f'Shape "sphere" "float radius" [0.4]\nAttributeEnd\n'
        for i, m in enumerate(materials))
    return f"""Film "image" "integer xresolution" [4] "integer yresolution" [4]
Camera "perspective"
WorldBegin
Texture "grid" "float" "checkerboard"
LightSource "point" "point from" [0 4 0]
{shapes}WorldEnd
"""


def test_hair_rows_match_tpurt(caplog):
    text = _scene(HAIRS)
    want = np.asarray(tpurt_build_job(
        tpurt_load_scene_string(text)).scene.mt_table)
    with caplog.at_level(logging.WARNING, logger="tpurt_torch.render"):
        got = host_tables(load_scene_string(text))["mt_table"]
    assert got.tobytes() == want.tobytes()
    assert any('textured "beta_m"' in r.getMessage() for r in caplog.records)


def test_lobe_set_holds_hair_only_where_the_table_does():
    hair = host_tables(load_scene_string(_scene(HAIRS[:2])))["mt_table"]
    none = host_tables(load_scene_string(
        _scene(['Material "matte"', 'Material "plastic"'])))["mt_table"]
    assert lobe_slots(hair).hair and not lobe_slots(none).hair
