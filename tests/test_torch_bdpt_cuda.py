"""bdpt on the card: the small stand-in under ``Integrator "bdpt"`` (main
path G at 32x32) and frame F's small scene under bdpt (the media walk,
the medium vertices, the connection batch's shadow walk) rendered on the
card equal to the CPU, and the traversal kernel K1 against its plain
PyTorch version on a G connection batch: every call the kernel's wrapper
receives while 2^16 lanes of the stand-in at 700x700 go through
bdpt_radiance (the walk's 2n-lane closest calls, then the any-hit slices
of the connection batch).

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_bdpt_cuda.py``.

Bounds: the renders' means within 1e-3 relative, >= 99% of pixels within
1e-3 abs + 1e-3 rel (chip_smoke.py's phase 9); prims (or occlusion) equal
on >= 99.99% of lanes, t within rtol 1e-5 on >= 99.99% of the hits both
find (chip_smoke.py's K1 bounds).
"""

import numpy as np
import pytest
import torch

from tpurt_torch.config import tpurt_chunk
from tpurt_torch.render.bdpt import bdpt_radiance
from tpurt_torch.render.driver import build_job, render
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import media_scene, standin_scene
from test_torch_media_cuda import N, _hold, _lanes, _recorder

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_equals_cpu(text):
    g, job = render(load_scene_string(text), "cuda")
    h, _ = render(load_scene_string(text), "cpu")
    assert job.cfg.name == "bdpt" and np.isfinite(g).all()
    assert abs(g.mean() - h.mean()) <= 1e-3 * h.mean()
    close = (np.abs(g - h) <= 1e-3 + 1e-3 * np.abs(h)).all(axis=-1)
    assert close.mean() >= 0.99


def test_bdpt_small_standin_card_equals_cpu(cuda):
    _card_equals_cpu(standin_scene("small", integrator="bdpt"))


def test_bdpt_small_media_frame_card_equals_cpu(cuda):
    _card_equals_cpu(media_scene("small", integrator="bdpt"))


def test_k1_on_bdpt_connection_batch(cuda):
    job = build_job(load_scene_string(
        standin_scene("medium", integrator="bdpt", res=700)), "cuda")
    ids, px, py, sidx, total = _lanes(job)
    calls, rec = _recorder()
    c = tpurt_chunk(total)
    bdpt_radiance(job.scene, job.sampler, job.camera, px, py, sidx, job.cfg,
                  rec, track_lane=ids % c, track_chunk=c)
    walk = [k for k in calls if not k[3]]
    assert len(walk) == job.cfg.max_depth + 1
    assert len(calls) > len(walk) and all(k[3] for k in calls[len(walk):])
    assert all(k[0].shape[0] == 2 * N for k in walk)
    _hold(job.scene.geo, calls)
