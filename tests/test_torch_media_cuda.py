"""The traversal kernel K1 against its plain PyTorch version on the card,
on the rays of frame F's shadow walk and of the ao integrator's occlusion
rays: every call the kernel's wrapper receives while 2^16 camera paths go
through volpath's first two bounce steps (the walk's crossing calls
included) or through ao with two samples.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_media_cuda.py``.

Bounds: prims (or occlusion) equal on >= 99.99% of lanes, t within rtol
1e-5 on >= 99.99% of the hits both find (chip_smoke.py's K1 bounds).
"""

import dataclasses

import pytest
import torch

from tpurt_torch.config import tpurt_chunk
from tpurt_torch.kernels import traverse as ktr
from tpurt_torch.render.driver import build_job
from tpurt_torch.render.integrator import ao_radiance
from tpurt_torch.render.volpath import (volpath_bounce_init,
                                        volpath_bounce_step)
from tpurt_torch.scene import load_scene_string
from tpurt_torch.testscenes import media_scene, standin_scene

pytestmark = pytest.mark.cuda
N = 1 << 16


def _lanes(job):
    total = job.film.width * job.film.height * job.sampler.spp
    ids = torch.arange(N, device="cuda") * total // N
    pid = ids // job.sampler.spp
    return (ids, pid % job.film.width, pid // job.film.width,
            ids % job.sampler.spp, total)


def _recorder():
    calls = []

    def recording(geo, o, d, t_max, any_hit, time=None, tree="tri"):
        calls.append((o, d, t_max, any_hit))
        return ktr.traverse_wide(geo, o, d, t_max, any_hit, time=time,
                                 tree=tree)

    return calls, recording


def _hold(geo, calls):
    assert calls
    for o, d, t_max, any_hit in calls:
        ref = ktr.traverse_wide_reference(geo, o, d, t_max, any_hit=any_hit)
        ker = ktr.traverse_wide(geo, o, d, t_max, any_hit=any_hit)
        if any_hit:
            agree = ((ref[1] >= 0) == (ker[1] >= 0)).float().mean().item()
            assert agree >= 0.9999, agree
            continue
        assert (ref[1] == ker[1]).float().mean().item() >= 0.9999
        both = (ref[1] >= 0) & (ker[1] >= 0)
        if both.any():
            rel = (ref[0] - ker[0]).abs()[both] / ref[0].abs()[both]
            assert (rel <= 1e-5).float().mean().item() >= 0.9999


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_k1_on_media_frame_walk_rays(cuda):
    """Frame F's geometry (the medium size's grid and meshes) at 700x700:
    the camera rays, the walk's crossings and the bounce rays."""
    job = build_job(load_scene_string(media_scene("medium", res=700)),
                    "cuda")
    assert job.scene.has_null_boundaries
    ids, px, py, sidx, total = _lanes(job)
    calls, rec = _recorder()
    st = volpath_bounce_init(job.scene, job.sampler, job.camera, px, py,
                             sidx, job.cfg, rec,
                             track_lane=ids % tpurt_chunk(total))
    for bounce in range(2):
        st = {k: None if v is None else v[st["alive"]]
              for k, v in st.items()}
        st = volpath_bounce_step(job.scene, job.sampler, job.cfg, st,
                                 bounce, rec, camera=job.camera)
    assert len(calls) > 3  # camera, crossings, bounce rays
    _hold(job.scene.geo, calls)


def test_k1_on_ao_occlusion_rays(cuda):
    """The stand-in (medium size) under ao at 700x700: the camera rays and
    two samples' occlusion rays (t_max 1e8)."""
    job = build_job(load_scene_string(standin_scene("medium",
                                                    integrator="ao")
                                      .replace("[64]", "[700]")), "cuda")
    ids, px, py, sidx, _ = _lanes(job)
    calls, rec = _recorder()
    ao_radiance(job.scene, job.sampler, job.camera, px, py, sidx,
                dataclasses.replace(job.cfg, ao_samples=2), rec)
    assert [c[3] for c in calls] == [False, True, True]
    _hold(job.scene.geo, calls)
