"""The plain reference against the program on the CPU, for each traffic
mix: the harness's whole run (scene, set-up, window, comparison) comes
out correct at 64x64; the reference's sampling pass gives the program's
sample buffer to float32 rounding but on a lane in a few hundred (a path
that turns on a knife edge); its filter, given the program's own buffer,
gives the program's filtered pixels."""

import time

import numpy as np
import pytest
import torch

from portbench import entries, reference, run
from portbench.reference import geometry, path, pbrt, rpf, sampler
from portbench.scene import write_scene
from portbench.tests.cells import CELLS, small_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct_on_the_cpu(name):
    cell = small_cell(name)
    res = run.run_cell(cell, 2**33 + 11, 0.1, False, device="cpu",
                       t0=time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cell["config"]["limits"])


def _program(cell, tmp_path, res=16):
    from tpurt_torch.rpf.driver import render_rpf_job

    cell = small_cell(cell, res=res, spp=2, mesh_n=12)
    scene = write_scene(tmp_path / "s.pbrt", cell["config"], cell["traffic"],
                        5)
    job = entries.build(scene, "cpu")
    _, extras = render_rpf_job(job, write_feature_exrs=False,
                               return_buffers=True)
    return scene, extras


@pytest.mark.parametrize("name", CELLS)
def test_reference_samples_match_program(name, tmp_path):
    scene, extras = _program(name, tmp_path)
    raw = extras["raw_buffer"].reshape(-1, 19)
    sc = pbrt.read_scene(scene)
    g = geometry.Geometry(sc, "cpu")
    tracer = path.Tracer(sc, g, sampler.make(sc.sampler, *sc.res))
    pid = np.arange(16 * 16)
    lanes = (np.repeat(pid % 16, 2), np.repeat(pid // 16, 2),
             np.tile(np.arange(2), len(pid)))
    rows = tracer.trace(lanes).numpy()
    # the sampler's streams: film positions and lens samples to an ulp
    assert np.allclose(rows[:, [0, 1, 5, 6]], raw[:, [0, 1, 5, 6]],
                       rtol=2.4e-7, atol=6e-8)
    scale = np.abs(raw).max(0) + 1e-6
    close = (np.abs(rows - raw) <= 1e-4 * scale).all(-1)
    assert close.mean() >= 0.99 and raw[:, 2:5].mean() > 0


def test_reference_filter_matches_program(tmp_path):
    """The filter alone, on the program's own sample buffer."""
    scene, extras = _program(CELLS[0], tmp_path, res=12)
    raw = torch.tensor(extras["raw_buffer"])
    prog = extras["filtered_buffer"][..., 2:5].mean(2)
    h, w, s, _ = raw.shape
    offs, centre = rpf.box_offsets(7)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    win_y = yy.reshape(-1, 1) + np.array([o[0] for o in offs])
    win_x = xx.reshape(-1, 1) + np.array([o[1] for o in offs])
    inside = torch.tensor((win_y >= 0) & (win_y < h) & (win_x >= 0)
                          & (win_x < w))
    window = raw[torch.tensor(win_y).clamp(0, h - 1),
                 torch.tensor(win_x).clamp(0, w - 1)].reshape(h * w, -1, 19)
    ok = inside.repeat_interleave(s, dim=1)
    window = torch.where(ok[..., None], window, 0.0)
    centre_rows = torch.zeros(len(offs), dtype=torch.bool)
    centre_rows[centre] = True
    out = rpf.filter_pixels(raw.reshape(h * w, s, 19), window, ok,
                            centre_rows.repeat_interleave(s), 7)
    assert np.allclose(out.numpy().reshape(h, w, 3), prog, rtol=1e-5,
                       atol=1e-7)


def test_judge_rejects_other_integrators(tmp_path):
    cell = small_cell(CELLS[0])
    cell["config"]["scene"]["integrator"] = "path"
    scene = write_scene(tmp_path / "s.pbrt", cell["config"], cell["traffic"],
                        1)
    with pytest.raises(ValueError):
        reference.judge(scene, [[0, 0]], 7, "cpu")
