"""The port's command line, part 2: ``--profile DIR``, the statistics
report and the flags accepted for compatibility (tpurt_torch/cli.py
against tpurt/cli.py), on the CPU.

Bounds: the trace a Chrome-trace JSON with the render's events (the
sppm ranges among them); the report's SPPM/Photon paths followed equal
to iterations x photons, and its Scene lines equal to tpurt's report
after tpurt's build of the same scene; --seed and --nthreads change
nothing in the image.
"""

import json

import numpy as np
import torch

from tpurt.render.driver import build_job as tpurt_build_job
from tpurt.scene import load_scene as tpurt_load_scene
from tpurt.utils.stats import STATS as TPURT_STATS
from tpurt_torch import cli
from tpurt_torch.io.image import read_image
from tpurt_torch.render.sppm import CAMERA_RANGE, DEPOSIT_RANGE
from tpurt_torch.testscenes import write_caustic
from tpurt_torch.utils.stats import STATS

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def _scene(tmp_path):
    return write_caustic(str(tmp_path / "c.pbrt"), "small", res=12,
                         iterations=2)


def test_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    out = str(tmp_path / "o.pfm")
    assert cli.main([_scene(tmp_path), "--device", "cpu", "-o", out,
                     "--quiet", "--profile", str(prof)]) == 0
    traces = list(prof.glob("*.json"))
    assert [t.name for t in traces] == ["000_c.pt.trace.json"]
    names = {e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert CAMERA_RANGE in names and DEPOSIT_RANGE in names


def _section(report: str, title: str):
    lines = report.splitlines()
    i = lines.index(f"  {title}")
    out = []
    for ln in lines[i + 1:]:
        if not ln.startswith("    "):
            break
        out.append(ln)
    return out


def test_print_stats_reports_photons_and_scene(tmp_path, capsys):
    path = _scene(tmp_path)
    STATS.clear()
    capsys.readouterr()
    assert cli.main([path, "--device", "cpu", "-o",
                     str(tmp_path / "o.pfm")]) == 0
    report = capsys.readouterr().err
    assert report.count("Statistics:") == 1
    photons = _section(report, "SPPM")
    assert photons == [f"    {'Photon paths followed':<42}{2 * 144:>12d}"]
    TPURT_STATS.clear()
    tpurt_build_job(tpurt_load_scene(path))
    want = TPURT_STATS.report()
    assert _section(report, "Scene") == _section(want, "Scene")
    assert _section(report, "Memory") == _section(want, "Memory")


def test_seed_and_nthreads_are_accepted(tmp_path):
    path = _scene(tmp_path)
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    assert cli.main([path, "--device", "cpu", "-o", a, "--quiet"]) == 0
    assert cli.main([path, "--device", "cpu", "-o", b, "--quiet",
                     "--seed", "7", "--nthreads", "3"]) == 0
    np.testing.assert_array_equal(read_image(a), read_image(b))
