"""The whole ported slice against tpurt: part 3 of the cases of
test_torch_render.py, in files of at most three cases so that xdist's
loadfile queue runs them beside the suite's long files.  Helpers, fixtures
and bounds are those of test_torch_render.py.
"""

import pytest
import torch

from tpurt_torch import cli
from tpurt_torch.config import resolve_device
from tpurt_torch.scene import load_scene_string
from test_torch_render import (  # noqa: F401  (fixtures among them)
    BASE,
    OK,
)

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


def test_halton_pbrt_scramble_selected_by_environment(monkeypatch):
    from tpurt_torch.render.driver import build_job

    monkeypatch.setenv("TPURT_HALTON_SCRAMBLE", "pbrt")
    job = build_job(load_scene_string(BASE.format(**OK)), "cpu")
    assert job.sampler.scramble == "pbrt" and job.sampler.perms is not None
    monkeypatch.delenv("TPURT_HALTON_SCRAMBLE")
    job = build_job(load_scene_string(BASE.format(**OK)), "cpu")
    assert job.sampler.scramble == "affine" and job.sampler.perms is None


def test_cli_sampled_spectrum_raises(tmp_path):
    """--spectrum sampled is a rendering mode of the port: the CLI takes
    it and goes on to the scene, where what raises is a missing file by
    name: the scene's, or a fourier material's .bsdf file (tpurt renders
    the material black)."""
    with pytest.raises(FileNotFoundError):
        cli.main([str(tmp_path / "missing.pbrt"), "--device", "cpu",
                  "--spectrum", "sampled"])
    scene = tmp_path / "fourier.pbrt"
    bsdf = str(tmp_path / "missing.bsdf")
    scene.write_text(BASE.format(**dict(
        OK, material="fourier", kd=f'"string bsdffile" "{bsdf}"')))
    with pytest.raises(ValueError, match=f'Material "fourier".*{bsdf}'):
        cli.main([str(scene), "--device", "cpu", "--quiet", "--spectrum",
                  "sampled"])


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
