"""The RPF stand-in through the port's CLI on the CPU under every sampler,
each with one of the pixel filters (the samplers and filters themselves
are held to tpurt's in test_torch_samplers.py and test_torch_direct.py;
here the whole frame runs and is sane: no bound against tpurt)."""

import numpy as np
import pytest
import torch

from tpurt_torch import cli
from tpurt_torch.io.image import read_image
from tpurt_torch.rpf.driver import feature_exr_paths
from tpurt_torch.testscenes import standin_scene

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.mark.parametrize("sampler,scramble,pixel_filter", [
    ("halton", "affine", "box"), ("halton", "pbrt", "gaussian"),
    ("random", "", "mitchell"), ("stratified", "", "triangle"),
    ("02sequence", "", "sinc"), ("sobol", "", "gaussian"),
    ("maxmindist", "", "box"),
])
def test_cli_renders_rpf_standin_under_every_sampler_and_filter(
        tmp_path, monkeypatch, sampler, scramble, pixel_filter):
    """The RPF stand-in (8x8) through the CLI on the CPU under each
    sampler, with each filter: a finite image near the stand-in's level
    and the six feature EXRs."""
    if scramble:
        monkeypatch.setenv("TPURT_HALTON_SCRAMBLE", scramble)
    out = tmp_path / "frame.exr"
    text = standin_scene("small", str(out), integrator="rpf",
                         sampler=sampler).replace("[32]", "[8]").replace(
        'PixelFilter "box"', f'PixelFilter "{pixel_filter}"').replace(
        'Sampler "stratified"', 'Sampler "stratified" "integer xsamples" [2] '
        '"integer ysamples" [1]')
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    assert cli.main([str(path), "--device", "cpu", "--quiet"]) == 0
    img = read_image(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert 0.05 < img.mean() < 0.5
    assert all(np.isfinite(read_image(p)).all()
               for p in feature_exr_paths(str(out)))
