"""The control on the card: the plain reference in the precision below the
one its configuration states (bfloat16 for float32: the filter computed
from a sample buffer held in bfloat16) must come out as not correct,
where the program comes out correct, at 128x128 with the full stand-in
(the cells' own size is read by ``python3 -m portbench.calibrate``;
PERF.md has those readings)."""

import pytest
import torch

from portbench import compare, entries, reference
from portbench.scene import write_scene
from portbench.tests.cells import CELLS, small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_holds(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = small_cell(name, res=128, spp=8, mesh_n=128)
    config = cell["config"]
    for seed in (1, 2, 3):
        scene = write_scene(tmp_path / f"s{seed}.pbrt", config,
                            cell["traffic"], seed)
        pixels, _ = compare.pick(seed, (128, 128), 16, 16)
        ref = reference.judge(scene, pixels, 7, "cuda",
                              controls=(config["control"],))
        job = entries.build(scene, "cuda")
        img = entries.frame_fn(config, job)()[0]
        prog = img[pixels[:, 0], pixels[:, 1]]
        assert compare.held(compare.numbers(prog, ref["value"],
                                            ref["unfiltered"]),
                            config["limits"])
        assert not compare.held(compare.numbers(ref[config["control"]],
                                                ref["value"],
                                                ref["unfiltered"]),
                                config["limits"])
