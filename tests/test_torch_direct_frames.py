"""The directlighting frame of the direct-lighting textured slice: the port
against tpurt (scene, bounds and checks in torch_frame_scenes.py).  The
test ids keep the frame's name."""

import pytest
import torch

import torch_frame_scenes as frames

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["directlighting"])
def renders(request, tmp_path_factory):
    return frames.render_both(request.param,
                              tmp_path_factory.mktemp(request.param))


def test_textured_frame_cli_matches_tpurt(renders):
    frames.check_cli_matches_tpurt(renders)


def test_textured_frame_from_tpurt_tables_matches_tpurt(renders):
    frames.check_from_tpurt_tables_matches_tpurt(renders)
