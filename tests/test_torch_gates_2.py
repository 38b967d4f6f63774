"""Gate scene, the diffuse furnace under directlighting: the port against tpurt
and against the closed forms (scenes, bounds and checks in
torch_gate_scenes.py).  One scene a file, since each is a cold tpurt jit."""

import pytest
import torch

import torch_gate_scenes as gates

# one torch thread: the suite runs in parallel processes, and torch's
# default of a thread per core only spins on these small tensors
torch.set_num_threads(1)

NAMES = ["furnace-directlighting"]


@pytest.fixture(scope="module", params=NAMES)
def images(request):
    return (request.param,) + gates.render_both(request.param)


def test_gate_scene_matches_tpurt(images):
    gates.check_matches_tpurt(images[1], images[2])


def test_gate_scene_closed_form(images):
    gates.check_closed_form(images[0], images[2])
