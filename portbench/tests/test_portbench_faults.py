"""The harness's run, the chip check skipped, with the program broken
underneath: ``correct`` must come out false for each fault the cells can
have (one card, so no exchange between chips):

- a step that returns its state unchanged: the RPF filter returns its
  input buffer;
- half of the batch left out, the mean taken over the rest: every other
  sample of a pixel dropped before the filter;
- an answer altered where it is produced: the radiance of every sample
  raised by 1% as the program writes it into the RPF sample buffer.
"""

import time

import pytest
import torch

from portbench import run
from portbench.tests.cells import CELLS, small_cell

torch.set_num_threads(1)


def _faults():
    import tpurt_torch.rpf.driver as rpf
    from tpurt_torch.rpf.filter import COL

    fill = rpf.fill_sample_buffer

    def altered(job):
        buf = fill(job)
        buf[..., COL] *= 1.01
        return buf

    return {
        "unchanged": (rpf, "apply_rpf_filter", lambda b, *a, **k: b),
        "half": (rpf, "fill_sample_buffer",
                 lambda job: fill(job)[:, :, ::2].contiguous()),
        "altered": (rpf, "fill_sample_buffer", altered),
    }


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    target, attr, fn = _faults()[fault]
    monkeypatch.setattr(target, attr, fn)
    res = run.run_cell(cell, 2**33 + 3, 0.1, False, device="cpu",
                       t0=time.perf_counter())
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
