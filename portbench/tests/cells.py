"""Helpers of portbench's tests: a cell of BENCHMARK.json cut to a size
the CPU renders in seconds (64x64 at 4 samples a pixel, the stand-in at
24 longitudes, 64 blocks of 8x8 pixels drawn); the harness, the program
and the reference run unchanged on it."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small_cell(name: str, res: int = 64, spp: int = 4, mesh_n: int = 24):
    cell = copy.deepcopy(run.load_cell(name))
    cell["config"]["scene"].update(res=res)
    cell["config"]["scene"]["standin"]["n"] = mesh_n
    cell["config"]["blocks"] = {"count": 64, "size": 8}
    cell["traffic"]["sampler_params"] = {"integer pixelsamples": [spp]}
    return cell


CELLS = [w["name"] for w in manifest()["workloads"]]
