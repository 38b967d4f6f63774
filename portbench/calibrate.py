"""The readings the correctness limits are set from (PERF.md), on the card
at the cell's own size, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3]

For each seed: the cell's scene, one frame through the program's entry
(after a warm-up frame), the program's state freed, and the plain
reference at the pixels a run of that seed draws, compared as a run
compares them ("sound").  For each control seed: the reference in the
control's precision against the reference at the same pixels
("control").  One JSON line per reading on standard output, then each
number's largest sound reading and smallest control reading.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import compare, entries
from portbench.run import fixed_caches, load_cell
from portbench.scene import write_scene


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    args = ap.parse_args(argv)
    fixed_caches()
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    box = config["rpf"]["box_sizes"][-1]
    reference = importlib.import_module(config["reference"])
    sound, control = [], {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            scene = write_scene(Path(tmp) / "scene.pbrt", config, traffic,
                                seed)
            res = (config["scene"]["res"],) * 2
            blocks = config["blocks"]
            pixels, _ = compare.pick(seed, res, blocks["count"],
                                     blocks["size"])
            img = None
            if seed in args.seeds:
                job = entries.build(scene, "cuda")
                frame = entries.frame_fn(config, job)
                frame()
                img = frame()[0]
                del job, frame
                gc.collect()
                torch.cuda.empty_cache()
            t = time.perf_counter()
            ctls = (reference.CONTROLS if seed in args.control_seeds
                    else ())
            ref = reference.judge(scene, pixels, box, "cuda", ctls)
            ref_s = time.perf_counter() - t
            if img is not None:
                nums = compare.numbers(img[pixels[:, 0], pixels[:, 1]],
                                       ref["value"], ref["unfiltered"])
                sound.append(nums)
                print(json.dumps(dict(kind="sound", seed=seed,
                                      reference_s=ref_s, **nums)),
                      flush=True)
            for ctl in ctls:
                nums = compare.numbers(ref[ctl], ref["value"],
                                       ref["unfiltered"])
                control.setdefault(ctl, []).append(nums)
                print(json.dumps(dict(kind="control", control=ctl,
                                      seed=seed, **nums)), flush=True)
    summary = dict(kind="summary", workload=args.workload,
                   gpu=torch.cuda.get_device_name())
    if sound:
        summary["lower"] = {k: max(r[k] for r in sound) for k in sound[0]}
    for ctl, rs in control.items():
        summary[f"upper_{ctl}"] = {k: min(r[k] for r in rs) for k in rs[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
