"""One run of one benchmark cell of the port (``tpurt_torch``) on a CUDA
card.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the checkout's root;
its configuration file and its traffic mix (``portbench/traffic/
<traffic>.json``) give the scene (``portbench/scene.py``) and the entry
(``portbench/entries.py``).

1. Set-up, timed as ``setup_s`` from the start of the process: imports,
   the kernels from the checkout's cache (``build/tpurt_torch/``; built
   on a cold cache), the scene text written under ``TMPDIR`` from the
   seed, parsed, built and uploaded, and one warm-up frame.
2. The window: whole frames back to back, closed loop, one at a time,
   each image copied to the host, until the frame that crosses
   ``--seconds``.  ``frame_s`` is the window's wall time over its frames,
   ``peak_mem_gib`` the allocator's peak over the window.
3. With ``--trace 1``: each per-layer metric of the cell is read by its
   reader, ``portbench/metrics/<name>.py`` (``portbench/trace.py`` gives
   them the profiled frames and spans).
4. Correctness: the program's state is freed, pixels are drawn from the
   seed, each read from a frame of the window drawn from the seed too,
   the plain reference (``portbench/reference/``) works out the same
   pixels from the scene file alone, and the two are compared
   (``portbench/compare.py``) under the configuration's limits.
5. The compared numbers, each beside its limit, as the last lines on
   standard error; the result as the last line on standard output.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits 3.  If ``jax``, ``jaxlib``, ``flax`` or
``tpurt`` (top-level module names, compared whole) is loaded once the
window has closed, it prints no result and exits 4.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpurt")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its manifest entry, its
    configuration, its traffic mix, and its end-to-end and per-layer
    metrics (the entries of the manifest that the cell reports)."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in manifest["workloads"]}[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError(f"traffic {cell['traffic']}: only a closed loop "
                         "of one client is driven")

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if reports(m) and m["moves"] in names]
    return dict(name=name, chips=cell["chips"], config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the program
    fixes its own, ``build/tpurt_torch/``; these are for PyTorch's
    extension builder and Triton, should the program come to use them)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None) -> dict:
    """Run the cell on ``device``; returns the result (the JSON line's
    object) with the compared numbers under "checks".  ``t0``: the
    perf_counter reading set-up is timed from (the process's start)."""
    import numpy as np
    import torch

    from portbench import compare, entries
    from portbench.scene import write_scene

    t0 = _T0 if t0 is None else t0
    cuda = device == "cuda"
    config, traffic = cell["config"], cell["traffic"]
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        scene = write_scene(Path(tmp) / "scene.pbrt", config, traffic, seed)
        tb = time.perf_counter()
        job = entries.build(scene, device)
        _sync(device)
        spans = {"scene_build_s": time.perf_counter() - tb}
        frame = entries.frame_fn(config, job)
        frame()  # warm-up: every shape of the window
        _sync(device)
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        frames = []  # (seconds, image, extras)
        tw = time.perf_counter()
        while True:
            ts = time.perf_counter()
            img, extras = frame()
            _sync(device)
            frames.append((time.perf_counter() - ts, img, extras))
            if time.perf_counter() - tw >= seconds:
                break
        window_s = time.perf_counter() - tw
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        times = [f[0] for f in frames]
        log(f"{len(frames)} frames in {window_s:.4f} s: "
            + " ".join(f"{t:.4f}" for t in times)
            + f"; slowest {max(times):.4f} s, set-up {setup_s:.4f} s "
            f"(scene build {spans['scene_build_s']:.4f} s)")
        result = dict(correct=False, attempted=len(frames), failed=0)
        if trace:
            from portbench.trace import TracedRun

            traced = TracedRun(frame, device, spans, frames)
            result["metrics"] = traced.read(cell["per_layer"])
            result["device"] = traced.device_times()
            result["breakdown"] = traced.breakdown()
            del traced
        else:
            e2e = dict(frame_s=window_s / len(frames),
                       peak_mem_gib=window_peak / 2**30, setup_s=setup_s)
            result["metrics"] = {
                m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                for m in cell["end_to_end"]}
        result["device"] = dict(
            platform="gpu" if cuda else "cpu",
            kind=torch.cuda.get_device_name() if cuda else "cpu",
            count=cell["chips"] if cuda else 0,
            memory_peak_bytes=max(setup_peak, window_peak),
            **result.get("device", {}))
        del job, frame
        images = [f[1] for f in frames]
        frames.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        tr = time.perf_counter()
        res = images[0].shape[1], images[0].shape[0]
        blocks = config["blocks"]
        pixels, block = compare.pick(seed, res, blocks["count"],
                                     blocks["size"])
        which = compare.frame_of(seed, blocks["count"], len(images))[block]
        values = np.stack([images[f][y, x] for f, (y, x)
                           in zip(which, pixels)])
        reference = importlib.import_module(config["reference"])
        ref = reference.judge(scene, pixels,
                              config["rpf"]["box_sizes"][-1], device)
        nums = compare.numbers(values, ref["value"], ref["unfiltered"])
        log(f"reference {time.perf_counter() - tr:.4f} s ({len(pixels)} "
            f"pixels in {blocks['count']} blocks from "
            f"{len(set(which.tolist()))} of {len(images)} frames)")
    limits = config["limits"]
    result["correct"] = bool(limits) and compare.held(nums, limits)
    result["failed"] = (0 if result["correct"]
                        else len(set(which.tolist())))
    result["readings"] = nums  # every number, held or not: stderr only
    result["checks"] = {k: {"value": nums[k], "limit": lim}
                        for k, lim in limits.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"no cell {args.workload!r}: {e!r}")
        return 2
    fixed_caches()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is False)")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell['chips']}")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 4
    readings = result.pop("readings")
    log("readings: " + " ".join(f"{k} {v:.6g}" for k, v in readings.items()))
    log(f"correct {result['correct']} ({result['failed']} of "
        f"{result['attempted']} frames judged not correct)")
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}")
    print(json.dumps(result), flush=True)
    return 0
