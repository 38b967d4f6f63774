"""What the per-layer readers (``portbench/metrics/<name>.py``) read: the
traced run's spans and frames, and one frame profiled on the device
alone, made at its first use and kept.

A reader is a module with ``read(run) -> float | None``, ``run`` a
TracedRun; None leaves the metric out of the result (a reader that finds
nothing to read never returns 0).
"""

from __future__ import annotations

import importlib.util
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_reader(name: str):
    """The reader module of the per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_records(prof):
    """(name, start_ns, duration_ns, linked correlation id) of every
    device operation in the profiler's raw records."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns(),
             e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _union_s(starts, ends) -> float:
    """Seconds covered by the union of [start, end) intervals (ns)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    gap = np.maximum(s[1:] - reach[:-1], 0)
    return float((reach[-1] - s[0] - gap.sum()) / 1e9) if len(s) else 0.0


class TracedRun:
    """The traced part of a ``--trace 1`` run.

    frame: the cell's frame callable (entries); device: "cuda" (the
    profiled readings need the card); spans: host seconds the harness
    took ("scene_build_s"); frames: the window's (seconds, image,
    extras)."""

    def __init__(self, frame, device, spans, frames):
        self.frame, self.device = frame, device
        self.spans = dict(spans)
        self.frame_s = [f[0] for f in frames]
        self.extras = [f[2] for f in frames]
        self.wall_s = statistics.median(self.frame_s)
        self._cache = {}

    def _once(self, key, make):
        if key not in self._cache:
            t = time.perf_counter()
            self._cache[key] = make()
            _log(f"trace {key}: {time.perf_counter() - t:.2f} s")
        return self._cache[key]

    def read(self, metrics) -> dict:
        """{name: {"value", "unit"}} of the per-layer ``metrics`` (the
        manifest's entries) whose readers find something to read."""
        out = {}
        for m in metrics:
            value = load_reader(m["name"]).read(self)
            if value is None:
                _log(f"{m['name']}: nothing to read")
                continue
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    # ---- one frame on the device alone
    def device_profile(self) -> dict:
        """One frame profiled with the device's activity alone, summed
        from the raw records: "ops" {name: (count, seconds)}, "launches"
        (device operations: kernels, copies, sets), "busy_s" (the union
        of their intervals), "window_s" (the profiled frame's wall time),
        "gaps" {name of the operation that ended the gap: idle seconds}."""
        return self._once("device_profile", self._device_profile)

    def _warm_profiler(self):
        # the first profile of a process pays the profiler's start-up
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize()

    def _device_profile(self) -> dict:
        from torch.profiler import ProfilerActivity, profile

        self._warm_profiler()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            self.frame()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t
        recs = _device_records(prof)
        ops = {}
        for name, _s, dur, _c in recs:
            n, sec = ops.get(name, (0, 0.0))
            ops[name] = (n + 1, sec + dur / 1e9)
        starts = np.array([r[1] for r in recs], np.int64)
        ends = starts + np.array([r[2] for r in recs], np.int64)
        gaps = {}
        if len(recs) > 1:
            order = np.argsort(starts, kind="stable")
            reach = np.maximum.accumulate(ends[order])
            idle = starts[order][1:] - reach[:-1]
            for i in np.nonzero(idle > 0)[0]:
                name = recs[order[i + 1]][0]
                gaps[name] = gaps.get(name, 0.0) + idle[i] / 1e9
        return dict(ops=ops, launches=len(recs),
                    busy_s=_union_s(starts, ends), window_s=window_s,
                    gaps=gaps)

    # ---- the result line's device times and breakdown
    def device_times(self) -> dict:
        p = self.device_profile()
        return dict(busy_s=p["busy_s"], window_s=p["window_s"])

    def breakdown(self) -> dict:
        p = self.device_profile()
        ops = sorted(((k[:120], v[1]) for k, v in p["ops"].items()),
                     key=lambda x: -x[1])[:10]
        gaps = sorted(((f"before {k[:113]}", v) for k, v in
                       p["gaps"].items()), key=lambda x: -x[1])[:10]
        return dict(device_ops=[list(x) for x in ops],
                    idle_gaps=[list(x) for x in gaps])
