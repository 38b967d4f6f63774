"""Statistics, profiling phases, and progress reporting (port of
tpurt/utils/stats.py, the same registry and report format, so the two
CLIs print the same report for the same scene).

Reference analog: core/stats.{h,cpp} (STAT_COUNTER / STAT_MEMORY_COUNTER /
STAT_INT_DISTRIBUTION / STAT_PERCENT / STAT_RATIO macros :283-340, the
category/name-grouped report printed at WorldEnd api.cpp:1636-1643, and the
ProfilePhase sampling profiler :254) and core/progressreporter.{h,cpp}.

The thread-local counter merging disappears (host code is single-threaded
around the device); device-side quantities arrive as reductions read once
a render step.  ProfilePhase becomes a wall-clock context manager per
pipeline phase (the SIGPROF bitmask profiler's job is covered by the
CLI's --profile torch.profiler trace).
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Any, Dict, Optional, Tuple

import torch


class _Distribution:
    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, value: float, count: int = 1):
        self.count += count
        self.total += value * count if count > 1 else value
        self.min = min(self.min, value)
        self.max = max(self.max, value)


class StatsRegistry:
    """Named counters/distributions grouped 'Category/Name' like the
    reference's stats titles (e.g. 'Integrator/Camera rays traced')."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.memory: Dict[str, int] = defaultdict(int)
        self.distributions: Dict[str, _Distribution] = defaultdict(_Distribution)
        self.percents: Dict[str, Tuple[int, int]] = defaultdict(lambda: (0, 0))
        self.ratios: Dict[str, Tuple[int, int]] = defaultdict(lambda: (0, 0))
        self.phase_times: Dict[str, float] = defaultdict(float)

    def counter(self, title: str, value: int = 1):
        self.counters[title] += int(value)

    def memory_counter(self, title: str, nbytes: int):
        self.memory[title] += int(nbytes)

    def distribution(self, title: str, value: float, count: int = 1):
        self.distributions[title].add(value, count)

    def percent(self, title: str, num: int = 0, denom: int = 0):
        n, d = self.percents[title]
        self.percents[title] = (n + num, d + denom)

    def ratio(self, title: str, num: int = 0, denom: int = 0):
        n, d = self.ratios[title]
        self.ratios[title] = (n + num, d + denom)

    def clear(self):
        self.__init__()

    # -- report (format mirrors StatsAccumulator::Print) --------------------
    def report(self, file=None) -> str:
        by_cat: Dict[str, list] = defaultdict(list)

        def split(title):
            return title.split("/", 1) if "/" in title else ("Misc", title)

        for t, v in sorted(self.counters.items()):
            c, n = split(t)
            by_cat[c].append(f"    {n:<42}{v:>12d}")
        for t, v in sorted(self.memory.items()):
            c, n = split(t)
            mib = v / (1024.0 * 1024.0)
            by_cat[c].append(f"    {n:<42}{mib:>9.2f} MiB")
        for t, d in sorted(self.distributions.items()):
            if not d.count:
                continue
            c, n = split(t)
            avg = d.total / d.count
            by_cat[c].append(
                f"    {n:<42}{avg:>12.3f} avg [range {d.min:g} - {d.max:g}]")
        for t, (num, den) in sorted(self.percents.items()):
            if not den:
                continue
            c, n = split(t)
            by_cat[c].append(f"    {n:<42}{num:>12d} / {den:d} "
                             f"({100.0 * num / den:.2f}%)")
        for t, (num, den) in sorted(self.ratios.items()):
            if not den:
                continue
            c, n = split(t)
            by_cat[c].append(f"    {n:<42}{num:>12d} / {den:d} "
                             f"({num / den:.2f}x)")
        lines = ["Statistics:"]
        for cat in sorted(by_cat):
            lines.append(f"  {cat}")
            lines.extend(by_cat[cat])
        if self.phase_times:
            lines.append("  Profile (wall clock)")
            total = sum(self.phase_times.values())
            for name, t in sorted(self.phase_times.items(),
                                  key=lambda kv: -kv[1]):
                lines.append(f"    {name:<42}{t:>10.2f} s "
                             f"({100.0 * t / max(total, 1e-9):5.1f}%)")
        out = "\n".join(lines)
        if file is not None:
            print(out, file=file)
        return out


STATS = StatsRegistry()

# lanes whose subsurface probe chain still had chord left after its last
# step (tpurt's integrator.py:659-661)
BSS_OVERFLOW = "Subsurface/Probe chain budget exhausted"


class TrackStats:
    """Counters of the bounded loops, kept on the device and read once a
    frame (render/driver.py:report_loop_counters): the overflow counts of
    the media loops (render/volpath.py) and of the subsurface probe chain
    (render/integrator.py) under tpurt's names
    (``_report_budget_overflow``, integrator.py:1279-1297), and the
    grid-tracking steps taken (their sum, the lanes tracked, the most one
    lane took)."""

    def __init__(self):
        self._acc: Dict[str, Any] = {}

    def reset(self) -> None:
        self._acc = {}

    def add(self, name: str, value, op: str = "sum") -> None:
        if name not in self._acc:
            self._acc[name] = value
        elif op == "max":
            self._acc[name] = torch.maximum(torch.as_tensor(
                self._acc[name]), torch.as_tensor(value))
        else:
            self._acc[name] = self._acc[name] + value

    def read(self) -> Dict[str, int]:
        return {k: int(v) for k, v in self._acc.items()}


TRACK_STATS = TrackStats()


def print_stats(file=None) -> str:
    return STATS.report(file or sys.stderr)


class ProfilePhase:
    """Wall-clock phase timer (ProfilePhase analog; stats.h:254).  Usable
    as a context manager or decorator."""

    def __init__(self, name: str, registry: Optional[StatsRegistry] = None):
        self.name = name
        self.reg = registry or STATS

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.reg.phase_times[self.name] += time.time() - self.t0
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with self:
                return fn(*a, **kw)

        return wrapped


class ProgressReporter:
    """Terminal progress bar with ETA (progressreporter.h:50-85).  The
    reference redraws from a background thread; here callers call update()
    from the chunk loop, which is just as live for a wavefront renderer."""

    def __init__(self, total: int, title: str, quiet: bool = False,
                 file=None, width: int = 38):
        self.total = max(1, total)
        self.title = title
        self.done = 0
        self.t0 = time.time()
        self.quiet = quiet
        self.file = file or sys.stderr
        self.width = width
        self._last_len = 0

    def update(self, n: int = 1):
        self.done += n
        if self.quiet:
            return
        frac = min(1.0, self.done / self.total)
        filled = int(self.width * frac)
        el = time.time() - self.t0
        eta = el / max(frac, 1e-9) * (1 - frac)
        bar = "+" * filled + " " * (self.width - filled)
        line = (f"\r{self.title}: [{bar}] ({el:.1f}s|{eta:.1f}s)  ")
        self.file.write(line)
        self.file.flush()
        self._last_len = len(line)

    def done_report(self):
        if not self.quiet:
            self.update(0)
            self.file.write("\n")
            self.file.flush()
