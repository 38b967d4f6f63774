"""Paired timing of frames G (bdpt) and H (mlt) in two checkouts, in one call.

    python3 tpurt_torch/render/frame_ab.py OTHER_ROOT [--order pccp]

For this checkout ("c") and the checkout at OTHER_ROOT ("p", e.g. an
earlier tree unpacked with ``git archive``), in the given order, each side
in a process of its own that imports only its own tree: frame G
(``chip_smoke.py``'s stand-in under ``Integrator "bdpt"``, 700x700, 8 spp,
maxdepth 5) rendered three times after one warm-up (the median), then
frame H (the stand-in under ``Integrator "mlt"``, 100 mutations a pixel,
2^20 chains) rendered once through ``render_mlt_job``.  Prints one line a
side and frame, G's kernel launches a frame (one more render, the card's
activity profiled), and the medians; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _one(root: str, label: str) -> None:
    """Time G and H for the tree at ``root`` (run in a child process)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import torch
    from tpurt_torch.render.driver import build_job, load_scene, render_job
    from tpurt_torch.render.mlt import render_mlt_job
    from tpurt_torch.testscenes import write_standin

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    cs.WORK.mkdir(parents=True, exist_ok=True)
    g = build_job(load_scene(write_standin(
        str(cs.WORK / "ab_bdpt.pbrt"), "full", integrator="bdpt")), "cuda")
    render_job(g)  # warm-up
    runs = [timed(lambda: render_job(g)) for _ in range(3)]
    print(f"G {label} {root}: median {statistics.median(runs):.4f} s, runs "
          f"{['%.4f' % r for r in runs]}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render_job(g)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    print(f"launches G {label} {root}: {launches} kernel launches a frame")
    sd = load_scene(write_standin(str(cs.WORK / "ab_mlt.pbrt"), "full",
                                  integrator="mlt"))
    h = build_job(sd, "cuda")
    h_s = timed(lambda: render_mlt_job(h, sd.integrator_params,
                                       n_chains=1 << 20))
    print(f"H {label} {root}: {h_s:.4f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--order", default="pccp")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _one(*args.child)
        return 0
    out = {(f, s): [] for f in "GH" for s in "pc"}
    for side in args.order:
        root = os.path.abspath(args.other) if side == "p" else HERE
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              args.other, "--child", root, side],
                             capture_output=True, text=True, check=True)
        print(*[ln for ln in res.stdout.splitlines()
                 if ln.startswith("launches ")], sep="\n")
        for frame in "GH":
            line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith(f"{frame} ")][-1]
            print(line)
            out[frame, side].append(float(line.split(": ")[1].split()[
                1 if frame == "G" else 0]))
    for frame in "GH":
        p, c = out[frame, "p"], out[frame, "c"]
        print(f"{frame} medians of the runs: other "
              f"{statistics.median(p):.4f} s {p}, this "
              f"{statistics.median(c):.4f} s {c}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
