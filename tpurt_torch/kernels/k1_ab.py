"""Paired timing of the traversal kernel's bodies in two checkouts, in one
call.

    python3 tpurt_torch/kernels/k1_ab.py OTHER_ROOT[,ROOT_Q,...]
        [--body K1,K1m,K1c,K1k,K1km] [--order pccppc] [--profile]

Each body is timed per launch (bursts of 10, median of 5) on its frame's
recorded rays (``chip_smoke.py``'s ``frame_ray_calls``, the calls of the
camera paths and the first bounce steps that launch the body):
  K1: frame A's 2^20 primary rays (the stand-in at 700x700, 8 spp);
  K1m: frame E's triangle calls (700x700, 8 spp, two bounce steps: the
    camera rays, then each step's shadow and bounce rays);
  K1c: frame E's curve calls (the same frame and steps);
  K1k: frame K's calls (A's stand-in under Accelerator "kdtree");
  K1km: frame E under the kd-tree at 256x256 (one bounce step).
This checkout ("c") and the one at OTHER_ROOT ("p", e.g. the parent commit
unpacked with ``git archive``; further roots, comma-separated, are "q",
"r", ... in the order string) run in the given order, each side in a
process of its own that imports only its own tree.  ``--profile`` also
traces one frame a side (E for K1m and K1c, K for K1k) and prints its
device busy time with the body's share.  Prints one line a run, body and
call, then the medians of the runs; needs one CUDA card.
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
BODIES = ("K1", "K1m", "K1c", "K1k", "K1km")
# the kernel each body's profiled frame is read for
PROFILED = {"K1m": "traverse_wide_kernel<1>", "K1c": "traverse_wide_kernel<2>",
            "K1k": "traverse_kd_kernel<0>"}


def _frame(cs, body: str):
    """(job, bounces) of the frame a body is timed on."""
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.testscenes import write_motion_hair, write_standin

    cs.WORK.mkdir(parents=True, exist_ok=True)
    if body == "K1":
        path, bounces = cs.phase_scene("full"), 0
    elif body in ("K1m", "K1c"):
        path = write_motion_hair(str(cs.WORK / "ab_e.pbrt"), "full")
        bounces = 2
    elif body == "K1k":
        path = write_standin(str(cs.WORK / "ab_k.pbrt"), "full",
                             accelerator="kdtree")
        bounces = 2
    else:
        path = write_motion_hair(str(cs.WORK / "ab_ekd.pbrt"), "full",
                                 res=256, accelerator="kdtree")
        bounces = 1
    return build_job(load_scene(path), "cuda"), bounces


def _one(root: str, label: str, bodies, profile: bool) -> None:
    """Time each body for the tree at ``root`` (run in a child process)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    import torch
    from tpurt_torch.kernels.traverse import (LEAF_KINDS, leaf_kind,
                                              load_library, traverse_wide)
    from tpurt_torch.render.driver import render_job

    load_library()
    names = {k: v[1] for k, v in LEAF_KINDS.items()}
    profiled = set()  # frames traced (K1m and K1c share E)
    for body in bodies:
        job, bounces = _frame(cs, body)
        geo = job.scene.geo
        if body == "K1":
            calls = [cs.frame_ray_sets(job)["primary"]]
        else:
            calls = [c for c in cs.frame_ray_calls(job, bounces)
                     if names[leaf_kind(geo, c[4], c[5])] == body]
        for i, (o, d, tm, any_hit, time_, tree) in enumerate(calls):
            ms = cs.cuda_ms(lambda: traverse_wide(
                geo, o, d, tm, any_hit, time=time_, tree=tree), burst=10)
            print(f"AB {body} {label} call {i} "
                  f"({'any-hit' if any_hit else 'closest'}, {o.shape[0]} "
                  f"rays): {ms:.4f} ms per launch in bursts of 10")
        frame = "E" if body in ("K1m", "K1c") else "K"
        if profile and body in PROFILED and frame not in profiled:
            profiled.add(frame)
            render_job(job)
            torch.cuda.synchronize()
            t0 = time.time()
            render_job(job)
            torch.cuda.synchronize()
            wall = time.time() - t0
            print(f"PROFILE {body} {label}: frame {wall:.4f} s unprofiled; "
                  f"the body is the kernel {PROFILED[body]}")
            cs.phase_profile(f"{body} frame ({label})",
                             lambda: render_job(job), wall, host=False)
        del job
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--body", default="K1",
                    help="comma-separated: " + ",".join(BODIES))
    ap.add_argument("--order", default="pccppc")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bodies = args.body.split(",")
    if set(bodies) - set(BODIES):
        ap.error(f"--body takes {','.join(BODIES)}")
    if args.child:
        _one(*args.child, bodies, args.profile)
        return 0
    roots = {"c": HERE}
    for letter, root in zip("pqrstuvwxyz", args.other.split(",")):
        roots[letter] = os.path.abspath(root)
    if set(args.order) - set(roots):
        ap.error(f"--order letters: {''.join(roots)}")
    out = {}
    for side in args.order:
        cmd = [sys.executable, os.path.abspath(__file__), args.other,
               "--body", args.body, "--child", roots[side], side]
        res = subprocess.run(cmd + (["--profile"] if args.profile else []),
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout[-4000:] + res.stderr[-4000:])
            return res.returncode
        for ln in res.stdout.splitlines():
            if ln.startswith(("AB ", "PROFILE ", "profile ", "  ")):
                print(ln)
            if ln.startswith("AB "):
                body, _, _, call = ln.split()[1:5]
                ms = float(ln.split("): ")[1].split()[0])
                out.setdefault((body, int(call)), {}).setdefault(
                    side, []).append(ms)
    for (body, call), runs in out.items():
        c = statistics.median(runs["c"])
        print(f"medians {body} call {call}: " + ", ".join(
            f"{side} {statistics.median(ms):.4f} ms {ms} (c / {side} "
            f"{c / statistics.median(ms):.2f})"
            for side, ms in sorted(runs.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
