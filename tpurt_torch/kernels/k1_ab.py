"""Paired timing of the traversal kernel K1 in two checkouts, in one call.

    python3 tpurt_torch/kernels/k1_ab.py OTHER_ROOT [--order pccppc]

K1's time per launch (bursts of 10, median of 15) on frame A's 2^20
primary rays (``chip_smoke.py``'s stand-in at 700x700, 8 spp, the rays of
``frame_ray_sets``) for this checkout ("c") and the checkout at
OTHER_ROOT ("p", e.g. the parent commit unpacked with ``git archive``),
in the given order, each side in a process of its own that imports only
its own tree.  Prints one line a run and the medians; needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _one(root: str, label: str) -> None:
    """Time K1 for the tree at ``root`` (run in a child process)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from tpurt_torch.kernels.traverse import load_library, traverse_wide
    from tpurt_torch.render.driver import build_job, load_scene

    load_library()
    job = build_job(load_scene(cs.phase_scene("full")), "cuda")
    o, d, tm = cs.frame_ray_sets(job)["primary"][:3]
    geo = job.scene.geo
    runs = [cs.cuda_ms(lambda: traverse_wide(geo, o, d, tm, False),
                       burst=10) for _ in range(15)]
    print(f"K1 {label} {root}: median {statistics.median(runs):.4f} ms, "
          f"min {min(runs):.4f}, max {max(runs):.4f} per launch in bursts "
          f"of 10")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--order", default="pccppc")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _one(*args.child)
        return 0
    out = {"p": [], "c": []}
    for side in args.order:
        root = os.path.abspath(args.other) if side == "p" else HERE
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              args.other, "--child", root, side],
                             capture_output=True, text=True, check=True)
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("K1 ")]
        print(line[-1])
        out[side].append(float(line[-1].split("median ")[1].split()[0]))
    print(f"medians of the runs: other {statistics.median(out['p']):.4f} ms "
          f"{out['p']}, this {statistics.median(out['c']):.4f} ms {out['c']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
