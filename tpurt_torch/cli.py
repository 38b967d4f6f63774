"""Command line for the ported slices (counterpart of tpurt/cli.py).

    python -m tpurt_torch.cli scene.pbrt --device cuda

renders each scene with its integrator and writes the image named by the
scene's Film (or --outfile) through tpurt_torch.io (EXR, PFM or PNG by
extension).  ``Integrator "rpf"`` runs the sampling pass, the RPF filter
at box 7 and the splat, and writes the six feature EXRs beside the Film's
filename.  ``Integrator "mlt"`` runs the bootstrap and the Metropolis
chains over bdpt (render.driver.render dispatches it to render/mlt.py, as
tpurt's cli.py:109-113 does).  The device is
explicit: --device cuda (the default) raises when CUDA is absent; pass
--device cpu to render on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurt_torch",
        description="PyTorch/CUDA port of tpurt's path and RPF slices")
    ap.add_argument("scenes", nargs="*", help=".pbrt scene files")
    ap.add_argument("--outfile", "-o", help="override Film filename")
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution, 1 spp (pbrt --quick)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--cropwindow", nargs=4, type=float,
                    metavar=("X0", "X1", "Y0", "Y1"))
    ap.add_argument("--spectrum", choices=("rgb", "sampled"), default="rgb",
                    help="spectral representation (only rgb is ported)")
    ap.add_argument("--device", default="cuda",
                    help="render device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=(logging.WARNING if args.quiet
               else logging.DEBUG if args.verbose else logging.INFO),
        format="%(levelname).1s %(name)s: %(message)s")
    log = logging.getLogger("tpurt_torch")
    if not args.scenes:
        ap.print_usage()
        print("error: no scene files given", file=sys.stderr)
        return 1
    if args.spectrum != "rgb":
        raise NotImplementedError("--spectrum sampled")

    from tpurt_torch.io.image import write_image
    from tpurt_torch.render.driver import load_scene, render

    for path in args.scenes:
        log.info("parsing %s", path)
        sd = load_scene(path)
        if sd.integrator_name == "rpf":
            from tpurt_torch.rpf.driver import render_rpf

            img, job, _extras = render_rpf(sd, device=args.device,
                                           quick=args.quick,
                                           crop_override=args.cropwindow)
        else:
            img, job = render(sd, device=args.device, quick=args.quick,
                              crop_override=args.cropwindow)
        out = args.outfile or job.film.filename
        write_image(out, img)
        log.info("wrote %s (%dx%d)", out, img.shape[1], img.shape[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
