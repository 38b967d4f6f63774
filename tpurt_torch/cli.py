"""Command line of the port (counterpart of tpurt/cli.py, pbrt's
main/pbrt.cpp:76-139).

    python -m tpurt_torch.cli scene.pbrt --device cuda
    python -m tpurt_torch.cli - < scene.pbrt        # the scene from stdin

renders each scene with its integrator and writes the image named by the
scene's Film (or --outfile) through tpurt_torch.io (EXR, PFM or PNG by
extension), then prints the statistics report (utils/stats.py) unless
--quiet.  ``Integrator "rpf"`` runs the sampling pass, the RPF filter at
box 7 and the splat, and writes the six feature EXRs beside the Film's
filename; ``"mlt"`` and ``"sppm"`` go through render.driver.render to
render/mlt.py and render/sppm.py.  --cat prints the parsed scene as pbrt
statements and renders nothing; --toply does the same and writes each
triangle mesh of more than 500 triangles to mesh_NNNNN.ply in the
current directory.  --profile DIR writes a torch.profiler trace of each
scene's render to DIR (Chrome trace JSON, one file a scene).  --nthreads
and --seed are accepted for pbrt's and tpurt's command line and read by
nothing.  The device is explicit: --device cuda (the default) raises
when CUDA is absent; pass --device cpu to render on the CPU.
--spectrum sampled renders path, volpath, directlighting, whitted, bdpt,
mlt and sppm with 60-bin spectra (spectrum_sampled.py); rpf renders in RGB
with a warning, ao is colourless.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys


def _profiled(out_dir: str, index: int, path: str):
    """A torch.profiler context that writes one Chrome trace to out_dir
    on exit (host activity, and the card's when CUDA is present)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    name = ("stdin" if path == "-"
            else os.path.splitext(os.path.basename(path))[0])
    trace = os.path.join(out_dir, f"{index:03d}_{name}.pt.trace.json")

    @contextlib.contextmanager
    def ctx():
        os.makedirs(out_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(trace)
        logging.getLogger("tpurt_torch").info("profile trace: %s", trace)

    return ctx()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurt_torch",
        description="PyTorch/CUDA port of tpurt (pbrt-v3 with RPF)")
    ap.add_argument("scenes", nargs="*", help=".pbrt scene files (- = stdin)")
    ap.add_argument("--outfile", "-o", help="override Film filename")
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution, 1 spp (pbrt --quick)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--cropwindow", nargs=4, type=float,
                    metavar=("X0", "X1", "Y0", "Y1"))
    ap.add_argument("--nthreads", type=int, default=0,
                    help="accepted for pbrt CLI compatibility and not read "
                         "(the device runs every lane)")
    ap.add_argument("--seed", type=int, default=0,
                    help="accepted for tpurt CLI compatibility and not read "
                         "(mlt reads the scene's \"integer seed\")")
    ap.add_argument("--cat", action="store_true",
                    help="print the parsed scene as canonical pbrt "
                         "statements and exit (pbrt --cat)")
    ap.add_argument("--toply", action="store_true",
                    help="like --cat, but write big triangle meshes to PLY "
                         "files in the current directory (pbrt --toply)")
    ap.add_argument("--spectrum", choices=("rgb", "sampled"), default="rgb",
                    help="spectral representation: rgb (RGBSpectrum, the "
                         "reference default) or sampled (60-bin "
                         "SampledSpectrum, pbrt.h PBRT_SAMPLED_SPECTRUM)")
    ap.add_argument("--profile", metavar="DIR", default="",
                    help="write a torch.profiler trace of each scene's "
                         "render to DIR (Chrome trace JSON)")
    ap.add_argument("--device", default="cuda",
                    help="render device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.cat or args.toply:
        from tpurt_torch.scene.catapi import PrintingAPI
        from tpurt_torch.scene.parser import parse_file

        for path in args.scenes:
            # PLY files land in the CWD like the reference's mesh_%05d.ply
            parse_file(path, PrintingAPI(to_ply=args.toply, ply_dir="."))
        return 0

    logging.basicConfig(
        level=(logging.WARNING if args.quiet
               else logging.DEBUG if args.verbose else logging.INFO),
        format="%(levelname).1s %(name)s: %(message)s")
    log = logging.getLogger("tpurt_torch")
    if not args.scenes:
        ap.print_usage()
        print("error: no scene files given", file=sys.stderr)
        return 1

    from tpurt_torch.io.image import write_image
    from tpurt_torch.render.driver import load_scene, render, spectral_mode
    from tpurt_torch.utils.stats import print_stats

    if args.profile:
        log.info("profiling to %s", args.profile)
    for i, path in enumerate(args.scenes):
        log.info("parsing %s", path)
        sd = load_scene(path)
        # one trace a scene
        prof = (_profiled(args.profile, i, path) if args.profile
                else contextlib.nullcontext())
        with prof:
            if sd.integrator_name == "rpf":
                from tpurt_torch.rpf.driver import render_rpf

                spectral_mode("rpf", args.spectrum)  # warns: RGB only
                img, job, _extras = render_rpf(sd, device=args.device,
                                               quick=args.quick,
                                               crop_override=args.cropwindow)
            else:
                img, job = render(sd, device=args.device, quick=args.quick,
                                  crop_override=args.cropwindow,
                                  spectrum=args.spectrum)
        out = args.outfile or job.film.filename
        write_image(out, img)
        log.info("wrote %s (%dx%d)", out, img.shape[1], img.shape[0])
        if not args.quiet:
            print_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
