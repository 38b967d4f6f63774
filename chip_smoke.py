"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py             # needs one CUDA card
    python3 chip_smoke.py --profile   # also times 3 renders of each
                                      # frame (1 without) and prints a
                                      # torch.profiler breakdown of one
                                      # frame of A, B, C1, D, E, F, AO,
                                      # G, J, K, L and M, of one H chain step
                                      # and of a 4-iteration I render
                                      # (F's, G's, H's and I's with
                                      # their ranges)

Phases (any failure exits non-zero; none is caught):
  1. environment: versions, the card's name and power limit
  2. build: every kernel library (traversal K1 with its motion and curve
     leaf bodies K1m and K1c and the kd walk K1k / K1km, gather probe K2)
     from the sources in this checkout, one nvcc each, started together
  3. scenes: the 700x700, 8 spp, ~66k-triangle stand-in for
     killeroo-simple, as a path scene and as an RPF scene, and their
     32x32 small versions
  4. K1 against its plain PyTorch version on 2^20 primary rays and 2^20
     shadow-like rays toward the light (closest-hit prim equal on
     >= 99.99% of lanes, t within rtol 1e-5 where both hit; any-hit
     occlusion equal on >= 99.99%), with both times and the work the
     rays need (counted by the twin: distinct records, present children,
     non-pad triangles, sorts) for the bound; then the same on the
     incoherent rays of the real frame: the bounce-2 rays and their shadow
     rays, recorded from the integrator's second bounce step over 2^20
     camera paths.  A kernel's "ms" is one launch between two CUDA events,
     host enqueue included; "ms_burst" is per launch in bursts of 10, the
     kernel's own time
  5. K2 against its plain version in float64 at the probe's sizes (16384
     x 128 f32 table, 8192 lanes, 128 rounds; max error <= 1e-6 of the
     column's sum of |rows|, the same sum on a second run), with the
     kernel's, the plain version's and one PyTorch call's times; then a
     staged case (512-B rows through the cp.async ring) and a narrow-row
     case (64-B rows, 8 lanes sharing a row) under the same two checks
  6. main path A: the CLI renders the full path frame on the card and
     writes the EXR; K1 must have launched and the plain traversal must
     not have run; then one warm-up and one timed render
  7. main path B: the CLI renders the full RPF frame (sampling pass with
     features, the RPF filter at box 7, splat) on the card; K1 must have
     launched and the plain traversal must not have run; the image is
     finite with mean > 0 and the six feature EXRs are written; then one
     timed frame on a built job (sampling, filter, splat, total, peak
     memory); then K1 against its plain version on this pass's rays
     (see "K1 on every path" below)
  8. the gather probe's entry point (python -m tpurt_torch.kernels.
     gather_bench): K2 must have launched; it prints the layout sweep
     (row width x fetch variant x access pattern)
  9. cross-checks: a 64x64 crop rendered with K1 and with the plain
     traversal (mean |diff| < 1e-4 of the image mean), and the small path
     and RPF stand-ins rendered on the card and on the CPU (means within
     1e-3 relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel)
 10. main path C1: the CLI renders the full direct-lighting textured frame
     (700x700, 8 spp: Integrator "directlighting", a distant light, a
     checkerboard Kd, an image-map Kd through EWA) on the card and writes
     the EXR; K1 must have launched and the plain traversal must not have
     run; the image is finite with mean > 0 and the image map's stripes
     show on the sphere (an unreadable map would render black and pass
     every other check); K1 against its plain version on this frame's
     rays; then one warm-up and the timed renders
     (direct_textured_render_s, peak memory); then the same frame under
     Sampler "sobol" and a gaussian filter, once, with the K1 check too
 11. main path C2: the full RPF frame under Sampler "random" (8 spp) and
     "stratified" (4x4 = 16 spp): the CLI renders it (the warm-up; K1
     launched, no plain traversal, finite image), then one timed frame on
     a built job (sampling, filter, splat, total, peak memory), and K1
     against its plain version on each pass's rays
 12. the whitted variant (a glass sphere and a mirror added) at 256x256
     through the CLI, with the same counter and image checks, and K1
     against its plain version on its rays, the refracted and mirrored
     ones of every bounce step included
 13. cross-checks of the new paths: the small textured and whitted scenes
     on the card against the CPU (the bounds of phase 9), and 2^20 lanes of
     every sampler's ``dim`` on the card bit-equal to the CPU's
 14. main path D: the CLI renders scene D (700x700, 8 spp, path, maxdepth
     5: two ~33k-triangle meshes of Disney and copper metal, a substrate
     ground, an uber cylinder, a translucent disk, a cone of mix, a
     paraboloid of thin Disney, a hyperboloid of checkered plastic, a
     sphere area light, an environment-mapped infinite light, a
     projection light and a goniometric light) on the card and writes the
     EXR; K1 must have launched and the plain traversal must not have
     run; the image is finite with mean > 0 and each new light shows in
     it as a broken one would not (d_light_checks: the sky's two colours
     in the background, the slide's stripes on the ground where the
     scene's own model of the projector puts them, the goniometric map's
     lit side); the environment map's sampling on 2^20 lanes on the card
     against the CPU (same texel on every lane, ties on the CDF included)
     and against the map's distribution; K1 against its plain version on
     D's rays, every bounce step; one warm-up and the timed renders
     (materials_lights_render_s, peak memory); D under Integrator "rpf"
     at 256x256 through the CLI, untimed, with the counter and image
     checks; the 64x64 D and the orthographic and environment camera
     scenes on the card against the CPU (phase 9's bounds)
 15. main path E: the CLI renders frame E (700x700, 8 spp, path, maxdepth
     5: a dollying camera, the two stand-in meshes translating over the
     shutter, a partial sphere rotating and rising, 8,192 cylinder hair
     fibers under Material "hair", ribbons with normals, flat curves, a
     metal quad with "vector S", a sphere area light and a distant light)
     on the card; the traversal's motion and curve leaf bodies (K1m, K1c)
     must have launched, its static body and the plain traversal not; the
     motion and the hair show against renders with each switched off
     (e_checks); K1m and K1c against their plain versions on every call
     of E's camera rays and first two bounce steps (K1m bit for bit: t,
     prim, b0 and b1 on every lane; its bound charges the lerps and
     watertight tests only to the triangle groups that pass its cull, the
     bound without the cull printed beside it); one warm-up and the
     timed renders (motion_hair_render_s, peak memory); E under
     Integrator "rpf" at 256x256 through the CLI; E at 64x64 on the card
     against the CPU (phase 9's bounds).  Frames A-D must launch only the
     static body (cli_counted)
 16. main path F: the CLI renders frame F (700x700, 8 spp, volpath,
     maxdepth 5: the camera in a homogeneous fog, the stand-in meshes, a
     Material "none" sphere holding a 64^3 grid medium, a glass sphere
     holding a scattering medium, a spot light and a sphere area light)
     on the card, its grid text's parse time printed; K1's static body
     launches, nothing else; the media show against renders with the
     media, the spot's in-scattering and the shadow walk switched off
     (f_checks); K1 against its plain version on F's camera rays and its
     first two bounce steps, the shadow walks' crossing calls included;
     the timed renders after a warm-up (media_render_s, peak memory, the
     tracking loops' steps and both overflow counts, which must be 0);
     under --profile one profiled frame (launches, idle share, the
     tracking loops' and the walk's share of the device time); F at 64x64
     on the card against the CPU (phase 9's bounds)
 17. main path AO: the CLI renders the stand-in under Integrator "ao"
     (700x700, 8 spp, 64 occlusion rays a hit) on the card; K1 against its
     plain version on the camera rays and two samples' occlusion rays;
     the timed renders (ao_render_s); under --profile one profiled frame
     (launches, K1's share of the device time); AO at 64x64 on the card
     against the CPU
 18. main path G: the CLI renders the stand-in under Integrator "bdpt"
     (700x700, 8 spp, maxdepth 5) on the card; K1 must have launched
     closest (the walk) and any-hit (the connection batch), the plain
     traversal not; g_checks: the mean within 5% of frame A's path mean,
     the light-tracing (t=1 splat) share above 0, the render that ignores
     connection occlusion brighter; K1 against its plain version on one
     chunk's walk calls and connection slices (the 2^20-ray slice's time,
     bound and plain time in the kernels line); the timed renders
     (bdpt_render_s, peak memory); under --profile one profiled frame
     with the walk's, the strategy loop's and the connection batch's
     device time
 19. bdpt cross-checks, card against CPU (phase 9's bounds): G at 32x32,
     frame F's 64x64 scene, frame D's 32x32 scene and frame E's scene at
     32x32, each under Integrator "bdpt"
 20. main path H: the CLI renders the stand-in under Integrator "mlt"
     (maxdepth 5) at 128x128 with 16 mutations a pixel (K1 launched, no
     plain traversal); then one 700x700 frame on a built job through
     render_mlt_job with 2^20 chains and 100 mutations a pixel, its
     own launches counted (K1 closest and any-hit, no plain traversal;
     "mlt" in the kernels line, the CLI run's "mlt_cli_128")
     (mlt_render_s, the bootstrap's and the chains' seconds, acceptance
     per depth), finite, its mean within 15% of frame A's path mean; K1
     against its plain version on one chain step's calls (depth 1, 2^20
     rows); under --profile one chain step's breakdown
 21. main path I: the CLI renders the caustic frame (testscenes.
     write_caustic "full": a glass sphere over a matte floor under a
     sphere area light, 700x700, Integrator "sppm", SPPM_ITERS (16; the
     frame's 64 before frames L and M) iterations of 490,000 photons,
     maxdepth 5, radius 0.0171) on the card (K1 launched
     closest and any-hit, no plain traversal); one timed render of the
     built job (sppm_render_s with its camera, grid, photon and deposit
     seconds summed over the iterations, peak memory, each iteration's
     fullest grid cell and candidate pairs); K1 against its plain version
     on every call of one iteration; the grid's pairs within the radius
     equal to brute force on 2^16 of that iteration's photon records;
     SPPM's camera and photon dims on the card bit-equal to the CPU's;
     tpurt's furnace scene within 0.05 of its closed form; the small
     caustic (48x48, 4 iterations) on the card against the CPU (phase 9's
     bounds); under --profile a 4-iteration render's breakdown with the
     four sppm ranges
 22. main path J: the CLI renders frame A's stand-in with --spectrum
     sampled (700x700, 8 spp, path, 60-bin spectra) on the card (K1
     launched, no plain traversal); K1 against its plain version on J's
     camera rays and first two bounce steps; the timed render
     (spectral_render_s, peak memory), J's mean beside A's; the small
     spectral scenes of path, directlighting, whitted, volpath (a
     homogeneous and a grid medium), bdpt and sppm on the card against
     the CPU (phase 9's bounds), and MLT's spectral evaluation on 2^14
     primary-sample rows card against CPU (rtol 1e-4 / atol 1e-5, the
     raster equal); under --profile one profiled frame
 23. main path K: the CLI renders frame A's stand-in under Accelerator
     "kdtree" (700x700, 8 spp) on the card (the kd walk K1k launched, no
     other body, no plain traversal); K1k against its plain twin on every
     call of K's camera rays and first two bounce steps (primary, bounce
     and shadow rays), with the work, bound and times; K1k's hits against
     K1's (the wide BVH of frame A) on the same 2^20 primary rays (prims
     equal on >= 99.99%); the timed render (kdtree_render_s, peak memory)
     and K's image against A's (phase 9's bounds); frame E under the
     kd-tree at 256x256 through render() (K1km and K1c launched, no other
     body, no plain traversal) and K1km against its twin on E's camera
     rays and first bounce step, bit for bit; under --profile one
     profiled frame of K
 24. main path L: the CLI renders frame A's stand-in through Camera
     "realistic" (testscenes.write_realistic "full": tpurt's biconvex
     test lens, focus 15.2, aperture 8 mm, 35 mm diagonal; 700x700, 8
     spp, path) on the card (K1 launched closest and any-hit, no plain
     traversal); the 64-zone exit-pupil build (64 x 2^18 float64 rays)
     on the card, timed; K1 against its plain version on every call of
     L's camera rays and first bounce step (the camera rays leave the
     front element from many origins), its time on L's camera rays beside
     A's, and the share of vignetted camera lanes; the timed render
     (realistic_render_s, traversal launches a render, peak memory), A
     and L timed alternately (A L L A), and L's mean beside A's; L at
     32x32 on the card against the CPU under path and bdpt (phase 9's
     bounds)
 25. main path M: the CLI renders frame A's stand-in with its meshes
     under Material "fourier" (a synthetic 3-channel table of up to 8
     orders a cell, testscenes.glossy_fourier_table) and its ground as 256
     Ptex faces under a matte Kd (write_ptex_fourier "full", 700x700, 8
     spp, path) on the card (K1 closest and any-hit, no plain
     traversal); M's camera hits read >= 12 distinct Ptex faces and > 5%
     fourier lanes; K1 against its plain version on M's camera rays and
     first bounce step; the timed render (ptex_fourier_render_s,
     traversal launches a render, peak memory), A and M timed
     alternately (A M M A), and M's mean beside A's;
     M at 32x32 on the card against the CPU under path, bdpt, sppm and
     path with --spectrum sampled (phase 9's bounds)
 26. main path N: the CLI renders frame A's stand-in with its first mesh
     under Material "subsurface" (Skin1, scale 10) and its second under
     "kdsubsurface" (testscenes.write_subsurface "full", 700x700, 8 spp,
     path; two diffusion tables, the sampler striding 15 dims a bounce)
     on the card (K1 closest and any-hit, no plain traversal); K1 against
     its plain version on every call of N's camera rays and first bounce
     step: the camera rays, the subsurface hop's 8 probe-chain calls and
     its exit point's any-hit call, the shadow and bounce rays, with the
     share of camera hits that took the hop; A and N timed alternately
     (A N N A), N's two runs its timed runs (subsurface_render_s, peak
     memory; the CLI run gives the traversal launches a render and the
     probe-chain overflow count), N's mean beside A's; one profiled
     frame, device only (launches, busy, idle share); N at 32x32 on the
     card against the CPU under path, rpf and directlighting (phase 9's
     bounds); the seconds of each step
 27. path O: the multi-device module at world size 1 over NCCL on
     cuda:0, joined through a file:// rendezvous (one card: NCCL takes
     one rank a device); render_sharded of the small stand-in (film rows
     reduce-scattered, then all-reduced) against render on the card, and
     rpf_filter_sharded of a seeded 64x64x4 buffer against
     apply_rpf_filter, within 2e-5; the backend and world size printed,
     the group destroyed
K1 on every path: phase 4 holds the kernel to its plain version on path
A's rays; paths B, C1, C2 and the whitted variant walk other scenes or
other rays, so each records the calls K1's wrapper receives while 2^20
lanes of its own frame (all of them at 256x256) go through the
integrator as trace_lanes takes them (frame_ray_calls: every bounce step
of C1 and the whitted variant, the first two of the RPF passes), and
every recorded call goes through the kernel and the plain version on the
same card tensors under phase 4's bounds, with its work counts, bound and
both times (k1_on_path; "vs_plain_by_path" in the kernels line).  These
launches are made outside the counted runs.

Each frame is timed over one render after its warm-up in the
no-argument run (three under --profile), and the profiled frames run only
under --profile, which keeps the no-argument run under ten minutes; each
phase's seconds are printed.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that the kernels' JSON.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
LANES = 1 << 20
# published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
# float32 operations of the twin's arithmetic that a traversal cannot do
# without: a slab test of a present child box, a watertight test of a
# non-pad triangle with its share of the closest-of-12 pick, and the
# 19-comparator sort (3 each) where two or more children are hit
K1_OPS_CHILD = 28
K1_OPS_TRIANGLE = 52 + 1
K1_OPS_SORT = 19 * 3
# live bytes of a record in the kernel's tables: an interior row's 48
# bounds + 8 references, a leaf's 108 vertex floats, and its 12 prim rows,
# which are read only where a hit is found
K1_BYTES_INTERIOR = 56 * 4
K1_BYTES_LEAF = 108 * 4
K1_BYTES_PRIMS = 12 * 4
# K1m / K1km: the 9 lerps (a product and a sum each) of a triangle's
# vertex coordinates; a group of 4 triangles' 9 vertex rows and 9 delta
# rows (16 B each) are read only for the groups that pass the group cull
# (motion_group_cull: the box lerped to the ray's time, its pad and the
# slab test, ~70 operations), whose box row is read for every leaf.  The
# work the algorithm needs, which is the bound: the cull of every live
# group, the lerps and the 4 watertight tests only of the groups that pass
# it (the twin's "groups_near"); the bound without the cull, every
# triangle lerped and tested and the whole delta rows read, is printed
# beside it
K1M_OPS_LERP = 9 * 2
K1M_OPS_CULL = 70
K1M_BYTES_BOX = 3 * 48
K1M_BYTES_GROUP = 2 * 9 * 16
# K1c: a curve leaf's 8 spans of 12 control-point coordinates and 2
# widths, its ribbon aux row and its 8 prim rows; a span's arithmetic in
# the twin's _curve_bundle_test: its ray frame and projection (~90), then
# per sub-segment the blossom (3 x 4 x 7), the culling, chord and width
# terms (~30), the de Casteljau evaluation (3 x 18), the distance, t and v
# tests (~20): ~190 a sub-segment, 8 sub-segments.  The work the algorithm
# needs, which is the bound: every live span's frame, projection and hull
# cull (curve_span_cull: ~70 more), and the 8 sub-segments only of the spans
# that pass it (the twin's "spans_near"); K1C_OPS_SPAN charges the 8
# sub-segments to every span (the bound without the cull, printed beside it)
K1C_BYTES_LEAF = 112 * 4
K1C_BYTES_AUX = 64 * 4
K1C_BYTES_PRIMS = 8 * 4
K1C_OPS_SPAN = 90 + 8 * 190
K1C_OPS_CULL = 90 + 70
K1C_OPS_SUBSEGMENTS = 8 * 190
# K1k / K1km, the kd walk: an interior node is one float4 of the derived
# table (its split, axis and children's references; read from the record
# table's row, it would be two), a leaf its 108 vertex floats and
# the float4 with its continuation; an interior step is the plane's t (a
# difference and a product) and 6 comparisons; a ray's root clip 6
# differences, 6 products and 12 min / max
K1K_BYTES_INTERIOR = 16
K1K_BYTES_LEAF = 108 * 4 + 16
K1K_OPS_INTERIOR = 8
K1K_OPS_RAY = 24


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 5, burst: int = 1):
    """Median milliseconds of fn() over reps runs after one warm-up,
    synchronised around each run.  With burst > 1 a run is that many
    calls enqueued back to back between one pair of events, and the time
    is per call: a kernel's own time, where one call between two events
    also counts the host's time to enqueue it, which for a sub-millisecond
    kernel is a large share."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def phase_env():
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    print(f"gpu: {gpu_line()} (count {torch.cuda.device_count()})")


def phase_build():
    from tpurt_torch.kernels import build, gather_bench, traverse

    t0 = time.time()
    libs = build.build_all([(traverse.SOURCE, traverse.EXTRA_FLAGS),
                            (gather_bench.SOURCE, gather_bench.EXTRA_FLAGS)])
    print(f"build: {len(libs)} kernel libraries in {time.time() - t0:.2f}s")
    for lib in libs:
        print(f"  {lib.path} nvcc {lib.build_s:.2f}s")
        for ln in lib.log.splitlines():
            if "registers" in ln or "spill" in ln or "stack frame" in ln:
                print("    ptxas:", ln.strip())
    # bind both (argtypes) from the libraries just built
    traverse.load_library()
    gather_bench.load_library()


def phase_scene(size: str = "full", integrator: str = "path"):
    from tpurt_torch.testscenes import write_standin

    WORK.mkdir(parents=True, exist_ok=True)
    name = "standin" if integrator == "path" else "standin_rpf"
    return write_standin(str(WORK / f"{name}_{size}.pbrt"), size,
                         integrator=integrator)


def frame_ray_calls(job, bounces: int, cfg=None):
    """Every call K1's wrapper receives, in order, while 2^20 of the
    frame's lanes (all of them where the frame has fewer), spread over the
    whole frame, go through the integrator as render.driver.trace_lanes
    takes them: path_bounce_init, then up to ``bounces`` path_bounce_step
    calls with the alive lanes kept by a boolean index between them, until
    none is alive (volpath's init and step on a scene with media, their
    shadow walks' crossing calls included; ao's camera hits and occlusion
    rays; bdpt's walk and connection batch for one chunk).  ``cfg``
    defaults to the job's (the RPF sampling pass has its own).  Each call is (o, d, t_max, any_hit, time, tree) as the wrapper
    got it, on the card."""
    from tpurt_torch.config import tpurt_chunk
    from tpurt_torch.render.bdpt import bdpt_radiance
    from tpurt_torch.render.integrator import (ao_radiance,
                                               path_bounce_init,
                                               path_bounce_step)
    from tpurt_torch.render.volpath import (volpath_bounce_init,
                                            volpath_bounce_step)

    cfg = cfg or job.cfg
    dev = job.scene.geo.device
    film, spp = job.film, job.sampler.spp
    total = film.width * film.height * spp
    n = min(LANES, total)
    ids = torch.arange(n, device=dev) * total // n  # whole frame
    pid = ids // spp
    x0, _, y0, _ = film.crop
    px = (x0 + pid % film.width).to(torch.int64)
    py = (y0 + pid // film.width).to(torch.int64)
    calls, recording = recorder()
    if cfg.name == "bdpt":
        # one chunk of trace_lanes' bdpt branch: the walk's 2n-lane
        # closest calls, then the connection batch's any-hit slices
        c = tpurt_chunk(total)
        bdpt_radiance(job.scene, job.sampler, job.camera, px, py, ids % spp,
                      cfg, recording, crop_xy=(x0, y0),
                      texture_eval=job.texture_eval, track_lane=ids % c,
                      track_chunk=c)
        torch.cuda.synchronize()
        return calls
    if cfg.name == "ao":
        ao_radiance(job.scene, job.sampler, job.camera, px, py, ids % spp,
                    cfg, recording, crop_xy=(x0, y0))
        torch.cuda.synchronize()
        return calls
    # volpath's own step on a scene with media, as trace_lanes runs it
    init, step, extra = path_bounce_init, path_bounce_step, {}
    if cfg.name == "volpath" and job.scene.has_media:
        init, step = volpath_bounce_init, volpath_bounce_step
        extra = dict(track_lane=ids % tpurt_chunk(total))
    st = init(job.scene, job.sampler, job.camera, px, py, ids % spp, cfg,
              recording, crop_xy=(x0, y0), **extra)
    for bounce in range(bounces):
        alive = st["alive"]
        if not bool(alive.any()):
            break
        # (a sampler without a lane context carries None)
        st = {k: None if v is None else v[alive] for k, v in st.items()}
        st = step(job.scene, job.sampler, cfg, st, bounce, recording,
                  camera=job.camera, texture_eval=job.texture_eval)
    torch.cuda.synchronize()
    return calls


def recorder():
    """(calls, traverse): a traversal that launches K1's wrapper and
    records each call's (o, d, t_max, any_hit, time, tree) in calls."""
    from tpurt_torch.kernels.traverse import traverse_wide

    calls = []

    def recording(geo, o, d, t_max, any_hit, time=None, tree="tri"):
        calls.append((o, d, t_max, any_hit, time, tree))
        return traverse_wide(geo, o, d, t_max, any_hit, time=time, tree=tree)

    return calls, recording


def frame_ray_sets(job):
    """The path frame's rays for phase 4: "primary" (2^20 camera rays
    spread over the frame), and "bounce" / "shadow", the closest-hit and
    any-hit calls of the integrator's second bounce step (the rays that
    leave the second surface hit)."""
    calls = frame_ray_calls(job, 2)
    assert [c[3] for c in calls] == [False, True, False, True, False]
    return dict(primary=calls[0], shadow=calls[3], bounce=calls[4])


def k1_work(geo, rays, w=None):
    """(bound_ms, bound_by, text): the least time for these rays.  The
    work is counted by the twin from what this run's rays need: each
    distinct record's live bytes read once (prim rows only of leaves in
    which a hit was found; a motion leaf's delta rows and a ribbon leaf's
    aux row beside it), the rays in (with their times, K1m) and the hits
    out once; the twin's arithmetic on the present children and non-pad
    triangles or curve spans of every record read, and a sort only where
    two or more children were hit; for curve spans the frame and cull of
    every span and the sub-segments only of those that pass the cull (the
    text also gives the bound with the sub-segments of every span); for
    moving triangles (K1m) the group cull of every live group and the rows,
    lerps and tests only of the groups that pass it (motion_work; the text
    also gives the bound without the cull).
    ``w``: the plain version's counts of these rays when the caller has
    them, else they are counted here."""
    from tpurt_torch.kernels.traverse import leaf_kind, traverse_reference

    o, d, tm, any_hit, time_, tree = rays
    kind = leaf_kind(geo, time_, tree)
    if w is None:
        w = {}
        traverse_reference(geo, o, d, tm, any_hit=any_hit, time=time_,
                           tree=tree, stats=w)
    n = o.shape[0]
    if kind in ("kd", "kd_motion"):
        return kd_work(kind, n, w)
    if kind == "curve":
        leaf_b = K1C_BYTES_LEAF + (0 if geo.cleaves_aux is None
                                   else K1C_BYTES_AUX)
        prim_b, prim_ops = K1C_BYTES_PRIMS, K1C_OPS_CULL
    else:
        leaf_b = K1_BYTES_LEAF
        prim_b = K1_BYTES_PRIMS
        prim_ops = K1_OPS_TRIANGLE
    nbytes = (w["interior_records"] * K1_BYTES_INTERIOR
              + w["leaf_records"] * leaf_b + w["hit_leaves"] * prim_b
              + n * (7 * 4 + 4 * 4 + (4 if kind == "motion" else 0)))
    ops = (w["children"] * K1_OPS_CHILD + w["triangles"] * prim_ops
           + w["sorts"] * K1_OPS_SORT)
    curve_note = ""
    if kind == "motion":
        nbytes, ops, curve_note = motion_work(w, nbytes, ops)
    if kind == "curve":
        ops_all = ops + w["triangles"] * (K1C_OPS_SPAN - K1C_OPS_CULL)
        ops += w["spans_near"] * K1C_OPS_SUBSEGMENTS
        all_ms, all_by = bound(nbytes, ops_all)
        curve_note = (
            f"; {w['spans_near']} spans pass the cull "
            f"({w['spans_near'] / max(w['triangles'], 1):.4f} of the live "
            f"spans); with every span's sub-segments {ops_all / 1e9:.3f} Gop,"
            f" bound {all_ms:.4f} ms ({all_by})")
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    bound_ms, bound_by = bound(nbytes, ops)
    steps = w["interior_steps"] + w["leaf_steps"]
    return bound_ms, bound_by, (
        f"{n} rays: {w['interior_steps']} interior + {w['leaf_steps']} leaf "
        f"steps ({steps / n:.2f} a ray) on {w['interior_records']} + "
        f"{w['leaf_records']} distinct records ({w['hit_leaves']} leaves "
        f"with a hit); {w['children']} children "
        f"({w['children'] / max(w['interior_steps'], 1):.2f} a record), "
        f"{w['sorts']} sorts, {w['triangles']} "
        f"{'spans' if kind == 'curve' else 'triangles'} "
        f"({w['triangles'] / max(w['leaf_steps'], 1):.2f} a leaf); "
        f"{nbytes / 1e6:.2f} MB ({b_ms:.4f} ms), {ops / 1e9:.3f} Gop "
        f"({o_ms:.4f} ms); bound {bound_ms:.4f} ms ({bound_by})"
        f"{curve_note}")


def motion_work(w: dict, nbytes: float, ops: float):
    """(bytes, operations, note) of a motion body (K1m, K1km) from its
    static counterpart's ``nbytes`` and ``ops`` over the same records (a
    leaf's vertex rows read, every triangle tested) and the twin's counts
    ``w``: the leaf's box row in place of its vertex rows, the cull of
    every live group, and the vertex and delta rows, lerps and 4 tests of
    the groups that pass it.  The note gives the groups and the bound
    without the cull (every triangle lerped and tested, every leaf's
    delta rows read)."""
    all_b = nbytes + w["leaf_records"] * K1_BYTES_LEAF
    all_ops = ops + w["triangles"] * K1M_OPS_LERP
    nbytes += (w["leaf_records"] * (K1M_BYTES_BOX - K1_BYTES_LEAF)
               + w["near_group_records"] * K1M_BYTES_GROUP)
    ops += (w["groups"] * K1M_OPS_CULL
            + w["groups_near"] * 4 * (K1_OPS_TRIANGLE + K1M_OPS_LERP)
            - w["triangles"] * K1_OPS_TRIANGLE)
    all_ms, all_by = bound(all_b, all_ops)
    return nbytes, ops, (
        f"; {w['groups']} live groups, {w['groups_near']} pass the cull "
        f"({w['groups_near'] / max(w['groups'], 1):.4f}; "
        f"{w['near_group_records']} distinct); without the cull "
        f"{all_b / 1e6:.2f} MB, {all_ops / 1e9:.3f} Gop, bound "
        f"{all_ms:.4f} ms ({all_by})")


def kd_work(kind: str, n: int, w: dict):
    """k1_work's (bound_ms, bound_by, text) for the kd walk, from the kd
    twin's counts ``w`` of these n rays: each distinct row's live bytes
    once (a moving leaf's delta rows beside it, prim rows of the leaves
    with a hit), the rays in and the hits out; the plane tests of every
    interior step, the triangle tests of every leaf step and each ray's
    root clip."""
    motion = kind == "kd_motion"
    nbytes = (w["interior_records"] * K1K_BYTES_INTERIOR
              + w["leaf_records"] * K1K_BYTES_LEAF
              + w["hit_leaves"] * K1_BYTES_PRIMS
              + n * (7 * 4 + 4 * 4 + (4 if motion else 0)))
    ops = (w["interior_steps"] * K1K_OPS_INTERIOR + n * K1K_OPS_RAY
           + w["triangles"] * K1_OPS_TRIANGLE)
    note = ""
    if motion:
        nbytes, ops, note = motion_work(w, nbytes, ops)
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    bound_ms, bound_by = bound(nbytes, ops)
    steps = w["interior_steps"] + w["leaf_steps"]
    return bound_ms, bound_by, (
        f"{n} rays: {w['interior_steps']} interior + {w['leaf_steps']} leaf "
        f"steps ({steps / n:.2f} a ray) on {w['interior_records']} + "
        f"{w['leaf_records']} distinct rows ({w['hit_leaves']} leaves with "
        f"a hit); {w['triangles']} triangles "
        f"({w['triangles'] / max(w['leaf_steps'], 1):.2f} a leaf); "
        f"{nbytes / 1e6:.2f} MB ({b_ms:.4f} ms), {ops / 1e9:.3f} Gop "
        f"({o_ms:.4f} ms); bound {bound_ms:.4f} ms ({bound_by}){note}")


def bit_unequal(ref, ker) -> int:
    """The number of lanes on which t, prim, b0 or b1 of the kernel and the
    plain version differ in any bit (a count: a float32 mean of an
    all-equal mask can round below 1)."""
    same = torch.ones_like(ref[1], dtype=torch.bool)
    for a, b in zip(ref, ker):
        same &= a.contiguous().view(torch.int32) == b.contiguous().view(
            torch.int32)
    return int((~same).sum().item())


def k1_agreement(ref, ker, any_hit):
    """Kernel against plain version on one ray set: (share of lanes with
    equal prim or equal occlusion, share of common hits with t within rtol
    1e-5, max |dt| over them)."""
    if any_hit:
        agree = ((ref[1] >= 0) == (ker[1] >= 0)).float().mean().item()
        return agree, 1.0, 0.0
    both = (ref[1] >= 0) & (ker[1] >= 0)
    agree = (ref[1] == ker[1]).float().mean().item()
    if not both.any():
        return agree, 1.0, 0.0
    dt = (ref[0] - ker[0]).abs()[both]
    t_ok = (dt / ref[0].abs()[both] <= 1e-5).float().mean().item()
    return agree, t_ok, dt.max().item()


def phase_kernel(job):
    """Kernel against its plain version at the main path's shapes."""
    from tpurt_torch.kernels.traverse import (traverse_wide,
                                              traverse_wide_reference)

    geo = job.scene.geo
    sets = frame_ray_sets(job)
    o, d, tm = sets["primary"][:3]

    ref = traverse_wide_reference(geo, o, d, tm, any_hit=False)
    ker = traverse_wide(geo, o, d, tm, any_hit=False)
    torch.cuda.synchronize()
    closest_agree, t_ok, t_err = k1_agreement(ref, ker, False)

    # shadow-like rays: from the primary hits toward the area light
    lt = job.scene.lights
    c = lt.rows[0, 4:7]
    hit = ref[1] >= 0
    p = o + torch.where(hit, ref[0], 0.0)[:, None] * d
    p = p - d * 1e-3
    to_l = c - p
    dist = to_l.norm(dim=-1)
    d_sh = (to_l / dist[:, None]).contiguous()
    t_sh = torch.where(hit, dist - lt.rows[0, 12] * 1.01, 0.0).contiguous()
    o_sh = p.contiguous()
    ref_a = traverse_wide_reference(geo, o_sh, d_sh, t_sh, any_hit=True)
    ker_a = traverse_wide(geo, o_sh, d_sh, t_sh, any_hit=True)
    torch.cuda.synchronize()
    any_agree = k1_agreement(ref_a, ker_a, True)[0]

    bound_ms, bound_by, text = k1_work(geo, sets["primary"])
    print(f"K1 work @ primary {text}")

    ms = cuda_ms(lambda: traverse_wide(geo, o, d, tm, any_hit=False))
    ms_burst = cuda_ms(lambda: traverse_wide(geo, o, d, tm, any_hit=False),
                       burst=10)
    plain_ms = cuda_ms(lambda: traverse_wide_reference(geo, o, d, tm,
                                                       any_hit=False))
    ms_a = cuda_ms(lambda: traverse_wide(geo, o_sh, d_sh, t_sh, any_hit=True),
                   burst=10)
    plain_ms_a = cuda_ms(lambda: traverse_wide_reference(
        geo, o_sh, d_sh, t_sh, any_hit=True))
    print(f"kernel vs plain @ {LANES} lanes: closest prim agree "
          f"{closest_agree:.6f} (hits {hit.float().mean().item():.3f}), "
          f"t within rtol 1e-5 {t_ok:.6f}, max |dt| {t_err:.3e}; "
          f"any-hit occlusion agree {any_agree:.6f} "
          f"(occluded {(ker_a[1] >= 0).float().mean().item():.3f})")
    print(f"traversal ms @ {LANES} lanes: closest kernel {ms:.4f} (one "
          f"launch between two events, host enqueue included; {ms_burst:.4f} "
          f"per launch in bursts of 10) plain {plain_ms:.3f}; any-hit "
          f"kernel {ms_a:.4f} (bursts) plain {plain_ms_a:.3f}")
    assert closest_agree >= 0.9999, closest_agree
    assert t_ok >= 0.9999, t_ok
    assert any_agree >= 0.9999, any_agree
    out = dict(max_abs_err=t_err, ms=ms, ms_burst=ms_burst,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None)

    # the frame's incoherent rays: bounce 2 (closest) and its shadow rays
    for name in ("bounce", "shadow"):
        o_i, d_i, t_i, any_hit = sets[name][:4]
        ref_i = traverse_wide_reference(geo, o_i, d_i, t_i, any_hit=any_hit)
        ker_i = traverse_wide(geo, o_i, d_i, t_i, any_hit=any_hit)
        torch.cuda.synchronize()
        agree, t_ok_i, t_err_i = k1_agreement(ref_i, ker_i, any_hit)
        b_ms, b_by, text = k1_work(geo, sets[name])
        ms_i = cuda_ms(lambda: traverse_wide(geo, o_i, d_i, t_i,
                                             any_hit=any_hit))
        burst_i = cuda_ms(lambda: traverse_wide(geo, o_i, d_i, t_i,
                                                any_hit=any_hit), burst=10)
        plain_i = cuda_ms(lambda: traverse_wide_reference(
            geo, o_i, d_i, t_i, any_hit=any_hit), reps=3)
        print(f"K1 work @ {name} {text}")
        print(f"kernel vs plain @ {name} rays ({'any-hit' if any_hit else 'closest'}"
              f"): agree {agree:.6f}, t within rtol 1e-5 {t_ok_i:.6f}, max "
              f"|dt| {t_err_i:.3e}; kernel {ms_i:.4f} ms one launch, "
              f"{burst_i:.4f} ms in bursts, plain {plain_i:.3f} ms"
              f" (hits {(ker_i[1] >= 0).float().mean().item():.3f})")
        assert agree >= 0.9999 and t_ok_i >= 0.9999, (name, agree, t_ok_i)
        out.update({f"{name}_rays": o_i.shape[0], f"ms_{name}": ms_i,
                    f"ms_burst_{name}": burst_i,
                    f"plain_ms_{name}": plain_i, f"bound_ms_{name}": b_ms,
                    f"bound_by_{name}": b_by})
    return out


def k1_on_path(label: str, job, bounces: int, cfg=None):
    """K1 against its plain version on the card at one driven path's own
    shapes: every call of frame_ray_calls(job, bounces, cfg) goes through
    the kernel and the plain version on the same tensors (the bounds of
    phase 4: prims or occlusion equal on >= 99.99% of lanes, t within
    rtol 1e-5 on >= 99.99% of common hits), with the work its rays need,
    the bound from it, the kernel's time per launch in bursts of 10 and
    the plain version's.  Returns one record a call for the kernels line;
    these launches are made outside the counted runs.  The motion bodies
    (K1m, K1km) must equal the plain version bit for bit on every lane
    (t, prim, b0, b1); every body's count of lanes that differ is
    printed."""
    calls = frame_ray_calls(job, bounces, cfg)
    assert calls and not calls[0][3], label
    return k1_on_calls(label, job.scene.geo, calls)


def k1_on_calls(label: str, geo, calls):
    """k1_on_path's checks and times on recorded calls of K1's wrapper
    (recorder) on ``geo``."""
    from tpurt_torch.kernels.traverse import (LEAF_KINDS, leaf_kind,
                                              traverse_reference,
                                              traverse_wide)

    names = {k: v[1] for k, v in LEAF_KINDS.items()}
    out = []
    for i, rays in enumerate(calls):
        o, d, tm, any_hit, time_, tree = rays
        body = names[leaf_kind(geo, time_, tree)]
        kw = dict(any_hit=any_hit, time=time_, tree=tree)
        w = {}
        ref = traverse_reference(geo, o, d, tm, stats=w, **kw)
        ker = traverse_wide(geo, o, d, tm, **kw)
        torch.cuda.synchronize()
        agree, t_ok, t_err = k1_agreement(ref, ker, any_hit)
        unequal = bit_unequal(ref, ker)
        b_ms, b_by, text = k1_work(geo, rays, w)
        ms_one = cuda_ms(lambda: traverse_wide(geo, o, d, tm, **kw))
        ms = cuda_ms(lambda: traverse_wide(geo, o, d, tm, **kw), burst=10)
        plain = cuda_ms(lambda: traverse_reference(geo, o, d, tm, **kw),
                        reps=1)
        kind = "any-hit" if any_hit else "closest"
        print(f"{body} work @ {label} call {i} {text}")
        print(f"{body} vs plain @ {label} call {i} ({kind}, live rays "
              f"{(tm > 0).float().mean().item():.3f}, hits "
              f"{(ker[1] >= 0).float().mean().item():.3f}): agree "
              f"{agree:.6f}, t within rtol 1e-5 {t_ok:.6f}, max |dt| "
              f"{t_err:.3e}, t prim b0 b1 bit-equal on all but {unequal} "
              f"of {o.shape[0]} lanes; kernel "
              f"{ms_one:.4f} ms one launch, {ms:.4f} ms in bursts, plain "
              f"{plain:.3f} ms")
        assert agree >= 0.9999 and t_ok >= 0.9999, (label, i, agree, t_ok)
        assert unequal == 0 or body not in ("K1m", "K1km"), (label, i,
                                                              unequal)
        out.append(dict(body=body, rays=o.shape[0], any_hit=any_hit,
                        agree=agree, bit_unequal_lanes=unequal,
                        max_abs_err=t_err,
                        ms=ms_one,
                        ms_burst=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by))
    return out


def phase_gather(gpu: str):
    """K2 against its plain version (float64) at the probe's sizes."""
    from tpurt_torch.kernels import gather_bench as gb

    idx, table = gb.probe_inputs("cuda")
    rows = gb.row_indices(idx, gb.M, gb.R)
    got = gb.gather_rows_sum(idx, table, gb.R)
    again = gb.gather_rows_sum(idx, table, gb.R)
    exact = gb.gather_rows_sum_reference(idx, table, gb.R,
                                         dtype=torch.float64)
    abs_sum = gb.gather_rows_sum_reference(idx, table.abs(), gb.R,
                                           dtype=torch.float64)
    torch.cuda.synchronize()
    err = (got.double() - exact).abs()
    max_err = err.max().item()
    worst = (err / abs_sum).max().item()
    lib_err = (gb.library_gather_sum(rows, table).double()
               - exact).abs().max().item()
    n = gb.B * gb.R
    ms = cuda_ms(lambda: gb.gather_rows_sum(idx, table, gb.R))
    ms_burst = cuda_ms(lambda: gb.gather_rows_sum(idx, table, gb.R), burst=10)
    plain_ms = cuda_ms(lambda: gb.gather_rows_sum_reference(idx, table,
                                                            gb.R))
    library_ms = cuda_ms(lambda: gb.library_gather_sum(rows, table))
    # least work: each distinct row reached read once, idx read, out
    # written; one float32 add per element of every row read
    distinct = int(torch.unique(rows).numel())
    nbytes = distinct * gb.REC * 4 + gb.B * 4 + gb.REC * 4
    bound_ms, bound_by = bound(nbytes, float(n) * gb.REC)
    print(f"K2 vs float64 @ M={gb.M} B={gb.B} R={gb.R}: max |err| "
          f"{max_err:.3e} ({worst:.3e} of the sum of |rows|), second run "
          f"equal {torch.equal(got, again)}; library max |err| "
          f"{lib_err:.3e}")
    print(f"K2 ms: kernel {ms:.4f} one launch, {ms_burst:.4f} in bursts of "
          f"10 ({ms_burst * 1e6 / n:.4f} ns/row), plain "
          f"{plain_ms:.4f} ({plain_ms * 1e6 / n:.4f} ns/row), library "
          f"embedding_bag {library_ms:.4f} ({library_ms * 1e6 / n:.4f} "
          f"ns/row); bound {bound_ms:.4f} ms ({bound_by}: {distinct} "
          f"distinct rows, {n} row reads) on {gpu}")
    assert worst <= 1e-6, worst
    assert torch.equal(got, again)
    # one staged and one narrow-row case, under the same two checks
    # (sweep_case raises past 1e-6 of the sum of |rows|)
    for width, variant, group in ((gb.REC, "cp_async", 1), (16, "direct", 8)):
        tab = table[:, :width].contiguous()
        c = gb.sweep_case(idx, table, width, variant, group, reps=5)
        plain_c = cuda_ms(lambda: gb.gather_rows_sum_reference(
            idx, tab, gb.R, group=group))
        rerun = torch.equal(gb.gather_rows_sum(idx, tab, gb.R, variant, group),
                            gb.gather_rows_sum(idx, tab, gb.R, variant, group))
        print(f"K2 {c['row_bytes']} B {variant} group {group}: "
              f"{c['rel_err']:.3e} of the sum of |rows|, second run equal "
              f"{rerun}; kernel {c['ms']:.4f} ms ({c['ns_per_row']:.4f} "
              f"ns/row), plain {plain_c:.4f} ms")
        assert rerun
    return dict(max_abs_err=max_err, ms=ms, ms_burst=ms_burst,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_main(scene_path: str, gpu: str):
    from tpurt_torch import cli
    from tpurt_torch.kernels.traverse import (reset_launches, traverse_wide,
                                              traverse_wide_reference)
    from tpurt_torch.render.driver import build_job, load_scene, render_job

    exr = WORK / "standin_full.exr"
    reset_launches()
    traverse_wide_reference.calls = 0
    t0 = time.time()
    rc = cli.main([scene_path, "--device", "cuda", "--outfile", str(exr),
                   "--quiet"])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    launches = traverse_wide.launches
    plain_calls = traverse_wide_reference.calls
    assert rc == 0 and exr.stat().st_size > 0
    print(f"main path (CLI, first run incl. scene build): {cli_s:.2f}s, "
          f"traversal kernel launches {launches}, plain calls {plain_calls}")
    assert launches > 0 and plain_calls == 0
    assert traverse_wide.kernel_launches["K1"] == launches

    t0 = time.time()
    job = build_job(load_scene(scene_path), "cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    img = render_job(job)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    img = render_job(job)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    assert img.shape == (700, 700, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    paths = job.film.width * job.film.height * job.sampler.spp
    print(f"render_s {render_s:.4f} (one frame after one warm-up) "
          f"camera Mrays/s {paths / render_s / 1e6:.4f} ({paths} paths) "
          f"peak mem {peak / 2**30:.3f} GiB, scene build {build_s:.2f}s, "
          f"image mean {img.mean():.5f} on {gpu}")
    return job, launches, render_s, float(img.mean())


def phase_rpf(scene_path: str, gpu: str):
    from tpurt_torch import cli
    from tpurt_torch.io.image import read_image
    from tpurt_torch.kernels.traverse import (reset_launches, traverse_wide,
                                              traverse_wide_reference)
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.rpf.driver import (feature_exr_paths, render_rpf_job,
                                        sampling_config)

    out = WORK / "standin_rpf_full_out.exr"
    sd = load_scene(scene_path)
    exrs = [Path(p) for p in feature_exr_paths(sd.film_params.find_one_string(
        "filename", ""))]
    for p in exrs + [out]:
        p.unlink(missing_ok=True)
    reset_launches()
    traverse_wide_reference.calls = 0
    t0 = time.time()
    rc = cli.main([scene_path, "--device", "cuda", "--outfile", str(out),
                   "--quiet"])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    launches = traverse_wide.launches
    plain_calls = traverse_wide_reference.calls
    img = read_image(str(out))
    print(f"main path B (RPF CLI, first run incl. scene build): "
          f"{cli_s:.2f}s, traversal kernel launches {launches}, plain calls "
          f"{plain_calls}, image mean {img.mean():.5f}, feature EXRs "
          f"{sum(p.exists() for p in exrs)}/6")
    assert rc == 0 and launches > 0 and plain_calls == 0
    assert traverse_wide.kernel_launches["K1"] == launches
    res = (sd.film_params.find_one_int("yresolution", 0),
           sd.film_params.find_one_int("xresolution", 0), 3)
    assert img.shape == res and np.isfinite(img).all() and img.mean() > 0
    assert all(p.exists() and p.stat().st_size > 0 for p in exrs)

    job = build_job(load_scene(scene_path), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    img, ex = render_rpf_job(job, write_feature_exrs=False)
    torch.cuda.synchronize()
    total = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(img).all() and img.mean() > 0
    print(f"rpf_sampling_s {ex['sampling_time']:.4f} rpf_filter_s "
          f"{ex['filter_time']:.4f} rpf_splat_s {ex['splat_time']:.4f} "
          f"rpf_total_s {total:.4f} (one frame after the CLI's) peak mem "
          f"{peak / 2**30:.3f} GiB, image mean {img.mean():.5f}, TF32 "
          f"matmul {torch.backends.cuda.matmul.allow_tf32} on {gpu}")
    k1_path = k1_on_path("B RPF", job, 2, sampling_config(job))
    return launches, job, total, k1_path


def phase_probe():
    """The gather probe's entry point, as a user runs it."""
    from tpurt_torch.kernels import gather_bench as gb

    gb.gather_rows_sum.launches = 0
    assert gb.main([]) == 0
    launches = gb.gather_rows_sum.launches
    print(f"probe entry point: gather kernel launches {launches}")
    assert launches > 0
    wide = [c for c in gb.LAST_SWEEP if c["row_bytes"] == gb.REC * 4
            and c["group"] == 1]
    best = max(wide, key=lambda c: c["l2_gb_s"])
    return launches, dict(l2_bytes=gb.B * gb.R * gb.REC * 4,
                          l2_gb_s=best["l2_gb_s"],
                          l2_best_variant=best["variant"])


def _close(g, h, what):
    d = np.abs(g - h)
    frac = (d <= 1e-3 + 1e-3 * np.abs(h)).all(axis=-1).mean()
    mrel = abs(g.mean() - h.mean()) / h.mean()
    print(f"{what} cuda vs cpu: mean rel {mrel:.3e}, pixels within "
          f"1e-3 {frac:.4f}, max |diff| {d.max():.3e}")
    assert np.isfinite(g).all() and mrel < 1e-3 and frac >= 0.99


def phase_cross(scene_path: str, small_path: str, small_rpf: str):
    from tpurt_torch.kernels.traverse import traverse_wide_reference
    from tpurt_torch.render.driver import load_scene, render
    from tpurt_torch.rpf.driver import render_rpf

    c0, c1 = 319.5 / 700, 383.5 / 700  # a centred 64x64 crop
    crop = (c0, c1, c0, c1)
    a, _ = render(load_scene(scene_path), "cuda", crop_override=crop)
    b, _ = render(load_scene(scene_path), "cuda", crop_override=crop,
                  traverse=traverse_wide_reference)
    diff = np.abs(a - b)
    rel = diff.mean() / max(float(a.mean()), 1e-12)
    print(f"crop 64x64 kernel vs plain traversal: max |diff| {diff.max():.3e} "
          f"mean |diff| {diff.mean():.3e} ({rel:.3e} of mean {a.mean():.5f})")
    assert a.shape == (64, 64, 3) and rel < 1e-4, rel

    g, _ = render(load_scene(small_path), "cuda")
    h, _ = render(load_scene(small_path), "cpu")
    _close(g, h, "small path stand-in")
    g, _, _ = render_rpf(load_scene(small_rpf), "cuda",
                         write_feature_exrs=False)
    h, _, _ = render_rpf(load_scene(small_rpf), "cpu",
                         write_feature_exrs=False)
    _close(g, h, "small RPF stand-in")


def cli_counted(scene_path: str, out: Path, what: str, bodies=("K1",),
                args=()):
    """Render a scene through the CLI on the card with the traversal
    counters set to 0 just before: returns (image read back from ``out``,
    traversal launches, seconds).  Fails if a leaf body of ``bodies`` did
    not launch or another one did (a frame without motion or curves runs
    only K1's static body), if a plain traversal (the wide-BVH or the kd
    twin) ran, or if the image is not finite with mean > 0.  ``args``:
    more CLI arguments."""
    from tpurt_torch import cli
    from tpurt_torch.io.image import read_image
    from tpurt_torch.kernels.traverse import (reset_launches,
                                              traverse_kd_reference,
                                              traverse_wide,
                                              traverse_wide_reference)

    out.unlink(missing_ok=True)
    reset_launches()
    traverse_wide_reference.calls = 0
    traverse_kd_reference.calls = 0
    t0 = time.time()
    rc = cli.main([scene_path, "--device", "cuda", "--outfile", str(out),
                   "--quiet", *args])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    launches = traverse_wide.launches
    plain_calls = (traverse_wide_reference.calls
                   + traverse_kd_reference.calls)
    img = read_image(str(out))
    by_body = dict(traverse_wide.kernel_launches)
    print(f"{what} (CLI, first run incl. scene build): {cli_s:.2f}s, "
          f"traversal kernel launches {launches} {by_body}, plain calls "
          f"{plain_calls}, image {img.shape[1]}x{img.shape[0]} mean "
          f"{img.mean():.5f}")
    assert rc == 0 and launches > 0 and plain_calls == 0
    assert all((n > 0) == (b in bodies) for b, n in by_body.items()), by_body
    assert np.isfinite(img).all() and img.mean() > 0
    return img, launches, cli_s


def phase_direct(gpu: str):
    """Main path C1: the direct-lighting textured frame."""
    from tpurt_torch.render.driver import build_job, load_scene, render_job
    from tpurt_torch.testscenes import write_textured

    scene = write_textured(str(WORK / "textured_full.pbrt"), "full")
    img, launches, _ = cli_counted(scene, WORK / "textured_full_out.exr",
                                   "main path C1 (direct-lighting textured)")
    assert img.shape == (700, 700, 3)
    # the image map was read and filtered: its red and green stripes
    # (0.9 against 0.2, out of phase) show on the sphere, which fills this
    # window; an unreadable map renders Kd = 0 and leaves only the
    # highlight, whose red to green ratio is the lights' and nearly constant
    win = img[205:365, 270:430].reshape(-1, 3)
    lit = win[win.min(axis=-1) > 1e-3]
    ratio = np.sort(lit[:, 0] / lit[:, 1])
    lo, hi = ratio[len(ratio) // 20], ratio[-len(ratio) // 20]
    print(f"image map on the sphere: {len(lit)} of {len(win)} pixels of its "
          f"window lit, red/green at their 5th and 95th percentile "
          f"{lo:.3f}, {hi:.3f}")
    assert len(lit) > len(win) // 2 and hi > 2.0 * lo, (len(lit), lo, hi)
    job = build_job(load_scene(scene), "cuda")
    assert job.cfg.specular_only and job.scene.has_texfilter
    k1_paths = {"direct_textured": k1_on_path(
        "C1 direct-lighting textured", job, job.cfg.max_depth + 1)}
    render_s, runs, peak, img = render_timed(job)
    print(f"direct_textured_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in runs]}) peak mem {peak / 2**30:.3f} GiB, "
          f"image mean {img.mean():.5f} on {gpu}")

    other = write_textured(str(WORK / "textured_full_sobol.pbrt"), "full",
                           sampler="sobol", pixel_filter="gaussian")
    job2 = build_job(load_scene(other), "cuda")
    k1_paths["direct_textured_sobol"] = k1_on_path(
        "C1 under sobol", job2, job2.cfg.max_depth + 1)
    torch.cuda.synchronize()
    t0 = time.time()
    img2 = render_job(job2)
    torch.cuda.synchronize()
    print(f"direct textured frame under sobol + gaussian, one cold run: "
          f"{time.time() - t0:.4f}s, image mean {img2.mean():.5f}")
    assert np.isfinite(img2).all() and img2.mean() > 0
    assert abs(img2.mean() - img.mean()) < 0.05 * img.mean()
    return job, launches, render_s, k1_paths


def phase_rpf_samplers(gpu: str):
    """Main path C2: the RPF frame under the random and stratified
    samplers.  Returns {sampler: K1 launches of the CLI run} and K1's
    records against its plain version on each frame's rays (the sampling
    pass's first two bounce steps: 2^20 camera paths, depth cut)."""
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.rpf.driver import render_rpf_job, sampling_config
    from tpurt_torch.testscenes import write_standin

    launches, k1_paths = {}, {}
    for sampler, spp in (("random", 8), ("stratified", 16)):
        scene = write_standin(str(WORK / f"standin_rpf_{sampler}.pbrt"),
                              "full", integrator="rpf", sampler=sampler)
        img, launches[sampler], _ = cli_counted(
            scene, WORK / f"standin_rpf_{sampler}_out.exr",
            f"main path C2 (RPF under {sampler})")
        assert img.shape == (700, 700, 3)
        job = build_job(load_scene(scene), "cuda")
        assert job.sampler.name == sampler and job.sampler.spp == spp
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        img, ex = render_rpf_job(job, write_feature_exrs=False)
        torch.cuda.synchronize()
        total = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        assert np.isfinite(img).all() and img.mean() > 0
        print(f"rpf_{sampler}_sampling_s {ex['sampling_time']:.4f} "
              f"rpf_{sampler}_filter_s {ex['filter_time']:.4f} "
              f"rpf_{sampler}_splat_s {ex['splat_time']:.4f} "
              f"rpf_{sampler}_total_s {total:.4f} ({spp} spp, one run after "
              f"the CLI's) peak mem {peak / 2**30:.3f} GiB, image mean "
              f"{img.mean():.5f} on {gpu}")
        k1_paths[f"rpf_{sampler}"] = k1_on_path(
            f"C2 RPF under {sampler}", job, 2, sampling_config(job))
        del job
        torch.cuda.empty_cache()
    return launches, k1_paths


def phase_whitted():
    """The whitted variant at 256x256 through the CLI."""
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.testscenes import write_textured

    scene = write_textured(str(WORK / "whitted_256.pbrt"), "full",
                           variant="whitted", res=256)
    img, launches, _ = cli_counted(scene, WORK / "whitted_256_out.exr",
                                   "whitted variant 256x256")
    assert img.shape == (256, 256, 3)
    job = build_job(load_scene(scene), "cuda")
    # (the refracted and mirrored rays of every bounce step)
    return launches, k1_on_path("whitted variant", job,
                                job.cfg.max_depth + 1)


SAMPLER_DIMS = (0, 1, 2, 5, 11, 19, 33)


def phase_cross_new():
    """The new paths on the card against the CPU."""
    from tpurt_torch.render.driver import load_scene, render
    from tpurt_torch.sampling.samplers import (halton_tables,
                                               sampler_from_tables,
                                               sampler_tables)
    from tpurt_torch.scene.paramset import ParamSet
    from tpurt_torch.testscenes import write_textured

    for variant in ("directlighting", "whitted"):
        small = write_textured(str(WORK / f"textured_small_{variant}.pbrt"),
                               "small", variant=variant)
        g, _ = render(load_scene(small), "cuda")
        h, _ = render(load_scene(small), "cpu")
        _close(g, h, f"small textured scene ({variant})")

    gen = torch.Generator().manual_seed(5)
    px = torch.randint(0, 700, (LANES,), generator=gen)
    py = torch.randint(0, 700, (LANES,), generator=gen)
    for name, scramble in (("halton", "affine"), ("halton", "pbrt"),
                           ("random", ""), ("stratified", ""),
                           ("02sequence", ""), ("sobol", ""),
                           ("maxmindist", "")):
        ps = ParamSet()
        ps.add("integer", "pixelsamples", [8])
        tab = (dict(halton_tables(8, 700, 700, scramble=scramble),
                    name="halton") if name == "halton"
               else sampler_tables(name, ps, 700, 700))
        cpu = sampler_from_tables(tab, "cpu")
        gpu = sampler_from_tables(tab, "cuda")
        s = torch.randint(0, cpu.spp, (LANES,), generator=gen)
        lanes_c = (px, py, s)
        lanes_g = tuple(a.cuda() for a in lanes_c)
        equal = all(torch.equal(
            gpu.dim(*lanes_g, d, gpu.lane_ctx(*lanes_g)).cpu(),
            cpu.dim(*lanes_c, d, cpu.lane_ctx(*lanes_c)))
            for d in SAMPLER_DIMS)
        print(f"sampler {name} {scramble}: dims {SAMPLER_DIMS} of {LANES} "
              f"lanes on the card bit-equal to the CPU's: {equal}")
        assert equal, name


def _pixel_rays(job):
    """Pixel-centre pinhole rays of the frame and their first hits through
    K1: (o, d, t, prim) as float64 / int numpy arrays."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.intersect import intersect_closest

    film = job.film
    dev = job.scene.geo.device
    ys, xs = torch.meshgrid(torch.arange(film.height, device=dev) + 0.5,
                            torch.arange(film.width, device=dev) + 0.5,
                            indexing="ij")
    p = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    o, d, _ = job.camera.generate_rays(p, torch.zeros_like(p))
    hit = intersect_closest(job.scene.geo, o, d, float("inf"), traverse_wide)
    return (o.double().cpu().numpy(), d.double().cpu().numpy(),
            hit.t.double().cpu().numpy(), hit.prim.cpu().numpy())


def _ground_view(job):
    """Per pixel of the frame (pixel centres, pinhole): the world point
    where the primary ray meets the ground plane y = 0, a mask of the
    pixels whose first hit is that plane (the ground quad), a mask of the
    pixels whose ray escapes, and the ray directions.  Numpy arrays."""
    film = job.film
    o, d, t, prim = _pixel_rays(job)
    t_plane = -o[:, 1] / np.minimum(d[:, 1], -1e-6)
    ground = ((prim >= 0) & (d[:, 1] < -1e-6)
              & (np.abs(t - t_plane) <= 1e-3 * t_plane))
    shape = (film.height, film.width)
    return ((o + t_plane[:, None] * d).reshape(shape + (3,)),
            ground.reshape(shape), (prim < 0).reshape(shape),
            d.reshape(shape + (3,)))


def d_light_checks(job, img):
    """Each new light of scene D shows in the frame the way a broken one
    would not (the numbers come from the scene's own description in
    tpurt_torch.testscenes, not from the renderer):
      sky: escaped upward rays toward world x > 0 see the map's warm half
        (red > 1.5 blue), toward x < 0 its cool half (blue > 1.5 red);
        an unread map renders a constant L = 1;
      projection: on open ground inside the projector's frustum, pixels
        the slide's model puts in a bright stripe are > 1.5 times those it
        puts in a dark one (medians); a dead or inverted slide lookup
        gives about 1 or less;
      goniometric: ground within 2.5 of the light's foot is > 1.5 times
        brighter on its lit side (world x > its x) than on its dark side;
        a lookup that ignores the map gives about 1 (1.3 with the
        projector's cone uniform too).
    Returns the measured numbers."""
    from tpurt_torch import testscenes as ts

    pw, ground, escaped, d = _ground_view(job)
    lum = img.mean(-1)
    up = escaped & (d[..., 1] > 0.05)
    warm = np.median(img[up & (d[..., 0] > 0.2)], 0)
    cool = np.median(img[up & (d[..., 0] < -0.2)], 0)
    # projector: light space of Translate PROJ_FROM, Rotate ay y, ax x
    frm = np.asarray(ts.PROJ_FROM, np.float64)
    a = np.subtract(ts.PROJ_TO, frm)
    a /= np.linalg.norm(a)
    ax, ay = np.arcsin(-a[1]), np.arctan2(a[0], a[2])
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    q = (pw - frm) @ (ry @ rx)  # R^T (p - from), row vectors
    inv_tan = 1.0 / np.tan(np.deg2rad(30.0) / 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = q[..., 0] * inv_tan / q[..., 2]
        sy = q[..., 1] * inv_tan / q[..., 2]
    inside = ground & (q[..., 2] > 0) & (np.abs(sx) < 0.95) & (
        np.abs(sy) < 0.95)
    col = (sx + 1) / 2 * 127  # the slide's column (128 wide, 16 a stripe)
    phase = np.mod(col, 32)
    bright = inside & (phase > 3) & (phase < 13)
    dark = inside & (phase > 19) & (phase < 29)
    stripes = np.median(lum[bright]) / max(np.median(lum[dark]), 1e-6)
    # goniometric light: lit toward world +x of its foot
    gx, _, gz = ts.GONIO_AT
    r = np.hypot(pw[..., 0] - gx, pw[..., 2] - gz)
    near = ground & (r > 0.3) & (r < 2.5)
    lit, unlit = near & (pw[..., 0] > gx + 0.2), near & (pw[..., 0] < gx - 0.2)
    gonio = np.median(lum[lit]) / max(np.median(lum[unlit]), 1e-6)
    out = dict(sky_warm=warm.round(4).tolist(), sky_cool=cool.round(4).tolist(),
               stripes_ratio=float(stripes), gonio_ratio=float(gonio),
               pixels=dict(sky=int(up.sum()), stripes=int(bright.sum()
                                                          + dark.sum()),
                           gonio=int(lit.sum() + unlit.sum())))
    print(f"D lights: {out}")
    assert up.sum() > 100 and bright.sum() > 100 and dark.sum() > 100
    assert lit.sum() > 100 and unlit.sum() > 100, out
    assert warm[0] > 1.5 * warm[2] and cool[2] > 1.5 * cool[0], out
    assert stripes > 1.5, out
    assert gonio > 1.5, out
    return out


def env_sampling_check(job):
    """The environment map's importance sampling on the card against the
    CPU on 2^20 uniforms: the same texel on every lane (ties on the CDF
    break to the same side), directions and pdfs within 1e-5; and the
    texels the card picks follow the map's distribution (each texel's
    count within 6 sigma of its expected count, sigma = sqrt(expected +
    1), from the host's CDF tables in float64), which a wrong inversion
    does not."""
    import dataclasses

    from tpurt_torch.render.lights import env_sample

    lt = job.scene.lights
    lt_cpu = dataclasses.replace(lt, **{
        f.name: getattr(lt, f.name).cpu() for f in dataclasses.fields(lt)
        if torch.is_tensor(getattr(lt, f.name))})
    gen = torch.Generator().manual_seed(9)
    u1, u2 = torch.rand(LANES, generator=gen), torch.rand(LANES, generator=gen)
    # a quarter of the lanes exactly on CDF entries
    cond, marg = lt_cpu.env_cond_cdf, lt_cpu.env_marg_cdf
    k = LANES // 4
    u2[:k] = marg[:-1][torch.randint(0, marg.shape[0] - 1, (k,),
                                     generator=gen)]
    u1[:k] = cond[:, :-1].reshape(-1)[torch.randint(
        0, cond[:, :-1].numel(), (k,), generator=gen)]
    wi_c, li_c, pdf_c = env_sample(lt_cpu, u1, u2)
    wi_g, li_g, pdf_g = env_sample(lt, u1.cuda(), u2.cuda())
    same_texel = torch.equal(li_g.cpu(), li_c)
    d_err = (wi_g.cpu() - wi_c).abs().max().item()
    p_err = ((pdf_g.cpu() - pdf_c).abs() / pdf_c.abs().clamp(min=1e-6)
             ).max().item()
    # distribution of the card's texels (a texel's radiance names it only
    # up to equal texels: count (row, column) from the direction instead)
    he, we = lt.env_map.shape[:2]
    m = lt.env_w2l.cpu().double()[:3, :3]
    wl = wi_g.cpu().double() @ m.T
    theta = torch.acos(wl[:, 2].clamp(-1, 1))
    phi = torch.remainder(torch.atan2(wl[:, 1], wl[:, 0]), 2 * np.pi)
    vi = (theta / np.pi * he).long().clamp(0, he - 1)
    ui = (phi / (2 * np.pi) * we).long().clamp(0, we - 1)
    counts = torch.bincount(vi * we + ui, minlength=he * we).double()
    n_rand = LANES - k
    c = cond.double().numpy()
    mg = marg.double().numpy()
    p = (np.diff(mg)[:, None] * np.diff(c, axis=1)).reshape(-1)
    sub = torch.bincount((vi * we + ui)[k:], minlength=he * we).double()
    dev = (sub.numpy() - n_rand * p) / np.sqrt(n_rand * p + 1.0)
    worst = float(np.abs(dev).max())
    print(f"env sampling @ {LANES} lanes ({k} on CDF entries): card texels "
          f"equal to the CPU's {same_texel}, max |dwi| {d_err:.3e}, max pdf "
          f"rel err {p_err:.3e}; random lanes' texel counts against the "
          f"map's distribution: worst {worst:.2f} sigma over {he}x{we} "
          f"texels ({int((counts > 0).sum())} hit)")
    assert same_texel and d_err <= 1e-5 and p_err <= 1e-5
    assert worst <= 6.0, worst
    return dict(same_texel=same_texel, max_abs_dwi=d_err,
                max_pdf_rel_err=p_err, worst_sigma=worst)


def phase_materials(gpu: str):
    """Main path D: scene D (every other material, quadric, light) through
    the CLI at 700x700, 8 spp, then its checks, K1 on its rays, 3 timed
    renders; D under rpf at 256x256; small scenes on the card against the
    CPU."""
    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.testscenes import write_camera_scene, write_materials

    scene = write_materials(str(WORK / "materials_full.pbrt"), "full")
    img, launches, _ = cli_counted(scene, WORK / "materials_full_out.exr",
                                   "main path D (materials, quadrics, lights)")
    assert img.shape == (700, 700, 3)
    job = build_job(load_scene(scene), "cuda")
    g = job.scene.geo
    print(f"scene D: {g.n_tris} triangles, quadrics {g.quads}, lights "
          f"{job.scene.lights.n_lights}, lobe set {job.scene.lobe_slots}")
    checks = d_light_checks(job, img)
    checks["env_sampling"] = env_sampling_check(job)
    k1_paths = {"materials": k1_on_path("D materials", job,
                                        job.cfg.max_depth + 1)}
    render_s, runs, peak, img = render_timed(job)
    print(f"materials_lights_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in runs]}) peak mem {peak / 2**30:.3f} GiB, "
          f"image mean {img.mean():.5f} on {gpu}")

    rpf = write_materials(str(WORK / "materials_rpf_256.pbrt"), "full",
                          integrator="rpf", res=256)
    img_r, launches_rpf, _ = cli_counted(rpf, WORK / "materials_rpf_out.exr",
                                         "scene D under rpf, 256x256")
    assert img_r.shape == (256, 256, 3)

    small = [("D 64x64", write_materials(str(WORK / "materials_64.pbrt"),
                                         "medium"))]
    for kind in ("orthographic", "environment"):
        small.append((f"{kind} camera", write_camera_scene(
            str(WORK / f"camera_{kind}.pbrt"), kind)))
    for what, path in small:
        gimg, _ = render(load_scene(path), "cuda")
        himg, _ = render(load_scene(path), "cpu")
        _close(gimg, himg, what)
    return job, launches, launches_rpf, render_s, k1_paths, checks


def _primary_prims(job, time_value: float):
    """The prim each pixel centre's pinhole ray hits at shutter time
    ``time_value`` (-1 where it escapes), as a long tensor on the card."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.intersect import intersect_closest

    film = job.film
    dev = job.scene.geo.device
    ys, xs = torch.meshgrid(torch.arange(film.height, device=dev) + 0.5,
                            torch.arange(film.width, device=dev) + 0.5,
                            indexing="ij")
    p = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    tt = torch.full((p.shape[0],), time_value, device=dev)
    o, d, _ = job.camera.generate_rays(p, torch.zeros_like(p), tt)
    return intersect_closest(job.scene.geo, o, d, float("inf"),
                             traverse_wide, time=tt).prim.long()


def e_checks(job, img):
    """The motion and the hair show in frame E the way a dead lerp or a
    dead hair BSDF would not.  Each is measured against a render of the
    same job with the feature switched off, on the same samples:
      motion: over the pixels a moving mesh covers at shutter close but
        not at shutter open (pixel-centre rays, camera and meshes at each
        time), the mean |luminance - the dead-lerp render's| over that
        render's mean; the dead-lerp render zeroes the delta tables, so a
        kernel or shading lerp that ignored the ray's time gives 0 (0.0000
        by construction; ~2.07 measured at 128x128 on the CPU);
      hair: the median red / blue over the pixels whose ray meets a hair
        fiber at both shutter times; eumelanin 1.3 makes it reddish, while
        the frame with the hair BSDF dead (the hair rows shaded by tpurt's
        gray diffuse stand-in) keeps the lights' colour, ~1.01 (~1.37 live
        at 128x128 on the CPU).
    Returns the measured numbers."""
    import dataclasses

    from tpurt_torch.render.bsdf import LobeSet
    from tpurt_torch.render.driver import render_job
    from tpurt_torch.render.intersect import motion_group_boxes
    from tpurt_torch.render.materials_build import C_KIND, MAT_HAIR

    geo = job.scene.geo
    film = job.film
    shape = (film.height, film.width)
    h0, h1 = _primary_prims(job, 0.0), _primary_prims(job, 1.0)
    p = geo.shade_rows.shape[0]
    mover = torch.zeros(p + 1, dtype=torch.bool, device=geo.device)
    mover[:p] = geo.shade_delta[:, :9].abs().sum(1) > 0
    swept = (~mover[h0] & mover[h1]).reshape(shape).cpu().numpy()
    mat = geo.shade_rows[:, 2].contiguous().view(torch.int32).long()
    is_hair = torch.zeros(p + 1, dtype=torch.bool, device=geo.device)
    is_hair[:p] = (job.scene.mt_table[mat.clamp(min=0), C_KIND].long()
                   == MAT_HAIR) & (mat >= 0)
    hair = (is_hair[h0] & is_hair[h1]).reshape(shape).cpu().numpy()

    dead_delta = torch.zeros_like(geo.leaves_delta)
    dead_geo = dataclasses.replace(
        geo, wnodes_delta=torch.zeros_like(geo.wnodes_delta),
        leaves_delta=dead_delta,
        leaves_box=motion_group_boxes(geo.leaves, dead_delta),
        shade_delta=torch.zeros_like(geo.shade_delta))
    img_dm = render_job(dataclasses.replace(
        job, scene=dataclasses.replace(job.scene, geo=dead_geo)))
    ls = job.scene.lobe_slots
    dead_ls = LobeSet(tuple(ls), ls.fresnel, ls.disney, ls.mix, ls.kinds,
                      hair=False)
    img_dh = render_job(dataclasses.replace(
        job, scene=dataclasses.replace(job.scene, lobe_slots=dead_ls)))
    lum, lum_dm = img.mean(-1), img_dm.mean(-1)
    motion = float(np.abs(lum[swept] - lum_dm[swept]).mean()
                   / max(lum_dm[swept].mean(), 1e-6))

    def red_blue(a):
        x = a[hair]
        return float(np.median(x[:, 0]) / max(np.median(x[:, 2]), 1e-6))

    out = dict(motion_swept_rel_diff=motion, hair_red_blue=red_blue(img),
               hair_red_blue_dead=red_blue(img_dh),
               pixels=dict(swept=int(swept.sum()), hair=int(hair.sum())))
    print(f"E checks: {out}")
    assert swept.sum() > 100 and hair.sum() > 100, out
    assert motion > 0.2, out
    assert out["hair_red_blue"] > 1.15, out
    assert out["hair_red_blue"] > 1.1 * out["hair_red_blue_dead"], out
    return out


def phase_motion_hair(gpu: str):
    """Main path E: frame E (motion blur, ray-traced curves and hair)
    through the CLI at 700x700, 8 spp, with K1m and K1c launched and K1's
    static body not; its checks; K1m and K1c against their plain versions
    on E's rays (camera paths and the first two bounce steps); 3 timed
    renders; E under rpf at 256x256; E at 64x64 on the card against the
    CPU."""
    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.testscenes import E_SIZES, write_motion_hair

    scene = write_motion_hair(str(WORK / "motion_hair_full.pbrt"), "full")
    img, launches, cli_s = cli_counted(
        scene, WORK / "motion_hair_full_out.exr",
        "main path E (motion blur, curves, hair)", bodies=("K1m", "K1c"))
    from tpurt_torch.kernels.traverse import traverse_wide
    by_body = dict(traverse_wide.kernel_launches)
    assert img.shape == (700, 700, 3)
    t0 = time.time()
    job = build_job(load_scene(scene), "cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    g = job.scene.geo
    fibers = E_SIZES["full"]["fibers"]
    print(f"scene E: {g.n_tris} triangles (delta table "
          f"{g.leaves_delta.shape[0]} leaf rows), quadrics {g.quads} (animated "
          f"{g.quad_animated_host}), {g.n_curves} curve spans ({fibers} "
          f"hair fibers x 4 segments x 2^3 = {fibers * 32} before tpurt's "
          f"pre-split), curve tables {g.cinodes.shape[0]} interior + "
          f"{g.cleaves.shape[0]} leaf rows "
          f"({(g.cinodes.numel() + g.cleaves.numel()) * 4 / 1e6:.1f} MB, "
          f"ribbon aux {g.cleaves_aux.numel() * 4 / 1e6:.1f} MB), stacks "
          f"{g.wstack_depth} / {g.cstack_depth}, lobe set "
          f"{job.scene.lobe_slots}, tangents {g.has_tangents}; scene build "
          f"{build_s:.2f}s")
    checks = e_checks(job, img)
    k1_e = k1_on_path("E motion hair", job, 2)
    assert {r["body"] for r in k1_e} == {"K1m", "K1c"}, k1_e
    render_s, runs, peak, img = render_timed(job)
    print(f"motion_hair_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in runs]}) peak mem {peak / 2**30:.3f} GiB, "
          f"image mean {img.mean():.5f}, CLI first run {cli_s:.2f}s on {gpu}")

    rpf = write_motion_hair(str(WORK / "motion_hair_rpf_256.pbrt"), "full",
                            integrator="rpf", res=256)
    img_r, launches_rpf, _ = cli_counted(
        rpf, WORK / "motion_hair_rpf_out.exr", "frame E under rpf, 256x256",
        bodies=("K1m", "K1c"))
    rpf_by_body = dict(traverse_wide.kernel_launches)
    assert img_r.shape == (256, 256, 3)

    small = write_motion_hair(str(WORK / "motion_hair_64.pbrt"), "medium")
    gimg, _ = render(load_scene(small), "cuda")
    himg, _ = render(load_scene(small), "cpu")
    _close(gimg, himg, "E 64x64")
    return (job, launches, by_body, launches_rpf, rpf_by_body, render_s,
            k1_e, checks)


def phase_profile(label: str, frame, wall_s: float, ranges=(),
                  top: int = 12, host: bool = True):
    """Device time by kernel over one full frame (``frame()``).  The idle
    share is 1 - kernel time / the unprofiled wall time ``wall_s``
    (tracing inflates the profiled wall clock).  ``ranges``: names of
    profiler ranges in the port (render/volpath.py's) whose kernels'
    device time is reported beside the total; they need the host's
    activity traced too, which on a frame of ~500,000 launches costs
    minutes: with ``host=False`` only the device is traced, no range is
    reported, and the device events are summed straight from the
    profiler's raw records (turning 150,000 of them into the profiler's
    Python events costs tens of seconds).  Returns the launches, the busy
    seconds, the idle share, K1's kernel seconds and each range's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not host:
        ranges = ()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host else [])) as prof:
        frame()
        torch.cuda.synchronize()
    # (name, launches, device seconds) of each kernel
    if host:
        events = prof.key_averages()
        kernels = [(e.key, e.count, e.self_device_time_total / 1e6)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.key not in ranges]
    else:
        agg = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                n, t = agg.get(e.name(), (0, 0))
                agg[e.name()] = (n + 1, t + e.duration_ns())
        kernels = [(k, n, t / 1e9) for k, (n, t) in agg.items()]
    kernels.sort(key=lambda e: -e[2])
    busy = sum(e[2] for e in kernels)
    launches = sum(e[1] for e in kernels)
    k1 = sum(e[2] for e in kernels if "traverse" in e[0])
    out = dict(launches=launches, busy_s=busy, idle=1 - busy / wall_s,
               k1_s=k1, k1_share=k1 / max(busy, 1e-12))
    print(f"profile {label}: {launches} kernel launches, device busy "
          f"{busy:.4f}s of {wall_s:.4f}s (idle share {1 - busy / wall_s:.3f});"
          f" K1 kernels {k1:.4f}s ({k1 / max(busy, 1e-12):.3f} of busy)")
    for name in ranges:
        cpu = [e for e in events if e.key == name
               and e.device_type != DeviceType.CUDA]
        dev_s = sum(e.device_time_total for e in cpu) / 1e6
        calls = sum(e.count for e in cpu)
        out[name] = dev_s
        print(f"  range {name}: {calls} calls, device time of its kernels "
              f"{dev_s:.4f}s ({dev_s / max(busy, 1e-12):.3f} of busy)"
              + (" (the profiler gave the range no device time: not "
                 "measured)" if calls and not dev_s else ""))
    for key, count, sec in kernels[:top]:
        print(f"  {sec * 1e3:9.2f} ms {count:6d}x {key[:100]}")
    return out


def _sphere_chord(c, r, a, u, t_max):
    """Length of the segments a + s u (u unit, s in [0, t_max]) inside the
    sphere (c, r)."""
    oc = a - np.asarray(c)
    b = (oc * u).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - r * r)
    sq = np.sqrt(np.maximum(disc, 0.0))
    s0 = np.clip(-b - sq, 0.0, t_max)
    s1 = np.clip(-b + sq, 0.0, t_max)
    return np.where(disc > 0, s1 - s0, 0.0)


def f_checks(job, img):
    """The media show in frame F the way dead media code would not.  Each
    is measured against a render of the same job with one part switched
    off, on the same samples (pixel sets from the scene's own description
    in tpurt_torch.testscenes and pixel-centre pinhole rays):
      media: mean |frame - the frame with every sigma zeroed| over the
        latter's mean; dead media code gives 0;
      shaft: over back-wall pixels outside the spot's footprint whose
        camera ray runs > 2 units inside the spot's cone, the median of
        frame / media-removed frame, over the same median where the ray
        misses the cone; in-scattering from the spot makes it > 1, a dead
        medium vertex NEE gives ~1;
      smoke shadow: over back-wall pixels inside the spot's inner cone
        whose segment to the spot crosses the smoke sphere (chord > r/2),
        the median luminance over that of the footprint's unshadowed
        pixels (attenuated: < 1; the smoke's transmittance) and over the
        same pixels' median when the shadow walk is off (shadow rays
        occluded by the null sphere: the walk's dead value, 1).
    Returns the measured numbers."""
    import dataclasses

    from tpurt_torch import testscenes as ts
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.driver import render_job
    from tpurt_torch.render.intersect import intersect_any

    sc = job.scene
    o, d, t, prim = _pixel_rays(job)
    pw = o + t[:, None] * d
    c, r = np.asarray(ts.SMOKE_CENTER), ts.SMOKE_RADIUS
    wall = (prim >= 0) & (np.abs(pw[:, 2] - ts.WALL_Z) < 1e-3)
    clear = wall & (_sphere_chord(c, r, o, d, t) == 0)
    removed = render_job(dataclasses.replace(job, scene=dataclasses.replace(
        sc, med_sigma_t=torch.zeros_like(sc.med_sigma_t),
        med_sigma_s=torch.zeros_like(sc.med_sigma_s))))
    lum, lum_rm = img.mean(-1).reshape(-1), removed.mean(-1).reshape(-1)
    media = float(np.abs(img - removed).mean() / removed.mean())

    sf = np.asarray(ts.SPOT_FROM)
    axis = (c - sf) / np.linalg.norm(c - sf)

    def cone_cos(q):
        v = q - sf
        return (v @ axis) / np.linalg.norm(v, axis=-1)

    cos_out = np.cos(np.deg2rad(ts.SPOT_CONE))
    cos_in = np.cos(np.deg2rad(ts.SPOT_CONE - ts.SPOT_DELTA))
    steps = np.linspace(0.0, 1.0, 66)[1:-1]
    inside = sum((cone_cos(o + (s * t)[:, None] * d) > cos_out)
                 for s in steps)
    ell = inside / len(steps) * t
    off_foot = clear & (cone_cos(pw) <= cos_out)
    shaft_px, calm_px = off_foot & (ell > 2.0), off_foot & (ell == 0)
    ratio = lum / np.maximum(lum_rm, 1e-6)
    shaft = float(np.median(ratio[shaft_px]) / np.median(ratio[calm_px]))

    to_l = sf - pw
    dist = np.linalg.norm(to_l, axis=-1)
    u = to_l / np.maximum(dist, 1e-9)[:, None]
    chord = _sphere_chord(c, r, pw, u, dist)
    foot = clear & (cone_cos(pw) > cos_in)
    dev = sc.geo.device
    occ = intersect_any(
        sc.geo, torch.tensor(pw + 1e-3 * u, dtype=torch.float32, device=dev),
        torch.tensor(u, dtype=torch.float32, device=dev),
        torch.tensor(dist * 0.999, dtype=torch.float32, device=dev),
        traverse_wide).cpu().numpy()
    shadow_px, lit_px = foot & (chord > 0.5 * r), foot & (chord == 0) & ~occ
    no_walk = render_job(dataclasses.replace(job, scene=dataclasses.replace(
        sc, has_null_boundaries=False)))
    lum_nw = no_walk.mean(-1).reshape(-1)
    out = dict(media_removed_rel_diff=media, shaft_ratio=shaft,
               smoke_shadow_over_lit=float(np.median(lum[shadow_px])
                                           / np.median(lum[lit_px])),
               smoke_shadow_over_no_walk=float(np.median(lum[shadow_px])
                                               / np.median(lum_nw[shadow_px])),
               pixels=dict(wall=int(wall.sum()), shaft=int(shaft_px.sum()),
                           calm=int(calm_px.sum()),
                           shadow=int(shadow_px.sum()),
                           lit=int(lit_px.sum())))
    print(f"F checks: {out}")
    assert min(out["pixels"].values()) > 100, out
    assert media > 0.1, out
    assert shaft > 1.3, out
    assert out["smoke_shadow_over_lit"] < 0.8, out
    assert out["smoke_shadow_over_no_walk"] > 1.25, out
    return out


# timed renders of each frame after its warm-up: 1 in the no-argument run,
# 3 under --profile (main sets it)
TIMED_RUNS = 1


def render_timed(job):
    """(median seconds, the runs, peak memory in bytes, the last image) of
    TIMED_RUNS renders of a built job after one warm-up."""
    from tpurt_torch.render.driver import render_job

    render_job(job)  # warm-up
    times, peak = [], 0
    for _ in range(TIMED_RUNS):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        img = render_job(job)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
    assert np.isfinite(img).all() and img.mean() > 0
    return statistics.median(times), times, peak, img


def phase_media(gpu: str, profile_all: bool):
    """Main path F: frame F (participating media through volpath) through
    the CLI at 700x700, 8 spp: its parse time, the traversal counters (K1
    only, no plain traversal), the media checks, K1 against its plain
    version on F's own rays (the camera rays, the first two bounce steps
    with their shadow walks' crossing calls), 3 timed renders
    (media_render_s) with the media loops' counters, one profiled frame
    (launches, idle share, the tracking loops' and the walk's share), and
    F at 64x64 on the card against the CPU."""
    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.render.volpath import (GRID_OVERFLOW, TRACK_STATS,
                                            TRACKING_RANGE, WALK_OVERFLOW,
                                            WALK_RANGE)
    from tpurt_torch.testscenes import write_media

    t_phase = time.time()
    scene = write_media(str(WORK / "media_full.pbrt"), "full")
    t0 = time.time()
    sd = load_scene(scene)
    parse_s = time.time() - t0
    grid = sd.media["smoke"].density
    print(f"scene F: {Path(scene).stat().st_size / 1e6:.2f} MB of text, "
          f"parsed in {parse_s:.2f}s; grid medium {grid.shape} "
          f"({grid.nbytes / 1e6:.2f} MB), media {list(sd.media)}, camera in "
          f"{sd.camera_medium!r}")
    img, launches, cli_s = cli_counted(scene, WORK / "media_full_out.exr",
                                       "main path F (volpath, media)")
    assert img.shape == (700, 700, 3)
    job = build_job(sd, "cuda")
    assert job.cfg.name == "volpath" and job.scene.has_grid_media
    assert job.scene.has_null_boundaries and job.scene.camera_medium >= 0
    checks = f_checks(job, img)
    k1_f = k1_on_path("F media", job, 2)
    assert sum(not r["any_hit"] for r in k1_f) > 3, k1_f  # walk crossings
    render_s, runs, peak, img = render_timed(job)
    stats = TRACK_STATS.read()
    steps = stats.get("Media/Grid tracking steps", 0)
    lanes = max(stats.get("Media/Grid tracked lanes", 0), 1)
    track = dict(steps_mean=steps / lanes,
                 steps_max=stats.get("Media/Grid tracking steps (max)", 0),
                 tracked_lanes=lanes,
                 grid_overflow=stats.get(GRID_OVERFLOW, 0),
                 walk_overflow=stats.get(WALK_OVERFLOW, 0))
    print(f"media_render_s {render_s:.4f} (runs {['%.4f' % r for r in runs]})"
          f" peak mem {peak / 2**30:.3f} GiB, image mean {img.mean():.5f}, "
          f"CLI first run {cli_s:.2f}s on {gpu}; media loops (last frame): "
          f"{track}")
    assert track["grid_overflow"] == 0 and track["walk_overflow"] == 0
    t_prof = time.time()
    prof = None
    if profile_all:
        prof = phase_profile("media frame F", lambda: render_job(job),
                             render_s, ranges=(TRACKING_RANGE, WALK_RANGE),
                             top=25)
    t_prof = time.time() - t_prof
    gimg, _ = render(load_scene(write_media(str(WORK / "media_64.pbrt"),
                                            "medium")), "cuda")
    himg, _ = render(load_scene(str(WORK / "media_64.pbrt")), "cpu")
    _close(gimg, himg, "F 64x64")
    print(f"phase 16 took {time.time() - t_phase:.1f}s, the profiled frame "
          f"{t_prof:.1f}s of it")
    return dict(launches=launches, render_s=render_s, parse_s=parse_s,
                peak=peak, checks=checks, track=track, profile=prof,
                k1=k1_f)


def phase_ao(gpu: str, profile_all: bool):
    """Main path AO: the stand-in under Integrator "ao" (64 cosine-weighted
    occlusion rays a camera hit) through the CLI at 700x700, 8 spp: the
    traversal counters, K1 against its plain version on AO's rays (the
    camera rays and the first two samples' occlusion rays: 2^20 camera
    paths), 3 timed renders (ao_render_s), one profiled frame (K1's share
    of the device time) and AO at 64x64 on the card against the CPU."""
    import dataclasses

    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.testscenes import write_standin

    scene = write_standin(str(WORK / "standin_ao_full.pbrt"), "full",
                          integrator="ao")
    img, launches, cli_s = cli_counted(scene, WORK / "standin_ao_out.exr",
                                       "main path AO (ambient occlusion)")
    assert img.shape == (700, 700, 3) and img.max() <= 1.0 + 1e-5
    job = build_job(load_scene(scene), "cuda")
    assert job.cfg.name == "ao" and job.cfg.ao_samples == 64
    k1_ao = k1_on_path("AO", job, 0,
                       dataclasses.replace(job.cfg, ao_samples=2))
    assert [r["any_hit"] for r in k1_ao] == [False, True, True], k1_ao
    render_s, runs, peak, img = render_timed(job)
    rays = job.film.width * job.film.height * job.sampler.spp
    print(f"ao_render_s {render_s:.4f} (runs {['%.4f' % r for r in runs]}) "
          f"peak mem {peak / 2**30:.3f} GiB, image mean {img.mean():.5f}, "
          f"{rays} camera paths x {job.cfg.ao_samples} occlusion rays, CLI "
          f"first run {cli_s:.2f}s on {gpu}")
    prof = None
    if profile_all:
        prof = phase_profile("ao frame", lambda: render_job(job), render_s)
        print(f"AO: K1 {'is' if prof['k1_share'] > 0.5 else 'is not'} most "
              f"of the device time ({prof['k1_share']:.3f})")
    small = write_standin(str(WORK / "standin_ao_64.pbrt"), "medium",
                          integrator="ao")
    gimg, _ = render(load_scene(small), "cuda")
    himg, _ = render(load_scene(small), "cpu")
    _close(gimg, himg, "AO 64x64")
    return dict(launches=launches, render_s=render_s, peak=peak,
                profile=prof, k1=k1_ao)


def _mean_without(job, splats: bool = True, occlusion: bool = True):
    """The mean of job's bdpt frame rendered with the t=1 splats dropped
    (``splats=False``) or with every connection ray's occlusion ignored
    (``occlusion=False``: the any-hit calls see t_max 0), on the same
    samples."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.driver import trace_lanes

    film = job.film
    state = film.initial_state(job.scene.geo.device, splats=True)

    def bank(st, sel):
        film.add_samples(state, st["p_film_crop"], st["L"], st["ray_w"])
        if splats and "splat_p" in st:
            film.add_splats(state, st["splat_p"], st["splat_L"])

    def traverse(geo, o, d, t_max, any_hit, time=None, tree="tri"):
        if any_hit and not occlusion:
            t_max = torch.zeros_like(t_max)
        return traverse_wide(geo, o, d, t_max, any_hit, time=time, tree=tree)

    trace_lanes(job, job.cfg, traverse, bank)
    return float(film.to_image(state, 1.0 / job.sampler.spp).mean())


def g_checks(job, img, path_mean: float):
    """Main path G's checks, each against a render of the same job on the
    same samples:
      path: the mean of G over frame A's path mean (the same scene;
        tpurt's own bdpt-vs-path gap on the small stand-in, measured on
        the CPU: +1.29% at 8 spp, +0.29% at 32 spp), within 5%;
      light tracing: 1 - the mean with the t=1 splats dropped over G's
        mean, the light-tracing strategies' share (dead splats: 0);
      occlusion: the mean with every connection ray's occlusion ignored
        over G's (a dead any-hit batch: 1)."""
    mean = float(img.mean())
    out = dict(bdpt_over_path=mean / path_mean,
               light_tracing_share=1.0 - _mean_without(job, splats=False)
               / mean,
               unoccluded_over_occluded=_mean_without(job, occlusion=False)
               / mean)
    print(f"G checks: {out}")
    assert abs(out["bdpt_over_path"] - 1.0) < 0.05, out
    assert out["light_tracing_share"] > 0.001, out
    assert out["unoccluded_over_occluded"] > 1.01, out
    return out


def phase_bdpt(gpu: str, path_mean: float, profile_all: bool):
    """Main path G: the stand-in under Integrator "bdpt" through the CLI
    at 700x700, 8 spp, maxdepth 5 (K1 must launch closest and any-hit, the
    plain traversal not), g_checks, K1 against its plain version on G's
    rays (one chunk's walk calls and connection slices), the timed frame
    (bdpt_render_s, peak memory), and under --profile the breakdown with
    the walk's, the strategy loop's and the connection batch's ranges."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.bdpt import (CONNECT_RANGE, CONNECT_SLICE,
                                         STRATEGY_RANGE, WALK_RANGE)
    from tpurt_torch.render.driver import build_job, load_scene, render_job
    from tpurt_torch.testscenes import write_standin

    scene = write_standin(str(WORK / "standin_bdpt_full.pbrt"), "full",
                          integrator="bdpt")
    img, launches, cli_s = cli_counted(scene, WORK / "standin_bdpt_out.exr",
                                       "main path G (bdpt)")
    any_hit = traverse_wide.any_hit_launches
    print(f"G: K1 closest launches {launches - any_hit}, any-hit {any_hit}")
    assert img.shape == (700, 700, 3) and any_hit > 0 and launches > any_hit
    job = build_job(load_scene(scene), "cuda")
    assert job.cfg.name == "bdpt" and job.cfg.max_depth == 5
    checks = g_checks(job, img, path_mean)
    k1_g = k1_on_path("G bdpt", job, 0)
    conn = [r for r in k1_g if r["any_hit"] and r["rays"] == CONNECT_SLICE]
    walk = [r for r in k1_g if not r["any_hit"]]
    assert len(walk) == job.cfg.max_depth + 1 and conn, k1_g
    render_s, runs, peak, img = render_timed(job)
    print(f"bdpt_render_s {render_s:.4f} (runs {['%.4f' % r for r in runs]})"
          f" peak mem {peak / 2**30:.3f} GiB, image mean {img.mean():.5f}, "
          f"CLI first run {cli_s:.2f}s, K1 launches {launches} on {gpu}")
    prof = None
    if profile_all:
        prof = phase_profile("bdpt frame G", lambda: render_job(job),
                             render_s, top=20,
                             ranges=(WALK_RANGE, STRATEGY_RANGE,
                                     CONNECT_RANGE))
    return dict(launches=launches, any_hit_launches=any_hit,
                render_s=render_s, peak=peak, checks=checks, k1=k1_g,
                connection=conn[0], profile=prof, mean=float(img.mean()))


def phase_bdpt_cross():
    """Phase 19: bdpt on the card against the CPU under phase 9's bounds:
    G small (32x32), frame F's 64x64 scene (the media walk, the medium
    vertices, the connection transmittance), frame D's small scene (every
    light kind's sample_le and pdf_le, the environment map) and frame E's
    small scene at 32x32 (K1m and K1c inside the walk, the curves'
    connection offsets)."""
    from tpurt_torch.render.driver import load_scene, render
    from tpurt_torch.testscenes import (write_materials, write_media,
                                        write_motion_hair, write_standin)

    scenes = [
        ("G 32x32", write_standin(str(WORK / "standin_bdpt_small.pbrt"),
                                  "small", integrator="bdpt")),
        ("F 64x64 under bdpt", write_media(str(WORK / "media_bdpt_64.pbrt"),
                                           "medium", integrator="bdpt")),
        ("D 32x32 under bdpt", write_materials(
            str(WORK / "materials_bdpt_small.pbrt"), "small",
            integrator="bdpt")),
        ("E 32x32 under bdpt", write_motion_hair(
            str(WORK / "motion_hair_bdpt_32.pbrt"), "small",
            integrator="bdpt", res=32)),
    ]
    for what, path in scenes:
        g, job = render(load_scene(path), "cuda")
        h, _ = render(load_scene(path), "cpu")
        assert job.cfg.name == "bdpt"
        _close(g, h, what)


def phase_mlt(gpu: str, path_mean: float, profile_all: bool):
    """Main path H: the stand-in under Integrator "mlt" (maxdepth 5)
    through the CLI at 128x128 with mutationsperpixel 16 (the dispatch: K1
    launched, no plain traversal), then one timed 700x700 frame on a built
    job through render_mlt_job with 2^20 chains and pbrt's 100 mutations
    a pixel, with the traversal counters set to 0 just before it and read
    just after (K1 launched closest and any-hit, the plain traversal
    not): mlt_render_s with its bootstrap and chain seconds and the
    acceptance per depth; its mean within 15% of frame A's path mean
    (tpurt's MLT tolerance, tests/test_bdpt.py:124-139).  Then K1 against
    its plain version on the calls of one chain step's evaluation (depth
    1, 2^20 rows).  Under --profile one chain step's breakdown
    (mlt_step_profile)."""
    from tpurt_torch.kernels.traverse import (reset_launches, traverse_wide,
                                              traverse_wide_reference)
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.render.mlt import render_mlt_job
    from tpurt_torch.testscenes import write_standin

    small = write_standin(str(WORK / "standin_mlt_128.pbrt"), "full",
                          integrator="mlt", res=128, mutations=16)
    img, launches_cli, cli_s = cli_counted(
        small, WORK / "standin_mlt_out.exr", "main path H (mlt, 128x128)")
    assert img.shape == (128, 128, 3)
    scene = write_standin(str(WORK / "standin_mlt_full.pbrt"), "full",
                          integrator="mlt")
    sd = load_scene(scene)
    job = build_job(sd, "cuda")
    assert job.cfg.name == "mlt"
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    traverse_wide_reference.calls = 0
    torch.cuda.synchronize()
    t0 = time.time()
    img = render_mlt_job(job, sd.integrator_params, n_chains=1 << 20,
                         stats=stats)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches, any_hit = traverse_wide.launches, traverse_wide.any_hit_launches
    plain_calls = traverse_wide_reference.calls
    peak = torch.cuda.max_memory_allocated()
    ratio = float(img.mean()) / path_mean
    print(f"mlt_render_s {render_s:.4f} (bootstrap {stats['bootstrap_s']:.4f}"
          f" s, chains {stats['chains_s']:.4f} s) peak mem "
          f"{peak / 2**30:.3f} GiB, image mean {img.mean():.5f} = "
          f"{ratio:.4f} of A's path mean, b per depth "
          f"{stats['b_per_depth']}, chains {stats['depths']}, K1 launches "
          f"{launches} (any-hit {any_hit}), plain calls {plain_calls}, CLI "
          f"128x128 {cli_s:.2f}s on {gpu}")
    assert img.shape == (700, 700, 3) and np.isfinite(img).all()
    assert launches > any_hit > 0 and plain_calls == 0
    assert abs(ratio - 1.0) < 0.15, ratio
    k1_h = k1_on_calls("H chain step", job.scene.geo, mlt_step_calls(job))
    prof = None
    if profile_all:
        prof = mlt_step_profile(job, stats["b_per_depth"][1])
    return dict(launches=launches, any_hit_launches=any_hit,
                launches_cli=launches_cli, render_s=render_s, peak=peak,
                stats=stats, ratio=ratio, k1=k1_h, profile=prof)


def mlt_step_calls(job):
    """Every call K1's wrapper receives while one chain step of frame H
    evaluates its proposals: depth 1's make_mlt_eval on 2^20 uniform rows
    (a large step), recorded on the card (recorder)."""
    from tpurt_torch.render.mlt import make_mlt_eval, n_dims_for

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    X = torch.rand((LANES, n_dims_for(job.cfg.max_depth)), generator=g,
                   device="cuda")
    calls, recording = recorder()
    make_mlt_eval(job, 1, recording)(X)
    torch.cuda.synchronize()
    assert calls and not calls[0][3] and any(c[3] for c in calls)
    return calls


def mlt_step_profile(job, b_d: float):
    """One chain step of frame H's depth 1 (2^20 chains from uniform
    rows, pbrt's sigma and large-step probability), timed after one
    warm-up step and then profiled, with bdpt's ranges."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.bdpt import (CONNECT_RANGE, STRATEGY_RANGE,
                                         WALK_RANGE)
    from tpurt_torch.render.mlt import (Chains, chain_step, make_mlt_eval,
                                        n_dims_for)

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    ev = make_mlt_eval(job, 1, traverse_wide)
    ch = Chains.start(torch.rand((1 << 20, n_dims_for(job.cfg.max_depth)),
                                generator=g, device="cuda"), ev)
    state = job.film.initial_state("cuda", splats=True)

    def step():
        chain_step(job.film, state, ev, ch, g, 0.01, 0.3, 1.0, b_d)

    step()  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    step()
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"H chain step (depth 1, 2^20 chains): {wall:.4f}s")
    return phase_profile("H chain step (depth 1, 2^20 chains)", step, wall,
                         ranges=(WALK_RANGE, STRATEGY_RANGE, CONNECT_RANGE))


# tpurt's tests/test_sppm.py furnace: a point light inside a Kd = .5
# sphere seen from the light, sum_{k=1..5} 0.5^k in closed form
SPPM_FURNACE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Integrator "sppm" "integer iterations" [8] "float radius" [0.25]
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "color I" [3.1415926 3.1415926 3.1415926]
Material "matte" "color Kd" [.5 .5 .5] "float sigma" [0]
ReverseOrientation
Shape "sphere" "float radius" [1]
WorldEnd
"""
# frame I's iterations: pbrt's default is 64, cut to 16 when frames L
# and M took the run past 15 minutes
SPPM_ITERS = 16


def sppm_grid_check(vp_p, vp_valid, radius, ph, hash_size: int):
    """The (photon, visible point) pairs with d^2 <= r^2 found through the
    hash grid (as the deposit finds them) against every pair tested, on
    the card: returns (pairs found, pairs by brute force, brute-force
    pairs of photons outside the grid, equal)."""
    from tpurt_torch.render import sppm

    keep = torch.nonzero(vp_valid).squeeze(1)
    grid = sppm._build_grid(vp_p, vp_valid, radius, hash_size)
    rid, start, count, ends = sppm._cell_runs(grid, ph, hash_size)
    k, vp = sppm._pair_slice(grid[1], start, count, ends, 0, int(ends[-1]))
    rec = rid[k]
    dp = ph[rec] - vp_p[vp]
    ok = ((dp * dp).sum(-1) <= radius[vp] * radius[vp]) & vp_valid[vp]
    n_vp = vp_p.shape[0]
    found = torch.unique(rec[ok] * n_vp + vp[ok])
    vq, rq = vp_p[keep], radius[keep]
    step = max(1, (1 << 26) // max(keep.numel(), 1))
    brute = []
    for a in range(0, ph.shape[0], step):
        dp = ph[a:a + step, None, :] - vq[None, :, :]
        i, j = torch.nonzero((dp * dp).sum(-1) <= (rq * rq)[None, :],
                             as_tuple=True)
        brute.append((i + a) * n_vp + keep[j])
    brute = torch.unique(torch.cat(brute))
    inside = torch.zeros(ph.shape[0], dtype=torch.bool, device=ph.device)
    inside[rid] = True
    outside = int((~inside[brute // n_vp]).sum())
    return (found.numel(), brute.numel(), outside,
            bool(torch.equal(found, brute)))


def sppm_dims_card_vs_cpu(film, n_iters: int):
    """SPPM's camera dims (its fused Halton sampler) and photon dims
    (dims 0-4 and the bounce dims through _ri_dyn) on 2^20 lanes on the
    card bit-equal to the CPU's."""
    from tpurt_torch.render import sppm
    from tpurt_torch.sampling import lowdiscrepancy as ld

    gen = torch.Generator().manual_seed(9)
    px = torch.randint(0, film.full_x, (LANES,), generator=gen)
    py = torch.randint(0, film.full_y, (LANES,), generator=gen)
    si = torch.randint(0, n_iters, (LANES,), generator=gen)
    hidx = torch.randint(0, 1 << 31, (LANES,), generator=gen)
    cpu = sppm.sppm_sampler(film, n_iters, "cpu")
    gpu = sppm.sppm_sampler(film, n_iters, "cuda")
    lc, lg = (px, py, si), tuple(a.cuda() for a in (px, py, si))
    cam = all(torch.equal(gpu.dim(*lg, d, gpu.lane_ctx(*lg)).cpu(),
                          cpu.dim(*lc, d, cpu.lane_ctx(*lc)))
              for d in range(2, 5 + 7 * 5))
    ph = all(torch.equal(sppm._radical_inverse(hidx.cuda(), b).cpu(),
                         sppm._radical_inverse(hidx, b))
             for b in (2, 3, 5, 7, 11))
    ph = ph and all(torch.equal(
        sppm._ri_dyn(hidx.cuda(), int(ld.PRIMES[d]), 8).cpu(),
        sppm._ri_dyn(hidx, int(ld.PRIMES[d]), 8)) for d in range(6, 26))
    print(f"sppm dims on {LANES} lanes, card bit-equal to the CPU: camera "
          f"dims 2-39 {cam}, photon dims {ph}")
    assert cam and ph
    return cam and ph


def phase_sppm(gpu: str, profile_all: bool):
    """Main path I: the caustic frame (testscenes.write_caustic "full":
    700x700, Integrator "sppm", SPPM_ITERS iterations of 490,000 photons,
    maxdepth 5, radius 0.0171) through the CLI (K1 closest and any-hit
    launched, the plain traversal not); one timed render of the built job
    (sppm_render_s, its four stages summed over the iterations, peak
    memory, and per iteration the fullest grid cell and the candidate
    pairs tested); K1 against its plain version on every call of one
    iteration (its camera pass and photon pass); the grid against brute
    force on 2^16 of that iteration's photon records; SPPM's dims card
    against CPU; the furnace's closed form on the card; the small caustic
    card against CPU (phase 9's bounds); under --profile the breakdown of
    a 4-iteration render with the four sppm ranges."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render import sppm
    from tpurt_torch.render.driver import build_job, load_scene, render
    from tpurt_torch.scene import load_scene_string
    from tpurt_torch.testscenes import write_caustic

    t_phase = time.time()
    scene = write_caustic(str(WORK / "caustic_full.pbrt"), "full",
                          iterations=SPPM_ITERS)
    img, launches, cli_s = cli_counted(scene, WORK / "caustic_full_out.exr",
                                       "main path I (sppm)")
    any_hit = traverse_wide.any_hit_launches
    print(f"I: K1 closest launches {launches - any_hit}, any-hit {any_hit}")
    assert img.shape == (700, 700, 3) and launches > any_hit > 0
    sd = load_scene(scene)
    job = build_job(sd, "cuda")
    assert job.cfg.name == "sppm"
    cfg = sppm.sppm_params(sd.integrator_params)
    assert cfg["n_iters"] == SPPM_ITERS and cfg["max_depth"] == 5
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    img = sppm.render_sppm_job(job, sd.integrator_params, stats=stats)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    stages = {k: stats[k] for k in ("camera_s", "grid_s", "photons_s",
                                    "deposit_s")}
    print(f"sppm_render_s {render_s:.4f} ({stages}) peak mem "
          f"{peak / 2**30:.3f} GiB, image mean {img.mean():.5f}, CLI first "
          f"run {cli_s:.2f}s on {gpu}")
    print(f"I per iteration: max_occ {stats['max_occ']}")
    print(f"I per iteration: candidate pairs {stats['pairs']}")
    assert np.isfinite(img).all() and img.mean() > 0

    # one iteration (the first) recorded: K1 on its calls, the grid on its
    # visible points and photon records
    calls, recording = recorder()
    n_pix = job.film.width * job.film.height
    pix = sppm._init_pixels(n_pix, cfg["radius"], job.scene, "cuda")
    smplr = sppm.sppm_sampler(job.film, cfg["n_iters"], "cuda")
    sppm._camera_pass(job, pix, smplr, 0, cfg["max_depth"], recording)
    hidx = torch.arange(n_pix, device="cuda")
    rec_p, _, _ = sppm._photon_walk(job.scene, hidx, cfg["max_depth"],
                                    recording, job.texture_eval)
    torch.cuda.synchronize()
    assert any(c[3] for c in calls) and not calls[0][3]
    k1_i = k1_on_calls("I sppm iteration", job.scene.geo, calls)
    found, brute, outside, equal = sppm_grid_check(
        pix.vp_p, pix.vp_valid, pix.radius, rec_p[:1 << 16], n_pix)
    print(f"I grid check: {min(1 << 16, rec_p.shape[0])} of "
          f"{rec_p.shape[0]} photon records, {int(pix.vp_valid.sum())} "
          f"visible points: pairs within r through the grid {found}, by "
          f"brute force {brute}, brute-force pairs outside the grid "
          f"{outside}, equal {equal}")
    assert equal and outside == 0 and brute > 0
    dims = sppm_dims_card_vs_cpu(job.film, cfg["n_iters"])

    fimg, _ = render(load_scene_string(SPPM_FURNACE), "cuda")
    want = sum(0.5 ** k for k in range(1, 6))
    print(f"I furnace on the card: mean {fimg.mean():.5f}, closed form "
          f"{want:.5f}")
    assert np.isfinite(fimg).all() and abs(fimg.mean() - want) < 0.05
    small = write_caustic(str(WORK / "caustic_small.pbrt"), "small")
    gimg, _ = render(load_scene(small), "cuda")
    himg, _ = render(load_scene(small), "cpu")
    _close(gimg, himg, "small caustic (sppm)")

    prof = None
    if profile_all:
        four = load_scene(write_caustic(str(WORK / "caustic_4.pbrt"), "full",
                                        iterations=4)).integrator_params
        sppm.render_sppm_job(job, four)  # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        sppm.render_sppm_job(job, four)
        torch.cuda.synchronize()
        prof = phase_profile(
            "sppm frame I (4 iterations)",
            lambda: sppm.render_sppm_job(job, four), time.time() - t0,
            top=20, ranges=(sppm.CAMERA_RANGE, sppm.GRID_RANGE,
                            sppm.PHOTON_RANGE, sppm.DEPOSIT_RANGE))
    print(f"phase 21 took {time.time() - t_phase:.1f}s")
    checks = dict(grid_pairs=found, grid_equal=equal,
                  furnace_mean=float(fimg.mean()), furnace_want=want,
                  dims_card_equal_cpu=dims)
    return dict(launches=launches, any_hit_launches=any_hit,
                render_s=render_s, stages=stages, peak=peak, stats=stats,
                k1=k1_i, checks=checks, profile=prof)


# the jnp code of tpurt's _traverse_wide that each leaf body replaces
def phase_spectral(gpu: str, path_mean: float, profile_all: bool):
    """Main path J: frame A's stand-in with --spectrum sampled through the
    CLI at 700x700, 8 spp (K1 launched, no plain traversal); K1 against
    its plain version on J's rays; the timed render and J's mean beside
    A's; the small spectral scenes card against CPU; MLT's spectral
    evaluation card against CPU; under --profile one profiled frame."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.render.mlt import make_mlt_eval, n_dims_for
    from tpurt_torch.scene import load_scene_string
    from tpurt_torch.spectrum_sampled import tables
    from tpurt_torch.testscenes import (SPECTRAL_SPECULAR_WORLD,
                                        spectral_media_world,
                                        spectral_scene, write_standin)

    scene = write_standin(str(WORK / "standin_spectral_full.pbrt"), "full")
    img, launches, cli_s = cli_counted(
        scene, WORK / "standin_spectral_out.exr",
        "main path J (--spectrum sampled)", args=("--spectrum", "sampled"))
    assert img.shape == (700, 700, 3)
    job = build_job(load_scene(scene), "cuda", spectrum="sampled")
    assert job.cfg.spectral and job.cfg.nch == 60
    k1_j = k1_on_path("J spectral", job, 2)
    render_s, runs, peak, img = render_timed(job)
    ratio = float(img.mean()) / path_mean
    print(f"spectral_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in runs]}) peak mem {peak / 2**30:.3f} GiB, "
          f"image mean {img.mean():.5f} = {ratio:.4f} of A's RGB mean "
          f"{path_mean:.5f} (basis: {tables().source}), CLI first run "
          f"{cli_s:.2f}s on {gpu}")
    cases = (("path", {}), ("directlighting", {}),
             ("whitted", dict(maxdepth=4, world=SPECTRAL_SPECULAR_WORLD)),
             ("volpath", dict(world=spectral_media_world())),
             ("bdpt", dict(maxdepth=2)),
             ("sppm", dict(maxdepth=2, extra=' "integer iterations" [2] '
                           '"float radius" [0.5]')))
    for integ, kw in cases:
        text = spectral_scene(integ, **kw)
        g, _ = render(load_scene_string(text), "cuda", spectrum="sampled")
        h, _ = render(load_scene_string(text), "cpu", spectrum="sampled")
        _close(g, h, f"spectral {integ} 16x16")
    text = spectral_scene("mlt", maxdepth=1,
                          extra=' "integer mutationsperpixel" [2]')
    jobs = [build_job(load_scene_string(text), dev, spectrum="sampled")
            for dev in ("cuda", "cpu")]
    gen = torch.Generator().manual_seed(5)
    X = torch.rand((1 << 14, n_dims_for(1)), generator=gen)
    vc, rc = make_mlt_eval(jobs[0], 1, traverse_wide)(X.cuda())
    vh, rh = make_mlt_eval(jobs[1], 1, traverse_wide)(X)
    torch.testing.assert_close(vc.cpu(), vh, rtol=1e-4, atol=1e-5)
    assert torch.equal(rc.cpu(), rh)
    print(f"spectral mlt eval cuda vs cpu on {X.shape[0]} rows: max |diff| "
          f"{(vc.cpu() - vh).abs().max().item():.3e}, raster equal, "
          f"nonzero {(vh > 0).any(-1).float().mean().item():.3f}")
    prof = None
    if profile_all:
        prof = phase_profile("spectral frame J", lambda: render_job(job),
                             render_s)
    return dict(launches=launches, render_s=render_s, peak=peak,
                ratio=ratio, k1=k1_j, profile=prof, job=job)


def phase_kdtree(gpu: str, job_a, profile_all: bool):
    """Main path K: frame A's stand-in under Accelerator "kdtree" through
    the CLI at 700x700, 8 spp (K1k launched, no other body, no plain
    traversal); K1k against its twin on K's rays; K1k's hits against K1's
    on the same primary rays; the timed render and K's image against A's;
    frame E under the kd-tree at 256x256 (K1km and K1c) with K1km against
    its twin; under --profile one profiled frame."""
    from tpurt_torch.kernels.traverse import (reset_launches,
                                              traverse_kd_reference,
                                              traverse_wide,
                                              traverse_wide_reference)
    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.testscenes import write_motion_hair, write_standin

    scene = write_standin(str(WORK / "standin_kd_full.pbrt"), "full",
                          accelerator="kdtree")
    img, launches, cli_s = cli_counted(
        scene, WORK / "standin_kd_out.exr", "main path K (kd-tree)",
        bodies=("K1k",))
    by_body = dict(traverse_wide.kernel_launches)
    assert img.shape == (700, 700, 3)
    t0 = time.time()
    job = build_job(load_scene(scene), "cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    g = job.scene.geo
    kind = g.knodes[:, 126]
    cont = g.knodes[:, 124].contiguous().view(torch.int32)
    tris = (~torch.isnan(g.knodes[:, :12])).sum(1)[kind > 0]
    print(f"kd table: {g.knodes.shape[0]} rows "
          f"({g.knodes.numel() * 4 / 1e6:.2f} MB), "
          f"{int((kind == 0).sum())} interior, {int((kind > 0).sum())} leaf "
          f"(continued {int((cont >= 0).sum())}), triangles a leaf row "
          f"{tris.float().mean().item():.2f} of 12, stack depth "
          f"{g.kstack_depth}; the kernel's tables {g.kinodes.shape[0]} "
          f"interior nodes of 16 B + {g.kleaves.shape[0]} leaf rows "
          f"({(g.kinodes.numel() + g.kleaves.numel()) * 4 / 1e6:.2f} MB); "
          f"scene build {build_s:.2f}s")
    calls = frame_ray_calls(job, 2)
    assert [c[3] for c in calls] == [False, True, False, True, False]
    k1_k = k1_on_calls("K kdtree", g, calls)
    assert {r["body"] for r in k1_k} == {"K1k"}, k1_k
    # the same triangles through the wide BVH: prims equal
    o, d, tm = calls[0][:3]
    hk = traverse_wide(g, o, d, tm, any_hit=False)
    hb = traverse_wide(job_a.scene.geo, o, d, tm, any_hit=False)
    vs_k1 = (hk[1] == hb[1]).float().mean().item()
    both = (hk[1] >= 0) & (hb[1] >= 0)
    dt = (hk[0] - hb[0]).abs()[both].max().item()
    print(f"K1k vs K1 (wide BVH) on {o.shape[0]} primary rays: prims equal "
          f"{vs_k1:.6f}, max |dt| over common hits {dt:.3e}")
    assert vs_k1 >= 0.9999, vs_k1
    render_s, runs, peak, img = render_timed(job)
    img_a = render_job(job_a)
    print(f"kdtree_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in runs]}) peak mem {peak / 2**30:.3f} GiB, "
          f"image mean {img.mean():.5f}, CLI first run {cli_s:.2f}s on {gpu}")
    _close(img, img_a, "K (kd-tree) vs A (wide BVH) 700x700")

    # frame E under the kd-tree through render(), which returns the job
    # the K1km checks reuse (the 5 MB scene parses once)
    e = write_motion_hair(str(WORK / "motion_hair_kd_256.pbrt"), "full",
                          res=256, accelerator="kdtree")
    reset_launches()
    traverse_wide_reference.calls = traverse_kd_reference.calls = 0
    t0 = time.time()
    img_e, ejob = render(load_scene(e), "cuda")
    torch.cuda.synchronize()
    e_by_body = dict(traverse_wide.kernel_launches)
    launches_e = traverse_wide.launches
    plain_calls = traverse_wide_reference.calls + traverse_kd_reference.calls
    print(f"frame E under the kd-tree, 256x256 (render(), scene build "
          f"included): {time.time() - t0:.2f}s, traversal kernel launches "
          f"{launches_e} {e_by_body}, plain calls {plain_calls}, image mean "
          f"{img_e.mean():.5f}")
    assert img_e.shape == (256, 256, 3) and np.isfinite(img_e).all()
    assert plain_calls == 0 and img_e.mean() > 0
    assert all((n > 0) == (b in ("K1km", "K1c"))
               for b, n in e_by_body.items()), e_by_body
    k1_ek = k1_on_path("E kd-tree 256", ejob, 1)
    assert {r["body"] for r in k1_ek} == {"K1km", "K1c"}, k1_ek
    prof = None
    if profile_all:
        prof = phase_profile("kd-tree frame K", lambda: render_job(job),
                             render_s)
    return dict(launches=launches, by_body=by_body, e_by_body=e_by_body,
                launches_e=launches_e, render_s=render_s, peak=peak,
                k1=k1_k, k1_e=k1_ek, vs_k1=vs_k1, profile=prof)


def paired_times(job_a, job):
    """Frame A's job and ``job`` rendered alternately, A X X A: the two
    pairs of seconds (the shared host's spread moves single runs by
    tens of percent; PERF.md section 7) and the peak memory of X's runs
    in bytes."""
    from tpurt_torch.render.driver import render_job

    runs, peak = {"a": [], "x": []}, 0
    for key in ("a", "x", "x", "a"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        img = render_job(job_a if key == "a" else job)
        torch.cuda.synchronize()
        runs[key].append(time.time() - t0)
        if key == "x":
            peak = max(peak, torch.cuda.max_memory_allocated())
            assert np.isfinite(img).all() and img.mean() > 0
    return runs["a"], runs["x"], peak


def phase_realistic(gpu: str, k1_a: dict, job_a, path_mean: float,
                    a_s: float, profile_all: bool = False):
    """Main path L: frame A's stand-in through Camera "realistic" (the
    biconvex test lens, focus 15.2, aperture 8 mm, 35 mm diagonal) via
    the CLI at 700x700, 8 spp (K1 closest and any-hit launched, no plain
    traversal); the 64-zone lens build on the card, timed; K1 against its
    plain version on every call of L's camera rays and first bounce step,
    its time on L's camera rays beside A's; the timed render with its
    launches and peak memory, its mean beside A's; the small L scene on
    the card against the CPU under path and bdpt; under --profile one
    profiled frame."""
    from tpurt_torch.kernels.traverse import reset_launches, traverse_wide
    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.render.lenses import N_ZONES, build_lens_system
    from tpurt_torch.testscenes import write_realistic

    scene = write_realistic(str(WORK / "realistic_full.pbrt"), "full")
    img, launches, cli_s = cli_counted(
        scene, WORK / "realistic_out.exr", "main path L (realistic camera)")
    any_hit = traverse_wide.any_hit_launches
    assert img.shape == (700, 700, 3) and any_hit > 0, any_hit
    lens = scene.rsplit(".", 1)[0] + ".dat"
    build_lens_system(lens, 8.0, 15.2, 0.035, device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    ls = build_lens_system(lens, 8.0, 15.2, 0.035, device="cuda")
    torch.cuda.synchronize()
    lens_s = time.time() - t0
    print(f"lens build on the card: {N_ZONES} zones x 2^18 rays in "
          f"{lens_s:.4f}s (rear z {ls.rear_z:.6f} m, zone 0 bound "
          f"{np.round(ls.exit_pupil[0], 6).tolist()})")
    job = build_job(load_scene(scene), "cuda")
    k1_l = k1_on_path("L realistic", job, 1)
    assert [r["any_hit"] for r in k1_l] == [False, True, False], k1_l
    vig = float((job.camera.generate_rays(
        *_film_lens_grid(job))[2] == 0).float().mean())
    print(f"K1 on L's camera rays: {k1_l[0]['ms_burst']:.4f} ms in bursts "
          f"(A's camera rays {k1_a['ms_burst']:.4f}), plain "
          f"{k1_l[0]['plain_ms']:.3f} ms; vignetted camera lanes {vig:.4f}")
    reset_launches()
    render_s, runs, peak, img = render_timed(job)
    per_render = traverse_wide.launches // (1 + TIMED_RUNS)
    ratio = float(img.mean()) / path_mean
    pair_a, pair_x, _ = paired_times(job_a, job)
    print(f"realistic_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in runs]}; A's {a_s:.4f}; paired A L L A "
          f"{['%.4f' % r for r in (pair_a[0], *pair_x, pair_a[1])]}) "
          f"traversal launches a render {per_render}, peak mem "
          f"{peak / 2**30:.3f} GiB, image mean {img.mean():.5f} = "
          f"{ratio:.4f} of A's {path_mean:.5f}, CLI first run "
          f"{cli_s:.2f}s on {gpu}")
    for integ in ("path", "bdpt"):
        small = write_realistic(str(WORK / f"realistic_small_{integ}.pbrt"),
                                "small", integrator=integ)
        g, _ = render(load_scene(small), "cuda")
        h, _ = render(load_scene(small), "cpu")
        _close(g, h, f"small L ({integ})")
    prof = None
    if profile_all:
        prof = phase_profile("realistic frame L", lambda: render_job(job),
                             render_s)
    return dict(launches=launches, any_hit_launches=any_hit,
                render_s=render_s, peak=peak, ratio=ratio, k1=k1_l,
                lens_build_s=lens_s, vignetted=vig, profile=prof,
                paired=(pair_a, pair_x))


def _film_lens_grid(job, n: int = 1 << 20):
    """(p_film, p_lens) of n lanes: film points on a grid over the whole
    film, lens samples from a seeded generator."""
    w, h = job.film.width, job.film.height
    i = torch.arange(n, device="cuda")
    side = int(np.sqrt(n))
    p_film = torch.stack([(i % side + 0.5) * (w / side),
                          (i // side + 0.5) * (h / side)], -1).float()
    gen = torch.Generator(device="cuda").manual_seed(3)
    return p_film, torch.rand((n, 2), device="cuda", generator=gen)


def phase_ptex_fourier(gpu: str, job_a, path_mean: float, a_s: float,
                       profile_all: bool = False):
    """Main path M: frame A's stand-in with its meshes under Material
    "fourier" (a synthetic 3-channel table of up to 8 orders) and its
    ground under a 256-face Ptex Kd, via the CLI at 700x700, 8 spp (K1
    closest and any-hit launched, no plain traversal); the camera hits
    read distinct Ptex faces and fourier lanes; K1 against its plain
    version on M's camera rays and first bounce step; the timed render
    with its launches and peak memory, its mean beside A's; the small M
    scene on the card against the CPU under path, bdpt, sppm and path
    with --spectrum sampled; under --profile one profiled frame."""
    from tpurt_torch.kernels.traverse import reset_launches, traverse_wide
    from tpurt_torch.render.driver import (build_job, load_scene, render,
                                           render_job)
    from tpurt_torch.render.integrator import INF, make_shade_ctx
    from tpurt_torch.render.interaction import compute_interaction
    from tpurt_torch.render.intersect import intersect_closest
    from tpurt_torch.testscenes import write_ptex_fourier

    scene = write_ptex_fourier(str(WORK / "ptex_fourier_full.pbrt"), "full")
    img, launches, cli_s = cli_counted(
        scene, WORK / "ptex_fourier_out.exr",
        "main path M (ptex and a fourier BSDF)")
    any_hit = traverse_wide.any_hit_launches
    assert img.shape == (700, 700, 3) and any_hit > 0, any_hit
    job = build_job(load_scene(scene), "cuda")
    assert job.scene.has_ptex and len(job.scene.fr_tables) == 1
    k1_m = k1_on_path("M ptex fourier", job, 1)
    # what the camera sees: the ground's Ptex faces and the fourier lanes
    o, d = _camera_rays(job)
    si = compute_interaction(job.scene.geo, intersect_closest(
        job.scene.geo, o, d, INF, traverse_wide), o, d, faces=True)
    ctx = make_shade_ctx(job.scene, si, job.texture_eval)
    faces = torch.unique(si.face_index[si.valid & ~ctx.fourier[0]]).numel()
    f_share = ctx.fourier[0].float().mean().item()
    print(f"M's camera hits: {faces} distinct Ptex faces, fourier lanes "
          f"{f_share:.4f}")
    assert faces >= 12 and f_share > 0.05, (faces, f_share)
    reset_launches()
    render_s, runs, peak, img = render_timed(job)
    per_render = traverse_wide.launches // (1 + TIMED_RUNS)
    ratio = float(img.mean()) / path_mean
    pair_a, pair_x, _ = paired_times(job_a, job)
    print(f"ptex_fourier_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in runs]}; A's {a_s:.4f}; paired A M M A "
          f"{['%.4f' % r for r in (pair_a[0], *pair_x, pair_a[1])]}) "
          f"traversal launches a render {per_render}, peak mem "
          f"{peak / 2**30:.3f} GiB, image mean {img.mean():.5f} = "
          f"{ratio:.4f} of A's {path_mean:.5f}, CLI first run "
          f"{cli_s:.2f}s on {gpu}")
    for integ, spectrum in (("path", "rgb"), ("bdpt", "rgb"),
                            ("sppm", "rgb"), ("path", "sampled")):
        small = write_ptex_fourier(
            str(WORK / f"ptex_fourier_small_{integ}.pbrt"), "small",
            integrator=integ)
        g, _ = render(load_scene(small), "cuda", spectrum=spectrum)
        h, _ = render(load_scene(small), "cpu", spectrum=spectrum)
        _close(g, h, f"small M ({integ}, {spectrum})")
    prof = None
    if profile_all:
        prof = phase_profile("ptex and fourier frame M",
                             lambda: render_job(job), render_s)
    return dict(launches=launches, any_hit_launches=any_hit,
                render_s=render_s, peak=peak, ratio=ratio, k1=k1_m,
                ptex_faces_seen=faces, fourier_share=f_share, profile=prof,
                paired=(pair_a, pair_x))


def phase_subsurface(gpu: str, job_a, path_mean: float, a_s: float,
                     profile_all: bool = False):
    """Main path N: frame A's stand-in with its first mesh under Material
    "subsurface" (Skin1 at scale 10) and its second under "kdsubsurface"
    (two diffusion tables), via the CLI at 700x700, 8 spp (K1 closest and
    any-hit launched, no plain traversal; its launches and probe-chain
    overflow count are a render's); K1 against its plain version on
    every call of N's camera rays and first bounce step: the camera rays,
    the 8 probe-chain calls and the exit point's any-hit call of the
    subsurface hop, the shadow and bounce rays; the share of camera hits
    that took the hop; A and N timed alternately (A N N A), N's two runs
    its timed runs (subsurface_render_s their median, peak memory theirs;
    the CLI run built the kernels); one profiled frame (launches, device
    busy, idle share); N at 32x32 on the card against the CPU under path,
    rpf and directlighting.  Prints the seconds of each step."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.driver import build_job, load_scene, render
    from tpurt_torch.render.driver import render_job
    from tpurt_torch.rpf.driver import render_rpf
    from tpurt_torch.testscenes import write_subsurface
    from tpurt_torch.utils.stats import BSS_OVERFLOW, TRACK_STATS

    steps = [time.time()]
    scene = write_subsurface(str(WORK / "subsurface_full.pbrt"), "full")
    img, launches, cli_s = cli_counted(
        scene, WORK / "subsurface_out.exr", "main path N (subsurface)")
    any_hit = traverse_wide.any_hit_launches
    over = TRACK_STATS.read().get(BSS_OVERFLOW, 0)
    assert img.shape == (700, 700, 3) and any_hit > 0, any_hit
    job = build_job(load_scene(scene), "cuda")
    assert job.scene.n_bss_tables == 2 and job.scene.dims_per_bounce == 15
    steps.append(time.time())
    calls = frame_ray_calls(job, 1)
    # camera; the hop's 8 probe calls and exit any-hit; shadow; bounce
    assert [c[3] for c in calls] == [False] * 9 + [True, True, False], [
        c[3] for c in calls]
    k1_n = k1_on_calls("N subsurface", job.scene.geo, calls)
    cam = traverse_wide(job.scene.geo, *calls[0][:3], any_hit=False)
    hits = int((cam[1] >= 0).sum())
    hop_share = calls[1][0].shape[0] / max(hits, 1)
    probe = k1_n[1]
    print(f"N's hop: {calls[1][0].shape[0]} of {hits} camera-hit lanes "
          f"({hop_share:.4f}) took it; K1 on its first probe call "
          f"{probe['ms_burst']:.4f} ms in bursts, bound "
          f"{probe['bound_ms']:.4f} ms ({probe['bound_by']}), plain "
          f"{probe['plain_ms']:.3f} ms; on the exit any-hit call "
          f"{k1_n[9]['ms_burst']:.4f} ms, bound {k1_n[9]['bound_ms']:.4f}")
    steps.append(time.time())
    pair_a, pair_x, peak = paired_times(job_a, job)
    render_s = statistics.median(pair_x)
    steps.append(time.time())
    ratio = float(img.mean()) / path_mean
    print(f"subsurface_render_s {render_s:.4f} (runs "
          f"{['%.4f' % r for r in pair_x]}; A's {a_s:.4f}; paired A N N A "
          f"{['%.4f' % r for r in (pair_a[0], *pair_x, pair_a[1])]}) "
          f"traversal launches a render {launches}, peak mem "
          f"{peak / 2**30:.3f} GiB, probe-chain overflow {over} lanes, "
          f"image mean {img.mean():.5f} = {ratio:.4f} of A's "
          f"{path_mean:.5f}, CLI first run {cli_s:.2f}s on {gpu}")
    prof = phase_profile("subsurface frame N", lambda: render_job(job),
                         render_s, host=False)
    steps.append(time.time())
    for integ in ("path", "rpf", "directlighting"):
        small = write_subsurface(str(WORK / f"subsurface_small_{integ}.pbrt"),
                                 "small", integrator=integ)
        if integ == "rpf":
            g = render_rpf(load_scene(small), "cuda",
                           write_feature_exrs=False)[0]
            h = render_rpf(load_scene(small), "cpu",
                           write_feature_exrs=False)[0]
        else:
            g, h = (render(load_scene(small), dev)[0]
                    for dev in ("cuda", "cpu"))
        _close(g, h, f"small N ({integ})")
    steps.append(time.time())
    print("phase 26 steps (s): " + ", ".join(
        f"{what} {b - a:.1f}" for what, a, b in zip(
            ("CLI run and job build", "K1 on 12 calls", "A N N A",
             "profiled frame", "small N card and CPU"), steps, steps[1:])))
    return dict(launches=launches, any_hit_launches=any_hit,
                render_s=render_s, peak=peak, ratio=ratio, k1=k1_n,
                hop_share=hop_share, overflow=over, profile=prof,
                paired=(pair_a, pair_x))


def phase_multidevice(small_path: str):
    """Path O: the multi-device module (parallel/mesh.py) at world size 1
    over NCCL on cuda:0 (one card; NCCL takes one rank a device), its
    group joined through a file:// rendezvous: render_sharded of the small
    stand-in, film rows reduce-scattered and then all-reduced, against
    render on the card, and rpf_filter_sharded of a seeded 64x64x4 buffer
    against apply_rpf_filter, each within 2e-5; the group is destroyed
    after."""
    import torch.distributed as dist

    from tpurt_torch.parallel.mesh import (gather_rows, make_group,
                                           render_sharded,
                                           rpf_filter_sharded, shard_rows)
    from tpurt_torch.render.driver import load_scene, render
    from tpurt_torch.rpf.filter import apply_rpf_filter

    init = WORK / "dist_init"
    init.unlink(missing_ok=True)
    group = make_group("cuda", init_method=f"file://{init}", rank=0,
                       world_size=1)
    backend, n = dist.get_backend(group), dist.get_world_size(group)
    want, _ = render(load_scene(small_path), "cuda")
    errs = {}
    for scatter in (True, False):
        got, _ = render_sharded(load_scene(small_path), group,
                                scatter_film=scatter, device="cuda")
        errs[f"render_scatter_{int(scatter)}"] = float(
            np.abs(got - want).max())
    gen = torch.Generator().manual_seed(5)
    h, w, spp = 64, 64, 4
    buf = torch.zeros((h, w, spp, 19))
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    buf[..., 0] = xx[..., None] + torch.rand((h, w, spp), generator=gen)
    buf[..., 1] = yy[..., None] + torch.rand((h, w, spp), generator=gen)
    buf[..., 2:5] = 2 * torch.rand((h, w, spp, 3), generator=gen)
    buf[..., 5:7] = torch.rand((h, w, spp, 2), generator=gen)
    buf[..., 7:19] = 0.01 * torch.randn((h, w, spp, 12), generator=gen)
    buf = buf.to("cuda")
    got = gather_rows(rpf_filter_sharded(shard_rows(buf, group), 5, h,
                                         group, sigma_seed=0.5), h, group)
    single = apply_rpf_filter(buf, 5, sigma_seed=0.5)
    errs["rpf_filter"] = float((got - single).abs().max())
    print(f"multi-device: backend {backend}, world size {n}; max |diff| "
          f"against one device {errs}")
    dist.destroy_process_group()
    assert backend == "nccl" and n == 1
    assert all(e <= 2e-5 for e in errs.values()), errs
    return dict(backend=backend, world_size=n, max_abs_err=errs)


def _camera_rays(job, n: int = 1 << 20):
    """(o, d) of n camera rays over the film (_film_lens_grid's)."""
    o, d, _ = job.camera.generate_rays(*_film_lens_grid(job, n))
    return o, d


LEAF_BODIES = {
    "K1m": ("traverse_wide_motion",
            "tpurt/render/intersect.py:669 (_tri_bundle_test, drec/time)"),
    "K1c": ("traverse_wide_curve",
            "tpurt/render/intersect.py:751 (_curve_bundle_test)"),
    "K1k": ("traverse_kd",
            "tpurt/render/intersect.py:1038 (_kd_step_fns; _kd_init_state "
            ":1147; the kd branch of _traverse_wide :1236)"),
    "K1km": ("traverse_kd_motion",
             "tpurt/render/intersect.py:1038 (_kd_step_fns with "
             "knodes_delta, _tri_bundle_test(drec, time) :669)"),
}


def leaf_body_entry(body: str, records, launches_by_path, checks):
    """The kernels line's entry of one leaf body of K1 (an instantiation of
    the same kernel file, so it replaces K1's TPU kernel; ``body`` names
    the jnp code it carries): the main path's launches, the numbers of its
    first recorded call (the 2^20 camera rays of its frame) and every
    recorded call."""
    name, jnp_code = LEAF_BODIES[body]
    mine = [r for r in records if r["body"] == body]
    first = mine[0]
    return dict(name=name, route="cuda",
                source="tpurt_torch/csrc/traverse.cu",
                replaces="tpurt/kernels/traverse.py:54", body=jnp_code,
                launches=sum(launches_by_path.values()),
                launches_by_path=launches_by_path,
                max_abs_err=max(r["max_abs_err"] for r in mine),
                ms=first["ms"], ms_burst=first["ms_burst"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=None,
                checks=checks, vs_plain_on_path=mine)


def main(argv=None) -> int:
    global TIMED_RUNS
    argv = sys.argv[1:] if argv is None else argv
    profile_all = "--profile" in argv
    TIMED_RUNS = 3 if profile_all else 1
    t_start = time.time()
    t_last = [t_start]

    def stamp(what: str):
        now = time.time()
        print(f"[{now - t_start:7.1f}s] {what} done in "
              f"{now - t_last[0]:.1f}s")
        t_last[0] = now

    phase_env()
    gpu = gpu_line()
    phase_build()
    full = phase_scene("full")
    small = phase_scene("small")
    full_rpf = phase_scene("full", "rpf")
    small_rpf = phase_scene("small", "rpf")

    from tpurt_torch.render.driver import build_job, load_scene

    job = build_job(load_scene(full), "cuda")
    g = job.scene.geo
    print(f"scene: {g.n_tris} triangles, {g.n_quads} sphere(s), wnodes "
          f"{g.wnodes.shape[0]} rows ({g.wnodes.numel() * 4 / 1e6:.1f} MB), "
          f"wstack_depth {g.wstack_depth}, {job.film.width}x"
          f"{job.film.height} {job.sampler.spp} spp")
    kids = (~torch.isnan(g.inodes[:, :8])).sum(1)
    fill = (~torch.isnan(g.leaves[:, :12])).sum(1)
    print(f"traversal tables: {g.inodes.shape[0]} interior rows of "
          f"{g.inodes.shape[1] * 4} B ({g.inodes.numel() * 4 / 1e6:.2f} MB), "
          f"{g.leaves.shape[0]} leaf rows of {g.leaves.shape[1] * 4} B "
          f"({g.leaves.numel() * 4 / 1e6:.2f} MB); children a record "
          f"{kids.float().mean().item():.2f} (none in the upper four: "
          f"{(kids <= 4).float().mean().item():.3f}), triangles a leaf "
          f"{fill.float().mean().item():.2f} of 12")
    k1 = phase_kernel(job)
    stamp("phase 4 (K1)")
    k2 = phase_gather(gpu)
    job, launches_a, render_s, path_mean = phase_main(full, gpu)
    stamp("phases 5-6 (K2, path A)")
    launches_b, rpf_job, rpf_total_s, k1_b = phase_rpf(full_rpf, gpu)
    stamp("phase 7 (RPF B)")
    launches_probe, k2_l2 = phase_probe()
    phase_cross(full, small, small_rpf)
    stamp("phases 8-9 (probe, cross-checks)")
    direct_job, launches_c1, direct_s, k1_paths = phase_direct(gpu)
    launches_c2, k1_c2 = phase_rpf_samplers(gpu)
    launches_w, k1_w = phase_whitted()
    k1_paths.update(k1_c2, rpf=k1_b, whitted=k1_w)
    phase_cross_new()
    stamp("phases 10-13 (C1, C2, whitted, cross-checks)")
    (d_job, launches_d, launches_d_rpf, d_s, k1_d,
     d_checks) = phase_materials(gpu)
    k1_paths.update(k1_d)
    stamp("phase 14 (D)")
    (e_job, launches_e, e_bodies, launches_e_rpf, e_rpf_bodies, e_s, k1_e,
     e_checks_out) = phase_motion_hair(gpu)
    stamp("phase 15 (E)")
    media = phase_media(gpu, profile_all)
    stamp("phase 16 (F)")
    ao = phase_ao(gpu, profile_all)
    stamp("phase 17 (AO)")
    bdpt = phase_bdpt(gpu, path_mean, profile_all)
    stamp("phase 18 (G)")
    phase_bdpt_cross()
    stamp("phase 19 (bdpt cross-checks)")
    mlt = phase_mlt(gpu, path_mean, profile_all)
    stamp("phase 20 (H)")
    sppm = phase_sppm(gpu, profile_all)
    stamp("phase 21 (I)")
    spectral = phase_spectral(gpu, path_mean, profile_all)
    stamp("phase 22 (J)")
    kd = phase_kdtree(gpu, job, profile_all)
    stamp("phase 23 (K)")
    real = phase_realistic(gpu, k1, job, path_mean, render_s, profile_all)
    stamp("phase 24 (L)")
    pf = phase_ptex_fourier(gpu, job, path_mean, render_s, profile_all)
    stamp("phase 25 (M)")
    ss = phase_subsurface(gpu, job, path_mean, render_s, profile_all)
    stamp("phase 26 (N)")
    multi = phase_multidevice(small)
    stamp("phase 27 (O)")
    k1_paths.update(media=media["k1"], ao=ao["k1"], bdpt=bdpt["k1"],
                    mlt=mlt["k1"], sppm=sppm["k1"], spectral=spectral["k1"],
                    realistic=real["k1"], ptex_fourier=pf["k1"],
                    subsurface=ss["k1"])
    conn = bdpt["connection"]
    if profile_all:
        from tpurt_torch.render.driver import render_job
        from tpurt_torch.rpf.driver import render_rpf_job

        phase_profile("path frame", lambda: render_job(job), render_s)
        phase_profile("RPF frame", lambda: render_rpf_job(
            rpf_job, write_feature_exrs=False), rpf_total_s)
        phase_profile("direct-lighting textured frame",
                      lambda: render_job(direct_job), direct_s)
        phase_profile("materials frame D", lambda: render_job(d_job), d_s)
        phase_profile("motion and hair frame E", lambda: render_job(e_job),
                      e_s)
        stamp("profiles")
    assert "jax" not in sys.modules and "tpurt" not in sys.modules
    print(json.dumps({"kernels": [
        dict(name="traverse_wide", route="cuda",
             source="tpurt_torch/csrc/traverse.cu",
             replaces="tpurt/kernels/traverse.py:54",
             launches=(launches_a + launches_b + launches_c1 + launches_w
                       + sum(launches_c2.values()) + launches_d
                       + launches_d_rpf + media["launches"]
                       + ao["launches"] + bdpt["launches"]
                       + mlt["launches"] + mlt["launches_cli"]
                       + sppm["launches"] + spectral["launches"]
                       + real["launches"] + pf["launches"]
                       + ss["launches"]),
             launches_by_path={
                 "path": launches_a, "rpf": launches_b,
                 "direct_textured": launches_c1,
                 "rpf_random": launches_c2["random"],
                 "rpf_stratified": launches_c2["stratified"],
                 "whitted": launches_w, "materials": launches_d,
                 "materials_rpf": launches_d_rpf,
                 "media": media["launches"], "ao": ao["launches"],
                 "bdpt": bdpt["launches"], "mlt": mlt["launches"],
                 "mlt_cli_128": mlt["launches_cli"],
                 "sppm": sppm["launches"], "spectral": spectral["launches"],
                 "realistic": real["launches"],
                 "ptex_fourier": pf["launches"],
                 "subsurface": ss["launches"]},
             subsurface_any_hit_launches=ss["any_hit_launches"],
             subsurface_hop_share=ss["hop_share"],
             subsurface_probe_overflow=ss["overflow"],
             multidevice=multi,
             realistic_any_hit_launches=real["any_hit_launches"],
             ptex_fourier_any_hit_launches=pf["any_hit_launches"],
             realistic_lens_build_s=real["lens_build_s"],
             bdpt_any_hit_launches=bdpt["any_hit_launches"],
             mlt_any_hit_launches=mlt["any_hit_launches"],
             sppm_any_hit_launches=sppm["any_hit_launches"],
             sppm_checks=sppm["checks"],
             connection_rays=conn["rays"], ms_connection=conn["ms"],
             ms_burst_connection=conn["ms_burst"],
             plain_ms_connection=conn["plain_ms"],
             bound_ms_connection=conn["bound_ms"],
             bound_by_connection=conn["bound_by"],
             bdpt_checks=bdpt["checks"],
             mlt_mean_over_path=mlt["ratio"],
             materials_checks=d_checks, media_checks=media["checks"],
             media_tracking=media["track"],
             ao_k1_share_of_device=(ao["profile"] or {}).get("k1_share"),
             vs_plain_by_path=k1_paths, **k1),
        *(leaf_body_entry(body, k1_e, {
            "motion_hair": e_bodies[body],
            "motion_hair_rpf": e_rpf_bodies[body]}, e_checks_out)
          for body in ("K1m", "K1c")),
        leaf_body_entry("K1k", kd["k1"], {"kdtree": kd["by_body"]["K1k"]},
                        dict(prims_equal_to_k1=kd["vs_k1"])),
        leaf_body_entry("K1km", kd["k1_e"], {
            "motion_hair_kdtree_256": kd["e_by_body"]["K1km"]}, {}),
        dict(name="gather_rows_sum", route="cuda",
             source="tpurt_torch/csrc/gather_bench.cu",
             replaces="tpurt/kernels/gather_bench.py:24",
             launches=launches_probe,
             launches_by_path={"gather_probe": launches_probe}, **k2,
             **k2_l2)]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
