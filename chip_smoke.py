"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py             # needs one CUDA card
    python3 chip_smoke.py --profile   # also prints a torch.profiler
                                      # breakdown of one path frame and
                                      # one RPF frame

Phases (any failure exits non-zero; none is caught):
  1. environment: versions, the card's name and power limit
  2. build: every kernel library (traversal K1, gather probe K2) from the
     sources in this checkout, one nvcc each, started together
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
     not have run; then one warm-up and 3 timed renders
  7. main path B: the CLI renders the full RPF frame (sampling pass with
     features, the RPF filter at box 7, splat) on the card; K1 must have
     launched and the plain traversal must not have run; the image is
     finite with mean > 0 and the six feature EXRs are written; then one
     warm-up and 3 timed frames (sampling, filter, splat, total, peak
     memory)
  8. the gather probe's entry point (python -m tpurt_torch.kernels.
     gather_bench): K2 must have launched; it prints the layout sweep
     (row width x fetch variant x access pattern)
  9. cross-checks: a 64x64 crop rendered with K1 and with the plain
     traversal (mean |diff| < 1e-4 of the image mean), and the small path
     and RPF stand-ins rendered on the card and on the CPU (means within
     1e-3 relative, >= 99% of pixels within 1e-3 abs + 1e-3 rel)
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


def frame_ray_sets(job):
    """The rays K1 gets in the real frame, as its wrapper receives them:
    "primary" (2^20 camera rays spread over the frame), and "bounce" /
    "shadow", the closest-hit and any-hit calls of the integrator's second
    bounce step (the rays that leave the second surface hit), recorded
    from path_bounce_init + two path_bounce_step calls with the wavefront
    loop's compaction between them.  Each set is (o, d, t_max, any_hit)."""
    from tpurt_torch.kernels.traverse import traverse_wide
    from tpurt_torch.render.integrator import (path_bounce_init,
                                               path_bounce_step)

    dev = job.scene.geo.device
    film, spp = job.film, job.sampler.spp
    total = film.width * film.height * spp
    ids = torch.arange(LANES, device=dev) * total // LANES  # whole frame
    pid = ids // spp
    px = (pid % film.width).to(torch.int64)
    py = (pid // film.width).to(torch.int64)
    calls = []

    def recording(geo, o, d, t_max, any_hit):
        calls.append((o, d, t_max, any_hit))
        return traverse_wide(geo, o, d, t_max, any_hit)

    st = path_bounce_init(job.scene, job.sampler, job.camera, px, py,
                          ids % spp, job.cfg, recording)
    for bounce in range(2):
        st = {k: v[st["alive"]] for k, v in st.items()}
        st = path_bounce_step(job.scene, job.sampler, job.cfg, st, bounce,
                              recording)
    torch.cuda.synchronize()
    assert [c[3] for c in calls] == [False, True, False, True, False]
    return dict(primary=calls[0], shadow=calls[3], bounce=calls[4])


def k1_work(geo, rays):
    """(bound_ms, bound_by, text): the least time for these rays.  The
    work is counted by the twin from what this run's rays need: each
    distinct record's live bytes read once (prim rows only of leaves in
    which a hit was found), the rays in and the hits out once; the twin's
    arithmetic on the present children and non-pad triangles of every
    record read, and a sort only where two or more children were hit."""
    from tpurt_torch.kernels.traverse import traverse_wide_reference

    o, d, tm, any_hit = rays
    w = {}
    traverse_wide_reference(geo, o, d, tm, any_hit=any_hit, stats=w)
    n = o.shape[0]
    nbytes = (w["interior_records"] * K1_BYTES_INTERIOR
              + w["leaf_records"] * K1_BYTES_LEAF
              + w["hit_leaves"] * K1_BYTES_PRIMS + n * (7 * 4 + 4 * 4))
    ops = (w["children"] * K1_OPS_CHILD + w["triangles"] * K1_OPS_TRIANGLE
           + w["sorts"] * K1_OPS_SORT)
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    bound_ms, bound_by = bound(nbytes, ops)
    steps = w["interior_steps"] + w["leaf_steps"]
    return bound_ms, bound_by, (
        f"{n} rays: {w['interior_steps']} interior + {w['leaf_steps']} leaf "
        f"steps ({steps / n:.2f} a ray) on {w['interior_records']} + "
        f"{w['leaf_records']} distinct records ({w['hit_leaves']} leaves "
        f"with a hit); {w['children']} children "
        f"({w['children'] / max(w['interior_steps'], 1):.2f} a record), "
        f"{w['sorts']} sorts, {w['triangles']} triangles "
        f"({w['triangles'] / max(w['leaf_steps'], 1):.2f} a leaf); "
        f"{nbytes / 1e6:.2f} MB ({b_ms:.4f} ms), {ops / 1e9:.3f} Gop "
        f"({o_ms:.4f} ms); bound {bound_ms:.4f} ms ({bound_by})")


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
    o, d, tm, _ = sets["primary"]

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
        o_i, d_i, t_i, any_hit = sets[name]
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
    from tpurt_torch.kernels.traverse import (traverse_wide,
                                              traverse_wide_reference)
    from tpurt_torch.render.driver import build_job, load_scene, render_job

    exr = WORK / "standin_full.exr"
    traverse_wide.launches = 0
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

    t0 = time.time()
    job = build_job(load_scene(scene_path), "cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    img = render_job(job)  # warm-up
    runs, peak = [], 0
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        img = render_job(job)
        torch.cuda.synchronize()
        runs.append(time.time() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
    assert img.shape == (700, 700, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    render_s = statistics.median(runs)
    paths = job.film.width * job.film.height * job.sampler.spp
    print(f"render_s {render_s:.4f} (runs {['%.4f' % r for r in runs]}) "
          f"camera Mrays/s {paths / render_s / 1e6:.4f} ({paths} paths) "
          f"peak mem {peak / 2**30:.3f} GiB, scene build {build_s:.2f}s, "
          f"image mean {img.mean():.5f} on {gpu}")
    return job, launches, render_s


def phase_rpf(scene_path: str, gpu: str):
    from tpurt_torch import cli
    from tpurt_torch.io.image import read_image
    from tpurt_torch.kernels.traverse import (traverse_wide,
                                              traverse_wide_reference)
    from tpurt_torch.render.driver import build_job, load_scene
    from tpurt_torch.rpf.driver import feature_exr_paths, render_rpf_job

    out = WORK / "standin_rpf_full_out.exr"
    sd = load_scene(scene_path)
    exrs = [Path(p) for p in feature_exr_paths(sd.film_params.find_one_string(
        "filename", ""))]
    for p in exrs + [out]:
        p.unlink(missing_ok=True)
    traverse_wide.launches = 0
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
    res = (sd.film_params.find_one_int("yresolution", 0),
           sd.film_params.find_one_int("xresolution", 0), 3)
    assert img.shape == res and np.isfinite(img).all() and img.mean() > 0
    assert all(p.exists() and p.stat().st_size > 0 for p in exrs)

    job = build_job(load_scene(scene_path), "cuda")
    torch.cuda.synchronize()
    render_rpf_job(job, write_feature_exrs=False)  # warm-up
    runs, peak = [], 0
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        img, ex = render_rpf_job(job, write_feature_exrs=False)
        torch.cuda.synchronize()
        runs.append(dict(total=time.time() - t0, sampling=ex["sampling_time"],
                         filter=ex["filter_time"], splat=ex["splat_time"]))
        peak = max(peak, torch.cuda.max_memory_allocated())
    assert np.isfinite(img).all() and img.mean() > 0
    med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(f"rpf_sampling_s {med['sampling']:.4f} rpf_filter_s "
          f"{med['filter']:.4f} rpf_splat_s {med['splat']:.4f} rpf_total_s "
          f"{med['total']:.4f} (medians of 3; total runs "
          f"{['%.4f' % r['total'] for r in runs]}) peak mem "
          f"{peak / 2**30:.3f} GiB, image mean {img.mean():.5f}, TF32 "
          f"matmul {torch.backends.cuda.matmul.allow_tf32} on {gpu}")
    return launches, job, med["total"]


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


def phase_profile(label: str, frame, wall_s: float):
    """Device time by kernel over one full frame (``frame()``).  The idle
    share is 1 - kernel time / the unprofiled wall time ``wall_s``
    (tracing inflates the profiled wall clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    print(f"profile {label}: {launches} kernel launches, device busy "
          f"{busy:.4f}s of {wall_s:.4f}s (idle share {1 - busy / wall_s:.3f})")
    for e in kernels[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"{e.key[:100]}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
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
    k2 = phase_gather(gpu)
    job, launches_a, render_s = phase_main(full, gpu)
    launches_b, rpf_job, rpf_total_s = phase_rpf(full_rpf, gpu)
    launches_probe, k2_l2 = phase_probe()
    phase_cross(full, small, small_rpf)
    if "--profile" in argv:
        from tpurt_torch.render.driver import render_job
        from tpurt_torch.rpf.driver import render_rpf_job

        phase_profile("path frame", lambda: render_job(job), render_s)
        phase_profile("RPF frame", lambda: render_rpf_job(
            rpf_job, write_feature_exrs=False), rpf_total_s)
    assert "jax" not in sys.modules and "tpurt" not in sys.modules
    print(json.dumps({"kernels": [
        dict(name="traverse_wide", route="cuda",
             source="tpurt_torch/csrc/traverse.cu",
             replaces="tpurt/kernels/traverse.py:54",
             launches=launches_a + launches_b,
             launches_by_path={"path": launches_a, "rpf": launches_b}, **k1),
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
