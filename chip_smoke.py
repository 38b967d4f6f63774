"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py             # needs one CUDA card
    python3 chip_smoke.py --profile   # also prints a torch.profiler
                                      # breakdown of one full-frame render

Phases (any failure exits non-zero; none is caught):
  1. environment: versions, the card's name and power limit
  2. build: the traversal kernel library, from the sources in this checkout
  3. scene: the 700x700, 8 spp, ~66k-triangle stand-in for killeroo-simple
  4. kernel against its plain PyTorch version on 2^20 primary rays and
     2^20 shadow-like rays toward the light (closest-hit prim equal on
     >= 99.99% of lanes, t within rtol 1e-5 where both hit; any-hit
     occlusion equal on >= 99.99%), with both times
  5. main path: the CLI renders the full frame on the card and writes the
     EXR; the traversal kernel must have launched and the plain version
     must not have run; then one warm-up and 3 timed renders
  6. cross-checks: a 64x64 crop rendered with the kernel and with the plain
     traversal (mean |diff| < 1e-4 of the image mean), and the small
     stand-in rendered on the card and on the CPU
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


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 5):
    """Median milliseconds of fn() over reps runs after one warm-up,
    synchronised around each run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_env():
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    print(f"gpu: {gpu_line()} (count {torch.cuda.device_count()})")


def phase_build():
    from tpurt_torch.kernels.traverse import load_library

    t0 = time.time()
    lib = load_library()
    print(f"build: {lib.path} nvcc {lib.build_s:.2f}s "
          f"(load {time.time() - t0:.2f}s)")
    for ln in lib.log.splitlines():
        if "registers" in ln or "spill" in ln or "stack frame" in ln:
            print("  ptxas:", ln.strip())
    return lib


def phase_scene(size: str = "full"):
    from tpurt_torch.testscenes import write_standin

    WORK.mkdir(parents=True, exist_ok=True)
    path = write_standin(str(WORK / f"standin_{size}.pbrt"), size)
    return path


def phase_kernel(job):
    """Kernel against its plain version at the main path's shapes."""
    from tpurt_torch.kernels.traverse import (traverse_wide,
                                              traverse_wide_reference)
    from tpurt_torch.render.integrator import _camera_setup

    geo = job.scene.geo
    dev = geo.device
    film, spp = job.film, job.sampler.spp
    total = film.width * film.height * spp
    ids = torch.arange(LANES, device=dev) * total // LANES  # whole frame
    pid = ids // spp
    px = (pid % film.width).to(torch.int64)
    py = (pid // film.width).to(torch.int64)
    _, _, o, d, _, _ = _camera_setup(job.sampler, job.camera, px, py,
                                     ids % spp, (0, 0))
    o, d = o.contiguous(), d.contiguous()
    tm = torch.full((LANES,), float("inf"), device=dev)

    ref = traverse_wide_reference(geo, o, d, tm, any_hit=False)
    ker = traverse_wide(geo, o, d, tm, any_hit=False)
    torch.cuda.synchronize()
    same = (ref[1] == ker[1])
    both = (ref[1] >= 0) & (ker[1] >= 0)
    rel = ((ref[0] - ker[0]).abs() / ref[0].abs())[both]
    closest_agree = same.float().mean().item()
    t_ok = (rel <= 1e-5).float().mean().item() if both.any() else 1.0
    t_err = (ref[0] - ker[0]).abs()[both].max().item() if both.any() else 0.0

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
    any_agree = ((ref_a[1] >= 0) == (ker_a[1] >= 0)).float().mean().item()

    ms = cuda_ms(lambda: traverse_wide(geo, o, d, tm, any_hit=False))
    plain_ms = cuda_ms(lambda: traverse_wide_reference(geo, o, d, tm,
                                                       any_hit=False))
    ms_a = cuda_ms(lambda: traverse_wide(geo, o_sh, d_sh, t_sh, any_hit=True))
    plain_ms_a = cuda_ms(lambda: traverse_wide_reference(
        geo, o_sh, d_sh, t_sh, any_hit=True))
    print(f"kernel vs plain @ {LANES} lanes: closest prim agree "
          f"{closest_agree:.6f} (hits {hit.float().mean().item():.3f}), "
          f"t within rtol 1e-5 {t_ok:.6f}, max |dt| {t_err:.3e}; "
          f"any-hit occlusion agree {any_agree:.6f} "
          f"(occluded {(ker_a[1] >= 0).float().mean().item():.3f})")
    print(f"traversal ms @ {LANES} lanes: closest kernel {ms:.3f} plain "
          f"{plain_ms:.3f}; any-hit kernel {ms_a:.3f} plain {plain_ms_a:.3f}")
    assert closest_agree >= 0.9999, closest_agree
    assert t_ok >= 0.9999, t_ok
    assert any_agree >= 0.9999, any_agree
    return dict(max_abs_err=t_err, ms=ms, plain_ms=plain_ms)


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


def phase_cross(scene_path: str, small_path: str):
    from tpurt_torch.kernels.traverse import traverse_wide_reference
    from tpurt_torch.render.driver import load_scene, render

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
    d = np.abs(g - h)
    frac = (d <= 1e-3 + 1e-3 * np.abs(h)).all(axis=-1).mean()
    mrel = abs(g.mean() - h.mean()) / h.mean()
    print(f"small stand-in cuda vs cpu: mean rel {mrel:.3e}, pixels within "
          f"1e-3 {frac:.4f}, max |diff| {d.max():.3e}")
    assert np.isfinite(g).all() and mrel < 1e-3 and frac >= 0.99


def phase_profile(job, render_s: float):
    """Device time by kernel over one full-frame render.  The idle share
    is 1 - kernel time / the unprofiled render_s (tracing inflates the
    profiled wall clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch.render.driver import render_job

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_job(job)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    print(f"profile: {launches} kernel launches, device busy {busy:.4f}s "
          f"of render_s {render_s:.4f}s (idle share {1 - busy / render_s:.3f})")
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

    from tpurt_torch.render.driver import build_job, load_scene

    job = build_job(load_scene(full), "cuda")
    g = job.scene.geo
    print(f"scene: {g.n_tris} triangles, {g.n_quads} sphere(s), wnodes "
          f"{g.wnodes.shape[0]} rows ({g.wnodes.numel() * 4 / 1e6:.1f} MB), "
          f"wstack_depth {g.wstack_depth}, {job.film.width}x"
          f"{job.film.height} {job.sampler.spp} spp")
    kstats = phase_kernel(job)
    job, launches, render_s = phase_main(full, gpu)
    phase_cross(full, small)
    if "--profile" in argv:
        phase_profile(job, render_s)
    assert "jax" not in sys.modules
    print(json.dumps({"kernels": [dict(
        name="traverse_wide", route="cuda",
        source="tpurt_torch/csrc/traverse.cu",
        replaces="tpurt/kernels/traverse.py:54",
        launches=launches, **kstats)]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
