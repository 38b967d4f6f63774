"""Gather probe: the CUDA kernel (csrc/gather_bench.cu), its wrapper and
its plain PyTorch version.

Replaces tpurt's Pallas probe ``tpurt/kernels/gather_bench.py:kernel``
(reached by ``run``).  ``gather_rows_sum(idx, table, rounds)`` returns

    out[0, :] = sum_{r < rounds} sum_{i < B} table[(idx[g(i)] + r*40503) % M, :]

as a (1, W) float32 tensor, with g(i) = (i // group) * group.  The
defaults (a 128-float table, ``variant="direct"``, ``group=1``) are tpurt's
probe; the others make it a sweep that decides the traversal kernel's
record layout: tables of W = 16, 32, 64 or 128 floats (rows of 64 to
512 B), rows fetched straight from global memory (``"direct"``), through a
shared-memory ring filled by ``cp.async`` (``"cp_async"``) or by 1-D bulk
copies on an mbarrier (``"bulk"``), and ``group=8`` letting 8 consecutive
reads share a row as neighbouring camera rays share a BVH record.

On a CPU tensor ``gather_rows_sum`` runs ``gather_rows_sum_reference`` (the
arithmetic of tpurt's ``run_xla``); on a CUDA tensor it launches the kernel
or raises.  Importing the module runs nothing; the probe is

    python -m tpurt_torch.kernels.gather_bench   # needs one CUDA card
        [--widths 64,128,256,512] [--variants direct,cp_async,bulk]
        [--groups 1,8] [--reps 10]

at tpurt's sizes (M=16384 rows, an 8 MiB table at 128 f32; B=8192 int32
lanes; R=128 rounds; the same seeded inputs, narrower tables being the
first W columns).  It prints ns per row read for the default kernel and for
``library_gather_sum``, one PyTorch call computing the same sum
(``embedding_bag`` over the materialised row list: the counterpart of
tpurt's ``jnp.take`` + sum), then one line per (width, variant, pattern)
with ms, ns per row and the GB/s that the row reads move through L2.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from tpurt_torch.kernels import build

SOURCE = "gather_bench.cu"
EXTRA_FLAGS = ()
M, REC, B, R = 16384, 128, 8192, 128  # the probe's sizes (tpurt's)
STRIDE = 40503  # per-round index offset
WIDTHS = (16, 32, 64, 128)  # floats per row the kernel takes (64..512 B)
VARIANTS = {"direct": 0, "cp_async": 1, "bulk": 2}  # the .cu's mode
LAST_SWEEP = []  # the cells (sweep_case dicts) of the probe's last run


@functools.lru_cache(maxsize=None)
def load_library() -> build.KernelLibrary:
    """Build (once per source version) and bind the kernel library."""
    lib = build.load_library(SOURCE, EXTRA_FLAGS)
    fn = lib.cdll.tpurt_gather_rows_sum
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, vp, ci, ci, ci, ci, vp, ci, vp, vp]
    fn.restype = ci
    return lib


def probe_inputs(device="cpu"):
    """tpurt's probe inputs: the (M, 128) table from default_rng(0), the
    (B,) int32 indices from default_rng(1)."""
    table = np.random.default_rng(0).normal(size=(M, REC)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, M, B).astype(np.int32)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(table, device=device))


def _shared_lanes(idx, group: int):
    """idx[g(i)]: lane i reads through the first lane of its group."""
    if group == 1:
        return idx
    i = torch.arange(idx.shape[0], device=idx.device)
    return idx[i - i % group]


def row_indices(idx, m: int, rounds: int, group: int = 1):
    """(rounds * B,) int64 row list in (round, lane) order."""
    r = torch.arange(rounds, dtype=torch.int64, device=idx.device)
    lanes = _shared_lanes(idx, group).to(torch.int64)
    return ((lanes[None, :] + r[:, None] * STRIDE) % m).reshape(-1)


def gather_rows_sum(idx, table, rounds: int, variant: str = "direct",
                    group: int = 1):
    """(1, W) f32 sum of ``rounds`` x B dynamic rows of the (M, W) table;
    W in ``WIDTHS``, ``variant`` in ``VARIANTS``, ``group`` consecutive
    lanes sharing a row."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {sorted(VARIANTS)}")
    if group < 1:
        raise ValueError(f"group {group} < 1")
    if table.device.type == "cpu":
        return gather_rows_sum_reference(idx, table, rounds, group=group)
    if table.device.type != "cuda":
        raise NotImplementedError(f"gather_rows_sum on {table.device}")
    dev = table.device
    b, m = idx.shape[0], table.shape[0]
    w = table.shape[1] if table.dim() == 2 else -1
    if w not in WIDTHS:
        raise ValueError(f"table shape {tuple(table.shape)}: the row width "
                         f"must be one of {WIDTHS}")
    build.check_tensor("idx", idx, torch.int32, (b,), dev)
    build.check_tensor("table", table, torch.float32, (m, w), dev)
    if b * rounds > 2 ** 30 or rounds < 0:  # int row counters in the .cu
        raise ValueError(f"B * rounds = {b * rounds} out of range")
    nblocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((nblocks, w), dtype=torch.float32, device=dev)
    out = torch.empty((1, w), dtype=torch.float32, device=dev)
    lib = load_library().cdll
    with torch.cuda.device(dev):
        err = lib.tpurt_gather_rows_sum(
            idx.data_ptr(), b, group, table.data_ptr(), m, w // 4,
            VARIANTS[variant], rounds, partial.data_ptr(), nblocks,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("gather_rows_sum", err)
    gather_rows_sum.launches += 1
    return out


gather_rows_sum.launches = 0


def gather_rows_sum_reference(idx, table, rounds: int, dtype=None,
                              group: int = 1):
    """Plain PyTorch version, tpurt's ``run_xla`` op for op: per round,
    gather the B rows and add their sum to the accumulator.  ``dtype``
    (e.g. torch.float64) sets the accumulation type; the table may have
    any width."""
    dtype = dtype or table.dtype
    m = table.shape[0]
    acc = torch.zeros((1, table.shape[1]), dtype=dtype, device=table.device)
    idx64 = _shared_lanes(idx, group).to(torch.int64)
    for r in range(rounds):
        j = (idx64 + r * STRIDE) % m
        acc = acc + table[j].to(dtype).sum(dim=0, keepdim=True)
    return acc


def library_gather_sum(rows, table):
    """One PyTorch call computing the same sum from the materialised row
    list (``row_indices``): ``embedding_bag`` with one bag, mode "sum".
    A yardstick for chip_smoke.py and the probe; the port never calls it."""
    return torch.nn.functional.embedding_bag(rows[None, :], table,
                                             mode="sum")


def _cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_case(idx, table, width: int, variant: str, group: int,
               reps: int = 10) -> dict:
    """One cell of the layout sweep: the first ``width`` columns of
    ``table`` read R x B times; checks the sum against float64 (1e-6 of the
    column's sum of |rows|) and times the kernel."""
    tab = table[:, :width].contiguous()
    got = gather_rows_sum(idx, tab, R, variant, group)
    want = gather_rows_sum_reference(idx, tab, R, torch.float64, group)
    scale = gather_rows_sum_reference(idx, tab.abs(), R, torch.float64, group)
    worst = ((got.double() - want).abs() / scale).max().item()
    if not worst <= 1e-6:
        raise AssertionError(f"{width * 4} B {variant} group {group}: error "
                             f"{worst:.3e} of the sum of |rows|")
    ms = _cuda_ms(lambda: gather_rows_sum(idx, tab, R, variant, group), reps)
    n = B * R
    return dict(row_bytes=width * 4, variant=variant, group=group, ms=ms,
                ns_per_row=ms * 1e6 / n,
                l2_gb_s=n * width * 4 / (ms * 1e-3) / 1e9, rel_err=worst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="64,128,256,512",
                    help="row widths in bytes to sweep")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--groups", default="1,8",
                    help="consecutive lanes sharing a row")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the gather probe needs a CUDA device")
    idx, table = probe_inputs("cuda")
    rows = row_indices(idx, M, R)
    got = gather_rows_sum(idx, table, R)
    want = gather_rows_sum_reference(idx, table, R, dtype=torch.float64)
    lib = library_gather_sum(rows, table)
    print(f"max |kernel - f64| {(got.double() - want).abs().max().item():.3e}"
          f", max |library - f64| "
          f"{(lib.double() - want).abs().max().item():.3e}")
    n = B * R
    gpu = torch.cuda.get_device_name(0)
    for name, fn in (("cuda kernel", lambda: gather_rows_sum(idx, table, R)),
                     ("library embedding_bag",
                      lambda: library_gather_sum(rows, table))):
        ms = _cuda_ms(fn, args.reps)
        print(f"{name}: {ms:.4f} ms, {ms * 1e6 / n:.3f} ns/row ({gpu})")
    print(f"sweep: {n} row reads of a {M}-row table per launch, mean of "
          f"{args.reps} launches ({gpu})")
    cells = []
    for wb in (int(x) for x in args.widths.split(",")):
        for variant in args.variants.split(","):
            for group in (int(x) for x in args.groups.split(",")):
                c = sweep_case(idx, table, wb // 4, variant, group, args.reps)
                cells.append(c)
                print(f"  {c['row_bytes']:3d} B {variant:8s} "
                      f"{'own row' if group == 1 else f'{group} share':8s} "
                      f"{c['ms']:.4f} ms {c['ns_per_row']:.4f} ns/row "
                      f"{c['l2_gb_s']:.1f} GB/s")
    LAST_SWEEP[:] = cells
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
