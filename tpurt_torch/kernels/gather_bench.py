"""Gather probe: the CUDA kernel (csrc/gather_bench.cu), its wrapper and
its plain PyTorch version.

Replaces tpurt's Pallas probe ``tpurt/kernels/gather_bench.py:kernel``
(reached by ``run``).  ``gather_rows_sum(idx, table, rounds)`` returns

    out[0, :] = sum_{r < rounds} sum_{i < B} table[(idx[i] + r*40503) % M, :]

as a (1, 128) float32 tensor.  On a CPU tensor it runs
``gather_rows_sum_reference`` (the arithmetic of tpurt's ``run_xla``); on
a CUDA tensor it launches the kernel or raises.  Importing the module runs
nothing; the probe is

    python -m tpurt_torch.kernels.gather_bench   # needs one CUDA card

at tpurt's sizes (M=16384 rows of 128 f32, an 8 MiB table; B=8192 int32
lanes; R=128 rounds; the same seeded inputs), printing ns per row read for
the kernel and for ``library_gather_sum``, one PyTorch call computing the
same sum (``embedding_bag`` over the materialised row list: the
counterpart of tpurt's ``jnp.take`` + sum).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpurt_torch.kernels import build

SOURCE = "gather_bench.cu"
EXTRA_FLAGS = ()
M, REC, B, R = 16384, 128, 8192, 128  # the probe's sizes (tpurt's)
STRIDE = 40503  # per-round index offset


@functools.lru_cache(maxsize=None)
def load_library() -> build.KernelLibrary:
    """Build (once per source version) and bind the kernel library."""
    lib = build.load_library(SOURCE, EXTRA_FLAGS)
    fn = lib.cdll.tpurt_gather_rows_sum
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, ci, ci, vp, ci, vp, vp]
    fn.restype = ci
    return lib


def probe_inputs(device="cpu"):
    """tpurt's probe inputs: the (M, 128) table from default_rng(0), the
    (B,) int32 indices from default_rng(1)."""
    table = np.random.default_rng(0).normal(size=(M, REC)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, M, B).astype(np.int32)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(table, device=device))


def row_indices(idx, m: int, rounds: int):
    """(rounds * B,) int64 row list in (round, lane) order."""
    r = torch.arange(rounds, dtype=torch.int64, device=idx.device)
    return ((idx.to(torch.int64)[None, :] + r[:, None] * STRIDE) % m
            ).reshape(-1)


def gather_rows_sum(idx, table, rounds: int):
    """(1, 128) f32 sum of ``rounds`` x B dynamic rows of ``table``."""
    if table.device.type == "cpu":
        return gather_rows_sum_reference(idx, table, rounds)
    if table.device.type != "cuda":
        raise NotImplementedError(f"gather_rows_sum on {table.device}")
    dev = table.device
    b, m = idx.shape[0], table.shape[0]
    build.check_tensor("idx", idx, torch.int32, (b,), dev)
    build.check_tensor("table", table, torch.float32, (m, REC), dev)
    if b * rounds > 2 ** 30 or rounds < 0:  # int row counters in the .cu
        raise ValueError(f"B * rounds = {b * rounds} out of range")
    nblocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((nblocks, REC), dtype=torch.float32, device=dev)
    out = torch.empty((1, REC), dtype=torch.float32, device=dev)
    lib = load_library().cdll
    with torch.cuda.device(dev):
        err = lib.tpurt_gather_rows_sum(
            idx.data_ptr(), b, table.data_ptr(), m, rounds,
            partial.data_ptr(), nblocks, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("gather_rows_sum", err)
    gather_rows_sum.launches += 1
    return out


gather_rows_sum.launches = 0


def gather_rows_sum_reference(idx, table, rounds: int, dtype=None):
    """Plain PyTorch version, tpurt's ``run_xla`` op for op: per round,
    gather the B rows and add their sum to the accumulator.  ``dtype``
    (e.g. torch.float64) sets the accumulation type."""
    dtype = dtype or table.dtype
    m = table.shape[0]
    acc = torch.zeros((1, table.shape[1]), dtype=dtype, device=table.device)
    idx64 = idx.to(torch.int64)
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


def main() -> int:
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
    for name, fn in (("cuda kernel", lambda: gather_rows_sum(idx, table, R)),
                     ("library embedding_bag",
                      lambda: library_gather_sum(rows, table))):
        ms = _cuda_ms(fn)
        print(f"{name}: {ms:.4f} ms, {ms * 1e6 / n:.3f} ns/row "
              f"({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
