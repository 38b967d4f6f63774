"""One builder for the port's CUDA kernels.

Each kernel source under ``tpurt_torch/csrc/`` has a plain C interface and
is compiled by nvcc for ``sm_90a`` into its own shared library in
``build/tpurt_torch/`` (``config.BUILD_DIR``, gitignored), named by a hash
of the source and the flags, and loaded with ctypes.  A library is built
once per source version: a later process finds it on disk.  Nothing is
built when a module is imported; ``load_library`` runs at a kernel's
first launch (or from ``build_all``, which starts every nvcc at once).

Every exported C function returns the launch's ``cudaGetLastError()``;
``raise_on_error`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

from tpurt_torch.config import BUILD_DIR

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelLibrary(NamedTuple):
    cdll: ctypes.CDLL
    path: str
    build_s: float  # 0.0 when an identical build was already on disk
    log: str  # nvcc/ptxas output of the build (registers, spills)


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def load_library(source: str, extra_flags: Tuple[str, ...] = ()
                 ) -> KernelLibrary:
    """Build (once per source version and flags) and load
    ``csrc/<source>``."""
    src_path = CSRC / source
    flags = NVCC_FLAGS + tuple(extra_flags)
    tag = hashlib.sha256(src_path.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src_path.stem}-{tag}.so"
    build_s, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.time()
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp),
                               str(src_path)], capture_output=True, text=True)
        build_s = time.time() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {source} failed ({proc.returncode}):\n"
                               f"{log}")
        os.replace(tmp, out)
    return KernelLibrary(ctypes.CDLL(str(out)), str(out), build_s, log)


def build_all(specs: Sequence[Tuple[str, Tuple[str, ...]]]):
    """Build several kernel libraries at once (one nvcc each, all started
    together); returns their KernelLibrary tuples in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as ex:
        futs = [ex.submit(load_library, src, tuple(fl)) for src, fl in specs]
        return [f.result() for f in futs]


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def check_tensor(name, x, dtype, shape, device) -> None:
    """Raise on what a kernel does not take: device, dtype, shape and
    contiguity are checked before any pointer is passed."""
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
