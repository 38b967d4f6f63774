"""ctypes loader for the native runtime library (csrc/tpurt_native.cpp,
the port's copy of tpurt's native/tpurt_native.cpp: the SAH BVH and
kd-tree builders and the Halton permutation generator).

Compiles the shared library on first use (g++ -O3) into build/tpurt_torch/
(config.BUILD_DIR); every entry point has a pure-Python fallback so the framework
works without a toolchain.  (pybind11 is not available in this image, so
the boundary is a plain C ABI — see the build-environment notes.)
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("tpurt_torch.native")

_LIB = None
_LOCK = threading.Lock()
_TRIED = False


def _source_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "csrc", "tpurt_native.cpp")


def _lib_path() -> str:
    # key the artifact by source CONTENT, not mtime: several checkouts
    # (worktrees, CI shards) share this cache directory, and an
    # mtime-keyed single filename lets an older checkout clobber a newer
    # build (observed: a round-2 worktree rebuilt the .so without
    # build_kdtree_sah and broke the main checkout's loads)
    import hashlib

    with open(_source_path(), "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    from tpurt_torch.config import BUILD_DIR

    return os.path.join(BUILD_DIR, f"libtpurt_native-{tag}.so")


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = _source_path()
        out = _lib_path()
        try:
            if (not os.path.exists(out)
                    or os.path.getmtime(out) < os.path.getmtime(src)):
                os.makedirs(os.path.dirname(out), exist_ok=True)
                # build beside the target and rename: processes sharing
                # the build directory never load a half-written library
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                       "-o", tmp, src]
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, out)
                log.info("built native library: %s", out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native library unavailable (%s); using Python "
                        "fallbacks", e)
            return None

        lib.build_bvh_sah.restype = ctypes.c_int32
        lib.build_bvh_sah.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.build_kdtree_sah.restype = ctypes.c_int32
        lib.build_kdtree_sah.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.gen_halton_perms.restype = None
        lib.gen_halton_perms.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _LIB = lib
        return _LIB


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_bvh_native(lo: np.ndarray, hi: np.ndarray, max_leaf: int = 1):
    """Native SAH build; returns the LinearBVH field tuple or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(lo)
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    cap = 2 * n
    nb_lo = np.empty((cap, 3), np.float32)
    nb_hi = np.empty((cap, 3), np.float32)
    right = np.zeros(cap, np.int32)
    prim_off = np.zeros(cap, np.int32)
    n_prims = np.zeros(cap, np.int32)
    axis = np.zeros(cap, np.int32)
    order = np.zeros(n, np.int32)
    m = lib.build_bvh_sah(_fptr(lo32), _fptr(hi32), n, max_leaf,
                          _fptr(nb_lo), _fptr(nb_hi), _iptr(right),
                          _iptr(prim_off), _iptr(n_prims), _iptr(axis),
                          _iptr(order))
    if m <= 0:
        return None
    return (nb_lo[:m].copy(), nb_hi[:m].copy(), right[:m].copy(),
            prim_off[:m].copy(), n_prims[:m].copy(), axis[:m].copy(), order)


def build_kdtree_native(lo: np.ndarray, hi: np.ndarray,
                        isect_cost: int = 80, trav_cost: int = 1,
                        empty_bonus: float = 0.5, max_prims: int = 1,
                        max_depth: int = -1):
    """Native SAH kd-tree build (kdtreeaccel.cpp semantics); returns
    (split, axis, above, prim_off, n_prims, indices, bounds(2,3)) or
    None when the library is unavailable.  axis == 3 marks leaves."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(lo)
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    node_cap = max(4 * n, 1024)
    idx_cap = max(8 * n, 1024)
    for _ in range(4):  # retry with doubled caps on overflow
        split = np.zeros(node_cap, np.float32)
        axis = np.zeros(node_cap, np.int32)
        above = np.zeros(node_cap, np.int32)
        prim_off = np.zeros(node_cap, np.int32)
        n_prims = np.zeros(node_cap, np.int32)
        indices = np.zeros(idx_cap, np.int32)
        bounds = np.zeros(6, np.float32)
        n_idx = np.zeros(1, np.int32)
        m = lib.build_kdtree_sah(
            _fptr(lo32), _fptr(hi32), n, isect_cost, trav_cost,
            ctypes.c_float(empty_bonus), max_prims, max_depth,
            node_cap, idx_cap, _fptr(split), _iptr(axis), _iptr(above),
            _iptr(prim_off), _iptr(n_prims), _iptr(indices), _fptr(bounds),
            _iptr(n_idx))
        if m > 0:
            k = int(n_idx[0])
            return (split[:m].copy(), axis[:m].copy(), above[:m].copy(),
                    prim_off[:m].copy(), n_prims[:m].copy(),
                    indices[:k].copy(), bounds.reshape(2, 3))
        if m == -1:
            return None
        node_cap = max(node_cap, -m) * 2
        idx_cap = max(idx_cap, -m) * 2
    return None


def gen_halton_perms_native(primes: np.ndarray):
    """Native permutation-table generation, bit-exact with the Python
    PCG32 path; returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    primes32 = np.ascontiguousarray(primes, np.int32)
    total = int(primes32.sum())
    out = np.zeros(total, np.uint16)
    lib.gen_halton_perms(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        _iptr(primes32), len(primes32))
    return out
