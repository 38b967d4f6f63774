"""Wide-BVH traversal: the CUDA kernel (csrc/traverse.cu), its wrapper and
its plain PyTorch twin.

Replaces tpurt's Pallas kernel ``tpurt/kernels/traverse.py:_kernel``
(reached by ``traverse_closest_pallas``) with the semantics tpurt renders
with, ``_traverse_wide`` (``tpurt/render/intersect.py``): the watertight
leaf test, the ``_BOX_T_SCALE`` far-scale, and an any-hit mode for shadow
rays.  The source note in traverse.cu says what bounds the kernel on
Hopper and what its design does about it.

``traverse_wide`` is the entry point.  On a CPU tensor it runs
``traverse_wide_reference``, the lockstep twin of ``_wide_step_fns``; on a
CUDA tensor it launches the kernel or raises.  The kernel library is built
by ``kernels.build`` (nvcc, from the sources in this checkout, at first
use, into ``build/tpurt_torch/``) and bound with ctypes.  The twin reads
the host record table ``geo.wnodes``; the kernel reads the tables derived
from it at upload (``geo.inodes``, ``geo.leaves``, ``geo.root_ref``:
``render.intersect.derive_traversal_tables``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpurt_torch.geom.wbvh import REC, SLOT_KIND, WIDTH
from tpurt_torch.kernels import build
from tpurt_torch.render.intersect import (
    _BOX_T_SCALE, CHILD_LO, INF, INTERIOR_REC, PRIM_LO, SORT8, _box8_test,
    _tri_bundle_test, safe_inv_dir)

SOURCE = "traverse.cu"
# IEEE rounding of every op, in the twin's order: no FMA contraction
EXTRA_FLAGS = ("-fmad=false",)
# must equal TPURT_STACK_MAX in traverse.cu: the largest stack depth
# DeviceGeometry.host_tables produces (the 192 cap rounded up to a power
# of two)
STACK_MAX = 256


@functools.lru_cache(maxsize=None)
def load_library() -> build.KernelLibrary:
    """Build (once per source version) and bind the kernel library."""
    lib = build.load_library(SOURCE, EXTRA_FLAGS)
    _bind(lib.cdll)
    return lib


def _bind(cdll) -> None:
    fn = cdll.tpurt_traverse_wide
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci,
                   ctypes.c_float, vp, vp, vp, vp, vp, vp]
    fn.restype = ci


def _launch(geo, o, d, t_max, any_hit: bool):
    """Check the inputs and launch the traversal kernel on the current
    stream; returns (t, prim, b0, b1)."""
    n = o.shape[0]
    dev = o.device
    mi, ml = geo.inodes.shape[0], geo.leaves.shape[0]
    build.check_tensor("inodes", geo.inodes, torch.float32,
                       (mi, INTERIOR_REC), dev)
    build.check_tensor("leaves", geo.leaves, torch.float32, (ml, REC), dev)
    build.check_tensor("o", o, torch.float32, (n, 3), dev)
    build.check_tensor("d", d, torch.float32, (n, 3), dev)
    build.check_tensor("t_max", t_max, torch.float32, (n,), dev)
    if not 1 <= geo.wstack_depth <= STACK_MAX:
        raise ValueError(f"wstack_depth {geo.wstack_depth} outside the "
                         f"kernel's compiled range 1..{STACK_MAX}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    b0 = torch.empty(n, dtype=torch.float32, device=dev)
    b1 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, b0, b1
    counter = torch.empty(1, dtype=torch.int32, device=dev)  # ray fetch
    with torch.cuda.device(dev):
        err = load_library().cdll.tpurt_traverse_wide(
            geo.inodes.data_ptr(), mi, geo.leaves.data_ptr(), ml,
            geo.root_ref, geo.wnodes.shape[0], o.data_ptr(), d.data_ptr(),
            t_max.data_ptr(), n, geo.wstack_depth, int(bool(any_hit)),
            _BOX_T_SCALE, t.data_ptr(), prim.data_ptr(), b0.data_ptr(),
            b1.data_ptr(), counter.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error("traverse_wide_kernel", err)
    return t, prim, b0, b1


def traverse_wide(geo, o, d, t_max, any_hit: bool):
    """Wide-BVH traversal of (N,) rays: returns (t, prim, b0, b1) like
    tpurt's ``_traverse_wide(..., tree="tri")`` for static geometry.
    o, d: (N, 3) f32; t_max: (N,) f32; lanes with t_max <= 0 start dead.
    any_hit stops a lane at its first hit (shadow rays)."""
    if o.device.type == "cpu":
        return traverse_wide_reference(geo, o, d, t_max, any_hit)
    if o.device.type != "cuda":
        raise NotImplementedError(f"traversal on {o.device}")
    out = _launch(geo, o, d, t_max, any_hit)
    if o.shape[0]:
        traverse_wide.launches += 1
    return out


traverse_wide.launches = 0


def traverse_wide_reference(geo, o, d, t_max, any_hit: bool, stats=None):
    """Plain PyTorch twin of tpurt's ``_wide_step_fns`` traversal.

    Lockstep over the live lanes: each step gathers one record per lane,
    runs the leaf test on leaf lanes and the 8-box test + ``SORT8``
    near-first ordering on interior lanes, pushes the other hit children
    far-to-near and descends into the nearest.  Dead lanes drop out of
    the working set between steps (a boolean index), which changes no
    lane's result.  Stack slots at or past ``geo.wstack_depth`` are
    dropped on push and read as 0 on pop, exactly as tpurt's one-hot
    stack behaves.  A lane takes at most one step per record of the table
    plus one, the kernel's guard: a tree never needs more, and a stack
    that overflowed (a pop that reads row 0 restarts at the root) cannot
    run on for ever.

    ``stats``, a dict, receives the work a traversal of these rays has to
    do: "interior_steps" and "leaf_steps" (records read, by kind),
    "children" and "triangles" (present child boxes and non-pad triangles
    tested in them), "sorts" (interior reads with two or more children
    hit, where an order is needed), and the distinct records read:
    "interior_records", "leaf_records", and "hit_leaves", the leaves in
    which some lane found a closer hit (whose prim rows are then read)."""
    traverse_wide_reference.calls += 1
    dev = o.device
    n = o.shape[0]
    S = geo.wstack_depth
    nodes = geo.wnodes
    inv_d = safe_inv_dir(d)
    t_best = t_max.to(torch.float32).clone()
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b0_best = torch.zeros(n, dtype=torch.float32, device=dev)
    b1_best = torch.zeros(n, dtype=torch.float32, device=dev)
    cur = torch.where(t_best > 0, 0, -1).to(torch.int64)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, S), dtype=torch.int32, device=dev)
    live = torch.nonzero(cur >= 0).squeeze(1)
    if stats is not None:
        seen = torch.zeros(nodes.shape[0], dtype=torch.bool, device=dev)
        seen_hit = torch.zeros_like(seen)
        stats.update(leaf_steps=0, interior_steps=0, children=0,
                     triangles=0, sorts=0)
    steps = 0
    while live.numel() and steps <= nodes.shape[0]:
        steps += 1
        rec = nodes[cur[live]]  # (m, 128): one record per live lane
        is_leaf = rec[:, SLOT_KIND] > 0
        m = live.numel()
        if stats is not None:
            seen[cur[live]] = True
            n_leaf = int(is_leaf.sum())
            stats["leaf_steps"] += n_leaf
            stats["interior_steps"] += m - n_leaf
        descend = torch.zeros(m, dtype=torch.bool, device=dev)
        first = torch.zeros(m, dtype=torch.int64, device=dev)

        # --- leaf lanes: 12 fused triangles, keep the closest ---
        lpos = torch.nonzero(is_leaf).squeeze(1)
        if lpos.numel():
            lanes = live[lpos]
            lrec = rec[lpos]
            h, t, b0, b1 = _tri_bundle_test(o[lanes], d[lanes],
                                            t_best[lanes], lrec)
            tk = torch.where(h, t, INF)
            kbest = torch.argmin(tk, dim=1, keepdim=True)  # first minimum
            t_min = tk.gather(1, kbest)[:, 0]
            better = t_min < t_best[lanes]
            if stats is not None:
                stats["triangles"] += int(
                    (~torch.isnan(lrec[:, :12])).sum())
                seen_hit[cur[lanes[better]]] = True
            bl = lanes[better]
            kb = kbest[better]
            t_best[bl] = t_min[better]
            prim_rows = lrec[better][:, PRIM_LO:PRIM_LO + 12].contiguous()
            prim_best[bl] = prim_rows.view(torch.int32).gather(1, kb)[:, 0]
            b0_best[bl] = b0[better].gather(1, kb)[:, 0]
            b1_best[bl] = b1[better].gather(1, kb)[:, 0]

        # --- interior lanes: box tests + near-first ordering ---
        ipos = torch.nonzero(~is_leaf).squeeze(1)
        if ipos.numel():
            lanes = live[ipos]
            irec = rec[ipos]
            hit8, t_near = _box8_test(irec, o[lanes], inv_d[lanes],
                                      t_best[lanes])
            meta = irec[:, CHILD_LO:CHILD_LO + WIDTH].contiguous().view(
                torch.int32).to(torch.int64)
            keys = [torch.where(hit8[:, k], t_near[:, k], INF)
                    for k in range(WIDTH)]
            vals = [meta[:, k] for k in range(WIDTH)]
            for i, j in SORT8:
                swap = keys[i] > keys[j]
                keys[i], keys[j] = (torch.where(swap, keys[j], keys[i]),
                                    torch.where(swap, keys[i], keys[j]))
                vals[i], vals[j] = (torch.where(swap, vals[j], vals[i]),
                                    torch.where(swap, vals[i], vals[j]))
            n_hit = hit8.sum(dim=1)
            if stats is not None:
                stats["children"] += int(
                    (~torch.isnan(irec[:, :WIDTH])).sum())
                stats["sorts"] += int((n_hit >= 2).sum())
            dsc = n_hit > 0
            sp_i = sp[lanes]
            # push hit children 1..n_hit-1 far-to-near above the old top
            for k in range(1, WIDTH):
                pos = sp_i + n_hit - 1 - k
                w = dsc & (k < n_hit) & (pos < S)
                stack[lanes[w], pos[w]] = vals[k][w].to(torch.int32)
            sp[lanes] = torch.where(dsc, sp_i + (n_hit - 1).clamp(min=0),
                                    sp_i)
            descend[ipos] = dsc
            first[ipos] = vals[0]

        # --- next node: nearest hit child, else pop, else done ---
        sp_l = sp[live]
        pop = ~descend & (sp_l > 0)
        top_slot = (sp_l - 1).clamp(min=0)
        top = stack[live, top_slot.clamp(max=S - 1)].to(torch.int64)
        top = torch.where(top_slot < S, top, 0)
        nxt = torch.where(descend, first, torch.where(pop, top, -1))
        if any_hit:
            nxt = torch.where(prim_best[live] >= 0, -1, nxt)
        sp[live] = torch.where(pop, sp_l - 1, sp_l)
        cur[live] = nxt
        live = live[nxt >= 0]
    if stats is not None:
        leaf_rows = nodes[:, SLOT_KIND] > 0
        stats.update(interior_records=int((seen & ~leaf_rows).sum()),
                     leaf_records=int((seen & leaf_rows).sum()),
                     hit_leaves=int(seen_hit.sum()))
    return t_best, prim_best, b0_best, b1_best


traverse_wide_reference.calls = 0
