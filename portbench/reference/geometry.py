"""Ray queries of the reference: the closest hit and any hit along rays,
over the scene's triangles and spheres.

Triangles take pbrt-v3's watertight test (``shapes/triangle.cpp``,
Triangle::Intersect: translate to the ray origin, permute the axes so
that the ray's largest component is z, shear, edge functions, the scaled
distance against the ray's extent), in float32.  Spheres solve the
quadratic in float64.  The closest hit is the least t, ties to the
lowest triangle number; spheres come after the triangles.

The triangles are grouped into leaves of at most LEAF triangles by a
median split on the longest axis of their centroids; a ray tests the
triangles of every leaf whose box its segment crosses.  The grouping
only skips triangles a ray cannot hit: the answer is that of testing
all of them.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 32


def _batch(device):
    """(rays a batch, (ray, leaf) pairs tested at once) on ``device``."""
    return (1 << 16, 1 << 21) if str(device).startswith("cuda") else \
        (1 << 12, 1 << 16)


def _leaves(tri_v: np.ndarray):
    """Triangle numbers grouped by median splits: a list of int arrays."""
    cen = tri_v.mean(axis=1)
    out, todo = [], [np.arange(len(tri_v))]
    while todo:
        ids = todo.pop()
        if len(ids) <= LEAF:
            out.append(ids)
            continue
        c = cen[ids]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        order = ids[np.argsort(c[:, ax], kind="stable")]
        todo += [order[:len(order) // 2], order[len(order) // 2:]]
    return out


class Geometry:
    def __init__(self, scene, device, dtype=torch.float32):
        self.device, self.dtype = device, dtype
        tv = scene.tri_v
        groups = _leaves(tv)
        ids = np.full((len(groups), LEAF), -1, np.int64)
        for k, g in enumerate(groups):
            ids[k, :len(g)] = g
        lo = np.stack([tv[g].reshape(-1, 3).min(0) for g in groups])
        hi = np.stack([tv[g].reshape(-1, 3).max(0) for g in groups])
        dev = device
        self.leaf_ids = torch.tensor(ids, device=dev)
        self.leaf_lo = torch.tensor(lo, dtype=torch.float64, device=dev)
        self.leaf_hi = torch.tensor(hi, dtype=torch.float64, device=dev)
        self.tri_v = torch.tensor(tv, device=dev).to(dtype)  # (T, 3, 3)
        self.tri_mat = torch.tensor(scene.tri_mat, device=dev)
        self.sph_c = torch.tensor(np.array([s["center"] for s in
                                            scene.spheres], np.float64)
                                  .reshape(-1, 3), device=dev)
        self.sph_r = torch.tensor([s["radius"] for s in scene.spheres],
                                  dtype=torch.float64, device=dev)
        self.sph_mat = torch.tensor([s["material"] for s in scene.spheres],
                                    dtype=torch.int64, device=dev)
        self.sph_light = torch.tensor(
            [-1 if s["light"] is None else s["light"]
             for s in scene.spheres], dtype=torch.int64, device=dev)

    # -- triangles ---------------------------------------------------------
    def _tri_test(self, o, d, t_max, prim):
        """Watertight test of rays (o, d, t_max) (P,) against triangles
        ``prim`` (P,) (-1: none): (hit, t, b0, b1, b2)."""
        v = self.tri_v[prim.clamp(min=0)]  # (P, 3, 3)
        p = v - o[:, None, :]
        kz = d.abs().argmax(dim=-1)
        kx = (kz + 1) % 3
        ky = (kx + 1) % 3
        perm = torch.stack([kx, ky, kz], -1)
        dp = torch.gather(d, 1, perm)
        pp = torch.gather(p, 2, perm[:, None, :].expand(-1, 3, -1))
        sx = -dp[:, 0] / dp[:, 2]
        sy = -dp[:, 1] / dp[:, 2]
        sz = 1.0 / dp[:, 2]
        x = pp[..., 0] + sx[:, None] * pp[..., 2]
        y = pp[..., 1] + sy[:, None] * pp[..., 2]
        e0 = x[:, 1] * y[:, 2] - y[:, 1] * x[:, 2]
        e1 = x[:, 2] * y[:, 0] - y[:, 2] * x[:, 0]
        e2 = x[:, 0] * y[:, 1] - y[:, 0] * x[:, 1]
        # pbrt redoes an edge function that is exactly 0 in double
        zero = (e0 == 0) | (e1 == 0) | (e2 == 0)
        if bool(zero.any()):
            xd, yd = x.double(), y.double()
            e0 = torch.where(zero, (xd[:, 1] * yd[:, 2] - yd[:, 1] * xd[:, 2])
                             .to(e0.dtype), e0)
            e1 = torch.where(zero, (xd[:, 2] * yd[:, 0] - yd[:, 2] * xd[:, 0])
                             .to(e1.dtype), e1)
            e2 = torch.where(zero, (xd[:, 0] * yd[:, 1] - yd[:, 0] * xd[:, 1])
                             .to(e2.dtype), e2)
        mixed = (((e0 < 0) | (e1 < 0) | (e2 < 0))
                 & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
        det = e0 + e1 + e2
        z = pp[..., 2] * sz[:, None]
        ts = e0 * z[:, 0] + e1 * z[:, 1] + e2 * z[:, 2]
        tm = t_max.to(ts.dtype)
        ok = (~mixed & (det != 0) & (prim >= 0)
              & torch.where(det < 0, (ts < 0) & (ts >= tm * det),
                            (ts > 0) & (ts <= tm * det)))
        inv = 1.0 / torch.where(det == 0, 1.0, det)
        return ok, ts * inv, e0 * inv, e1 * inv, e2 * inv

    def _pairs(self, o, d, t_max):
        """(ray, leaf) pairs whose leaf box the segment [0, t_max] of the
        ray crosses (slab test in float64, padded by 1e-6 relative)."""
        od, dd = o.double(), d.double()
        inv = 1.0 / torch.where(dd == 0, 1e-300, dd)
        tm = t_max.double()
        rays, leaves = [], []
        step = max(1, (1 << 22) // max(1, self.leaf_lo.shape[0]))
        for a in range(0, o.shape[0], step):
            sl = slice(a, a + step)
            t0 = (self.leaf_lo[None] - od[sl, None]) * inv[sl, None]
            t1 = (self.leaf_hi[None] - od[sl, None]) * inv[sl, None]
            near = torch.minimum(t0, t1).amax(-1)
            far = torch.maximum(t0, t1).amin(-1)
            pad = 1e-6 * (far.abs() + 1.0)
            hit = (near <= far + pad) & (far + pad >= 0) & (near <= tm[sl, None])
            r, lf = hit.nonzero(as_tuple=True)
            rays.append(r + a)
            leaves.append(lf)
        return torch.cat(rays), torch.cat(leaves)

    def _triangles(self, o, d, t_max, any_hit: bool):
        """Per ray: the closest (t, prim, b0, b1, b2) over the triangles, or
        with any_hit just whether one lies within t_max."""
        n = o.shape[0]
        dev = o.device
        key = torch.full((n,), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=dev)
        rays, leaves = self._pairs(o, d, t_max)
        step = _batch(dev)[1] // LEAF
        for a in range(0, rays.shape[0], step):
            r = rays[a:a + step].repeat_interleave(LEAF)
            prim = self.leaf_ids[leaves[a:a + step]].reshape(-1)
            ok, t, *_ = self._tri_test(o[r], d[r], t_max[r], prim)
            t32 = t.float().clamp(min=0)
            # t > 0 as float32 bits orders as int32; ties to the lower prim
            k = (t32.view(torch.int32).to(torch.int64) << 32) | prim
            k = torch.where(ok, k, torch.iinfo(torch.int64).max)
            key.scatter_reduce_(0, r, k, "amin")
        found = key != torch.iinfo(torch.int64).max
        if any_hit:
            return found
        prim = torch.where(found, key & 0xFFFFFFFF, -1)
        ok, t, b0, b1, b2 = self._tri_test(o, d, t_max, prim)
        return found & ok, t, prim, b0, b1, b2

    # -- spheres -----------------------------------------------------------
    def _spheres(self, o, d, t_max):
        """Per ray: the closest sphere hit within t_max (t float64, sphere
        number or -1)."""
        n = o.shape[0]
        best = torch.full((n,), float("inf"), dtype=torch.float64,
                          device=o.device)
        which = torch.full((n,), -1, dtype=torch.int64, device=o.device)
        od, dd = o.double(), d.double()
        for k in range(self.sph_r.shape[0]):
            oc = od - self.sph_c[k]
            a = (dd * dd).sum(-1)
            b = 2.0 * (dd * oc).sum(-1)
            c = (oc * oc).sum(-1) - self.sph_r[k] ** 2
            disc = b * b - 4.0 * a * c
            root = torch.sqrt(disc.clamp(min=0))
            q = torch.where(b < 0, -0.5 * (b - root), -0.5 * (b + root))
            t0 = q / a
            t1 = c / torch.where(q == 0, 1e-300, q)
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            t = torch.where(lo > 0, lo, hi)
            ok = (disc >= 0) & (t > 0) & (t < t_max.double()) & (t < best)
            best = torch.where(ok, t, best)
            which = torch.where(ok, k, which)
        return best, which

    def closest(self, o, d, t_max):
        """dict(hit, t, prim (triangle or -1), sphere (-1 if none), b0, b1,
        b2) of the closest hit of each ray within t_max."""
        out = []
        step = _batch(o.device)[0]
        for a in range(0, o.shape[0], step):
            sl = slice(a, a + step)
            ok, t, prim, b0, b1, b2 = self._triangles(o[sl], d[sl],
                                                      t_max[sl], False)
            st, sph = self._spheres(o[sl], d[sl], t_max[sl])
            tt = torch.where(ok, t.double(), float("inf"))
            use_s = (sph >= 0) & (st < tt)
            out.append(dict(
                hit=ok | use_s, t=torch.where(use_s, st.to(t.dtype), t),
                prim=torch.where(use_s | ~ok, -1, prim),
                sphere=torch.where(use_s, sph, -1), b0=b0, b1=b1, b2=b2))
        return {k: torch.cat([c[k] for c in out]) for k in out[0]}

    def occluded(self, o, d, t_max):
        """Whether anything lies along each ray within t_max."""
        out = []
        step = _batch(o.device)[0]
        for a in range(0, o.shape[0], step):
            sl = slice(a, a + step)
            hit = self._triangles(o[sl], d[sl], t_max[sl], True)
            st, sph = self._spheres(o[sl], d[sl], t_max[sl])
            out.append(hit | (sph >= 0))
        return torch.cat(out)
