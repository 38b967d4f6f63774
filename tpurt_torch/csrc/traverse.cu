// Wide-BVH traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel tpurt/kernels/traverse.py:_kernel (reached by
// traverse_closest_pallas), with the semantics tpurt actually renders
// with: _traverse_wide / _wide_step_fns in tpurt/render/intersect.py.
// Two places differ from the Pallas body and follow production instead:
// the leaf test is the watertight _tri_bundle_test (not Moeller-Trumbore
// with t > 1e-5), and the box far-scale is _BOX_T_SCALE (passed in by the
// wrapper) instead of 1 + 6e-7.  any_hit adds the shadow-ray mode: a lane
// stops at the first leaf that yields a hit.
//
// Three leaf bodies, each its own instantiation of the walk (template
// parameter LEAF), so that a frame without motion or curves runs exactly
// the static body and pays nothing for the others in registers:
//   K1  (TPURT_LEAF_TRI): 12 static triangles a leaf;
//   K1m (TPURT_LEAF_MOTION): the same triangles lerped to the ray's time,
//     v + time * dv, by the per-leaf delta rows that mirror the leaf table
//     (tpurt's _tri_bundle_test(drec, time), intersect.py:669-725).  A
//     motion leaf turn is the whole warp's (motion_leaf_turn, below): each
//     group of 4 triangles of every leaf lane is culled by its box at the
//     ray's time (group_near) a lane each, and the survivors lerped and
//     tested a group a lane;
//   K1c (TPURT_LEAF_CURVE): 8 cubic Bezier spans a leaf of the curve tree,
//     each split into 8 sub-segments by constant blossom weights and run
//     through pbrt's depth-0 width test (tpurt's _curve_bundle_test,
//     intersect.py:751-897), ribbons scaled by the aux rows.  A curve leaf
//     turn is the whole warp's (curve_leaf_turn, below): the spans of all
//     leaf lanes are culled by their hull a lane each, and the survivors
//     tested (span, sub-segment) a lane.
// The interior records, the stack, the schedule and the body choice are
// the same for all three.
// Under Accelerator "kdtree" the triangle rays take the kd walk instead
// (traverse_kd_kernel, at the end of this file): K1k and K1km, which replace
// tpurt's jnp kd traversal (_kd_step_fns, intersect.py:1038, the kd branch
// of _traverse_wide, which stands in for traverse.py:54 there) and share
// K1's ray setup, scheduler and watertight leaf test.
//
// Tables (derived at upload from the host record table of
// tpurt/geom/wbvh.py by render/intersect.py:derive_traversal_tables):
//   interior table, 64 f32 a row (256 B, 56 live):
//     [0:48] child bounds lo.x lo.y lo.z hi.x hi.y hi.z (8 each, absent
//     children are NaN boxes), [48:56] child references (i32)
//   leaf table, 128 f32 a row: [0:108] 12 triangles' v0.x..v2.z (12 each,
//     pads NaN), [108:120] prim rows (i32, pads -1)
//   motion delta table (K1m), 128 f32 a row beside each leaf row: the
//     vertex deltas (end - start) in the same slots, pads 0
//   curve leaf table (K1c), 128 f32 a row: [0:96] 8 spans' 12 control-point
//     coordinates, coordinate-major (slot 8c + k), pads NaN; [96:104]
//     span-start widths, [104:112] span-end widths, [112:120] prim rows;
//     ribbon aux table, 64 f32 a row beside it: n0 (3 x 8), n1 (3 x 8),
//     angle (8), 1/sin(angle) (8)
//   a reference is 2 * row + (1 if the row is in the leaf table), so a
//   lane knows a record's kind before it reads it; root_ref is the root's.
//
// What bounds it on this card: instruction throughput under divergence, not
// memory.  A ray reads few records (3.9 for a primary ray of the stand-in
// frame, 1 to 1.6 for a bounce or shadow ray), each from L1 or L2 (the
// tables fit the 50 MB L2), and does a few hundred non-fused float
// operations, compares and selects on each; there is no product for the
// tensor cores.  What multiplies the instruction cost is that the lanes of a
// warp disagree: a warp that holds interior and leaf records runs both
// bodies, and it lives as long as its longest ray.  Measured with every
// ray repeated 32 times, so that each warp holds one ray, the same work
// takes about half the time.  What each part of the design does about it:
//   - fewer instructions per record: PTX min.NaN/max.NaN for the
//     NaN-propagating slab test, the watertight test's axis permutation
//     done by addressing (the ray picks which vertex rows it loads) rather
//     than by selects, the record kind carried in the reference, no test
//     of the upper four children or of a group of four triangles when all
//     are absent, and no sort when at most one child is hit;
//   - persistent warps: a grid sized to the card, each warp taking
//     K1_CHUNK rays at a time from a global integer counter and refilling
//     its dead lanes when K1_REFILL or fewer are live, so a warp of bounce
//     rays does not idle on its longest ray; a ray's result depends only
//     on its own walk, so the schedule does not change it;
//   - the body most lanes want: a turn runs the interior body when at
//     least as many live lanes hold an interior record as a leaf, else the
//     leaf body, never both;
//   - records are loaded directly, 16 bytes a lane and only the live
//     slots: lanes that hold the same record get one L1 broadcast, and the
//     stack stays in local memory (TPURT_STACK_MAX slots, of which a walk
//     touches a few).
// Measured on an NVIDIA H100 80GB HBM3 (700 W) and not used, each slower
// than what is here: a warp-cooperative fetch of shared records through
// shared memory (__match_any_sync, one float4 a lane into per-warp slots;
// 10-16% slower on every ray set: the staging adds a shared-memory round
// trip and the match to every step), while-while scheduling with
// postponed leaves (Aila and Laine 2009) and one step a lane a turn (both
// slower on bounce and shadow rays), a shared-memory stack sized by
// stack_depth (costs occupancy), a leaf prefetch into L1, and a grid of
// one ray a thread.
// Each lane visits its records in the order the plain version does, so
// ties resolve the same way; only when a lane does a step changes.
//
// Numerics follow the plain twin (tpurt_torch/kernels/traverse.py) op for
// op.  Build without --use_fast_math and with -fmad=false so products are
// not contracted into FMAs; divisions are IEEE.  jnp/torch minimum and
// maximum propagate NaN while fminf/fmaxf drop it, so the slab test uses
// min.NaN/max.NaN: a NaN box must never be hit.  (They order -0 below +0,
// which the twin's does not; the slab values only feed comparisons, where
// the two zeros are equal.)

#include <cuda_runtime.h>
#include <stdint.h>

#define K1_REFILL 24  // refill a warp's dead lanes when <= this many live
#define K1_CHUNK 32   // rays a warp takes from the counter at a time
// blocks per SM the register budget is set for: 80 registers, no spills
// (4 gives 96 registers and the same times, 8 spills)
#define K1_MINBLOCKS 6
// the motion bodies hold a leaf group's delta rows beside its vertices
// (K1m also 7 KB of shared memory a block: its warps' job lists and
// results), the curve body a span's ray frame and projected control points
// (and 31 KB: its job lists, span queues and results).  At 4 blocks an SM
// K1m takes 124 registers and K1km 126, no spills; at 5 (96 registers) K1m
// spilled 90 B and was 2-4% slower, K1km 84 B and 8-15% slower
#define K1M_MINBLOCKS 4
#define K1C_MINBLOCKS 4

#define TPURT_LEAF_TRI 0     // LEAF_KINDS in kernels/traverse.py
#define TPURT_LEAF_MOTION 1
#define TPURT_LEAF_CURVE 2
#define TPURT_CURVE_SUB 8    // 2^CURVE_LEAF_SUBDIV sub-segments a span

#define TPURT_WIDTH 8
#define TPURT_LEAF_K 12
#define TPURT_STACK_MAX 256    // must equal STACK_MAX in kernels/traverse.py
#define TPURT_KD_STACK_MAX 128  // must equal KD_STACK_MAX there
#define TPURT_BLOCK 128
#define TPURT_INT_ROW4 16      // float4 per interior-table row (256 B)
#define TPURT_LEAF_ROW4 32     // float4 per leaf-table row (512 B)
#define TPURT_AUX_ROW4 16      // float4 per ribbon aux row (256 B)
#define FULL 0xffffffffu

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// one comparator of tpurt's _SORT8 network: strict '>' swap of keys+vals
#define CSWAP(i, j)                                        \
  {                                                        \
    if (key[i] > key[j]) {                                 \
      float tk_ = key[i]; key[i] = key[j]; key[j] = tk_;   \
      int tv_ = val[i]; val[i] = val[j]; val[j] = tv_;     \
    }                                                      \
  }

// what a lane keeps of its ray (a body's unused fields are dead code)
struct Ray {
  float ox, oy, oz;     // origin
  float ix, iy, iz;     // 1/d with signed infinities on zero components
  float opx, opy, opz;  // origin, permuted for the watertight test
  float sx, sy, sz;     // its shear
  int kx, ky, kz;       // float4 offset of the permuted x, y, z vertex rows
  float time;           // shutter time (K1m)
  float dx, dy, dz;     // direction as given (K1c, the kd walk)
  float dl, hx, hy, hz; // |d| and d / |d| (K1c)
};

__device__ __forceinline__ float comp(const float4& v, int j) {
  return reinterpret_cast<const float*>(&v)[j];
}

// a ray as a lane keeps it: 1/d with signed infinities on zero components
// (intersect.py:1234), the watertight test's permutation (|d|'s largest
// axis becomes z) and shear, the shutter time (K1m), the direction and its
// length (K1c)
template <int LEAF>
__device__ __forceinline__ void load_ray(Ray& r,
                                         const float* __restrict__ o_in,
                                         const float* __restrict__ d_in,
                                         const float* __restrict__ time_in,
                                         int ray) {
  const float inf = __int_as_float(0x7f800000);
  r.ox = o_in[3 * ray];
  r.oy = o_in[3 * ray + 1];
  r.oz = o_in[3 * ray + 2];
  const float dx = d_in[3 * ray], dy = d_in[3 * ray + 1],
              dz = d_in[3 * ray + 2];
  r.ix = dx != 0.f ? 1.f / dx : (dx >= 0.f ? inf : -inf);
  r.iy = dy != 0.f ? 1.f / dy : (dy >= 0.f ? inf : -inf);
  r.iz = dz != 0.f ? 1.f / dz : (dz >= 0.f ? inf : -inf);
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const bool use2 = (az >= ax) && (az >= ay);  // (x, y, z)
  const bool use1 = !use2 && (ay >= ax);       // (z, x, y); else (y, z, x)
#define PERM_X(x, y, z) (use2 ? (x) : (use1 ? (z) : (y)))
#define PERM_Y(x, y, z) (use2 ? (y) : (use1 ? (x) : (z)))
#define PERM_Z(x, y, z) (use2 ? (z) : (use1 ? (y) : (x)))
  const float dpx = PERM_X(dx, dy, dz), dpy = PERM_Y(dx, dy, dz),
              dpz = PERM_Z(dx, dy, dz);
  r.opx = PERM_X(r.ox, r.oy, r.oz);
  r.opy = PERM_Y(r.ox, r.oy, r.oz);
  r.opz = PERM_Z(r.ox, r.oy, r.oz);
  // a leaf's x, y, z rows of one vertex are 3 float4 apart
  r.kx = 3 * PERM_X(0, 1, 2);
  r.ky = 3 * PERM_Y(0, 1, 2);
  r.kz = 3 * PERM_Z(0, 1, 2);
#undef PERM_X
#undef PERM_Y
#undef PERM_Z
  r.sx = -dpx / dpz;
  r.sy = -dpy / dpz;
  r.sz = 1.f / dpz;
  if (LEAF == TPURT_LEAF_MOTION) r.time = time_in[ray];
  r.dx = dx;  // read by the curve body and the kd walk, else dead
  r.dy = dy;
  r.dz = dz;
  if (LEAF == TPURT_LEAF_CURVE) {
    r.dl = sqrtf(dx * dx + dy * dy + dz * dz);
    r.hx = dx / r.dl;
    r.hy = dy / r.dl;
    r.hz = dz / r.dl;
  }
}

// 8 slab tests of an interior record, then the
// near-first order: key/val sorted, returns the number of children hit
__device__ __forceinline__ int interior_test(const float4* __restrict__ rec,
                                             const Ray& r, float t_best,
                                             float box_scale, float* key,
                                             int* val) {
  const float inf = __int_as_float(0x7f800000);
  int n_hit = 0;
  int only = 0;  // the last child hit: the next record when n_hit == 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // children 4h .. 4h+3
    const float4 lx = rec[0 + h];
    // children fill a record from slot 0, so the upper four are often
    // absent; a box whose lo.x is NaN is hit by no ray
    if (h == 1 && lx.x != lx.x && lx.y != lx.y && lx.z != lx.z &&
        lx.w != lx.w) {
#pragma unroll
      for (int j = 4; j < TPURT_WIDTH; ++j) {
        key[j] = inf;
        val[j] = 0;
      }
      break;
    }
    const float4 ly = rec[2 + h], lz = rec[4 + h];
    const float4 hx = rec[6 + h], hy = rec[8 + h], hz = rec[10 + h];
    const float4 ch = rec[12 + h];
    const float* plx = reinterpret_cast<const float*>(&lx);
    const float* ply = reinterpret_cast<const float*>(&ly);
    const float* plz = reinterpret_cast<const float*>(&lz);
    const float* phx = reinterpret_cast<const float*>(&hx);
    const float* phy = reinterpret_cast<const float*>(&hy);
    const float* phz = reinterpret_cast<const float*>(&hz);
    const float* pch = reinterpret_cast<const float*>(&ch);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // max(-inf, x) and min(inf, x) of the twin are x, NaN included
      float t0 = (plx[j] - r.ox) * r.ix, t1 = (phx[j] - r.ox) * r.ix;
      float t_near = min_nan(t0, t1);
      float t_far = max_nan(t0, t1);
      t0 = (ply[j] - r.oy) * r.iy;
      t1 = (phy[j] - r.oy) * r.iy;
      t_near = max_nan(t_near, min_nan(t0, t1));
      t_far = min_nan(t_far, max_nan(t0, t1));
      t0 = (plz[j] - r.oz) * r.iz;
      t1 = (phz[j] - r.oz) * r.iz;
      t_near = max_nan(t_near, min_nan(t0, t1));
      t_far = min_nan(t_far, max_nan(t0, t1));
      t_far = t_far * box_scale;
      const bool hit = (t_near <= t_far) && (t_far > 0.f) &&
                       (t_near < t_best);
      key[4 * h + j] = hit ? t_near : inf;
      val[4 * h + j] = __float_as_int(pch[j]);
      n_hit += hit ? 1 : 0;
      only = hit ? val[4 * h + j] : only;
    }
  }
  // nothing to order: no child to descend into, or exactly one
  if (n_hit <= 1) {
    val[0] = only;
    return n_hit;
  }
  // tpurt.render.intersect._SORT8 (Batcher odd-even merge, 8 inputs);
  // tests/test_torch_intersect.py holds this list equal to tpurt's
  CSWAP(0, 1) CSWAP(2, 3) CSWAP(4, 5) CSWAP(6, 7) CSWAP(0, 2)
  CSWAP(1, 3) CSWAP(4, 6) CSWAP(5, 7) CSWAP(1, 2) CSWAP(5, 6)
  CSWAP(0, 4) CSWAP(1, 5) CSWAP(2, 6) CSWAP(3, 7) CSWAP(2, 4)
  CSWAP(3, 5) CSWAP(1, 2) CSWAP(3, 4) CSWAP(5, 6)
  return n_hit;
}

// the 4 fused watertight triangle tests of group g (triangles 4g .. 4g+3)
// of a leaf record: the closest hit below t_best if it beats t_min, the
// lowest slot winning a tie as jnp.argmin does.  MOTION lerps every loaded
// vertex row to the ray's time first (v + time * dv, two roundings, the
// twin's order); the lerp is per component, so lerping the permuted rows
// equals permuting the lerped ones.
template <bool MOTION>
__device__ __forceinline__ void group_test(const float4* __restrict__ rec,
                                           const float4* __restrict__ drec,
                                           int g, const Ray& r, float t_best,
                                           float& t_min, int& k_best,
                                           float& bb0, float& bb1) {
  float4 v[9];  // permuted x, y, z rows of v0, v1, v2
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[3 * i + 0] = rec[9 * i + r.kx + g];
    v[3 * i + 1] = rec[9 * i + r.ky + g];
    v[3 * i + 2] = rec[9 * i + r.kz + g];
  }
  if (MOTION) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int at[3] = {9 * i + r.kx + g, 9 * i + r.ky + g,
                         9 * i + r.kz + g};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 dv = drec[at[c]];
        float4& w = v[3 * i + c];
        w.x = w.x + r.time * dv.x;
        w.y = w.y + r.time * dv.y;
        w.z = w.z + r.time * dv.z;
        w.w = w.w + r.time * dv.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // (v - o) permuted equals permuted v minus permuted o, bit for bit
    const float p0x = reinterpret_cast<const float*>(&v[0])[j] - r.opx;
    const float p0y = reinterpret_cast<const float*>(&v[1])[j] - r.opy;
    const float p0z = reinterpret_cast<const float*>(&v[2])[j] - r.opz;
    const float p1x = reinterpret_cast<const float*>(&v[3])[j] - r.opx;
    const float p1y = reinterpret_cast<const float*>(&v[4])[j] - r.opy;
    const float p1z = reinterpret_cast<const float*>(&v[5])[j] - r.opz;
    const float p2x = reinterpret_cast<const float*>(&v[6])[j] - r.opx;
    const float p2y = reinterpret_cast<const float*>(&v[7])[j] - r.opy;
    const float p2z = reinterpret_cast<const float*>(&v[8])[j] - r.opz;
    const float x0 = p0x + r.sx * p0z, y0 = p0y + r.sy * p0z;
    const float x1 = p1x + r.sx * p1z, y1 = p1y + r.sy * p1z;
    const float x2 = p2x + r.sx * p2z, y2 = p2y + r.sy * p2z;
    const float e0 = x1 * y2 - y1 * x2;
    const float e1 = x2 * y0 - y2 * x0;
    const float e2 = x0 * y1 - y0 * x1;
    const bool same_sign = (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) ||
                           (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f);
    const float det = e0 + e1 + e2;
    const float t_scaled = (e0 * p0z + e1 * p1z + e2 * p2z) * r.sz;
    const float tmd = t_best * det;
    const bool t_ok = det < 0.f ? (t_scaled <= 0.f && t_scaled > tmd)
                                : (t_scaled >= 0.f && t_scaled < tmd);
    if (same_sign && det != 0.f && t_ok) {
      const float inv_det = 1.f / det;
      const float t = t_scaled * inv_det;
      if (t < t_min) {  // strict: the lowest slot wins a tie
        t_min = t;
        k_best = 4 * g + j;
        bb0 = e0 * inv_det;
        bb1 = e1 * inv_det;
      }
    }
  }
}

// ---- K1m / K1km: the motion leaf's group cull ----
// The box rows (render/intersect.py:motion_group_boxes, 64 floats a leaf
// beside its delta rows) hold, for each group of 4 triangles, the min and
// max of its 12 vertices' start coordinates and of their deltas, by axis:
// [min v xyz, max v xyz, min dv xyz, max dv xyz] in 3 float4, group g at
// float4 3g.  A NaN first float marks a group of pads.
//
// Why a cull: frame E's meshes move many triangle widths over the shutter
// and the tree is built over their motion-union boxes, so a ray crosses the
// swept box of many triangles that sit elsewhere at its own time.  Without
// it, each live group cost its 18 float4 loads, 36 lerps and 4 watertight
// tests (~350 operations); the cull (~70 operations, 3 float4) keeps 18% of
// the live groups on E's camera rays (0.99 of 5.52 a ray, counted by the
// twin's "groups_near" on 2^15 of them), and none in which the twin hits.
//
// Why it never drops a group the twin hits (motion_group_cull, its plain
// copy op for op, argues each step):
//   - the lerp: lo(tau) = min v + min(tau * min dv, tau * max dv), hi(tau)
//     to match, rounded as the twin rounds v + tau * dv (-fmad=false).
//     Rounding to nearest is monotone, so every lerped vertex the twin
//     computes lies in [lo, hi] exactly, at any tau: tpurt lerps by the raw
//     shutter time, which may lie outside [0, 1] (the min and max of the
//     two products cover a negative tau);
//   - the watertight test accepts a ray that passes a few ulps of |v - o|
//     outside the triangle (the permuted differences, the shear and the
//     edge functions each round once or twice) and places its t a few
//     ulps of |v - o| along the ray from the point it meets, |v - o| <= B =
//     the largest |coordinate| of the lerped box plus that of o.  The box
//     is padded by MCULL_REL * B + MCULL_ABS: 2^12 ulps of B, a wide margin
//     over both; the ray's point at the twin's t (or at t_best, where that
//     t rounds below it) lies in the padded box;
//   - the slab test: a slab t rounds three times (difference, 1/d,
//     product), within gamma(3) of exact and of the exact sign; the far
//     limit and t_best are scaled by MCULL_T = 1 + 2^-16, and t_far = 0 is
//     kept.  A NaN slab value (0 * inf: a zero direction component in the
//     plane of a face) fails every comparison that drops a group.
// Out of scope: a cull of interior children by a time-lerped box.  It
// would skip pushes, so the stack would no longer match the twin's when
// stack_depth overflows, and bit-equality under a short stack would be lost.
#define TPURT_GROUPS 3       // groups of 4 triangles a leaf
#define TPURT_BOX_ROW4 16    // float4 per motion box row (256 B)
#define MCULL_REL 0x1p-12f   // must equal MCULL_* in render/intersect.py
#define MCULL_ABS 0x1p-100f
#define MCULL_T (1.f + 0x1p-16f)

// can group `box` (3 float4) hold a hit of the ray (origin o, 1/d inv)
// at time tau, over (0, t_best]?  Never for a group of pads.
__device__ __forceinline__ bool group_near(const float4* __restrict__ box,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float tau, float t_best) {
  const float4 a = box[0], b = box[1], c = box[2];
  if (a.x != a.x) return false;  // a group of pads: its twin never hits
  const float tlx = tau * b.z, tly = tau * b.w, tlz = tau * c.x;
  const float thx = tau * c.y, thy = tau * c.z, thz = tau * c.w;
  const float lx = a.x + min_nan(tlx, thx), ly = a.y + min_nan(tly, thy),
              lz = a.z + min_nan(tlz, thz);
  const float hx = a.w + max_nan(tlx, thx), hy = b.x + max_nan(tly, thy),
              hz = b.y + max_nan(tlz, thz);
  const float big = max_nan(
      max_nan(max_nan(fabsf(lx), fabsf(ly)), fabsf(lz)),
      max_nan(max_nan(fabsf(hx), fabsf(hy)), fabsf(hz)));
  const float big_o = max_nan(max_nan(fabsf(ox), fabsf(oy)), fabsf(oz));
  const float pad = (big + big_o) * MCULL_REL + MCULL_ABS;
  float t0 = ((lx - pad) - ox) * ix, t1 = ((hx + pad) - ox) * ix;
  float t_near = min_nan(t0, t1), t_far = max_nan(t0, t1);
  t0 = ((ly - pad) - oy) * iy;
  t1 = ((hy + pad) - oy) * iy;
  t_near = max_nan(t_near, min_nan(t0, t1));
  t_far = min_nan(t_far, max_nan(t0, t1));
  t0 = ((lz - pad) - oz) * iz;
  t1 = ((hz + pad) - oz) * iz;
  t_near = max_nan(t_near, min_nan(t0, t1));
  t_far = min_nan(t_far, max_nan(t0, t1));
  return !(t_near > t_far * MCULL_T || t_far < 0.f ||
           t_near > t_best * MCULL_T);
}

// 12 fused watertight triangle tests of a leaf record, 4 per float4 group,
// on one lane: the closest hit below t_best, the lowest slot winning a tie
// as jnp.argmin does.  MOTION (K1km) lerps to the ray's time and first
// skips the groups that group_near rules out (box: the leaf's box row).
template <bool MOTION>
__device__ __forceinline__ void leaf_test(const float4* __restrict__ rec,
                                          const float4* __restrict__ drec,
                                          const float4* __restrict__ box,
                                          const Ray& r, float t_best,
                                          float& t_min, int& k_best,
                                          float& bb0, float& bb1) {
#pragma unroll 1
  for (int g = 0; g < 3; ++g) {
    if (MOTION) {
      if (!group_near(box + 3 * g, r.ox, r.oy, r.oz, r.ix, r.iy, r.iz,
                      r.time, t_best))
        continue;
    } else if (g > 0) {
      // triangles fill a leaf from slot 0, so the later groups are often
      // pads; a triangle whose v0.x is NaN is hit by no ray
      const float4 x = rec[g];  // v0.x of triangles 4g .. 4g+3
      if (x.x != x.x && x.y != x.y && x.z != x.z && x.w != x.w) continue;
    }
    group_test<MOTION>(rec, drec, g, r, t_best, t_min, k_best, bb0, bb1);
  }
}

// ---- K1m: the motion leaf turn, spread over the warp ----
// A motion leaf turn lists the (ray, group) jobs of every lane that sits
// on a leaf, 3 a lane, runs each job's group_near on a lane of its own
// (pad groups fail it), lists the jobs that pass in per-warp shared memory
// and tests them a group a lane (the lerp and 4 watertight tests); each
// group's result goes to a (group, owner) cell, and the owner keeps the
// closest in group order, with the twin's strict <.
// Why: the body it replaces ran, on each leaf lane alone, the lerp and the
// 4 tests of every live group of its leaf (5.5 groups a camera ray of frame
// E) while the warp's other lanes waited; after the cull a ray has ~1
// group to test, and the warp tests its leaf lanes' survivors together.
// Measured (NVIDIA H100 80GB HBM3, 700 W, tpurt_torch/kernels/k1_ab.py on
// frame E's triangle calls, camera / bounce / shadow rays, per launch in
// bursts, medians of 2, each run paired against the parent's body, which
// took 0.81-0.82 / 0.68 / 0.46-0.47 ms; PERF.md section 6): this design
// 0.6327 / 0.4961 / 0.3572 ms; the same with a load of each lane's box
// row first to list only its live groups, 0.6538 / 0.5167 / 0.3698; the
// cull alone, on each leaf lane in leaf_test<true> (as K1km runs it),
// 0.6954 / 0.5527 / 0.4131, and at 5 blocks an SM both it and the warp's
// turn 0.668 / 0.53 / 0.38-0.39.  Turn rules (each against this design's
// majority rule, 0.6383 / 0.4957 / 0.3644 in the same run): the leaf body
// only when leaf lanes number twice the interior ones, 0.6489 / 0.5024 /
// 0.3684, or half, 0.6479 / 0.5130 / 0.3706; the interior lanes every turn
// and the leaf turn at 16 or 8 leaf lanes (K1km's rule), 0.7215 / 0.5267 /
// 0.3908 and 0.6596 / 0.5078 / 0.3581.  What remains is the walk: K1's
// static body on the same tree and rays (their start vertices, every
// triangle tested) takes 0.7679 / 0.5677 / 0.3713 ms.
struct MotionWarp {
  unsigned char job[TPURT_GROUPS * 32];   // (owner lane << 2) | group
  unsigned char near[TPURT_GROUPS * 32];  // the jobs that pass the cull
  // each (group, owner lane)'s closest hit: t (inf: none), slot, b0, b1
  float res_t[TPURT_GROUPS][32], res_b0[TPURT_GROUPS][32],
      res_b1[TPURT_GROUPS][32];
  int res_k[TPURT_GROUPS][32];
};

// One motion leaf turn of the warp (every lane calls it): on_leaf lanes
// hold the leaf row `row` of `leaves` (its delta rows in `delta`, its box
// row in `boxes`).  Returns on each such lane the closest hit below t_best
// as leaf_test<true> would: t_min, its slot, b0 and b1.
__device__ __forceinline__ void motion_leaf_turn(
    bool on_leaf, int row, const float4* __restrict__ leaves,
    const float4* __restrict__ delta, const float4* __restrict__ boxes,
    const Ray& r, float t_best, int lane, MotionWarp& sh, float& t_min,
    int& k_best, float& bb0, float& bb1) {
  const float inf = __int_as_float(0x7f800000);
  // every group of every leaf lane is a job; the cull drops pad groups
  // (a load here to skip them first would cost a dependent round trip)
  const unsigned leaf_lanes = __ballot_sync(FULL, on_leaf);
  const int total = TPURT_GROUPS * __popc(leaf_lanes);
  if (on_leaf) {
    const int at = TPURT_GROUPS * __popc(leaf_lanes & ((1u << lane) - 1u));
#pragma unroll
    for (int g = 0; g < TPURT_GROUPS; ++g) {
      sh.job[at + g] = (unsigned char)((lane << 2) | g);
      sh.res_t[g][lane] = inf;
    }
  }
  __syncwarp();
  // the cull, a job a lane
  int nq = 0;  // jobs that pass (warp-uniform)
  for (int j0 = 0; j0 < total; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < total;
    const int code = valid ? sh.job[j] : 0;
    const int owner = code >> 2;
    const float ox = __shfl_sync(FULL, r.ox, owner);
    const float oy = __shfl_sync(FULL, r.oy, owner);
    const float oz = __shfl_sync(FULL, r.oz, owner);
    const float ix = __shfl_sync(FULL, r.ix, owner);
    const float iy = __shfl_sync(FULL, r.iy, owner);
    const float iz = __shfl_sync(FULL, r.iz, owner);
    const float tau = __shfl_sync(FULL, r.time, owner);
    const float tb = __shfl_sync(FULL, t_best, owner);
    const int orow = __shfl_sync(FULL, row, owner);
    const bool keep =
        valid && group_near(boxes + (size_t)orow * TPURT_BOX_ROW4 +
                                3 * (code & 3),
                            ox, oy, oz, ix, iy, iz, tau, tb);
    const unsigned km = __ballot_sync(FULL, keep);
    if (keep) sh.near[nq + __popc(km & ((1u << lane) - 1u))] = code;
    nq += __popc(km);
  }
  __syncwarp();
  // the groups that pass, a group a lane
  for (int j0 = 0; j0 < nq; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < nq;
    const int code = valid ? sh.near[j] : 0;
    const int owner = code >> 2, g = code & 3;
    Ray q;  // the owner's ray, as group_test reads it
    q.opx = __shfl_sync(FULL, r.opx, owner);
    q.opy = __shfl_sync(FULL, r.opy, owner);
    q.opz = __shfl_sync(FULL, r.opz, owner);
    q.sx = __shfl_sync(FULL, r.sx, owner);
    q.sy = __shfl_sync(FULL, r.sy, owner);
    q.sz = __shfl_sync(FULL, r.sz, owner);
    const int perm =
        __shfl_sync(FULL, r.kx | (r.ky << 4) | (r.kz << 8), owner);
    q.kx = perm & 15;
    q.ky = (perm >> 4) & 15;
    q.kz = perm >> 8;
    q.time = __shfl_sync(FULL, r.time, owner);
    const float tb = __shfl_sync(FULL, t_best, owner);
    const int orow = __shfl_sync(FULL, row, owner);
    if (valid) {
      float t = inf, b0 = 0.f, b1 = 0.f;
      int k = 0;
      group_test<true>(leaves + (size_t)orow * TPURT_LEAF_ROW4,
                       delta + (size_t)orow * TPURT_LEAF_ROW4, g, q, tb, t,
                       k, b0, b1);
      sh.res_t[g][owner] = t;
      sh.res_k[g][owner] = k;
      sh.res_b0[g][owner] = b0;
      sh.res_b1[g][owner] = b1;
    }
  }
  __syncwarp();
  if (on_leaf) {
    // strict <: the lowest slot wins a tie, as the twin's argmin
#pragma unroll
    for (int g = 0; g < TPURT_GROUPS; ++g) {
      const float t = sh.res_t[g][lane];
      if (t < t_min) {
        t_min = t;
        k_best = sh.res_k[g][lane];
        bb0 = sh.res_b0[g][lane];
        bb1 = sh.res_b1[g][lane];
      }
    }
  }
  __syncwarp();  // the next turn rewrites the warp's lists and cells
}

// ---- K1c: the curve leaf turn, spread over the warp ----
// A curve leaf turn enumerates the (ray, live span) jobs of every lane that
// sits on a leaf, runs each job's ray frame, projection and cull on a lane
// of its own, queues the spans that pass in per-warp shared memory and
// tests them (span, sub-segment) a lane, 4 spans a warp pass; a segmented
// minimum returns each span's result to its owner, which keeps the closest
// in slot order.
// Why: the body it replaces ran, on each leaf lane alone, all 8 spans' 8
// sub-segments (~13,000 operations a leaf) while the warp's other lanes
// waited, though on frame E's rays only 14-17% of the live spans pass the
// hull cull (span_near below, the test pbrt makes before its depth-0
// branch) and can be hit at all; culled or not, a span's frame and cull
// cost ~160 operations, its sub-segments ~1,500.  The queue keeps full
// warps on the sub-segment tests, 4 spans a pass, so a leaf turn costs ~2
// passes of the frame and cull and a pass of sub-segments per 4 surviving
// spans.
// Measured (NVIDIA H100 80GB HBM3, 700 W, tpurt_torch/kernels/k1_ab.py on
// frame E's five curve calls, per launch in bursts; PERF.md section 6): this
// design 0.7275 / 0.7544 / 0.9236 / 0.5834 / 0.7996 ms; the variant that
// queues 32 spans and runs each span's 8 sub-segments on one lane, with the
// weights compile-time constants (104 registers), 2.5541 / 2.1972 / 3.3232
// / 1.7615 / 2.7825 ms, no faster than the body it replaces: a surviving span's
// 8 sequential sub-segments on one lane cost a warp pass ~8x as long as
// the (span, sub-segment) pass, and a turn rarely fills 32 spans.  So the
// weights are computed in registers from q (exact, below), not loaded.
#define K1C_QCAP 36  // queued spans: fewer than 4 carried over + 32 new
#define K1C_QF 29    // floats a queued span, field-major in CurveWarp::q
#define QF_W0 12     // [0:12] rx[4], ry[4], rz[4]; then w0, w1
#define QF_W1 13
#define QF_N0 14     // ribbon normals n0 [14:17], n1 [17:20]
#define QF_ANG 20
#define QF_INVSIN 21
#define QF_D 22      // the owner ray's d [22:25], |d|, z limit
#define QF_DL 25
#define QF_ZLIM 26
#define QF_CODE 27   // (owner lane << 3) | slot, as int bits
#define QF_HASN 28   // 1 when the span's ribbon normal is set

struct CurveWarp {
  float q[K1C_QF][K1C_QCAP];
  // each (slot, owner lane)'s closest sub-segment: t (inf: none), s, v
  float res_t[TPURT_WIDTH][32], res_s[TPURT_WIDTH][32],
      res_v[TPURT_WIDTH][32];
  unsigned short job[TPURT_WIDTH * 32];  // (owner lane << 3) | slot
};

// the span cull's pads; curve_span_cull in render/intersect.py (its plain
// copy, op for op) argues why no span the twin hits is dropped: blossom
// weights are non-negative and sum to 1, so every sub-segment point lies in
// the hull of the 4 projected control points, ~20 ulps of the span's
// largest |coordinate| out after rounding (padded by 64, plus 2^-140
// against subnormal sums); the half-width is at most max(|w0|, |w1|) / 2, a
// ribbon's factor at most (|n0| + |n1|) (1 on the linear branch, else
// |1/sin(angle)| if larger); the radius is padded by 2^-16 relative and
// 2^-61 absolute (dist^2 <= hw^2 / 4 rounding or underflowing)
#define CULL_HULL_REL 0x1p-18f
#define CULL_HULL_ABS 0x1p-140f
#define CULL_R_REL (1.f + 0x1p-16f)
#define CULL_R_ABS 0x1p-61f

// pbrt's bounding test ahead of recursiveIntersect's depth-0 branch
// (curve.cpp), which tpurt's jnp code omits: can a sub-segment of this
// span pass the width and depth tests below z_lim?  n0 / n1: the ribbon
// normals' squared lengths (has_n when n0 > 0.5).
__device__ __forceinline__ bool span_near(const float* rx, const float* ry,
                                          const float* rz, float w0,
                                          float w1, bool ribbon, float n0,
                                          float n1, float ang,
                                          float inv_sin, float z_lim) {
  float big = fabsf(rx[0]);
#pragma unroll
  for (int i = 1; i < 4; ++i) big = max_nan(big, fabsf(rx[i]));
#pragma unroll
  for (int i = 0; i < 4; ++i) big = max_nan(big, fabsf(ry[i]));
#pragma unroll
  for (int i = 0; i < 4; ++i) big = max_nan(big, fabsf(rz[i]));
  const float pad = big * CULL_HULL_REL + CULL_HULL_ABS;
  const float xlo = min_nan(min_nan(rx[0], rx[1]), min_nan(rx[2], rx[3])) - pad;
  const float xhi = max_nan(max_nan(rx[0], rx[1]), max_nan(rx[2], rx[3])) + pad;
  const float ylo = min_nan(min_nan(ry[0], ry[1]), min_nan(ry[2], ry[3])) - pad;
  const float yhi = max_nan(max_nan(ry[0], ry[1]), max_nan(ry[2], ry[3])) + pad;
  const float zlo = min_nan(min_nan(rz[0], rz[1]), min_nan(rz[2], rz[3])) - pad;
  const float zhi = max_nan(max_nan(rz[0], rz[1]), max_nan(rz[2], rz[3])) + pad;
  const float gx = max_nan(max_nan(xlo, -xhi), 0.f);
  const float gy = max_nan(max_nan(ylo, -yhi), 0.f);
  float half = max_nan(fabsf(w0), fabsf(w1)) * 0.5f;
  if (ribbon && n0 > 0.5f) {
    const float slerp = ang < 1e-4f ? 1.f : max_nan(fabsf(inv_sin), 1.f);
    half = half * ((sqrtf(n0) + sqrtf(n1)) * slerp);
  }
  const float rad = half * CULL_R_REL + CULL_R_ABS;
  return gx <= rad && gy <= rad && gx * gx + gy * gy <= rad * rad &&
         zhi > 0.f && zlo < z_lim;
}

// BlossomBezier's weights of the 4 control points at (u1, u2, u3)
// (curve.cpp:43-53).  For the sub-segment ends a = q / 8 and b = a + 1 / 8
// every product and sum is a multiple of 2^-9 below 4, so each weight is
// exact and equal to the twin's CURVE_W rounded to f32.
__device__ __forceinline__ void blossom_w(float u1, float u2, float u3,
                                          float* w) {
  const float v1 = 1.f - u1, v2 = 1.f - u2, v3 = 1.f - u3;
  w[0] = v1 * v2 * v3;
  w[1] = u1 * v2 * v3 + v1 * u2 * v3 + v1 * v2 * u3;
  w[2] = u1 * u2 * v3 + u1 * v2 * u3 + v1 * u2 * u3;
  w[3] = u1 * u2 * u3;
}

// sub-segment q of queued span e through pbrt's depth-0 width test
// (curve.cpp:289-373), op for op as the twin's _curve_bundle_test; t is
// inf when it is not hit
__device__ __forceinline__ void sub_segment_test(const CurveWarp& sh, int e,
                                                 int q, float& t_out,
                                                 float& s_out, float& v_out) {
  const float inf = __int_as_float(0x7f800000);
  float rx[4], ry[4], rz[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rx[i] = sh.q[i][e];
    ry[i] = sh.q[4 + i][e];
    rz[i] = sh.q[8 + i][e];
  }
  const float a = q * (1.f / TPURT_CURVE_SUB);
  const float b = (q + 1) * (1.f / TPURT_CURVE_SUB);
  float w[4][4];
  blossom_w(a, a, a, w[0]);
  blossom_w(a, a, b, w[1]);
  blossom_w(a, b, b, w[2]);
  blossom_w(b, b, b, w[3]);
  float sx[4], sy[4], sz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // sum(w[k][m] * r[m]) from the left, as the twin's sum()
    float ax = w[k][0] * rx[0], ay = w[k][0] * ry[0], az = w[k][0] * rz[0];
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      ax = ax + w[k][m] * rx[m];
      ay = ay + w[k][m] * ry[m];
      az = az + w[k][m] * rz[m];
    }
    sx[k] = ax;
    sy[k] = ay;
    sz[k] = az;
  }
  // endpoint tangent-perpendicular culling (curve.cpp:294-301)
  const bool e_ok0 =
      (sy[1] - sy[0]) * (-sy[0]) + sx[0] * (sx[0] - sx[1]) >= 0.f;
  const bool e_ok1 =
      (sy[2] - sy[3]) * (-sy[3]) + sx[3] * (sx[3] - sx[2]) >= 0.f;
  // closest-point parameter on the chord (curve.cpp:303-307)
  const float cdx = sx[3] - sx[0], cdy = sy[3] - sy[0];
  const float denom = cdx * cdx + cdy * cdy;
  const bool den_ok = denom > 0.f;
  const float wp = -(sx[0] * cdx + sy[0] * cdy) / (den_ok ? denom : 1.f);
  const float s = min_nan(max_nan(a + (1.f / TPURT_CURVE_SUB) * wp, a), b);
  const float w0 = sh.q[QF_W0][e], w1 = sh.q[QF_W1][e];
  const float dl = sh.q[QF_DL][e];
  float hw = w0 + (w1 - w0) * s;
  if (sh.q[QF_HASN][e] != 0.f) {
    // ribbon: the slerped normal's projection on the ray (curve.cpp:313-321)
    const float ang = sh.q[QF_ANG][e], inv_sin = sh.q[QF_INVSIN][e];
    const bool small = ang < 1e-4f;
    const float s0 = small ? 1.f - s : sinf((1.f - s) * ang) * inv_sin;
    const float s1 = small ? s : sinf(s * ang) * inv_sin;
    const float nhx = s0 * sh.q[QF_N0][e] + s1 * sh.q[QF_N0 + 3][e];
    const float nhy = s0 * sh.q[QF_N0 + 1][e] + s1 * sh.q[QF_N0 + 4][e];
    const float nhz = s0 * sh.q[QF_N0 + 2][e] + s1 * sh.q[QF_N0 + 5][e];
    hw = hw * (fabsf(nhx * sh.q[QF_D][e] + nhy * sh.q[QF_D + 1][e] +
                     nhz * sh.q[QF_D + 2][e]) / dl);
  }
  // the sub-segment at clamp(wp, 0, 1), with its derivative
  const float ww = min_nan(max_nan(wp, 0.f), 1.f);
  float c1x[3], c1y[3], c1z[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c1x[i] = sx[i] + ww * (sx[i + 1] - sx[i]);
    c1y[i] = sy[i] + ww * (sy[i + 1] - sy[i]);
    c1z[i] = sz[i] + ww * (sz[i + 1] - sz[i]);
  }
  const float c2x0 = c1x[0] + ww * (c1x[1] - c1x[0]);
  const float c2x1 = c1x[1] + ww * (c1x[2] - c1x[1]);
  const float c2y0 = c1y[0] + ww * (c1y[1] - c1y[0]);
  const float c2y1 = c1y[1] + ww * (c1y[2] - c1y[1]);
  const float c2z0 = c1z[0] + ww * (c1z[1] - c1z[0]);
  const float c2z1 = c1z[1] + ww * (c1z[2] - c1z[1]);
  const float pcx = c2x0 + ww * (c2x1 - c2x0);
  const float pcy = c2y0 + ww * (c2y1 - c2y0);
  const float pcz = c2z0 + ww * (c2z1 - c2z0);
  float dvx = c2x1 - c2x0, dvy = c2y1 - c2y0;
  if (dvx * dvx + dvy * dvy == 0.f) {  // EvalBezier fallback
    dvx = sx[3] - sx[0];
    dvy = sy[3] - sy[0];
  }
  const float dist2 = pcx * pcx + pcy * pcy;
  const bool ok = e_ok0 && e_ok1 && den_ok && dist2 <= hw * hw * 0.25f &&
                  pcz > 0.f && pcz < sh.q[QF_ZLIM][e];
  const float t_q = pcz / dl;
  t_out = ok ? t_q : inf;
  s_out = s;
  const float dist = sqrtf(dist2);
  const float hwc = max_nan(hw, 1e-20f);
  const float edge_f = dvx * (-pcy) + pcx * dvy;
  v_out = edge_f > 0.f ? 0.5f + dist / hwc : 0.5f - dist / hwc;
}

// queued spans base .. base+count-1 (count <= 4), a span to each 8 lanes,
// sub-segment q = lane & 7; the closest sub-segment wins, the lowest q on a
// tie (the twin's strict < in q order), and goes to the span's owner slot
__device__ __forceinline__ void test_queued(CurveWarp& sh, int base,
                                            int count, int lane) {
  const float inf = __int_as_float(0x7f800000);
  const int g = lane >> 3, q = lane & 7;
  const bool act = g < count;
  const int e = base + (act ? g : 0);
  float t = inf, s = 0.f, v = 0.f;
  if (act) sub_segment_test(sh, e, q, t, s, v);
  int qq = q;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float t2 = __shfl_xor_sync(FULL, t, off);
    const int q2 = __shfl_xor_sync(FULL, qq, off);
    const float s2 = __shfl_xor_sync(FULL, s, off);
    const float v2 = __shfl_xor_sync(FULL, v, off);
    if (t2 < t || (t2 == t && q2 < qq)) {
      t = t2;
      qq = q2;
      s = s2;
      v = v2;
    }
  }
  if (act && q == 0) {
    const int code = __float_as_int(sh.q[QF_CODE][e]);
    sh.res_t[code & 7][code >> 3] = t;
    sh.res_s[code & 7][code >> 3] = s;
    sh.res_v[code & 7][code >> 3] = v;
  }
  __syncwarp();
}

// One curve leaf turn of the warp (every lane calls it): on_leaf lanes hold
// the leaf row `row` of `leaves` (ribbon rows in `aux`, or null).  Returns on
// each such lane the closest span hit below t_best as the twin's
// _curve_bundle_test + argmin would: t_min, its slot, and s / v in bb0 / bb1.
__device__ __forceinline__ void curve_leaf_turn(
    bool on_leaf, int row, const float4* __restrict__ leaves,
    const float4* __restrict__ aux, const Ray& r, float t_best, int lane,
    CurveWarp& sh, float& t_min, int& k_best, float& bb0, float& bb1) {
  const float inf = __int_as_float(0x7f800000);
  // this lane's live spans (pads: cp0.x is NaN; such a span never hits)
  unsigned live = 0;
  if (on_leaf) {
    const float4* rec = leaves + (size_t)row * TPURT_LEAF_ROW4;
    const float4 x0 = rec[0], x1 = rec[1];
    live = (x0.x == x0.x ? 1u : 0u) | (x0.y == x0.y ? 2u : 0u) |
           (x0.z == x0.z ? 4u : 0u) | (x0.w == x0.w ? 8u : 0u) |
           (x1.x == x1.x ? 16u : 0u) | (x1.y == x1.y ? 32u : 0u) |
           (x1.z == x1.z ? 64u : 0u) | (x1.w == x1.w ? 128u : 0u);
#pragma unroll
    for (int k = 0; k < TPURT_WIDTH; ++k) sh.res_t[k][lane] = inf;
  }
  const int cnt = __popc(live);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  {
    int at = incl - cnt;
    for (unsigned m = live; m; m &= m - 1)
      sh.job[at++] = (unsigned short)((lane << 3) | (__ffs(m) - 1));
  }
  const float z_lim = r.dl * t_best;
  __syncwarp();
  int nq = 0;  // queued spans (warp-uniform)
  for (int j0 = 0; j0 < total; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < total;
    const int code = valid ? sh.job[j] : 0;
    const int owner = code >> 3, slot = code & 7;
    // the owner's ray
    const float ox = __shfl_sync(FULL, r.ox, owner);
    const float oy = __shfl_sync(FULL, r.oy, owner);
    const float oz = __shfl_sync(FULL, r.oz, owner);
    const float dx = __shfl_sync(FULL, r.dx, owner);
    const float dy = __shfl_sync(FULL, r.dy, owner);
    const float dz = __shfl_sync(FULL, r.dz, owner);
    const float dl = __shfl_sync(FULL, r.dl, owner);
    const float hx = __shfl_sync(FULL, r.hx, owner);
    const float hy = __shfl_sync(FULL, r.hy, owner);
    const float hz = __shfl_sync(FULL, r.hz, owner);
    const float zl = __shfl_sync(FULL, z_lim, owner);
    const int orow = __shfl_sync(FULL, row, owner);
    bool keep = false;
    float rx[4], ry[4], rz[4], w0 = 0.f, w1 = 0.f;
    float nv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    bool has_n = false;
    if (valid) {
      const float* f = reinterpret_cast<const float*>(
          leaves + (size_t)orow * TPURT_LEAF_ROW4);
      float c[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) c[i] = f[TPURT_WIDTH * i + slot];
      w0 = f[12 * TPURT_WIDTH + slot];
      w1 = f[13 * TPURT_WIDTH + slot];
      // "up" = cross(d, cp3 - cp0); degenerate -> CoordinateSystem(d)
      const float v30x = c[9] - c[0], v30y = c[10] - c[1],
                  v30z = c[11] - c[2];
      float ux = dy * v30z - dz * v30y;
      float uy = dz * v30x - dx * v30z;
      float uz = dx * v30y - dy * v30x;
      if (ux * ux + uy * uy + uz * uz < 1e-18f) {
        const bool pick = fabsf(dx) > fabsf(dy);
        ux = pick ? -dz : 0.f;
        uy = pick ? 0.f : dz;
        uz = pick ? dx : -dy;
      }
      // x = normalize(cross(up, dhat)); y = cross(dhat, x)
      float xx = uy * hz - uz * hy;
      float xy = uz * hx - ux * hz;
      float xz = ux * hy - uy * hx;
      const float xl = max_nan(sqrtf(xx * xx + xy * xy + xz * xz), 1e-20f);
      xx = xx / xl;
      xy = xy / xl;
      xz = xz / xl;
      const float yx = hy * xz - hz * xy;
      const float yy = hz * xx - hx * xz;
      const float yz = hx * xy - hy * xx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qx = c[3 * i] - ox, qy = c[3 * i + 1] - oy,
                    qz = c[3 * i + 2] - oz;
        rx[i] = qx * xx + qy * xy + qz * xz;
        ry[i] = qx * yx + qy * yy + qz * yz;
        rz[i] = qx * hx + qy * hy + qz * hz;
      }
      float n0 = 0.f, n1 = 0.f;
      if (aux != nullptr) {
        const float* fa = reinterpret_cast<const float*>(
            aux + (size_t)orow * TPURT_AUX_ROW4);
#pragma unroll
        for (int i = 0; i < 8; ++i) nv[i] = fa[TPURT_WIDTH * i + slot];
        n0 = nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2];
        n1 = nv[3] * nv[3] + nv[4] * nv[4] + nv[5] * nv[5];
        has_n = n0 > 0.5f;
      }
      keep = span_near(rx, ry, rz, w0, w1, aux != nullptr, n0, n1, nv[6],
                       nv[7], zl);
    }
    const unsigned km = __ballot_sync(FULL, keep);
    if (keep) {
      const int e = nq + __popc(km & ((1u << lane) - 1u));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sh.q[i][e] = rx[i];
        sh.q[4 + i][e] = ry[i];
        sh.q[8 + i][e] = rz[i];
      }
      sh.q[QF_W0][e] = w0;
      sh.q[QF_W1][e] = w1;
      sh.q[QF_HASN][e] = has_n ? 1.f : 0.f;
      if (has_n) {
#pragma unroll
        for (int i = 0; i < 6; ++i) sh.q[QF_N0 + i][e] = nv[i];
        sh.q[QF_ANG][e] = nv[6];
        sh.q[QF_INVSIN][e] = nv[7];
        sh.q[QF_D][e] = dx;
        sh.q[QF_D + 1][e] = dy;
        sh.q[QF_D + 2][e] = dz;
      }
      sh.q[QF_DL][e] = dl;
      sh.q[QF_ZLIM][e] = zl;
      sh.q[QF_CODE][e] = __int_as_float(code);
    }
    nq += __popc(km);
    __syncwarp();
    // test full passes of 4 spans from the top of the queue; fewer than 4
    // wait for the next round
    while (nq >= 4) {
      nq -= 4;
      test_queued(sh, nq, 4, lane);
    }
  }
  if (nq > 0) test_queued(sh, 0, nq, lane);
  if (on_leaf) {
    // strict <: the lowest slot wins a tie, as the twin's argmin
#pragma unroll
    for (int k = 0; k < TPURT_WIDTH; ++k) {
      const float t = sh.res_t[k][lane];
      if (t < t_min) {
        t_min = t;
        k_best = k;
        bb0 = sh.res_s[k][lane];
        bb1 = sh.res_v[k][lane];
      }
    }
  }
  __syncwarp();  // the next turn rewrites the warp's job list
}

template <int LEAF>
__global__ void __launch_bounds__(
    TPURT_BLOCK, LEAF == TPURT_LEAF_CURVE    ? K1C_MINBLOCKS
                 : LEAF == TPURT_LEAF_MOTION ? K1M_MINBLOCKS
                                             : K1_MINBLOCKS)
traverse_wide_kernel(const float4* __restrict__ inodes, int n_inodes,
                     const float4* __restrict__ leaves,
                     int n_leaves, const float4* __restrict__ side,
                     const float4* __restrict__ boxes,
                     const float* __restrict__ time_in, int root_ref,
                     int step_limit,
                     const float* __restrict__ o_in,
                     const float* __restrict__ d_in,
                     const float* __restrict__ t_max_in, int n,
                     int stack_depth, int any_hit, float box_scale,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ b0_out, float* __restrict__ b1_out,
                     int* __restrict__ counter) {
  int stack[TPURT_STACK_MAX];  // local memory; only touched slots cost
  const int lane = threadIdx.x & 31;
  // the curve and motion bodies' per-warp job lists, queues and results:
  // dynamic shared memory, launched only with those bodies (K1 gets none)
  extern __shared__ float4 dyn_smem[];
  const float inf = __int_as_float(0x7f800000);

  Ray r;
  float t_best = 0.f, b0_best = 0.f, b1_best = 0.f;
  int prim_best = -1;
  int ray = -1;   // the ray this lane holds, -1 when none
  int cur = -1;   // its current reference, -1 when it is done
  int sp = 0, steps = 0;
  // the warp's pool of rays taken from the counter, and whether the
  // counter may hold more (all warp-uniform)
  int pool = 0, pool_end = 0;
  bool more = true;

  for (;;) {
    // ---- retire finished rays, fetch new ones ----
    if (cur < 0 && ray >= 0) {
      t_out[ray] = t_best;
      prim_out[ray] = prim_best;
      b0_out[ray] = b0_best;
      b1_out[ray] = b1_best;
      ray = -1;
    }
    unsigned alive = __ballot_sync(FULL, cur >= 0);
    if ((more || pool < pool_end) && __popc(alive) <= K1_REFILL) {
      const unsigned dead = ~alive;
      if (pool >= pool_end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(counter, K1_CHUNK);
        base = __shfl_sync(FULL, base, 0);
        more = base < n;
        pool = more ? base : 0;
        pool_end = more ? min(base + K1_CHUNK, n) : 0;
      }
      const int mine = pool + __popc(dead & ((1u << lane) - 1u));
      if (cur < 0 && mine < pool_end) {
        ray = mine;
        load_ray<LEAF>(r, o_in, d_in, time_in, ray);
        t_best = t_max_in[ray];
        prim_best = -1;
        b0_best = 0.f;
        b1_best = 0.f;
        sp = 0;
        steps = 0;
        cur = t_best > 0.f ? root_ref : -1;
      }
      pool = min(pool + __popc(dead), pool_end);
      alive = __ballot_sync(FULL, cur >= 0);
    }
    if (!alive) {
      if (!more && pool >= pool_end && !__any_sync(FULL, ray >= 0)) break;
      continue;
    }

    // ---- one turn: the body most live lanes want, never both ----
    const bool do_interior =
        __popc(__ballot_sync(FULL, cur >= 0 && !(cur & 1))) >=
        __popc(__ballot_sync(FULL, cur >= 0 && (cur & 1)));
    if (do_interior) {
      // interior records: 8 slab tests, near-first order, push and descend
      if (cur >= 0 && !(cur & 1)) {
        if ((cur >> 1) >= n_inodes) {  // malformed table
          cur = -1;
        } else {
          float key[TPURT_WIDTH];
          int val[TPURT_WIDTH];
          const int n_hit =
              interior_test(inodes + (size_t)(cur >> 1) * TPURT_INT_ROW4, r,
                            t_best, box_scale, key, val);
          int nxt;
          if (n_hit > 0) {
            // push hit children 1..n_hit-1 far-to-near above the old top
            // (intersect.py:1010-1016); descend into the nearest, no push
#pragma unroll
            for (int k = 1; k < TPURT_WIDTH; ++k) {
              const int pos = sp + n_hit - 1 - k;
              if (k < n_hit && pos < stack_depth) stack[pos] = val[k];
            }
            sp += n_hit - 1;
            nxt = val[0];
          } else if (sp > 0) {
            // slots past stack_depth read as row 0 (the root), like the
            // twin's one-hot read
            nxt = (sp - 1 < stack_depth) ? stack[sp - 1] : root_ref;
            --sp;
          } else {
            nxt = -1;
          }
          // a tree visits each record at most once, so a lane never needs
          // more steps than there are records; the bound only guards
          // against a malformed table (or an overflowed stack) hanging the
          // card
          if (++steps > step_limit) nxt = -1;
          cur = nxt;
        }
      }
    } else if (LEAF != TPURT_LEAF_TRI) {
      // curve or motion leaf records: the whole warp tests the leaf lanes'
      // spans or triangle groups
      if (cur >= 0 && (cur & 1) && (cur >> 1) >= n_leaves) cur = -1;
      const bool on_leaf = cur >= 0 && (cur & 1);
      const int row = on_leaf ? (cur >> 1) : 0;
      float t_min = inf, bb0 = 0.f, bb1 = 0.f;
      int k_best = 0;
      if (LEAF == TPURT_LEAF_CURVE)
        curve_leaf_turn(
            on_leaf, row, leaves, side, r, t_best, lane,
            reinterpret_cast<CurveWarp*>(dyn_smem)[threadIdx.x >> 5], t_min,
            k_best, bb0, bb1);
      else
        motion_leaf_turn(
            on_leaf, row, leaves, side, boxes, r, t_best, lane,
            reinterpret_cast<MotionWarp*>(dyn_smem)[threadIdx.x >> 5], t_min,
            k_best, bb0, bb1);
      if (on_leaf) {
        if (t_min < t_best) {
          t_best = t_min;
          prim_best = reinterpret_cast<const int*>(
              leaves + (size_t)row * TPURT_LEAF_ROW4)[
                  (LEAF == TPURT_LEAF_CURVE ? 112 : 108) + k_best];
          b0_best = bb0;
          b1_best = bb1;
        }
        int nxt;
        if (sp > 0) {
          nxt = (sp - 1 < stack_depth) ? stack[sp - 1] : root_ref;
          --sp;
        } else {
          nxt = -1;
        }
        if (any_hit && prim_best >= 0) nxt = -1;
        if (++steps > step_limit) nxt = -1;
        cur = nxt;
      }
    } else if (cur >= 0 && (cur & 1)) {
      // leaf records: the 12-triangle test
      if ((cur >> 1) >= n_leaves) {  // malformed table
        cur = -1;
      } else {
        const size_t row = (size_t)(cur >> 1);
        const float4* rec = leaves + row * TPURT_LEAF_ROW4;
        float t_min = inf, bb0 = 0.f, bb1 = 0.f;
        int k_best = 0;
        leaf_test<LEAF == TPURT_LEAF_MOTION>(
            rec,
            LEAF == TPURT_LEAF_MOTION ? side + row * TPURT_LEAF_ROW4
                                      : nullptr,
            LEAF == TPURT_LEAF_MOTION ? boxes + row * TPURT_BOX_ROW4
                                      : nullptr,
            r, t_best, t_min, k_best, bb0, bb1);
        if (t_min < t_best) {
          t_best = t_min;
          prim_best = reinterpret_cast<const int*>(rec)[108 + k_best];
          b0_best = bb0;
          b1_best = bb1;
        }
        int nxt;
        if (sp > 0) {
          nxt = (sp - 1 < stack_depth) ? stack[sp - 1] : root_ref;
          --sp;
        } else {
          nxt = -1;
        }
        if (any_hit && prim_best >= 0) nxt = -1;
        if (++steps > step_limit) nxt = -1;
        cur = nxt;
      }
    }
  }
}

// as many blocks as the card holds at once (they share the ray counter),
// asked once per device and kernel (a benign race: every thread writes the
// same value); returns a cudaError_t
static int fit_grid(const void* kernel, int* resident, int n, size_t smem,
                    int* blocks) {
  *blocks = (n + TPURT_BLOCK - 1) / TPURT_BLOCK;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          TPURT_BLOCK, smem);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = sms * (per_sm < 1 ? 1 : per_sm);
  }
  if (*blocks > resident[dev]) *blocks = resident[dev];
  return (int)cudaSuccess;
}

template <int LEAF>
static int launch(const float* inodes, int n_inodes, const float* leaves,
                  int n_leaves, const float* side, const float* boxes,
                  const float* time,
                  int root_ref, int step_limit, const float* o,
                  const float* d, const float* t_max, int n,
                  int stack_depth, int any_hit, float box_scale,
                  float* t_out, int* prim_out, float* b0_out, float* b1_out,
                  int* counter, cudaStream_t s) {
  static int resident[64] = {0};
  // the curve and motion bodies' shared scratch: a CurveWarp or a
  // MotionWarp a warp
  const size_t smem =
      LEAF == TPURT_LEAF_CURVE    ? (TPURT_BLOCK / 32) * sizeof(CurveWarp)
      : LEAF == TPURT_LEAF_MOTION ? (TPURT_BLOCK / 32) * sizeof(MotionWarp)
                                  : 0;
  int blocks = 0;
  int err = fit_grid((const void*)traverse_wide_kernel<LEAF>, resident, n,
                     smem, &blocks);
  if (err != 0) return err;
  err = (int)cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != 0) return err;
  traverse_wide_kernel<LEAF><<<blocks, TPURT_BLOCK, smem, s>>>(
      reinterpret_cast<const float4*>(inodes), n_inodes,
      reinterpret_cast<const float4*>(leaves), n_leaves,
      reinterpret_cast<const float4*>(side),
      reinterpret_cast<const float4*>(boxes), time, root_ref, step_limit, o,
      d, t_max, n, stack_depth, any_hit, box_scale, t_out,
      prim_out, b0_out, b1_out, counter);
  return (int)cudaGetLastError();
}

// C entry point for ctypes.  leaf_kind picks the body (TPURT_LEAF_*):
// side is the delta table (K1m, required, with boxes, its group box rows,
// and time) or the ribbon aux table (K1c, null without ribbons).  Launches
// on `stream`, does not synchronise, allocates nothing (`counter` is one
// int of scratch, zeroed here on the stream); returns cudaGetLastError()
// (0 = launched).  step_limit is the host table's row count, the bound the
// plain twin uses.
extern "C" int tpurt_traverse_wide(int leaf_kind, const float* inodes,
                                   int n_inodes, const float* leaves,
                                   int n_leaves, const float* side,
                                   const float* boxes, const float* time,
                                   int root_ref,
                                   int step_limit, const float* o,
                                   const float* d, const float* t_max,
                                   int n, int stack_depth, int any_hit,
                                   float box_scale, float* t_out,
                                   int* prim_out, float* b0_out,
                                   float* b1_out, int* counter,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (stack_depth > TPURT_STACK_MAX || stack_depth < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (leaf_kind) {
    case TPURT_LEAF_TRI:
      return launch<TPURT_LEAF_TRI>(inodes, n_inodes, leaves, n_leaves,
                                    nullptr, nullptr, nullptr, root_ref,
                                    step_limit,
                                    o, d, t_max, n, stack_depth,
                                    any_hit, box_scale, t_out, prim_out,
                                    b0_out, b1_out, counter, s);
    case TPURT_LEAF_MOTION:
      if (side == nullptr || boxes == nullptr || time == nullptr)
        return (int)cudaErrorInvalidValue;
      return launch<TPURT_LEAF_MOTION>(inodes, n_inodes, leaves, n_leaves,
                                       side, boxes, time, root_ref,
                                       step_limit, o,
                                       d, t_max, n, stack_depth,
                                       any_hit, box_scale, t_out, prim_out,
                                       b0_out, b1_out, counter, s);
    case TPURT_LEAF_CURVE:
      return launch<TPURT_LEAF_CURVE>(inodes, n_inodes, leaves, n_leaves,
                                      side, nullptr, nullptr, root_ref,
                                      step_limit,
                                      o, d, t_max, n, stack_depth,
                                      any_hit, box_scale, t_out, prim_out,
                                      b0_out, b1_out, counter, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The kd walk: K1k (static triangles) and K1km (the motion delta rows)
// ---------------------------------------------------------------------------
// tpurt's kd traversal (_kd_init_state and _kd_step_fns,
// tpurt/render/intersect.py:1038-1162, the kd branch of _traverse_wide at
// :1236-1240) is jnp code, not a Pallas kernel; it runs under
// Accelerator "kdtree".  Tables (render/intersect.py:derive_kd_tables, from
// the record table of tpurt_torch/geom/kdtree.py, which the twin reads):
//   interior: one float4 a node, split, axis (i32), below and above
//     references (i32), in the builder's depth-first order;
//   leaf: the BVH leaf's 12-triangle bundle in [0:120] (K1's leaf_test
//     reads it), [124] the continuation's reference (i32, -1 = none), with
//     the motion delta rows beside them in the same order (K1km);
//   a reference is 2 * row + (1 for a leaf), so a lane knows a node's kind
//     before it reads it; root_ref is the root's.
// The root-bounds clip (its far t scaled by box_scale, _BOX_T_SCALE), then
// binary descent with a (node, tmin, tmax) interval stack of stack_depth
// slots: near child first (below when o < split, or o == split and
// d <= 0), the far child pushed with (tplane, tmax) when the plane lies
// inside the interval; a cell past the best hit pops; a leaf walks its
// continuation rows before popping; any-hit ends at the first hit.  The
// updates come in the twin's order (kernels/traverse.py:
// traverse_kd_reference), so ties resolve as tpurt's do: tplane rounds as
// its (split - o) * inv_d, no FMA (-fmad=false).
// What bounds it: the chain of dependent reads and the divergence, not the
// bytes (a primary ray of frame A's stand-in takes 16.6 steps, 12.3 of them
// interior, over leaves of 2.4 triangles).  So it runs on K1's scheduler:
// persistent warps taking K1_CHUNK rays from a counter and refilling dead
// lanes at K1_REFILL; the interval stack and (tmin, tmax) travel with the
// lane, d stays in its registers, and an interior step is one 16-byte read,
// its kind known from the reference.  An interior step is ~20 operations, a
// leaf step the 12-triangle test, so leaf turns wait for company, by a rule
// set by the leaf body's cost: K1k runs one body a turn, the interior step
// unless the lanes on leaves outnumber K1K_INTERIOR_WEIGHT times those on
// interior nodes; K1km's leaf body (the lerp and twice the rows, 8.3
// triangles a row on frame E's moving meshes) costs more, so its interior
// lanes step every turn and its leaf lanes when K1KM_LEAF_LANES of them wait
// or no lane is on an interior node.
// Measured (NVIDIA H100 80GB HBM3, 700 W; tpurt_torch/kernels/k1_ab.py, per
// launch in bursts, on K's five calls and E-under-kd's three; PERF.md
// section 6) and not used: refilling at 0 live lanes (whole chunks: K's camera
// rays and their shadow rays 10-13% faster, its bounce calls 43-65% slower)
// or at 8 (K1k 9-32% slower); K1k at weights 1 and 16 (0-12% slower); for
// K1k both bodies every turn (20-39% slower) or the interior every turn with
// the leaves at n_leaf >= n_int / 4, >= n_int, >= 8 or >= 16 lanes (up to
// 24% slower, the last within -1% and +5%); K1km with one body a turn at
// weight 4 (E's camera rays 2.62 ms against 2.30, its other rays 1% faster),
// weight 1 (3.90 ms) or 16 (2.49 ms).  The previous design (a thread a ray
// over the record table: the 16-byte node read after the row's kind, both
// bodies in one loop) and its times are in PERF.md's section 6.
#define K1K_INTERIOR_WEIGHT 4
#define K1KM_LEAF_LANES 16
// blocks per SM the register budget is set for: as K1's (the motion walk,
// K1km, takes K1m's: K1M_MINBLOCKS)
#define K1K_MINBLOCKS 6

template <int LEAF>
__global__ void __launch_bounds__(
    TPURT_BLOCK, LEAF == TPURT_LEAF_MOTION ? K1M_MINBLOCKS : K1K_MINBLOCKS)
traverse_kd_kernel(const float4* __restrict__ inodes, int n_inodes,
                   const float4* __restrict__ leaves, int n_leaves,
                   const float4* __restrict__ delta,
                   const float4* __restrict__ boxes,
                   const float* __restrict__ time_in,
                   const float* __restrict__ bounds, int root_ref,
                   int step_limit, const float* __restrict__ o_in,
                   const float* __restrict__ d_in,
                   const float* __restrict__ t_max_in, int n,
                   int stack_depth, int any_hit, float box_scale,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ b0_out, float* __restrict__ b1_out,
                   int* __restrict__ counter) {
  int st_node[TPURT_KD_STACK_MAX];  // local memory; only touched slots cost
  float st_tmin[TPURT_KD_STACK_MAX], st_tmax[TPURT_KD_STACK_MAX];
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);

  Ray r;
  float tmin = 0.f, tmax = 0.f;
  float t_best = 0.f, b0_best = 0.f, b1_best = 0.f;
  int prim_best = -1;
  int ray = -1;   // the ray this lane holds, -1 when none
  int cur = -1;   // its current reference, -1 when it is done
  int sp = 0, steps = 0;
  int pool = 0, pool_end = 0;  // as traverse_wide_kernel's
  bool more = true;

  for (;;) {
    // ---- retire finished rays, fetch new ones ----
    if (cur < 0 && ray >= 0) {
      t_out[ray] = t_best;
      prim_out[ray] = prim_best;
      b0_out[ray] = b0_best;
      b1_out[ray] = b1_best;
      ray = -1;
    }
    unsigned alive = __ballot_sync(FULL, cur >= 0);
    if ((more || pool < pool_end) && __popc(alive) <= K1_REFILL) {
      const unsigned dead = ~alive;
      if (pool >= pool_end) {
        int base = 0;
        if (lane == 0) base = atomicAdd(counter, K1_CHUNK);
        base = __shfl_sync(FULL, base, 0);
        more = base < n;
        pool = more ? base : 0;
        pool_end = more ? min(base + K1_CHUNK, n) : 0;
      }
      const int mine = pool + __popc(dead & ((1u << lane) - 1u));
      if (cur < 0 && mine < pool_end) {
        ray = mine;
        load_ray<LEAF>(r, o_in, d_in, time_in, ray);
        const float t_max = t_max_in[ray];
        // root clip: jnp's minimum / maximum and max / min reductions
        // propagate NaN, so a ray in the plane of a face (0 * inf) misses
        const float tx0 = (bounds[0] - r.ox) * r.ix;
        const float tx1 = (bounds[3] - r.ox) * r.ix;
        const float ty0 = (bounds[1] - r.oy) * r.iy;
        const float ty1 = (bounds[4] - r.oy) * r.iy;
        const float tz0 = (bounds[2] - r.oz) * r.iz;
        const float tz1 = (bounds[5] - r.oz) * r.iz;
        const float t_near = max_nan(
            max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)), min_nan(tz0, tz1));
        const float t_far = min_nan(min_nan(max_nan(tx0, tx1),
                                            max_nan(ty0, ty1)),
                                    max_nan(tz0, tz1)) * box_scale;
        tmin = max_nan(t_near, 0.f);
        tmax = min_nan(t_far, t_max);
        t_best = t_max;
        prim_best = -1;
        b0_best = 0.f;
        b1_best = 0.f;
        sp = 0;
        steps = 0;
        cur = (t_max > 0.f && tmin <= tmax) ? root_ref : -1;
      }
      pool = min(pool + __popc(dead), pool_end);
      alive = __ballot_sync(FULL, cur >= 0);
    }
    if (!alive) {
      if (!more && pool >= pool_end && !__any_sync(FULL, ray >= 0)) break;
      continue;
    }

    // ---- one turn: leaf turns wait for company (the source note) ----
    const int n_int = __popc(__ballot_sync(FULL, cur >= 0 && !(cur & 1)));
    const int n_leaf = __popc(__ballot_sync(FULL, cur >= 0 && (cur & 1)));
    const bool run_leaf = LEAF == TPURT_LEAF_MOTION
                              ? n_leaf >= K1KM_LEAF_LANES || n_int == 0
                              : n_int * K1K_INTERIOR_WEIGHT < n_leaf;
    const bool run_interior = LEAF == TPURT_LEAF_MOTION || !run_leaf;
    if (cur < 0 || ((cur & 1) ? !run_leaf : !run_interior)) continue;
    const bool do_interior = !(cur & 1);
    if ((cur >> 1) >= (do_interior ? n_inodes : n_leaves)) {
      cur = -1;  // malformed table
      continue;
    }
    int nxt = -1;
    bool pop = false;
    if (do_interior) {
      const float4 node = inodes[cur >> 1];  // split, axis, below, above
      const float split = node.x;
      const int axis = __float_as_int(node.y);
      const int below = __float_as_int(node.z), above = __float_as_int(node.w);
      const float o_a = axis == 0 ? r.ox : (axis == 1 ? r.oy : r.oz);
      const float inv_a = axis == 0 ? r.ix : (axis == 1 ? r.iy : r.iz);
      const float d_a = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
      const float tplane = (split - o_a) * inv_a;
      const bool below_first = (o_a < split) || (o_a == split && d_a <= 0.f);
      const int near = below_first ? below : above;
      const int far = below_first ? above : below;
      if (tmin > t_best) {
        pop = true;  // a cell past the best hit cannot improve it
      } else {
        const bool no_far = (tplane > tmax) || (tplane <= 0.f);
        const bool no_near = tplane < tmin;
        nxt = (no_far || !no_near) ? near : far;
        if (!no_far && !no_near) {
          if (sp < stack_depth) {
            st_node[sp] = far;
            st_tmin[sp] = tplane;
            st_tmax[sp] = tmax;
          }
          ++sp;
          tmax = tplane;
        }
      }
    } else {
      const size_t row = (size_t)(cur >> 1);
      const float4* rec = leaves + row * TPURT_LEAF_ROW4;
      float t_min = inf, bb0 = 0.f, bb1 = 0.f;
      int k_best = 0;
      leaf_test<LEAF == TPURT_LEAF_MOTION>(
          rec,
          LEAF == TPURT_LEAF_MOTION ? delta + row * TPURT_LEAF_ROW4 : nullptr,
          LEAF == TPURT_LEAF_MOTION ? boxes + row * TPURT_BOX_ROW4 : nullptr,
          r, t_best, t_min, k_best, bb0, bb1);
      if (t_min < t_best) {
        t_best = t_min;
        prim_best = reinterpret_cast<const int*>(rec)[108 + k_best];
        b0_best = bb0;
        b1_best = bb1;
      }
      nxt = reinterpret_cast<const int*>(rec)[124];  // the continuation
      pop = nxt < 0;
    }
    if (pop && sp > 0) {
      // slots past stack_depth read as (0, 0, 0), like the twin's: the
      // twin's row 0 is the root
      const bool ok = sp - 1 < stack_depth;
      nxt = ok ? st_node[sp - 1] : root_ref;
      tmin = ok ? st_tmin[sp - 1] : 0.f;
      tmax = ok ? st_tmax[sp - 1] : 0.f;
      --sp;
    }
    if (any_hit && prim_best >= 0) nxt = -1;
    // a walk reads each row at most once; the bound (the record table's
    // row count, as the twin's) guards against a malformed table
    if (++steps > step_limit) nxt = -1;
    cur = nxt;
  }
}

template <int LEAF>
static int launch_kd(const float* inodes, int n_inodes, const float* leaves,
                     int n_leaves, const float* delta, const float* boxes,
                     const float* time,
                     const float* bounds, int root_ref, int step_limit,
                     const float* o, const float* d, const float* t_max,
                     int n, int stack_depth, int any_hit, float box_scale,
                     float* t_out, int* prim_out, float* b0_out,
                     float* b1_out, int* counter, cudaStream_t s) {
  static int resident[64] = {0};
  int blocks = 0;
  int err = fit_grid((const void*)traverse_kd_kernel<LEAF>, resident, n, 0,
                     &blocks);
  if (err != 0) return err;
  err = (int)cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != 0) return err;
  traverse_kd_kernel<LEAF><<<blocks, TPURT_BLOCK, 0, s>>>(
      reinterpret_cast<const float4*>(inodes), n_inodes,
      reinterpret_cast<const float4*>(leaves), n_leaves,
      reinterpret_cast<const float4*>(delta),
      reinterpret_cast<const float4*>(boxes), time, bounds, root_ref,
      step_limit, o, d, t_max, n, stack_depth, any_hit, box_scale, t_out,
      prim_out, b0_out, b1_out, counter);
  return (int)cudaGetLastError();
}

// C entry point for ctypes: the kd walk.  leaf_kind TPURT_LEAF_TRI (K1k)
// or TPURT_LEAF_MOTION (K1km, with delta, its group boxes and time).
// inodes (n_inodes, 4) and leaves (n_leaves, 128): the derived tables,
// delta the leaves' delta rows, boxes their group box rows; bounds: the
// root box lo.xyz, hi.xyz; step_limit: the record table's row count.
// Launches on `stream`, does not synchronise, allocates nothing
// (`counter`: one int of scratch, zeroed here on the stream); returns
// cudaGetLastError() (0 = launched).
extern "C" int tpurt_traverse_kd(int leaf_kind, const float* inodes,
                                 int n_inodes, const float* leaves,
                                 int n_leaves, const float* delta,
                                 const float* boxes, const float* time,
                                 const float* bounds,
                                 int root_ref, int step_limit,
                                 const float* o, const float* d,
                                 const float* t_max, int n, int stack_depth,
                                 int any_hit, float box_scale, float* t_out,
                                 int* prim_out, float* b0_out,
                                 float* b1_out, int* counter, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (stack_depth > TPURT_KD_STACK_MAX || stack_depth < 1 || n_inodes < 1 ||
      n_leaves < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (leaf_kind) {
    case TPURT_LEAF_TRI:
      return launch_kd<TPURT_LEAF_TRI>(
          inodes, n_inodes, leaves, n_leaves, nullptr, nullptr, nullptr,
          bounds,
          root_ref, step_limit, o, d, t_max, n, stack_depth, any_hit,
          box_scale, t_out, prim_out, b0_out, b1_out, counter, s);
    case TPURT_LEAF_MOTION:
      if (delta == nullptr || boxes == nullptr || time == nullptr)
        return (int)cudaErrorInvalidValue;
      return launch_kd<TPURT_LEAF_MOTION>(
          inodes, n_inodes, leaves, n_leaves, delta, boxes, time, bounds,
          root_ref,
          step_limit, o, d, t_max, n, stack_depth, any_hit, box_scale, t_out,
          prim_out, b0_out, b1_out, counter, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
