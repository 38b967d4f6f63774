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
//     (tpurt's _tri_bundle_test(drec, time), intersect.py:669-725);
//   K1c (TPURT_LEAF_CURVE): 8 cubic Bezier spans a leaf of the curve tree,
//     each split into 8 sub-segments by constant blossom weights and run
//     through pbrt's depth-0 width test (tpurt's _curve_bundle_test,
//     intersect.py:751-897), ribbons scaled by the aux rows.
// The interior records, the stack, the schedule and the body choice are
// the same for all three.
// Under Accelerator "kdtree" the triangle rays take the kd walk instead
// (traverse_kd_kernel, at the end of this file): K1k and K1km, which replace
// tpurt's jnp kd traversal (_kd_step_fns, intersect.py:1038, the kd branch
// of _traverse_wide, which stands in for traverse.py:54 there) and share
// K1's ray setup and watertight leaf test.
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
// the motion body holds a leaf group's delta rows beside its vertices, the
// curve body a span's ray frame and projected control points
#define K1M_MINBLOCKS 5
#define K1C_MINBLOCKS 4

#define TPURT_LEAF_TRI 0     // LEAF_KINDS in kernels/traverse.py
#define TPURT_LEAF_MOTION 1
#define TPURT_LEAF_CURVE 2
#define TPURT_CURVE_SUB 8    // 2^CURVE_LEAF_SUBDIV sub-segments a span

#define TPURT_WIDTH 8
#define TPURT_LEAF_K 12
#define TPURT_STACK_MAX 256    // must equal STACK_MAX in kernels/traverse.py
#define TPURT_KD_STACK_MAX 128  // must equal KD_STACK_MAX there
#define TPURT_KD_BLOCK 128
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
  float dx, dy, dz;     // direction as given (K1c)
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
  if (LEAF == TPURT_LEAF_CURVE) {
    r.dx = dx;
    r.dy = dy;
    r.dz = dz;
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

// 12 fused watertight triangle tests of a leaf record, 4 per float4 group;
// the closest hit below t_best, the lowest slot winning a tie as
// jnp.argmin does.  MOTION lerps every loaded vertex row to the ray's time
// first (v + time * dv, two roundings, the twin's order); the lerp is per
// component, so lerping the permuted rows equals permuting the lerped ones.
template <bool MOTION>
__device__ __forceinline__ void leaf_test(const float4* __restrict__ rec,
                                          const float4* __restrict__ drec,
                                          const Ray& r, float t_best,
                                          float& t_min, int& k_best,
                                          float& bb0, float& bb1) {
#pragma unroll 1
  for (int g = 0; g < 3; ++g) {
    float4 v[9];  // permuted x, y, z rows of v0, v1, v2
    // triangles fill a leaf from slot 0, so the later groups are often
    // pads; a triangle whose v0.x is NaN is hit by no ray
    if (g > 0) {
      const float4 x = rec[g];  // v0.x of triangles 4g .. 4g+3
      if (x.x != x.x && x.y != x.y && x.z != x.z && x.w != x.w) continue;
    }
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
}

// 8 fused curve spans of a curve leaf record, each tested as 8 blossomed
// sub-segments in the ray's frame (curve.cpp:162-174, :289-373), op for op
// as the twin's _curve_bundle_test: within a span the closest sub-segment
// wins (tpurt's documented deviation), across spans the lowest slot wins a
// tie.  cw holds the (8, 4, 4) blossom weights.  aux is the leaf's ribbon
// row, or null.  bb0 / bb1 return the span-local s and the width v.
__device__ __forceinline__ void curve_leaf_test(
    const float4* __restrict__ rec, const float4* __restrict__ aux,
    const float* __restrict__ cw, const Ray& r, float t_best, float& t_min,
    int& k_best, float& bb0, float& bb1) {
  const float inf = __int_as_float(0x7f800000);
  const float z_lim = r.dl * t_best;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {  // spans 4h .. 4h+3
    if (h == 1) {
      const float4 x = rec[1];  // cp0.x of spans 4 .. 7: pads are NaN
      if (x.x != x.x && x.y != x.y && x.z != x.z && x.w != x.w) break;
    }
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      float c[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) c[i] = comp(rec[2 * i + h], j);
      const float w0 = comp(rec[24 + h], j), w1 = comp(rec[26 + h], j);
      // "up" = cross(d, cp3 - cp0); degenerate -> CoordinateSystem(d)
      const float v30x = c[9] - c[0], v30y = c[10] - c[1],
                  v30z = c[11] - c[2];
      float ux = r.dy * v30z - r.dz * v30y;
      float uy = r.dz * v30x - r.dx * v30z;
      float uz = r.dx * v30y - r.dy * v30x;
      if (ux * ux + uy * uy + uz * uz < 1e-18f) {
        const bool pick = fabsf(r.dx) > fabsf(r.dy);
        ux = pick ? -r.dz : 0.f;
        uy = pick ? 0.f : r.dz;
        uz = pick ? r.dx : -r.dy;
      }
      // x = normalize(cross(up, dhat)); y = cross(dhat, x)
      float xx = uy * r.hz - uz * r.hy;
      float xy = uz * r.hx - ux * r.hz;
      float xz = ux * r.hy - uy * r.hx;
      const float xl = max_nan(sqrtf(xx * xx + xy * xy + xz * xz), 1e-20f);
      xx = xx / xl;
      xy = xy / xl;
      xz = xz / xl;
      const float yx = r.hy * xz - r.hz * xy;
      const float yy = r.hz * xx - r.hx * xz;
      const float yz = r.hx * xy - r.hy * xx;
      float rx[4], ry[4], rz[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qx = c[3 * i] - r.ox, qy = c[3 * i + 1] - r.oy,
                    qz = c[3 * i + 2] - r.oz;
        rx[i] = qx * xx + qy * xy + qz * xz;
        ry[i] = qx * yx + qy * yy + qz * yz;
        rz[i] = qx * r.hx + qy * r.hy + qz * r.hz;
      }
      bool has_n = false;
      float n0x = 0.f, n0y = 0.f, n0z = 0.f, n1x = 0.f, n1y = 0.f, n1z = 0.f,
            ang = 0.f, inv_sin = 0.f;
      if (aux != nullptr) {
        n0x = comp(aux[0 + h], j);
        n0y = comp(aux[2 + h], j);
        n0z = comp(aux[4 + h], j);
        n1x = comp(aux[6 + h], j);
        n1y = comp(aux[8 + h], j);
        n1z = comp(aux[10 + h], j);
        ang = comp(aux[12 + h], j);
        inv_sin = comp(aux[14 + h], j);
        has_n = n0x * n0x + n0y * n0y + n0z * n0z > 0.5f;
      }
      float t_span = inf, s_span = 0.f, v_span = 0.f;
#pragma unroll 1
      for (int q = 0; q < TPURT_CURVE_SUB; ++q) {
        const float* wq = cw + 16 * q;
        float sx[4], sy[4], sz[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // sum(w[k][m] * r[m]) from the left, as the twin's sum()
          float ax = wq[4 * k] * rx[0], ay = wq[4 * k] * ry[0],
                az = wq[4 * k] * rz[0];
#pragma unroll
          for (int m = 1; m < 4; ++m) {
            ax = ax + wq[4 * k + m] * rx[m];
            ay = ay + wq[4 * k + m] * ry[m];
            az = az + wq[4 * k + m] * rz[m];
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
        const float a = q * (1.f / TPURT_CURVE_SUB);
        const float b = (q + 1) * (1.f / TPURT_CURVE_SUB);
        const float s =
            min_nan(max_nan(a + (1.f / TPURT_CURVE_SUB) * wp, a), b);
        float hw = w0 + (w1 - w0) * s;
        if (has_n) {
          // ribbon: the slerped normal's projection on the ray
          // (curve.cpp:313-321)
          const bool small = ang < 1e-4f;
          const float s0 = small ? 1.f - s : sinf((1.f - s) * ang) * inv_sin;
          const float s1 = small ? s : sinf(s * ang) * inv_sin;
          const float nhx = s0 * n0x + s1 * n1x;
          const float nhy = s0 * n0y + s1 * n1y;
          const float nhz = s0 * n0z + s1 * n1z;
          hw = hw * (fabsf(nhx * r.dx + nhy * r.dy + nhz * r.dz) / r.dl);
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
        const bool ok = e_ok0 && e_ok1 && den_ok &&
                        dist2 <= hw * hw * 0.25f && pcz > 0.f && pcz < z_lim;
        const float t_q = pcz / r.dl;
        if (ok && t_q < t_span) {
          const float dist = sqrtf(dist2);
          const float hwc = max_nan(hw, 1e-20f);
          const float edge_f = dvx * (-pcy) + pcx * dvy;
          t_span = t_q;
          s_span = s;
          v_span = edge_f > 0.f ? 0.5f + dist / hwc : 0.5f - dist / hwc;
        }
      }
      if (t_span < t_min) {  // strict: the lowest slot wins a tie
        t_min = t_span;
        k_best = 4 * h + j;
        bb0 = s_span;
        bb1 = v_span;
      }
    }
  }
}

template <int LEAF>
__global__ void __launch_bounds__(
    TPURT_BLOCK, LEAF == TPURT_LEAF_CURVE    ? K1C_MINBLOCKS
                 : LEAF == TPURT_LEAF_MOTION ? K1M_MINBLOCKS
                                             : K1_MINBLOCKS)
traverse_wide_kernel(const float4* __restrict__ inodes, int n_inodes,
                     const float4* __restrict__ leaves,
                     int n_leaves, const float4* __restrict__ side,
                     const float* __restrict__ time_in, int root_ref,
                     int step_limit,
                     const float* __restrict__ o_in,
                     const float* __restrict__ d_in,
                     const float* __restrict__ t_max_in,
                     const float* __restrict__ curve_w, int n,
                     int stack_depth, int any_hit, float box_scale,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ b0_out, float* __restrict__ b1_out,
                     int* __restrict__ counter) {
  int stack[TPURT_STACK_MAX];  // local memory; only touched slots cost
  const int lane = threadIdx.x & 31;
  // the curve body's blossom weights, read by every lane: one copy a block
  __shared__ float cw[LEAF == TPURT_LEAF_CURVE ? 16 * TPURT_CURVE_SUB : 1];
  if (LEAF == TPURT_LEAF_CURVE) {
    for (int i = threadIdx.x; i < 16 * TPURT_CURVE_SUB; i += blockDim.x)
      cw[i] = curve_w[i];
    __syncthreads();
  }
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
    } else if (cur >= 0 && (cur & 1)) {
      // leaf records: the 12-triangle test, or the 8-span curve test
      if ((cur >> 1) >= n_leaves) {  // malformed table
        cur = -1;
      } else {
        const size_t row = (size_t)(cur >> 1);
        const float4* rec = leaves + row * TPURT_LEAF_ROW4;
        float t_min = inf, bb0 = 0.f, bb1 = 0.f;
        int k_best = 0;
        if (LEAF == TPURT_LEAF_CURVE) {
          curve_leaf_test(rec, side ? side + row * TPURT_AUX_ROW4 : nullptr,
                          cw, r, t_best, t_min, k_best, bb0, bb1);
        } else {
          leaf_test<LEAF == TPURT_LEAF_MOTION>(
              rec,
              LEAF == TPURT_LEAF_MOTION ? side + row * TPURT_LEAF_ROW4
                                        : nullptr,
              r, t_best, t_min, k_best, bb0, bb1);
        }
        if (t_min < t_best) {
          t_best = t_min;
          prim_best = reinterpret_cast<const int*>(rec)[
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
    }
  }
}

template <int LEAF>
static int launch(const float* inodes, int n_inodes, const float* leaves,
                  int n_leaves, const float* side, const float* time,
                  int root_ref, int step_limit, const float* o,
                  const float* d, const float* t_max, const float* curve_w,
                  int n, int stack_depth, int any_hit, float box_scale,
                  float* t_out, int* prim_out, float* b0_out, float* b1_out,
                  int* counter, cudaStream_t s) {
  int blocks = (n + TPURT_BLOCK - 1) / TPURT_BLOCK;
  // as many blocks as the card holds at once; they share the ray counter.
  // The count is asked once per device and body (a benign race: every
  // thread writes the same value).
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, traverse_wide_kernel<LEAF>, TPURT_BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = sms * (per_sm < 1 ? 1 : per_sm);
  }
  if (blocks > resident[dev]) blocks = resident[dev];
  err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  traverse_wide_kernel<LEAF><<<blocks, TPURT_BLOCK, 0, s>>>(
      reinterpret_cast<const float4*>(inodes), n_inodes,
      reinterpret_cast<const float4*>(leaves), n_leaves,
      reinterpret_cast<const float4*>(side), time, root_ref, step_limit, o,
      d, t_max, curve_w, n, stack_depth, any_hit, box_scale, t_out,
      prim_out, b0_out, b1_out, counter);
  return (int)cudaGetLastError();
}

// C entry point for ctypes.  leaf_kind picks the body (TPURT_LEAF_*):
// side is the delta table (K1m, required, with time) or the ribbon aux
// table (K1c, null without ribbons); curve_w is K1c's (8, 4, 4) blossom
// weights.  Launches on `stream`, does not synchronise, allocates nothing
// (`counter` is one int of scratch, zeroed here on the stream); returns
// cudaGetLastError() (0 = launched).  step_limit is the host table's row
// count, the bound the plain twin uses.
extern "C" int tpurt_traverse_wide(int leaf_kind, const float* inodes,
                                   int n_inodes, const float* leaves,
                                   int n_leaves, const float* side,
                                   const float* time, int root_ref,
                                   int step_limit, const float* o,
                                   const float* d, const float* t_max,
                                   const float* curve_w, int n,
                                   int stack_depth, int any_hit,
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
                                    nullptr, nullptr, root_ref, step_limit,
                                    o, d, t_max, curve_w, n, stack_depth,
                                    any_hit, box_scale, t_out, prim_out,
                                    b0_out, b1_out, counter, s);
    case TPURT_LEAF_MOTION:
      if (side == nullptr || time == nullptr)
        return (int)cudaErrorInvalidValue;
      return launch<TPURT_LEAF_MOTION>(inodes, n_inodes, leaves, n_leaves,
                                       side, time, root_ref, step_limit, o,
                                       d, t_max, curve_w, n, stack_depth,
                                       any_hit, box_scale, t_out, prim_out,
                                       b0_out, b1_out, counter, s);
    case TPURT_LEAF_CURVE:
      if (curve_w == nullptr) return (int)cudaErrorInvalidValue;
      return launch<TPURT_LEAF_CURVE>(inodes, n_inodes, leaves, n_leaves,
                                      side, nullptr, root_ref, step_limit,
                                      o, d, t_max, curve_w, n, stack_depth,
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
// Accelerator "kdtree".  One thread walks one ray over the kd record table
// of tpurt_torch/geom/kdtree.py as it is (rows of 128 f32):
//   interior: [120] split, [121] axis (i32), [122] below row, [123] above
//     row (i32): one float4, 16 bytes, the only part of the row it reads;
//   leaf: the BVH leaf's 12-triangle bundle in [0:120] (K1's leaf_test
//     reads it unchanged), [124] the continuation row (i32, -1 = none);
//   [126] kind (0 interior, 1 leaf).
// The root-bounds clip (its far t scaled by box_scale, _BOX_T_SCALE), then
// binary descent with a (node, tmin, tmax) interval stack of stack_depth
// slots: near child first (below when o < split, or o == split and
// d <= 0), the far child pushed with (tplane, tmax) when the plane lies
// inside the interval; a cell past the best hit pops; a leaf walks its
// continuation rows before popping; any-hit ends at the first hit.  The
// updates come in the twin's order (kernels/traverse.py:
// traverse_kd_reference), so ties resolve as tpurt's do: tplane rounds as
// its (split - o) * inv_d, no FMA (-fmad=false).
// What bounds it: not bytes (a ray reads one 16-byte interior row a level
// it descends and a few leaf rows, from L1 or L2) but the chain of
// dependent reads and the divergence: measured on an H100, a primary ray
// of frame A's stand-in takes 16.6 steps (12.3 interior, 4.3 leaf rows of
// 2.4 triangles), and the walk runs ~38x its byte bound (PERF.md).
// The design is the simple one: a thread a ray, the interval stack in
// local memory, no persistent warps, the tables as the host built them;
// chip_smoke.py reports its time against its bound on every driven call.
template <int LEAF>
__global__ void __launch_bounds__(TPURT_KD_BLOCK)
traverse_kd_kernel(const float4* __restrict__ nodes, int n_rows,
                   const float4* __restrict__ delta,
                   const float* __restrict__ time_in,
                   const float* __restrict__ bounds,
                   const float* __restrict__ o_in,
                   const float* __restrict__ d_in,
                   const float* __restrict__ t_max_in, int n,
                   int stack_depth, int any_hit, float box_scale,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ b0_out, float* __restrict__ b1_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const float inf = __int_as_float(0x7f800000);
  Ray r;
  load_ray<LEAF>(r, o_in, d_in, time_in, ray);
  const float t_max = t_max_in[ray];
  // root clip: jnp's minimum / maximum and max / min reductions propagate
  // NaN, so a ray in the plane of a face (0 * inf) misses the box
  const float tx0 = (bounds[0] - r.ox) * r.ix, tx1 = (bounds[3] - r.ox) * r.ix;
  const float ty0 = (bounds[1] - r.oy) * r.iy, ty1 = (bounds[4] - r.oy) * r.iy;
  const float tz0 = (bounds[2] - r.oz) * r.iz, tz1 = (bounds[5] - r.oz) * r.iz;
  const float t_near = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                               min_nan(tz0, tz1));
  const float t_far = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                              max_nan(tz0, tz1)) * box_scale;
  float tmin = max_nan(t_near, 0.f);
  float tmax = min_nan(t_far, t_max);
  float t_best = t_max, b0_best = 0.f, b1_best = 0.f;
  int prim_best = -1;
  int cur = (t_max > 0.f && tmin <= tmax) ? 0 : -1;
  int st_node[TPURT_KD_STACK_MAX];
  float st_tmin[TPURT_KD_STACK_MAX], st_tmax[TPURT_KD_STACK_MAX];
  int sp = 0, steps = 0;
  while (cur >= 0) {
    if (cur >= n_rows) break;  // malformed table
    const float4* rec = nodes + (size_t)cur * (TPURT_LEAF_ROW4);
    const float4 tail = rec[31];  // [124] cont, [126] kind
    int nxt = -1;
    bool pop = false;
    if (tail.z > 0.f) {
      float t_min = inf, bb0 = 0.f, bb1 = 0.f;
      int k_best = 0;
      leaf_test<LEAF == TPURT_LEAF_MOTION>(
          rec,
          LEAF == TPURT_LEAF_MOTION ? delta + (size_t)cur * TPURT_LEAF_ROW4
                                    : nullptr,
          r, t_best, t_min, k_best, bb0, bb1);
      if (t_min < t_best) {
        t_best = t_min;
        prim_best = reinterpret_cast<const int*>(rec)[108 + k_best];
        b0_best = bb0;
        b1_best = bb1;
      }
      nxt = __float_as_int(tail.x);
      pop = nxt < 0;
    } else {
      const float4 node = rec[30];  // split, axis, below, above
      const float split = node.x;
      const int axis = __float_as_int(node.y);
      const int below = __float_as_int(node.z), above = __float_as_int(node.w);
      const float o_a = axis == 0 ? r.ox : (axis == 1 ? r.oy : r.oz);
      const float inv_a = axis == 0 ? r.ix : (axis == 1 ? r.iy : r.iz);
      const float d_a = d_in[3 * ray + (axis == 0 ? 0 : (axis == 1 ? 1 : 2))];
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
    }
    if (pop && sp > 0) {
      // slots past stack_depth read as (0, 0, 0), like the twin's
      const bool ok = sp - 1 < stack_depth;
      nxt = ok ? st_node[sp - 1] : 0;
      tmin = ok ? st_tmin[sp - 1] : 0.f;
      tmax = ok ? st_tmax[sp - 1] : 0.f;
      --sp;
    }
    if (any_hit && prim_best >= 0) nxt = -1;
    // a walk reads each row at most once; the bound guards against a
    // malformed table hanging the card
    if (++steps > n_rows) nxt = -1;
    cur = nxt;
  }
  t_out[ray] = t_best;
  prim_out[ray] = prim_best;
  b0_out[ray] = b0_best;
  b1_out[ray] = b1_best;
}

// C entry point for ctypes: the kd walk.  leaf_kind TPURT_LEAF_TRI (K1k)
// or TPURT_LEAF_MOTION (K1km, with delta and time).  nodes: the (n_rows,
// 128) kd record table; bounds: the root box lo.xyz, hi.xyz.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() (0 = launched).
extern "C" int tpurt_traverse_kd(int leaf_kind, const float* nodes,
                                 int n_rows, const float* delta,
                                 const float* time, const float* bounds,
                                 const float* o, const float* d,
                                 const float* t_max, int n, int stack_depth,
                                 int any_hit, float box_scale, float* t_out,
                                 int* prim_out, float* b0_out,
                                 float* b1_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (stack_depth > TPURT_KD_STACK_MAX || stack_depth < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (n + TPURT_KD_BLOCK - 1) / TPURT_KD_BLOCK;
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  switch (leaf_kind) {
    case TPURT_LEAF_TRI:
      traverse_kd_kernel<TPURT_LEAF_TRI><<<blocks, TPURT_KD_BLOCK, 0, s>>>(
          nd, n_rows, nullptr, nullptr, bounds, o, d, t_max, n, stack_depth,
          any_hit, box_scale, t_out, prim_out, b0_out, b1_out);
      break;
    case TPURT_LEAF_MOTION:
      if (delta == nullptr || time == nullptr)
        return (int)cudaErrorInvalidValue;
      traverse_kd_kernel<TPURT_LEAF_MOTION><<<blocks, TPURT_KD_BLOCK, 0, s>>>(
          nd, n_rows, reinterpret_cast<const float4*>(delta), time, bounds, o,
          d, t_max, n, stack_depth, any_hit, box_scale, t_out, prim_out,
          b0_out, b1_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
