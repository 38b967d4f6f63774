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
// Table layout (tpurt/geom/wbvh.py), 128 f32 per record, slot 126 = kind:
//   interior: [0:48] child bounds lo.x lo.y lo.z hi.x hi.y hi.z (8 each,
//             absent children are NaN boxes), [48:56] child rows (i32)
//   leaf:     [0:108] 12 triangles' v0.x..v2.z (12 each, pads NaN),
//             [108:120] prim rows (i32, pads -1)
//
// What bounds it on this card: dependent-load latency.  Each step reads
// one record whose address comes from the previous step, and the whole
// table (8.4 MB for a ~66k-triangle mesh) sits in the 50 MB L2, so a step
// waits on an L2 round trip rather than on DRAM bandwidth.  The design
// answers that with occupancy: one thread per ray, 128 threads per block,
// a per-thread stack in local memory, and only the slots the record kind
// needs are loaded (kind first, then 14 float4 for an interior record or
// 30 float4 for a leaf), so many warps have a load in flight at once.
// Divergent threads replace tpurt's lockstep schedule and its two-phase
// straggler compaction (intersect.py:1251-1290), which this form does
// not need.  Staging records in shared memory, warp-cooperative
// traversal and ray sorting are later work.
//
// Numerics follow the plain twin (tpurt_torch/kernels/traverse.py) op for
// op.  Build without --use_fast_math and with -fmad=false so products are
// not contracted into FMAs; divisions are IEEE.  jnp/torch minimum and
// maximum propagate NaN while fminf/fmaxf drop it, so the slab test uses
// the NaN-propagating helpers below: a NaN box must never be hit.

#include <cuda_runtime.h>
#include <stdint.h>

#define TPURT_WIDTH 8
#define TPURT_LEAF_K 12
#define TPURT_REC4 32          // float4 per 128-slot record
#define TPURT_STACK_MAX 256    // must equal STACK_MAX in kernels/traverse.py
#define TPURT_BLOCK 128

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// jnp.minimum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? qnan() : (b < a ? b : a);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? qnan() : (b > a ? b : a);
}

// one comparator of tpurt's _SORT8 network: strict '>' swap of keys+vals
#define CSWAP(i, j)                                        \
  {                                                        \
    if (key[i] > key[j]) {                                 \
      float tk_ = key[i]; key[i] = key[j]; key[j] = tk_;   \
      int tv_ = val[i]; val[i] = val[j]; val[j] = tv_;     \
    }                                                      \
  }

__global__ void __launch_bounds__(TPURT_BLOCK)
traverse_wide_kernel(const float4* __restrict__ nodes, int n_nodes,
                     const float* __restrict__ o_in,
                     const float* __restrict__ d_in,
                     const float* __restrict__ t_max_in, int n,
                     int stack_depth, int any_hit, float box_scale,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ b0_out, float* __restrict__ b1_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float inf = __int_as_float(0x7f800000);

  const float ox = o_in[3 * lane], oy = o_in[3 * lane + 1],
              oz = o_in[3 * lane + 2];
  const float dx = d_in[3 * lane], dy = d_in[3 * lane + 1],
              dz = d_in[3 * lane + 2];
  // 1/d with signed infinities on zero components (intersect.py:1234)
  const float ix = dx != 0.f ? 1.f / dx : (dx >= 0.f ? inf : -inf);
  const float iy = dy != 0.f ? 1.f / dy : (dy >= 0.f ? inf : -inf);
  const float iz = dz != 0.f ? 1.f / dz : (dz >= 0.f ? inf : -inf);

  // watertight-test permutation: |d| largest axis becomes z
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const bool use2 = (az >= ax) && (az >= ay);   // (x, y, z)
  const bool use1 = !use2 && (ay >= ax);        // (z, x, y); else (y, z, x)
#define PERM_X(x, y, z) (use2 ? (x) : (use1 ? (z) : (y)))
#define PERM_Y(x, y, z) (use2 ? (y) : (use1 ? (x) : (z)))
#define PERM_Z(x, y, z) (use2 ? (z) : (use1 ? (y) : (x)))
  const float dpx = PERM_X(dx, dy, dz), dpy = PERM_Y(dx, dy, dz),
              dpz = PERM_Z(dx, dy, dz);
  const float sx = -dpx / dpz;
  const float sy = -dpy / dpz;
  const float sz = 1.f / dpz;

  float t_best = t_max_in[lane];
  int prim_best = -1;
  float b0_best = 0.f, b1_best = 0.f;
  int cur = t_best > 0.f ? 0 : -1;
  int sp = 0;
  int stack[TPURT_STACK_MAX];
  // a tree visits each record at most once, so a lane never needs more
  // steps than there are records; the bound only guards against a
  // malformed table hanging the card
  int steps = 0;

  while (cur >= 0 && cur < n_nodes && steps++ <= n_nodes) {
    const float4* rec = nodes + (size_t)cur * TPURT_REC4;
    const float kind = rec[31].z;  // slot 126
    bool descend = false;
    int first = -1;
    if (kind > 0.f) {
      // ---- leaf: 12 fused triangles, 4 per float4 group ----
      float t_min = inf, bb0 = 0.f, bb1 = 0.f;
      int k_best = 0;
#pragma unroll 1
      for (int g = 0; g < 3; ++g) {
        float4 v[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) v[i] = rec[i * 3 + g];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v0x = reinterpret_cast<const float*>(&v[0])[j];
          const float v0y = reinterpret_cast<const float*>(&v[1])[j];
          const float v0z = reinterpret_cast<const float*>(&v[2])[j];
          const float v1x = reinterpret_cast<const float*>(&v[3])[j];
          const float v1y = reinterpret_cast<const float*>(&v[4])[j];
          const float v1z = reinterpret_cast<const float*>(&v[5])[j];
          const float v2x = reinterpret_cast<const float*>(&v[6])[j];
          const float v2y = reinterpret_cast<const float*>(&v[7])[j];
          const float v2z = reinterpret_cast<const float*>(&v[8])[j];
          const float q0x = v0x - ox, q0y = v0y - oy, q0z = v0z - oz;
          const float q1x = v1x - ox, q1y = v1y - oy, q1z = v1z - oz;
          const float q2x = v2x - ox, q2y = v2y - oy, q2z = v2z - oz;
          const float p0x = PERM_X(q0x, q0y, q0z), p0y = PERM_Y(q0x, q0y, q0z),
                      p0z = PERM_Z(q0x, q0y, q0z);
          const float p1x = PERM_X(q1x, q1y, q1z), p1y = PERM_Y(q1x, q1y, q1z),
                      p1z = PERM_Z(q1x, q1y, q1z);
          const float p2x = PERM_X(q2x, q2y, q2z), p2y = PERM_Y(q2x, q2y, q2z),
                      p2z = PERM_Z(q2x, q2y, q2z);
          const float x0 = p0x + sx * p0z, y0 = p0y + sy * p0z;
          const float x1 = p1x + sx * p1z, y1 = p1y + sy * p1z;
          const float x2 = p2x + sx * p2z, y2 = p2y + sy * p2z;
          const float e0 = x1 * y2 - y1 * x2;
          const float e1 = x2 * y0 - y2 * x0;
          const float e2 = x0 * y1 - y0 * x1;
          const bool same_sign = (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) ||
                                 (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f);
          const float det = e0 + e1 + e2;
          const float t_scaled = (e0 * p0z + e1 * p1z + e2 * p2z) * sz;
          const float tmd = t_best * det;
          const bool t_ok = det < 0.f ? (t_scaled <= 0.f && t_scaled > tmd)
                                      : (t_scaled >= 0.f && t_scaled < tmd);
          if (same_sign && det != 0.f && t_ok) {
            const float inv_det = 1.f / det;
            const float t = t_scaled * inv_det;
            // strict '<' over k = 0..11: the lowest slot wins a tie,
            // as jnp.argmin does
            if (t < t_min) {
              t_min = t;
              k_best = 4 * g + j;
              bb0 = e0 * inv_det;
              bb1 = e1 * inv_det;
            }
          }
        }
      }
      if (t_min < t_best) {
        const float4 pr = rec[27 + (k_best >> 2)];  // slots 108..119
        const float* prf = reinterpret_cast<const float*>(&pr);
        t_best = t_min;
        prim_best = __float_as_int(prf[k_best & 3]);
        b0_best = bb0;
        b1_best = bb1;
      }
    } else {
      // ---- interior: 8 slab tests, near-first order by _SORT8 ----
      float key[TPURT_WIDTH];
      int val[TPURT_WIDTH];
      int n_hit = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // children 4h .. 4h+3
        const float4 lx = rec[0 + h], ly = rec[2 + h], lz = rec[4 + h];
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
          float t0 = (plx[j] - ox) * ix, t1 = (phx[j] - ox) * ix;
          float t_near = max_nan(-inf, min_nan(t0, t1));
          float t_far = min_nan(inf, max_nan(t0, t1));
          t0 = (ply[j] - oy) * iy;
          t1 = (phy[j] - oy) * iy;
          t_near = max_nan(t_near, min_nan(t0, t1));
          t_far = min_nan(t_far, max_nan(t0, t1));
          t0 = (plz[j] - oz) * iz;
          t1 = (phz[j] - oz) * iz;
          t_near = max_nan(t_near, min_nan(t0, t1));
          t_far = min_nan(t_far, max_nan(t0, t1));
          t_far = t_far * box_scale;
          const bool hit = (t_near <= t_far) && (t_far > 0.f) &&
                           (t_near < t_best);
          key[4 * h + j] = hit ? t_near : inf;
          val[4 * h + j] = __float_as_int(pch[j]);
          n_hit += hit ? 1 : 0;
        }
      }
      // tpurt.render.intersect._SORT8 (Batcher odd-even merge, 8 inputs);
      // tests/test_torch_intersect.py holds this list equal to tpurt's
      CSWAP(0, 1) CSWAP(2, 3) CSWAP(4, 5) CSWAP(6, 7) CSWAP(0, 2)
      CSWAP(1, 3) CSWAP(4, 6) CSWAP(5, 7) CSWAP(1, 2) CSWAP(5, 6)
      CSWAP(0, 4) CSWAP(1, 5) CSWAP(2, 6) CSWAP(3, 7) CSWAP(2, 4)
      CSWAP(3, 5) CSWAP(1, 2) CSWAP(3, 4) CSWAP(5, 6)
      if (n_hit > 0) {
        // push hit children 1..n_hit-1 far-to-near above the old top
        // (intersect.py:1010-1016); descend into the nearest, no push
#pragma unroll
        for (int k = 1; k < TPURT_WIDTH; ++k) {
          const int pos = sp + n_hit - 1 - k;
          if (k < n_hit && pos < stack_depth) stack[pos] = val[k];
        }
        sp += n_hit - 1;
        descend = true;
        first = val[0];
      }
    }
    int nxt;
    if (descend) {
      nxt = first;
    } else if (sp > 0) {
      // slots past stack_depth read as 0, like the twin's one-hot read
      nxt = (sp - 1 < stack_depth) ? stack[sp - 1] : 0;
      --sp;
    } else {
      nxt = -1;
    }
    if (any_hit && prim_best >= 0) nxt = -1;
    cur = nxt;
  }
#undef PERM_X
#undef PERM_Y
#undef PERM_Z

  t_out[lane] = t_best;
  prim_out[lane] = prim_best;
  b0_out[lane] = b0_best;
  b1_out[lane] = b1_best;
}

// C entry point for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError() (0 = launched).
extern "C" int tpurt_traverse_wide(const float* nodes, int n_nodes,
                                   const float* o, const float* d,
                                   const float* t_max, int n,
                                   int stack_depth, int any_hit,
                                   float box_scale, float* t_out,
                                   int* prim_out, float* b0_out,
                                   float* b1_out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (stack_depth > TPURT_STACK_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (n + TPURT_BLOCK - 1) / TPURT_BLOCK;
  traverse_wide_kernel<<<blocks, TPURT_BLOCK, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(nodes), n_nodes, o, d, t_max, n,
      stack_depth, any_hit, box_scale, t_out, prim_out, b0_out, b1_out);
  return (int)cudaGetLastError();
}
