// Gather probe for Hopper (sm_90a): the sum of many dynamic table rows.
//
// Replaces the TPU kernel tpurt/kernels/gather_bench.py:kernel (reached by
// run, pallas_call at :36).  It computes
//   out[0, :] = sum_{r < R} sum_{i < B} table[(idx[i] + r * 40503) mod M, :]
// for a (M, 128) f32 table and (B,) int32 row indices, as the Pallas
// kernel does with the table in VMEM and the indices in SMEM.  Its use is
// to measure the rate of per-lane dynamic row reads, the access pattern of
// the BVH traversal kernel (traverse.cu), whose records are rows of the
// same 512-byte width.
//
// What bounds it on this card: L2 bandwidth and latency, not DRAM.  The
// probe's 8 MiB table does not fit a block's 227 KB of shared memory, but
// it fits the 50 MB L2 many times over, so after the first touch every
// row read is an L2 hit.  The least DRAM traffic is one read of each row
// the indices reach (the bound chip_smoke.py reports); the kernel instead
// reads B * R rows (512 MiB at the probe's sizes) through L2, which is
// what a probe of row-read rate has to do.  The design answers latency
// with parallelism: one warp per 512-byte row, a float4 per thread (one
// fully coalesced 512-byte request per row), several rows in flight per
// warp, and enough warps to fill every SM.
//
// Deterministic sums: warp w of the grid takes rows k = w, w + W, ... of
// the flattened (round, lane) order, each block adds its warps' sums in
// warp order into partial[block], and a second one-warp kernel adds the
// partials in block order.  No float atomics, so the result is the same
// on every run with the same grid.

#include <cuda_runtime.h>
#include <stdint.h>

#define TPURT_REC4 32       // float4 per 128-float row
#define TPURT_WARPS 8       // warps per block of the first pass
#define TPURT_UNROLL 4      // rows in flight per warp
#define TPURT_STRIDE 40503  // the probe's per-round index offset

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// floor-mod row of flattened row k = r * b + i (jnp's and torch's %)
__device__ __forceinline__ int64_t row_of(const int32_t* __restrict__ idx,
                                          int k, int b, int m) {
  const int r = k / b;
  const int i = k - r * b;
  int64_t j = ((int64_t)__ldg(idx + i) + (int64_t)r * TPURT_STRIDE) % m;
  return j < 0 ? j + m : j;
}

__global__ void __launch_bounds__(TPURT_WARPS * 32)
gather_rows_partial_kernel(const int32_t* __restrict__ idx, int b,
                           const float4* __restrict__ table, int m,
                           int total, float4* __restrict__ partial) {
  __shared__ float4 acc_s[TPURT_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = gridDim.x * TPURT_WARPS;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int k = blockIdx.x * TPURT_WARPS + warp;
  // TPURT_UNROLL independent rows per step: their loads overlap
  for (; k + (TPURT_UNROLL - 1) * nwarps < total; k += TPURT_UNROLL * nwarps) {
    float4 v[TPURT_UNROLL];
#pragma unroll
    for (int u = 0; u < TPURT_UNROLL; ++u)
      v[u] = __ldg(table + row_of(idx, k + u * nwarps, b, m) * TPURT_REC4 +
                   lane);
#pragma unroll
    for (int u = 0; u < TPURT_UNROLL; ++u) add4(acc, v[u]);
  }
  for (; k < total; k += nwarps)
    add4(acc, __ldg(table + row_of(idx, k, b, m) * TPURT_REC4 + lane));
  acc_s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float4 s = acc_s[0][lane];
#pragma unroll
    for (int w = 1; w < TPURT_WARPS; ++w) add4(s, acc_s[w][lane]);
    partial[blockIdx.x * TPURT_REC4 + lane] = s;
  }
}

__global__ void gather_rows_final_kernel(const float4* __restrict__ partial,
                                         int nblocks,
                                         float4* __restrict__ out) {
  const int lane = threadIdx.x;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int blk = 0; blk < nblocks; ++blk)
    add4(s, partial[blk * TPURT_REC4 + lane]);
  out[lane] = s;
}

// idx (b,) int32, table (m, 128) f32, partial (nblocks, 128) f32 scratch,
// out (1, 128) f32; all on the device of `stream`.  b * rounds <= 2^30, so
// the int row counters (k + 3 * warps) cannot overflow.
// Returns the launches' cudaGetLastError().
extern "C" int tpurt_gather_rows_sum(const void* idx, int b,
                                     const void* table, int m, int rounds,
                                     void* partial, int nblocks, void* out,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  gather_rows_partial_kernel<<<nblocks, TPURT_WARPS * 32, 0, s>>>(
      (const int32_t*)idx, b, (const float4*)table, m, b * rounds,
      (float4*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gather_rows_final_kernel<<<1, TPURT_REC4, 0, s>>>(
      (const float4*)partial, nblocks, (float4*)out);
  return (int)cudaGetLastError();
}
