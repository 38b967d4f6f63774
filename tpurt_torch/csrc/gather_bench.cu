// Gather probe for Hopper (sm_90a): the sum of many dynamic table rows,
// widened into a sweep over row width, fetch variant and access pattern.
//
// Replaces the TPU kernel tpurt/kernels/gather_bench.py:kernel (reached by
// run, pallas_call at :36).  It computes
//   out[0, :] = sum_{r < R} sum_{i < B} table[(idx[g(i)] + r * 40503) mod M, :]
// for a (M, W) f32 table and (B,) int32 row indices, as the Pallas kernel
// does (W = 128, g(i) = i) with the table in VMEM and the indices in SMEM.
// Its use is to measure the rate of dynamic row reads, the access pattern
// of the BVH traversal kernel (traverse.cu), and so to decide that
// kernel's record layout and fetch:
//   - row width W = 16, 32, 64 or 128 floats (64..512 B), read by LPR = 4,
//     8, 16 or 32 lanes a row, a float4 a lane, so one warp instruction
//     reads 8, 4, 2 or 1 rows;
//   - variant 0 "direct": each lane loads its float4 from global memory;
//     variant 1 "cp_async": each lane copies its float4 into a per-warp
//     ring in shared memory with cp.async.cg (16 B), several stages in
//     flight, and the sum is taken from shared memory;
//     variant 2 "bulk": one lane per row starts a 1-D cp.async.bulk of the
//     whole row into the ring, completing on a per-stage mbarrier;
//   - pattern g(i) = (i / group) * group: group = 1 gives every lane its
//     own row, group = 8 lets 8 consecutive reads share a row, as
//     neighbouring camera rays share a BVH record.
//
// What bounds it on this card: L2 bandwidth and latency, not DRAM.  The
// probe's 8 MiB table does not fit a block's 227 KB of shared memory, but
// it fits the 50 MB L2 many times over, so after the first touch every
// row read is an L2 (or L1) hit.  The least DRAM traffic is one read of
// each row the indices reach (the bound chip_smoke.py reports); the kernel
// instead reads B * R rows through L2, which is what a probe of row-read
// rate has to do: its real floor is B * R * W * 4 bytes over the rate L2
// delivers.  The design answers latency with parallelism: 16-byte loads,
// neighbouring lanes on neighbouring addresses, four warp instructions
// (or ring stages) in flight per warp, and enough warps to fill every SM.
//
// Deterministic sums: warp w of the grid takes chunks c = w, w + W, ... of
// 32 / LPR consecutive reads of the flattened (round, lane) order, adds
// its sub-rows with a fixed shuffle tree, each block adds its warps' sums
// in warp order into partial[block], and a second small kernel adds the
// partials in block order.  No float atomics, so the result is the same
// on every run with the same grid.  At W = 128, variant 0, the order is
// one row per warp step, as in the first version of this kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#define TPURT_WARPS 8       // warps per block of the first pass
#define TPURT_UNROLL 4      // warp instructions / ring stages in flight
#define TPURT_STRIDE 40503  // the probe's per-round index offset

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// floor-mod row of flattened read k = r * b + i (jnp's and torch's %),
// with lane i reading through idx[(i / group) * group]
__device__ __forceinline__ int64_t row_of(const int32_t* __restrict__ idx,
                                          int k, int b, int group, int m) {
  const int r = k / b;
  int i = k - r * b;
  i -= i % group;
  int64_t j = ((int64_t)__ldg(idx + i) + (int64_t)r * TPURT_STRIDE) % m;
  return j < 0 ? j + m : j;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// LPR lanes read one row (a float4 each); MODE 0 direct, 1 cp.async ring,
// 2 bulk-copy ring.  partial is (gridDim.x, LPR) float4.
template <int LPR, int MODE>
__global__ void __launch_bounds__(TPURT_WARPS * 32)
gather_rows_partial_kernel(const int32_t* __restrict__ idx, int b, int group,
                           const float4* __restrict__ table, int m,
                           int total, float4* __restrict__ partial) {
  constexpr int RPI = 32 / LPR;  // rows per warp instruction
  __shared__ float4 acc_s[TPURT_WARPS][LPR];
  __shared__ __align__(128) float4 ring[MODE ? TPURT_WARPS : 1]
                                       [MODE ? TPURT_UNROLL : 1][32];
  __shared__ __align__(8) uint64_t bars[MODE == 2 ? TPURT_WARPS : 1]
                                       [MODE == 2 ? TPURT_UNROLL : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / LPR;   // which of the instruction's rows
  const int col = lane % LPR;   // which float4 of the row
  const int nwarps = gridDim.x * TPURT_WARPS;
  const int nchunks = (total + RPI - 1) / RPI;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  int c = blockIdx.x * TPURT_WARPS + warp;

  if (MODE == 0) {
    // TPURT_UNROLL independent instructions per step: their loads overlap
    for (; c + (TPURT_UNROLL - 1) * nwarps < nchunks;
         c += TPURT_UNROLL * nwarps) {
      float4 v[TPURT_UNROLL];
#pragma unroll
      for (int u = 0; u < TPURT_UNROLL; ++u) {
        const int k = (c + u * nwarps) * RPI + sub;
        v[u] = k < total
                   ? __ldg(table + row_of(idx, k, b, group, m) * LPR + col)
                   : zero4;
      }
#pragma unroll
      for (int u = 0; u < TPURT_UNROLL; ++u) add4(acc, v[u]);
    }
    for (; c < nchunks; c += nwarps) {
      const int k = c * RPI + sub;
      if (k < total)
        add4(acc, __ldg(table + row_of(idx, k, b, group, m) * LPR + col));
    }
  } else {
    if (MODE == 2) {
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < TPURT_UNROLL; ++s)
          asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                           smem_u32(&bars[warp][s]))
                       : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncwarp();
    }
    // stage s of the ring holds chunk c + s * nwarps; every lane copies (or
    // zero-fills) its own 16 bytes, or the row's first lane the whole row
    auto fill_stage = [&](int chunk, int s) {
      const int k = chunk * RPI + sub;
      const bool valid = chunk < nchunks && k < total;
      float4* dst = &ring[warp][s][lane];
      if (MODE == 1) {
        if (valid) {
          const float4* src =
              table + row_of(idx, k, b, group, m) * LPR + col;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           smem_u32(dst)),
                       "l"(src)
                       : "memory");
        } else {
          *dst = zero4;
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      } else {
        const uint32_t bar = smem_u32(&bars[warp][s]);
        const unsigned rows = __ballot_sync(0xffffffffu, valid && col == 0);
        if (!valid) *dst = zero4;
        if (lane == 0)
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                  "r"(bar),
              "r"((uint32_t)(__popc(rows) * LPR * 16))
              : "memory");
        __syncwarp();
        if (valid && col == 0) {
          const float4* src = table + row_of(idx, k, b, group, m) * LPR;
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
              "l"(src), "r"((uint32_t)(LPR * 16)), "r"(bar)
              : "memory");
        }
      }
    };
#pragma unroll
    for (int s = 0; s < TPURT_UNROLL; ++s) fill_stage(c + s * nwarps, s);
    for (int j = 0; c < nchunks; c += nwarps, ++j) {
      const int s = j % TPURT_UNROLL;
      if (MODE == 1)
        asm volatile("cp.async.wait_group %0;\n" ::"n"(TPURT_UNROLL - 1)
                     : "memory");
      else
        mbar_wait(smem_u32(&bars[warp][s]), (j / TPURT_UNROLL) & 1);
      __syncwarp();
      add4(acc, ring[warp][s][lane]);
      __syncwarp();  // the stage is free: refill it
      fill_stage(c + TPURT_UNROLL * nwarps, s);
    }
    if (MODE == 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // sub-rows of the warp, in a fixed order
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    float4 o;
    o.x = __shfl_xor_sync(0xffffffffu, acc.x, off);
    o.y = __shfl_xor_sync(0xffffffffu, acc.y, off);
    o.z = __shfl_xor_sync(0xffffffffu, acc.z, off);
    o.w = __shfl_xor_sync(0xffffffffu, acc.w, off);
    add4(acc, o);
  }
  if (lane < LPR) acc_s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && lane < LPR) {
    float4 s = acc_s[0][lane];
#pragma unroll
    for (int w = 1; w < TPURT_WARPS; ++w) add4(s, acc_s[w][lane]);
    partial[blockIdx.x * LPR + lane] = s;
  }
}

__global__ void gather_rows_final_kernel(const float4* __restrict__ partial,
                                         int nblocks, int lpr,
                                         float4* __restrict__ out) {
  const int lane = threadIdx.x;
  if (lane >= lpr) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int blk = 0; blk < nblocks; ++blk) add4(s, partial[blk * lpr + lane]);
  out[lane] = s;
}

template <int LPR>
static cudaError_t launch_partial(int mode, int nblocks, cudaStream_t s,
                                  const int32_t* idx, int b, int group,
                                  const float4* table, int m, int total,
                                  float4* partial) {
  const int threads = TPURT_WARPS * 32;
  if (mode == 0)
    gather_rows_partial_kernel<LPR, 0><<<nblocks, threads, 0, s>>>(
        idx, b, group, table, m, total, partial);
  else if (mode == 1)
    gather_rows_partial_kernel<LPR, 1><<<nblocks, threads, 0, s>>>(
        idx, b, group, table, m, total, partial);
  else if (mode == 2)
    gather_rows_partial_kernel<LPR, 2><<<nblocks, threads, 0, s>>>(
        idx, b, group, table, m, total, partial);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// idx (b,) int32, table (m, 4 * lpr) f32 with lpr in {4, 8, 16, 32},
// partial (nblocks, 4 * lpr) f32 scratch, out (1, 4 * lpr) f32; all on the
// device of `stream`.  mode 0 direct, 1 cp.async ring, 2 bulk-copy ring;
// group >= 1 consecutive lanes share a row.  b * rounds <= 2^30, so the
// int read counters cannot overflow.  Returns the launches'
// cudaGetLastError().
extern "C" int tpurt_gather_rows_sum(const void* idx, int b, int group,
                                     const void* table, int m, int lpr,
                                     int mode, int rounds, void* partial,
                                     int nblocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  const float4* tb = (const float4*)table;
  float4* pt = (float4*)partial;
  const int total = b * rounds;
  cudaError_t err;
  if (group < 1) return (int)cudaErrorInvalidValue;
  switch (lpr) {
    case 4:
      err = launch_partial<4>(mode, nblocks, s, ix, b, group, tb, m, total, pt);
      break;
    case 8:
      err = launch_partial<8>(mode, nblocks, s, ix, b, group, tb, m, total, pt);
      break;
    case 16:
      err = launch_partial<16>(mode, nblocks, s, ix, b, group, tb, m, total, pt);
      break;
    case 32:
      err = launch_partial<32>(mode, nblocks, s, ix, b, group, tb, m, total, pt);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  gather_rows_final_kernel<<<1, 32, 0, s>>>((const float4*)partial, nblocks,
                                            lpr, (float4*)out);
  return (int)cudaGetLastError();
}
