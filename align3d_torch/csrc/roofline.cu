// P1 and P2: the roofline probes, the card's attainable rates for the two
// kinds of work the port's kernels do (float32 arithmetic, random gathers).
//
// P1 (fma_peak) replaces the TPU probe tools/roofline_v4.py::vpu_fma_peak
// (its Pallas `kern`). Each thread holds one element x and runs, per step,
// the probe's chains: ILP independent chains a_i = x * (1 + 1e-7 i), then
// U times a_i = fmaf(a_i, 1.0000001f, x), then their sum, added into the
// thread's total. What bounds it: the FP32 pipes, 2 flops per fmaf, 128
// lanes per SM, 67 TFLOP/s on an H100 SXM at 700 W. The design keeps every
// chain in registers, reads one element and writes one per thread, and
// launches enough blocks to fill the 132 SMs several times over. Each step
// starts its chains from fmaf(total, 0, x), which is x (total is finite) but
// depends on the step before, so no compiler can hoist a step's chains out
// of the loop (the TPU probe re-runs them per grid step). An empty asm
// statement on x is not enough: ptxas sees no instruction there and hoisted
// the chains, which made a first version report 36x the card's peak.
//
// P2 (gather_peak) replaces the TPU probe tools/roofline_v4.py::
// lane_gather_peak (its Pallas `kern`): chains of dynamic gathers with
// distinct random indices per chain. It has one mode per level of memory a
// kernel of the port gathers from:
//   * lane (shared memory): the TPU probe's own arithmetic. A warp holds one
//     128-wide row (4 values a lane); per step each chain starts at x + i and
//     U times becomes take(a + x, idx_i), through shared memory (K4 stages
//     its candidate tiles there). Bound: the shared-memory pipe, 32 banks.
//     The stores and warp barriers of every step keep it in the loop.
//   * table (device memory): each thread runs ILP chains of U gathers
//     a_i += T[idx], idx from a per-chain linear congruential sequence
//     (state = state * 1664525 + 1013904223, idx = umulhi(state, m)) seeded
//     from a hash of (element, chain, step). With a table the size of one
//     pair's target pack (~25 MB) the gathers hit the 50 MB L2 (K1 at
//     B = 1, K3); with the batch-64 packs (~1.6 GB) they go to HBM (K1 at
//     B = 64). Bound: L2 or HBM sectors; a 4-byte random gather moves a
//     32-byte sector. All arithmetic is unsigned, so sums wrap as int32 does
//     in the plain twin.
//
// The table mode's ablation (tools/ablate.py builds this file with -D macros
// into build/ablate/): A3D_TABLE_ILP x A3D_TABLE_U, the loads a thread has in
// flight (the library: 4 x 16, tools/roofline.py's TABLE_ILP, TABLE_U);
// A3D_TABLE_MIN_BLOCKS, __launch_bounds__' minimum of resident blocks per
// SM; A3D_TABLE_SECTOR 1, each gather reads the whole 32-byte sector that
// holds its index as two 16-byte loads and adds its 8 values (another
// function, same index stream: the table must be 32-byte aligned, its length
// a multiple of 8); A3D_ABLATE_L2_FETCH 1 exports a3d_l2_fetch_granularity,
// which sets cudaLimitMaxL2FetchGranularity and returns the old value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFmaIlp = 4, kFmaU = 64;      // vpu_fma_peak's ilp and u
constexpr int kLaneIlp = 4, kLaneU = 16;    // lane_gather_peak's ilp and u
#ifndef A3D_TABLE_ILP
#define A3D_TABLE_ILP 4
#endif
#ifndef A3D_TABLE_U
#define A3D_TABLE_U 16
#endif
#ifndef A3D_TABLE_MIN_BLOCKS
#define A3D_TABLE_MIN_BLOCKS 1
#endif
#ifndef A3D_TABLE_SECTOR
#define A3D_TABLE_SECTOR 0
#endif
constexpr int kTableIlp = A3D_TABLE_ILP, kTableU = A3D_TABLE_U;
constexpr int kRow = 128;                   // lanes of the TPU probe's rows
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fma_peak(const float* __restrict__ x, float* __restrict__ out, int n, int steps) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const float xe = x[e];
  float total = 0.0f;
  for (int s = 0; s < steps; ++s) {
    const float xs = fmaf(total, 0.0f, xe);
    float a[kFmaIlp];
#pragma unroll
    for (int i = 0; i < kFmaIlp; ++i) a[i] = __fmul_rn(xs, 1.0f + 1e-7f * (float)i);
#pragma unroll
    for (int k = 0; k < kFmaU; ++k) {
#pragma unroll
      for (int i = 0; i < kFmaIlp; ++i) a[i] = fmaf(a[i], 1.0000001f, xs);
    }
    float o = a[0];
#pragma unroll
    for (int i = 1; i < kFmaIlp; ++i) o = __fadd_rn(o, a[i]);
    total = __fadd_rn(total, o);
  }
  out[e] = total;
}

// One warp per 128-wide row: lane l holds row positions l, l + 32, l + 64, l + 96.
__global__ void __launch_bounds__(kThreads)
gather_lane(const int32_t* __restrict__ x, const int32_t* __restrict__ idx, int32_t* __restrict__ out,
            int rows, int steps) {
  __shared__ uint32_t buf[kRowsPerBlock][kLaneIlp][kRow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // whole warps leave together; no block-wide barrier below
  uint32_t xv[4], total[4] = {0u, 0u, 0u, 0u};
  int id[kLaneIlp][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    xv[j] = (uint32_t)x[(size_t)row * kRow + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < kLaneIlp; ++i)
      id[i][j] = idx[((size_t)i * rows + row) * kRow + lane + 32 * j] & (kRow - 1);
  }
  for (int s = 0; s < steps; ++s) {
    uint32_t a[kLaneIlp][4];
#pragma unroll
    for (int i = 0; i < kLaneIlp; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = xv[j] + (uint32_t)i;
#pragma unroll
    for (int k = 0; k < kLaneU; ++k) {
#pragma unroll
      for (int i = 0; i < kLaneIlp; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) buf[warp][i][lane + 32 * j] = a[i][j] + xv[j];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kLaneIlp; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = buf[warp][i][id[i][j]];
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t acc = a[0][j];
#pragma unroll
      for (int i = 1; i < kLaneIlp; ++i) acc += a[i][j];
      total[j] += acc;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[(size_t)row * kRow + lane + 32 * j] = (int32_t)total[j];
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x2c1b3c6du;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t table_load(const int32_t* __restrict__ table, uint32_t j) {
#if A3D_TABLE_SECTOR
  const int4* sector = reinterpret_cast<const int4*>(table + (j & ~7u));
  const int4 lo = __ldg(sector), hi = __ldg(sector + 1);
  return (uint32_t)lo.x + (uint32_t)lo.y + (uint32_t)lo.z + (uint32_t)lo.w + (uint32_t)hi.x + (uint32_t)hi.y +
         (uint32_t)hi.z + (uint32_t)hi.w;
#else
  return (uint32_t)__ldg(table + j);
#endif
}

__global__ void __launch_bounds__(kThreads, A3D_TABLE_MIN_BLOCKS)
gather_table(const int32_t* __restrict__ table, uint32_t m, const int32_t* __restrict__ x,
             int32_t* __restrict__ out, int n, int steps) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const uint32_t xe = (uint32_t)x[e];
  uint32_t total = 0u;
  for (int s = 0; s < steps; ++s) {
    uint32_t st[kTableIlp], a[kTableIlp];
#pragma unroll
    for (int i = 0; i < kTableIlp; ++i) {
      st[i] = mix32(((uint32_t)s * (uint32_t)n + (uint32_t)e) * kTableIlp + (uint32_t)i);
      a[i] = xe + (uint32_t)i;
    }
#pragma unroll
    for (int k = 0; k < kTableU; ++k) {
#pragma unroll
      for (int i = 0; i < kTableIlp; ++i) {
        st[i] = st[i] * 1664525u + 1013904223u;
        a[i] += table_load(table, __umulhi(st[i], m));
      }
    }
    uint32_t acc = a[0];
#pragma unroll
    for (int i = 1; i < kTableIlp; ++i) acc += a[i];
    total += acc;
  }
  out[e] = (int32_t)total;
}

}  // namespace

extern "C" int a3d_fma_peak(const void* x, void* out, int n, int steps, void* stream) {
  fma_peak<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, steps);
  return (int)cudaGetLastError();
}

extern "C" int a3d_gather_lane(const void* x, const void* idx, void* out, int rows, int steps,
                               void* stream) {
  gather_lane<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), rows, steps);
  return (int)cudaGetLastError();
}

extern "C" int a3d_gather_table(const void* table, unsigned m, const void* x, void* out, int n,
                                int steps, void* stream) {
  gather_table<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), (uint32_t)m, static_cast<const int32_t*>(x),
      static_cast<int32_t*>(out), n, steps);
  return (int)cudaGetLastError();
}

#if A3D_ABLATE_L2_FETCH
extern "C" int a3d_l2_fetch_granularity(int bytes, int* previous) {
  size_t old = 0;
  cudaError_t err = cudaDeviceGetLimit(&old, cudaLimitMaxL2FetchGranularity);
  if (err != cudaSuccess) return (int)err;
  *previous = (int)old;
  return (int)cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
}
#endif
