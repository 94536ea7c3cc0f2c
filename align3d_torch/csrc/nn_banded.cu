// K4: banded sorted-grid nearest-neighbour search.
//
// Replaces the TPU kernel align3d_tpu/ops/nn_banded.py::_nn_kernel (through
// nearest_banded and, in payload mode, associate_p2p). It keeps that
// kernel's search contract, so the candidates are the same set: for each
// block of 128 sorted queries, 9 bands of band_tiles x 128 consecutive sorted
// DB positions, starting at the wrapper's band starts. The TPU kernel scored
// a candidate tile with an MXU matmul, double-buffered the bands with DMA
// semaphores and carried the winner's payload through lane selects; none of
// that carries over.
//
// The score is c3 + ((qx*c0 + qy*c1) + qz*c2) with c0..c2 = -2c and
// c3 = |c|^2, written with round-to-nearest intrinsics that nvcc never
// contracts into FMAs: the plain twin (ops/nn_banded.py::band_search_plain)
// computes the same expression in the same order, so the two agree bitwise.
// The winner is the smallest score, then the smallest sorted position among
// equal scores (a lexicographic minimum, independent of the scan order); a
// NaN score never wins; a query with no finite score gets the first position
// whose score is +inf, or none. In payload mode the winner's rows 4..7 are
// gathered. No atomics: a rerun is bitwise equal.
//
// What bounds it on the H100: the issue rate of the scoring loop (a band of
// 512 is 4,608 candidates x 128 queries per block, 8 flops each; the DB
// reads are L2 hits, since neighbouring blocks read overlapping bands). The
// design cuts the instructions per query-candidate pair:
// - One 256-thread block takes one query block. Each warp covers all 128
//   queries, 4 per lane, and scores 16 of every staged tile's 128
//   candidates: one broadcast shared-memory load of a candidate serves 4
//   queries, and the 16 candidates are unrolled, so a pair costs the 6
//   rounded operations of the score, a compare and two selects.
// - Within one warp's run of a band the positions increase, so a strict
//   s < best keeps the first of equal scores, the smallest position: the
//   inner loop has no tie test. The winner's index within a 16-candidate
//   slice is an immediate, added to the slice's position once per slice.
//   The full (score, position) rule runs only where runs meet: once per
//   band (bands may overlap, or coincide when the DB is smaller than a
//   band) and once per query when the 8 warps' winners merge through shared
//   memory.
// - Staging is asynchronous: rows 0..3 of each tile (2 KB, contiguous) go
//   to a ring of 3 chunks of 4 tiles (24 KB a block, whatever the band
//   width) with cp.async, so the loads of chunk c + 2 overlap the scoring of
//   chunk c, and one barrier per chunk both publishes a chunk and frees the
//   buffer it overwrites.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQB = 128;                  // queries per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQPT = kQB / 32;            // queries per lane: a warp covers the query block
constexpr int kSlice = kQB / kWarps;      // candidates of each tile a warp scores
constexpr int kPlanes = 8;                // rows of a position-major planes tile
constexpr int kBands = 9;                 // one band per (dx, dy)
constexpr int kTileFloats = 4 * kQB;      // rows 0..3 of a tile, as they lie in memory
constexpr int kChunkTiles = 4;            // tiles per staged chunk (8 KB)
constexpr int kChunkFloats = kChunkTiles * kTileFloats;
constexpr int kStages = 3;                // chunks in the ring
constexpr int kNoWinner = 0x7fffffff;

static_assert(kQPT == 4 && kSlice % 4 == 0, "the scoring loop reads 4 candidates per load");
static_assert(2 * kWarps * kQB <= kStages * kChunkFloats, "the block merge reuses the ring");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float score_of(float qx, float qy, float qz, float c0, float c1, float c2,
                                          float c3) {
  return __fadd_rn(c3, __fadd_rn(__fadd_rn(__fmul_rn(qx, c0), __fmul_rn(qy, c1)), __fmul_rn(qz, c2)));
}

// (s, p) comes first in the lexicographic (score, position) order.
__device__ __forceinline__ bool before(float s, int p, float best, int bpos) {
  return s < best || (s == best && p < bpos);
}

__global__ void __launch_bounds__(kThreads)
nn_banded(const float* __restrict__ planes, const float* __restrict__ queries,
          const int32_t* __restrict__ bstarts, int qp, int tiles, int band_tiles, int payload,
          float* __restrict__ score, int32_t* __restrict__ pos_out, float* __restrict__ pay) {
  __shared__ __align__(16) float ring[kStages * kChunkFloats];
  __shared__ int s_tile0[kBands];
  const int blk = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t < kBands) {
    // The wrapper's starts already keep the band inside the DB; the clamp
    // only guards memory against a bad argument.
    const int tile0 = bstarts[blk * kBands + t] / kQB;
    s_tile0[t] = max(0, min(tile0, tiles - band_tiles));
  }
  float qx[kQPT], qy[kQPT], qz[kQPT];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int qi = blk * kQB + i * 32 + lane;
    qx[i] = queries[qi];
    qy[i] = queries[qp + qi];
    qz[i] = queries[2 * qp + qi];
  }
  __syncthreads();  // s_tile0

  const int per_band = (band_tiles + kChunkTiles - 1) / kChunkTiles;
  const int nchunks = kBands * per_band;
  // Stage chunk c (or nothing past the last) as one cp.async group.
  auto stage = [&](int c) {
    if (c < nchunks) {
      const int b = c / per_band, first = (c - b * per_band) * kChunkTiles;
      const int pieces = min(kChunkTiles, band_tiles - first) * (kTileFloats / 4);
      const float* src = planes + (size_t)(s_tile0[b] + first) * (kPlanes * kQB);
      float* dst = ring + (c % kStages) * kChunkFloats;
      for (int i = t; i < pieces; i += kThreads) {
        const int j = i / (kTileFloats / 4), k = 4 * (i - j * (kTileFloats / 4));
        cp_async16(dst + j * kTileFloats + k, src + (size_t)j * (kPlanes * kQB) + k);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) stage(c);

  float best[kQPT], band_best[kQPT];
  int bpos[kQPT], band_pos[kQPT];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    best[i] = band_best[i] = INFINITY;
    bpos[i] = band_pos[i] = kNoWinner;
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of chunk c have landed
    __syncthreads();               // everyone's have; chunk c - 1's buffer is free
    stage(c + kStages - 1);
    const int b = c / per_band, first = (c - b * per_band) * kChunkTiles;
    const int nt = min(kChunkTiles, band_tiles - first);
    const float* buf = ring + (c % kStages) * kChunkFloats + warp * kSlice;
    for (int j = 0; j < nt; ++j) {
      const float* tile = buf + j * kTileFloats;
      int won[kQPT];  // index in this slice of the run's new winner, -1 if none
#pragma unroll
      for (int i = 0; i < kQPT; ++i) won[i] = -1;
#pragma unroll
      for (int u = 0; u < kSlice; u += 4) {
        const float4 c0 = *reinterpret_cast<const float4*>(tile + u);
        const float4 c1 = *reinterpret_cast<const float4*>(tile + kQB + u);
        const float4 c2 = *reinterpret_cast<const float4*>(tile + 2 * kQB + u);
        const float4 c3 = *reinterpret_cast<const float4*>(tile + 3 * kQB + u);
#pragma unroll
        for (int i = 0; i < kQPT; ++i) {
          const float s0 = score_of(qx[i], qy[i], qz[i], c0.x, c1.x, c2.x, c3.x);
          if (s0 < band_best[i]) { band_best[i] = s0; won[i] = u; }
          const float s1 = score_of(qx[i], qy[i], qz[i], c0.y, c1.y, c2.y, c3.y);
          if (s1 < band_best[i]) { band_best[i] = s1; won[i] = u + 1; }
          const float s2 = score_of(qx[i], qy[i], qz[i], c0.z, c1.z, c2.z, c3.z);
          if (s2 < band_best[i]) { band_best[i] = s2; won[i] = u + 2; }
          const float s3 = score_of(qx[i], qy[i], qz[i], c0.w, c1.w, c2.w, c3.w);
          if (s3 < band_best[i]) { band_best[i] = s3; won[i] = u + 3; }
        }
      }
      const int slice_pos = (s_tile0[b] + first + j) * kQB + warp * kSlice;
#pragma unroll
      for (int i = 0; i < kQPT; ++i) band_pos[i] = won[i] >= 0 ? slice_pos + won[i] : band_pos[i];
    }
    if (first + nt == band_tiles) {  // the band's last chunk: merge its run
#pragma unroll
      for (int i = 0; i < kQPT; ++i) {
        if (before(band_best[i], band_pos[i], best[i], bpos[i])) {
          best[i] = band_best[i];
          bpos[i] = band_pos[i];
        }
        band_best[i] = INFINITY;
        band_pos[i] = kNoWinner;
      }
    }
  }

  // Merge the 8 warps' winners of each query, in warp order, through the ring.
  cp_async_wait<0>();
  __syncthreads();
  float* s_best = ring;
  int* s_pos = reinterpret_cast<int*>(ring + kWarps * kQB);
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    s_best[warp * kQB + i * 32 + lane] = best[i];
    s_pos[warp * kQB + i * 32 + lane] = bpos[i];
  }
  __syncthreads();
  if (t >= kQB) return;
  float bs = s_best[t];
  int bq = s_pos[t];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float s = s_best[w * kQB + t];
    const int p = s_pos[w * kQB + t];
    if (before(s, p, bs, bq)) {
      bs = s;
      bq = p;
    }
  }
  const int qi = blk * kQB + t;
  if (bs == INFINITY) {
    // No finite score (a NaN query, or scores that overflowed): the strict
    // compare took no +inf, so look for the first +inf position once more.
    const float x = queries[qi], y = queries[qp + qi], z = queries[2 * qp + qi];
    for (int b = 0; b < kBands; ++b) {
      for (int k = 0; k < band_tiles * kQB; ++k) {
        const int p = s_tile0[b] * kQB + k;
        const float* c = planes + (size_t)(p / kQB) * (kPlanes * kQB) + (p % kQB);
        if (p < bq && score_of(x, y, z, c[0], c[kQB], c[2 * kQB], c[3 * kQB]) == INFINITY) bq = p;
      }
    }
  }
  score[qi] = bs;
  pos_out[qi] = bq;
  if (payload) {
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;
    if (bq != kNoWinner) {
      const float* src = planes + (size_t)(bq / kQB) * (kPlanes * kQB) + (bq % kQB);
      w0 = src[4 * kQB];
      w1 = src[5 * kQB];
      w2 = src[6 * kQB];
      w3 = src[7 * kQB];
    }
    pay[qi] = w0;
    pay[qp + qi] = w1;
    pay[2 * qp + qi] = w2;
    pay[3 * qp + qi] = w3;
  }
}

}  // namespace

extern "C" int a3d_nn_banded(const void* planes, const void* queries, const void* bstarts,
                             int nblocks, int tiles, int band_tiles, int payload, void* score,
                             void* pos, void* pay, void* stream) {
  nn_banded<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float*>(queries),
      static_cast<const int32_t*>(bstarts), nblocks * kQB, tiles, band_tiles, payload,
      static_cast<float*>(score), static_cast<int32_t*>(pos), static_cast<float*>(pay));
  return (int)cudaGetLastError();
}
