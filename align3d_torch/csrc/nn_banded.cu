// K4: banded sorted-grid nearest-neighbour search.
//
// Replaces the TPU kernel align3d_tpu/ops/nn_banded.py::_nn_kernel (through
// nearest_banded and, in payload mode, associate_p2p). It keeps that
// kernel's search contract, so the candidates are the same set: for each
// block of 128 sorted queries, 9 bands of band_tiles x 128 consecutive sorted
// DB positions, starting at the wrapper's band starts. The TPU kernel scored
// a candidate tile with an MXU matmul, double-buffered the bands with DMA
// semaphores and carried the winner's payload through lane selects; none of
// that carries over. Here one 128-thread block takes one query block, one
// thread per query. For each band the threads stage up to 8 tiles of
// candidates in shared memory (rows 0..3 of the position-major planes, one
// float4 per candidate, each global read coalesced), then every thread scores
// all staged candidates from shared memory, where the reads are broadcasts.
//
// The score is c3 + ((qx*c0 + qy*c1) + qz*c2) with c0..c2 = -2c and
// c3 = |c|^2, written with round-to-nearest intrinsics that nvcc never
// contracts into FMAs: the plain twin (ops/nn_banded.py::band_search_plain)
// computes the same expression in the same order, so the two agree bitwise.
// The winner is the smallest score, then the smallest sorted position among
// equal scores (a lexicographic minimum, independent of the scan order); a
// NaN score never wins. In payload mode the thread then reads rows 4..7 of
// the winning position, one gather. No atomics: a rerun is bitwise equal.
//
// What bounds it on the H100: issue rate of the scoring loop. Each
// candidate costs ~10 instructions per query (three multiplies, three
// adds, the compare and two selects) and a broadcast shared-memory load,
// so a band width of 512 is 4,608 candidates x 128 queries per block; the
// DB traffic is 9 x band_width x 16 bytes per block, mostly L2 hits since
// neighbouring blocks read overlapping bands. The design keeps every
// candidate in shared memory once per block and every query in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQB = 128;        // queries per block = threads per block
constexpr int kPlanes = 8;      // rows of a position-major planes tile
constexpr int kBands = 9;       // one band per (dx, dy)
constexpr int kChunkTiles = 8;  // tiles staged in shared memory at once (16 KB)
constexpr int kNoWinner = 0x7fffffff;

__global__ void __launch_bounds__(kQB)
nn_banded(const float* __restrict__ planes, const float* __restrict__ queries,
          const int32_t* __restrict__ bstarts, int qp, int tiles, int band_tiles, int payload,
          float* __restrict__ score, int32_t* __restrict__ pos_out, float* __restrict__ pay) {
  __shared__ float4 cand[kChunkTiles * kQB];
  const int blk = blockIdx.x;
  const int t = threadIdx.x;
  const int qi = blk * kQB + t;
  const float qx = queries[qi];
  const float qy = queries[qp + qi];
  const float qz = queries[2 * qp + qi];

  float best = INFINITY;
  int bpos = kNoWinner;
  for (int b = 0; b < kBands; ++b) {
    // The wrapper's starts already keep the band inside the DB; the clamp
    // only guards memory against a bad argument.
    int tile0 = bstarts[blk * kBands + b] / kQB;
    tile0 = max(0, min(tile0, tiles - band_tiles));
    for (int c0 = 0; c0 < band_tiles; c0 += kChunkTiles) {
      const int nt = min(kChunkTiles, band_tiles - c0);
      __syncthreads();  // the previous chunk's scoring is done
      for (int j = 0; j < nt; ++j) {
        const float* src = planes + (size_t)(tile0 + c0 + j) * (kPlanes * kQB);
        cand[j * kQB + t] = make_float4(src[t], src[kQB + t], src[2 * kQB + t], src[3 * kQB + t]);
      }
      __syncthreads();
      const int base = (tile0 + c0) * kQB;
      const int ncand = nt * kQB;
      for (int k = 0; k < ncand; ++k) {
        const float4 c = cand[k];
        const float s = __fadd_rn(
            c.w, __fadd_rn(__fadd_rn(__fmul_rn(qx, c.x), __fmul_rn(qy, c.y)), __fmul_rn(qz, c.z)));
        const int p = base + k;
        if (s < best || (s == best && p < bpos)) {
          best = s;
          bpos = p;
        }
      }
    }
  }
  score[qi] = best;
  pos_out[qi] = bpos;
  if (payload) {
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f, w3 = 0.0f;
    if (bpos != kNoWinner) {
      const float* src = planes + (size_t)(bpos / kQB) * (kPlanes * kQB) + (bpos % kQB);
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
  nn_banded<<<nblocks, kQB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const float*>(queries),
      static_cast<const int32_t*>(bstarts), nblocks * kQB, tiles, band_tiles, payload,
      static_cast<float*>(score), static_cast<int32_t*>(pos), static_cast<float*>(pay));
  return (int)cudaGetLastError();
}
