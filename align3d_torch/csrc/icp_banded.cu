// K7 and K8: the banded Gauss-Newton step of image ICP, for B frame pairs at
// once, one template in two instantiations.
//
// Replaces the TPU kernels align3d_tpu/ops/icp_pallas_v3.py::_icp_kernel_v3
// (K7: float32 7-channel target pack, optional displacement stats) and
// align3d_tpu/ops/icp_pallas_v4.py::_icp_kernel_v4 (K8: int32 5-channel pack
// with bf16 normals and u8 taps, the reduction stack rounded to bf16). Each
// computes what its plain twin in align3d_torch/ops/icp_pallas_v3.py /
// icp_pallas_v4.py computes: per source pixel, the ray rebuilt from the pixel
// and its depth, the pose, the projection, and the target looked up at
// (trunc(v + 0.5), trunc(u + 0.5)) only where that lies in the pixel's band:
// 2R + 1 candidate rows around the (chunk, group)'s predicted row and two
// 128-lane groups around its predicted column. Outside the band the pixel
// reads zeros and its weight is 0. Then the gates (bounds, validity,
// distance, the cos-monotone normal-angle gate), the point-to-plane and
// photometric residuals and Jacobians, and per system the 8x8 block
// sum_p aw_k a_l of the (16, N) stack, with the weight sum at [7, 7].
//
// What bounds it on an H100: the band prediction makes every gather land in
// a few rows of the target around the source row, so the pack is read about
// once (K7: 11.06 MB a 640x480 pair, 3.30 us at 3.35 TB/s; K8: 8.60 MB,
// 2.57 us). The TPU kernels stage each chunk's band in VMEM by DMA because a
// TPU has no fast random gather; the card has one, so each thread computes
// its pixel's band membership arithmetically and reads its target channels
// straight from global memory (L1/L2 serve the neighbours' reuse). Past the
// bytes, the time is the ~150 float operations of each pixel (issue-bound)
// and the reduction of the stack, which the TPU kernels run on the MXU as one
// (16, N) x (N, 16) contraction. Here it runs on the tensor cores too, as
// mma.sync: each warp stages its 32 pixels' 16 a channels and two weights in
// shared memory (the rows padded so that ldmatrix reads without bank
// conflicts) and contracts them, M the 16 aw channels, N two 8-channel halves
// of a (the diagonal 8x8 blocks are the halves' useful rows), K the pixels.
// One ldmatrix.x4 a k-step yields both operands: its four registers are the
// B fragments of the two halves, and times the weights the A fragment (aw
// is formed there, rounded as the twin rounds it). K8 (bf16 stack):
// m16n8k16 bf16 with f32 results; a bf16 x bf16 product is exact in f32. K7
// (f32 stack): m16n8k8 tf32 on a 3xTF32 split, hi = tf32(x), lo = tf32(x -
// hi), as lo.hi + hi.lo + hi.hi, about f32's accuracy. Each mma starts from
// a zero accumulator and its result is added into f32 registers in a fixed
// order, so the tensor cores' own accumulation (not IEEE-ordered) spans 8-16
// products only. wgmma wants 64-row tiles, which a 16 x 16 result does not
// fill, and the contraction is far below the tensor rate: the point is to
// keep the reduction off the shared-memory pipe, where scalar loads of the
// 128 entries would cost 16,384 wavefronts a tile.
//
// Layout: a (chunk, group) tile of 16 rows x 128 lanes of one pair is two
// blocks of 256 threads, the same for every B: block hb takes lanes
// 64 hb + [0, 64) of all 16 rows (so the two blocks gather from about
// disjoint halves of the band, and each block's gathers reuse its SM's L1),
// in 4 sub-passes; in sub-pass q thread t takes lane 64 hb + t % 64 of row
// 4 q + t / 64, so each thread holds rows s and s + 8 of its lane, which the
// stats fold adds (the TPU kernel's fold8), and each warp 32 neighbouring
// lanes of one row. The source words of all 4 sub-passes are loaded first.
// Warps need no block barrier in the loop: each contracts its own 32
// pixels. At the end the 8 warps' sums are added in warp order; each block
// writes its 128 sums; the last block of a pair to arrive (an int32 arrival
// counter per pair, shared with K1: launches on one stream run in order)
// adds the pair's partials in block order (two threads an entry, each over
// half the blocks, then the two), writes the blocks and re-arms the counter.
// The order of every sum is fixed: a rerun is bitwise identical, and a
// pair's blocks at B = 64 are bitwise its B = 1 blocks.
//
// The file is compiled with -fmad=false (_kernels.FILE_FLAGS): each product
// and sum rounds on its own, as in the twin, so the association and the
// gates decide as the twin does. Only the reduction differs from the twin's
// order (the mma's products and sums; the flag does not reach inline PTX).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Ablation builds only (tools/ablate.py banded_sections): A3D_BANDED_SKIP_REDUCE
// drops the stack's reduction (the stack's bits are folded into one word by
// xor, so that the compiler keeps all that feeds the stack; the partials are
// zeros), A3D_BANDED_SKIP_GATHER replaces each target word by one the compiler
// cannot see through (no memory access). The library builds neither; their
// results are not the step's.
#ifndef A3D_BANDED_SKIP_REDUCE
#define A3D_BANDED_SKIP_REDUCE 0
#endif
#ifndef A3D_BANDED_SKIP_GATHER
#define A3D_BANDED_SKIP_GATHER 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;
constexpr int kLanes = 128;
constexpr int kBlocksPerTile = 2;                                       // ops/icp_pallas_v3.py BLOCKS_PER_TILE
constexpr int kSubPasses = kChunk * kLanes / (kBlocksPerTile * kThreads);  // 4
constexpr int kStack = 16;                                              // channels of the stack
constexpr int kEntries = 128;                                           // two 8x8 blocks
constexpr int kFinishBatch = 32;

// A warp's staged stack: the 16 channels of a for its 32 pixels and the two
// weights (aw = a w is formed as the contraction reads a). K8 keeps a
// pixel-major (a row of 16 bf16 a pixel, read by ldmatrix.trans), K7
// channel-major (a row of 32 floats a channel, read by ldmatrix); each row
// is padded so that the 8 rows an ldmatrix phase reads fall in 8 distinct
// 16-B bank groups (pitch / 16 odd). Weights: K8 a bf16 row each of w_geom
// and w_color, K7 (w_geom, w_color) float pairs a pixel.
template <bool kV4>
struct Stage {
  static constexpr int kPitch = kV4 ? 48 : 32 * 4 + 16;          // bytes a pixel row (K8) / channel row (K7)
  static constexpr int kRows = kV4 ? 32 : kStack;
  static constexpr int kWeights = kRows * kPitch;                 // byte offset of the weights
  static constexpr int kBytes = kWeights + 32 * 2 * (kV4 ? 2 : 4);
  static constexpr int kSteps = kV4 ? 2 : 4;                      // k-steps: 16 bf16 / 8 f32 pixels each
};

struct BandParams {
  int nchunks, g, h, w, radius;
  float fx, fy, cx, cy, inv_fx, inv_fy;
  float max_dist2, cos_angle, max_color2, huber;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lerp2(float a00, float a01, float a10, float a11, float fu, float fv) {
  const float r0 = a00 * (1.0f - fu) + a01 * fu;
  const float r1 = a10 * (1.0f - fu) + a11 * fu;
  return r0 * (1.0f - fv) + r1 * fv;
}

// clip(x, 0, hi) that keeps a NaN, as jnp.clip and torch.clamp do.
__device__ __forceinline__ float clip_nan(float x, float hi) {
  return x < 0.0f ? 0.0f : (x > hi ? hi : x);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Word c of the target pack at ``t`` (c planes apart).
__device__ __forceinline__ uint32_t target_word(const uint32_t* t, size_t plane, int c) {
#if A3D_BANDED_SKIP_GATHER
  uint32_t r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"((uint32_t)(size_t)t + (uint32_t)c));
  return r;
#else
  return __ldg(t + c * plane);
#endif
}

// The target's channels at (vi, ui): z, nx, ny, nz and the 9 taps in [0, 1].
template <bool kV4>
__device__ __forceinline__ void load_target(const void* pack, size_t plane, size_t base, float& tz, float& nx,
                                            float& ny, float& nz, float taps[9]) {
  const uint32_t* t = static_cast<const uint32_t*>(pack) + base;
  if constexpr (kV4) {
    const uint32_t w0 = target_word(t, plane, 0), w1 = target_word(t, plane, 1), w2 = target_word(t, plane, 2);
    const uint32_t w3 = target_word(t, plane, 3), w4 = target_word(t, plane, 4);
    tz = __uint_as_float(w0);
    nx = __uint_as_float(w1 & 0xFFFF0000u);
    ny = __uint_as_float(w1 << 16);
    nz = __uint_as_float(w2 & 0xFFFF0000u);
    const float inv255 = 1.0f / 255.0f;
    taps[0] = (float)((w3 >> 24) & 0xFF) * inv255;
    taps[1] = (float)((w3 >> 16) & 0xFF) * inv255;
    taps[2] = (float)((w3 >> 8) & 0xFF) * inv255;
    taps[3] = (float)(w3 & 0xFF) * inv255;
    taps[4] = (float)((w4 >> 24) & 0xFF) * inv255;
    taps[5] = (float)((w4 >> 16) & 0xFF) * inv255;
    taps[6] = (float)((w4 >> 8) & 0xFF) * inv255;
    taps[7] = (float)(w4 & 0xFF) * inv255;
    taps[8] = (float)(w2 & 0xFF) * inv255;
  } else {
    tz = __uint_as_float(target_word(t, plane, 0));
    nx = __uint_as_float(target_word(t, plane, 1));
    ny = __uint_as_float(target_word(t, plane, 2));
    nz = __uint_as_float(target_word(t, plane, 3));
    const float inv255 = 1.0f / 255.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float word = __uint_as_float(target_word(t, plane, 4 + c));
      const float a = floorf(word * (1.0f / 65536.0f));
      const float rem = word - a * 65536.0f;
      const float bb = floorf(rem * (1.0f / 256.0f));
      const float cc = rem - bb * 256.0f;
      taps[3 * c] = a * inv255;
      taps[3 * c + 1] = bb * inv255;
      taps[3 * c + 2] = cc * inv255;
    }
  }
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives row l / 4, elements 2 (l % 4) and
// 2 (l % 4) + 1 of each (for 32-bit data: element l % 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d = A B + c, A 16x16 bf16 (row), B 16x8 bf16 (col), f32 d and c.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1,
                                         const float c[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
}

// d = A B + c, A 16x8 tf32 (row), B 8x8 tf32 (col), f32 d and c.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1,
                                         const float c[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
}

// x = hi + lo for 3xTF32 (hi.hi + hi.lo + lo.hi carries ~22 bits): hi is x rounded
// to tf32's 10 fraction bits (half away from zero, on the bits: cvt.rna.tf32.f32
// of a finite x, in 2 integer operations where the conversion takes ~4), lo = x -
// hi exactly, of which the tensor core reads the top 19 bits (truncation:
// |error| < 2^-11 |lo| <= 2^-22 |x|).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// The same with each 8x8 matrix transposed: lane l receives column l / 4,
// rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two bf16 products, each rounded once to nearest even: bf16(bf16(a) bf16(w)).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Adds the contraction of this warp's staged 32 pixels into acc: acc[0..1]
// are entries 8 g + 2 t + {0, 1} of the geometric block, acc[2..3] the same
// of the colour block (g = lane / 4, t = lane % 4). One ldmatrix.x4 a k-step
// gives r[0] = a(channel g), r[1] = a(g + 8) at the k-step's first pixels and
// r[2], r[3] the same at its last: B of the first half (channels 0-7) is
// {r[0], r[2]}, of the second {r[1], r[3]}, and A (aw, 16 channels) is r
// times the pixels' weights, w_geom for channels 0-7 and w_color for 8-15.
template <bool kV4>
__device__ __forceinline__ void contract_step(uint32_t base, const unsigned char* stage, int lane32, int ks,
                                              float acc[4]) {
  using S = Stage<kV4>;
  const int m = lane32 >> 3, t = lane32 & 3;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t r[4], a[4];
  if constexpr (kV4) {
    // Matrix m: pixels 16 ks + 8 (m / 2) + [0, 8), channels 8 (m % 2) + [0, 8).
    ldmatrix_x4_trans(base + (16 * ks + (lane32 & 7) + 8 * (m >> 1)) * S::kPitch + 16 * (m & 1), r);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(stage + S::kWeights);
    // (w(p), w(p + 1)) for p = 16 ks + 2 t and + 8: w_geom's row, then w_color's.
    a[0] = mul_bf16x2(r[0], w[8 * ks + t]);
    a[1] = mul_bf16x2(r[1], w[16 + 8 * ks + t]);
    a[2] = mul_bf16x2(r[2], w[8 * ks + 4 + t]);
    a[3] = mul_bf16x2(r[3], w[16 + 8 * ks + 4 + t]);
  } else {
    // Matrix m: channels 8 (m % 2) + [0, 8), pixels 8 ks + 4 (m / 2) + [0, 4).
    ldmatrix_x4(base + ((lane32 & 7) + 8 * (m & 1)) * S::kPitch + 32 * ks + 16 * (m >> 1), r);
    const float2* w = reinterpret_cast<const float2*>(stage + S::kWeights);
    const float2 w0 = w[8 * ks + t], w1 = w[8 * ks + 4 + t];  // (w_geom, w_color) of pixels t and t + 4
    a[0] = __float_as_uint(__uint_as_float(r[0]) * w0.x);
    a[1] = __float_as_uint(__uint_as_float(r[1]) * w0.y);
    a[2] = __float_as_uint(__uint_as_float(r[2]) * w1.x);
    a[3] = __float_as_uint(__uint_as_float(r[3]) * w1.y);
  }
  uint32_t ah[4], al[4];
  if constexpr (!kV4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
  }
  // Half h: B = a's channels 8 h + [0, 8) = {r[h], r[h + 2]}; its useful rows are
  // aw's channels 8 h + [0, 8), d[2 h] and d[2 h + 1].
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float d[4];
    if constexpr (kV4) {
      mma_bf16(d, a, r[h], r[h + 2], zero);
    } else {
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(r[h], b0h, b0l);
      split_tf32(r[h + 2], b1h, b1l);
      float small[4];
      mma_tf32(small, al, b0h, b1h, zero);
      mma_tf32(small, ah, b0l, b1l, small);
      mma_tf32(d, ah, b0h, b1h, small);
    }
    acc[2 * h] = acc[2 * h] + d[2 * h];
    acc[2 * h + 1] = acc[2 * h + 1] + d[2 * h + 1];
  }
}

// The k-steps in order. K7's are not unrolled: its 3xTF32 step holds ~30
// registers, and four of them interleaved would cost the kernel occupancy.
template <bool kV4>
__device__ __forceinline__ void contract(const unsigned char* stage, int lane32, float acc[4]) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(stage);
  if constexpr (kV4) {
#pragma unroll
    for (int ks = 0; ks < Stage<kV4>::kSteps; ++ks) contract_step<kV4>(base, stage, lane32, ks, acc);
  } else {
#pragma unroll 1
    for (int ks = 0; ks < Stage<kV4>::kSteps; ++ks) contract_step<kV4>(base, stage, lane32, ks, acc);
  }
}

// K8 runs at 48 registers (5 blocks an SM), K7 at 64 (4), neither spilling: the
// kernel is issue-bound at B = 64, and these occupancies hide the gathers'
// latency best of those that need no spill.
template <bool kV4>
__global__ void __launch_bounds__(kThreads, kV4 ? 5 : 4)
icp_banded_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                  const int32_t* __restrict__ chunk_base, const int32_t* __restrict__ dy_base,
                  const int32_t* __restrict__ dx_base, const float* __restrict__ src,
                  const void* __restrict__ tpack, BandParams p, float* __restrict__ partials,
                  unsigned int* __restrict__ arrivals, float* __restrict__ out, float* __restrict__ stats) {
  using S = Stage<kV4>;
  __shared__ __align__(16) unsigned char stages[kWarps][S::kBytes];
  __shared__ float warp_sums[kWarps][kEntries];
  __shared__ float halves[2][kEntries];
  __shared__ bool last;

  const int blk = blockIdx.x, blocks = gridDim.x, b = blockIdx.y;
  const int tile = blk / kBlocksPerTile, hb = blk % kBlocksPerTile;
  const int i = tile / p.g, j = tile % p.g;
  const int tid = threadIdx.x, lane = kLanes / 2 * hb + (tid & 63), quad = tid >> 6;
  const int warp = tid >> 5, lane32 = tid & 31;
  const int hp = p.nchunks * kChunk;
  const int k = p.g * kChunk;

  float pose[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) pose[e] = e < 9 ? rot[b * 9 + e] : trans[b * 3 + e - 9];

  // The tile's band: candidate rows cb + rb0s + [0, 2R] + s, lane groups [ga, ga + n_dg);
  // clip(x, lo, hi) as min(max(x, lo), hi), as jnp.clip (hi < lo gives hi).
  const int cb = chunk_base[b * p.nchunks + i];
  const int dyb = dy_base[(b * p.nchunks + i) * p.g + j];
  const int dxb = dx_base[(b * p.nchunks + i) * p.g + j];
  const int n_dg = p.g > 1 ? 2 : 1;
  const int band_rows = hp < 2 * kChunk ? hp : 2 * kChunk;
  const int rb0s = min(max(i * kChunk + dyb - p.radius - cb, 0), band_rows - (kChunk + 2 * p.radius));
  const int ga = p.g > 1 ? min(max(floor_div(dxb + kLanes * j - 64, kLanes), 0), p.g - n_dg) : 0;
  const int lo = ga * kLanes, hi = (ga + n_dg) * kLanes;

  const size_t plane = (size_t)hp * kLanes;
  const size_t src_z = ((size_t)(b * p.nchunks + i) * 2) * k * kLanes;
  const size_t src_i = src_z + (size_t)k * kLanes;
  const size_t pack_pair = (size_t)b * p.g * (kV4 ? 5 : 7) * plane;
  const float wm1 = (float)(p.w - 1), hm1 = (float)(p.h - 1);

  // Sub-pass q's row; its source words, all loaded before the first projection.
  int rows[kSubPasses];
  float zs[kSubPasses], ints[kSubPasses];
#pragma unroll
  for (int q = 0; q < kSubPasses; ++q) {
    rows[q] = 4 * q + quad;
    const size_t at = (size_t)(j * kChunk + rows[q]) * kLanes + lane;
    zs[q] = __ldg(src + src_z + at);
    ints[q] = __ldg(src + src_i + at);
  }

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#if A3D_BANDED_SKIP_REDUCE
  uint32_t sink = 0u;  // the stack's bits, folded, so that nothing that feeds the stack is dead code
#endif
  float stat_keep[kSubPasses / 2][3];
  unsigned char* stage = stages[warp];

#pragma unroll
  for (int q = 0; q < kSubPasses; ++q) {
    const int s = rows[q];
    const float z = zs[q], s_int = ints[q];
    const float row_f = (float)(i * kChunk + s), col_f = (float)(j * kLanes + lane);
    const float dirx = (col_f - p.cx) * p.inv_fx;
    const float diry = (row_f - p.cy) * p.inv_fy;
    const float sx = dirx * z, sy = diry * z;
    const float px = pose[0] * sx + pose[1] * sy + pose[2] * z + pose[9];
    const float py = pose[3] * sx + pose[4] * sy + pose[5] * z + pose[10];
    const float pz = pose[6] * sx + pose[7] * sy + pose[8] * z + pose[11];
    const float safe_z = pz == 0.0f ? 1e-12f : pz;
    const float inv_z = 1.0f / safe_z;
    const float u = px * p.fx * inv_z + p.cx;
    const float v = py * p.fy * inv_z + p.cy;

    const float u_int = truncf(u + 0.5f), v_int = truncf(v + 0.5f);
    const bool inb = u_int >= 0.0f && u_int < (float)p.w && v_int >= 0.0f && v_int < (float)p.h;
    const int ui = (int)fminf(fmaxf(u_int, 0.0f), wm1);  // fmaxf maps NaN to 0
    const int vi = (int)fminf(fmaxf(v_int, 0.0f), hm1);

    const int rel = vi - s - cb - rb0s;
    const bool matched = rel >= 0 && rel <= 2 * p.radius && ui >= lo && ui < hi;
    float tz = 0.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    float taps[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (matched) {
      const int g2 = ui >> 7;
      load_target<kV4>(tpack, plane, pack_pair + (size_t)g2 * (kV4 ? 5 : 7) * plane + (size_t)vi * kLanes + (ui & 127),
                       tz, nx, ny, nz, taps);
    }

    const float uif = (float)ui, vif = (float)vi;
    const float tpx = (uif - p.cx) * tz * p.inv_fx;
    const float tpy = (vif - p.cy) * tz * p.inv_fy;
    const float dx = tpx - px, dy = tpy - py, dz = tz - pz;
    const bool dist_ok = dx * dx + dy * dy + dz * dz <= p.max_dist2;
    const float dot_pn = px * nx + py * ny + pz * nz;
    const bool angle_rejected = dot_pn <= p.cos_angle && dot_pn >= -1.0f;
    const bool valid = z > 0.0f && inb && tz > 0.0f;
    float w_geom = (valid && dist_ok && !angle_rejected) ? 1.0f : 0.0f;

    const float r_geom = dx * nx + dy * ny + dz * nz;
    if (p.huber > 0.0f) {
      const float ar = fabsf(r_geom);
      w_geom = w_geom * (ar <= p.huber ? 1.0f : __fdiv_rn(p.huber, fmaxf(ar, 1e-30f)));
    }
    const float jg3 = py * nz - pz * ny, jg4 = pz * nx - px * nz, jg5 = px * ny - py * nx;

    const float u_s = clip_nan(u, wm1), v_s = clip_nan(v, hm1);
    const float u0 = truncf(u_s), v0 = truncf(v_s);
    const float fu = u_s - u0, fv = v_s - v0;
    const bool cu1 = u0 == uif, cv1 = v0 == vif;
    const float r0c0 = cv1 ? taps[3] : taps[0], r1c0 = cv1 ? taps[6] : taps[3];
    const float r0c1 = cv1 ? taps[4] : taps[1], r1c1 = cv1 ? taps[7] : taps[4];
    const float r0c2 = cv1 ? taps[5] : taps[2], r1c2 = cv1 ? taps[8] : taps[5];
    const float t00 = cu1 ? r0c1 : r0c0, t01 = cu1 ? r0c2 : r0c1;
    const float t10 = cu1 ? r1c1 : r1c0, t11 = cu1 ? r1c2 : r1c1;
    const float value = lerp2(t00, t01, t10, t11, fu, fv);
    const float uh_c = u_s + 0.005f;
    const float u0h = truncf(uh_c);
    const bool cross_u = u0h > u0;
    const float uh = lerp2(cross_u ? t01 : t00, cross_u ? r0c2 : t01, cross_u ? t11 : t10, cross_u ? r1c2 : t11,
                           uh_c - u0h, fv);
    const float vh_c = v_s + 0.005f;
    const float v0h = truncf(vh_c);
    const bool cross_v = v0h > v0;
    const float t20 = cu1 ? taps[7] : taps[6], t21 = cu1 ? taps[8] : taps[7];
    const float vh = lerp2(cross_v ? t10 : t00, cross_v ? t11 : t01, cross_v ? t20 : t10, cross_v ? t21 : t11,
                           fu, vh_c - v0h);
    const float du_g = (uh - value) * 200.0f;
    const float dv_g = (vh - value) * 200.0f;

    const float r_color = s_int * 0.003921569f - value;
    const float w_color = w_geom * (r_color * r_color <= p.max_color2 ? 1.0f : 0.0f);
    const float gx = du_g * p.fx * inv_z;
    const float gy = dv_g * p.fy * inv_z;
    const float gz = -(du_g * px * p.fx + dv_g * py * p.fy) * inv_z * inv_z;
    const float jc3 = py * gz - pz * gy, jc4 = pz * gx - px * gz, jc5 = px * gy - py * gx;

    const float a[kStack] = {nx, ny, nz, jg3, jg4, jg5, r_geom, 1.0f,
                             gx, gy, gz, jc3, jc4, jc5, r_color, 1.0f};
    // The stack, as the twin rounds it: K8 bf16(a) and bf16(w) (aw = bf16(bf16(a) bf16(w)) is
    // formed in the contraction), K7 a and w (aw = a w).
    const float wg = kV4 ? bf16r(w_geom) : w_geom, wc = kV4 ? bf16r(w_color) : w_color;
    uint32_t packed[kStack / 2];
    if constexpr (kV4) {
#pragma unroll
      for (int c = 0; c < kStack / 2; ++c) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(a[2 * c], a[2 * c + 1]);
        packed[c] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
#if A3D_BANDED_SKIP_REDUCE
#pragma unroll
    for (int c = 0; c < (kV4 ? kStack / 2 : kStack); ++c) sink ^= kV4 ? packed[c] : __float_as_uint(a[c]);
    sink ^= __float_as_uint(wg) ^ __float_as_uint(wc);
#else
    __syncwarp();  // the warp's contraction of the last sub-pass has read the stage
    if constexpr (kV4) {
      uint4* row = reinterpret_cast<uint4*>(stage + lane32 * S::kPitch);
      row[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      row[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(stage + S::kWeights);
      w[lane32] = __float2bfloat16_rn(wg);
      w[32 + lane32] = __float2bfloat16_rn(wc);
    } else {
#pragma unroll
      for (int c = 0; c < kStack; ++c) reinterpret_cast<float*>(stage + c * S::kPitch)[lane32] = a[c];
      reinterpret_cast<float2*>(stage + S::kWeights)[lane32] = make_float2(wg, wc);
    }
    __syncwarp();
    contract<kV4>(stage, lane32, acc);
#endif

    if (!kV4 && stats != nullptr) {
      // A select, as XLA makes of the product with the 0/1 weight: +0 off the weight.
      const bool pw = z > 0.0f && inb;
      const float vals[3] = {pw ? v_int - row_f : 0.0f, pw ? u_int - col_f : 0.0f, pw ? 1.0f : 0.0f};
      if (q < kSubPasses / 2) {
#pragma unroll
        for (int c = 0; c < 3; ++c) stat_keep[q][c] = vals[c];
      } else {
        // rows s - 8 and s: stats[b, i, c, j, s - 8, lane]
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const size_t o = ((((size_t)(b * p.nchunks + i) * 3 + c) * p.g + j) * 8 + (s - 8)) * kLanes + lane;
          stats[o] = stat_keep[q - kSubPasses / 2][c] + vals[c];
        }
      }
    }
  }

  // The warps' sums, added in warp order: this block's partial.
  const int e0 = 8 * (lane32 >> 2) + 2 * (lane32 & 3);
#if A3D_BANDED_SKIP_REDUCE
  if (sink == 0u) acc[0] = 1.0f;
#endif
  warp_sums[warp][e0] = acc[0];
  warp_sums[warp][e0 + 1] = acc[1];
  warp_sums[warp][64 + e0] = acc[2];
  warp_sums[warp][64 + e0 + 1] = acc[3];
  __syncthreads();
  if (tid < kEntries) {
    float sum = warp_sums[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = sum + warp_sums[w][tid];
    partials[((size_t)b * blocks + blk) * kEntries + tid] = sum;
    __threadfence();  // the partial is visible device-wide before the arrival
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + b, 1u) == (unsigned)(blocks - 1);
  __syncthreads();
  if (!last) return;

  // The pair's last block: its partials added in block order (from L2), two
  // threads an entry over half the blocks each (blocks is even), then the two.
  __threadfence();
  {
    const int entry = tid & (kEntries - 1), part = tid >> 7, n = blocks / 2;
    const float* src_part = partials + ((size_t)b * blocks + (size_t)part * n) * kEntries + entry;
    float sum = 0.0f;
    int t = 0;
    for (; t + kFinishBatch <= n; t += kFinishBatch) {
      float vals[kFinishBatch];
#pragma unroll
      for (int e = 0; e < kFinishBatch; ++e) vals[e] = __ldcg(src_part + (size_t)(t + e) * kEntries);
#pragma unroll
      for (int e = 0; e < kFinishBatch; ++e) sum += vals[e];
    }
    for (; t < n; ++t) sum += __ldcg(src_part + (size_t)t * kEntries);
    halves[part][entry] = sum;
  }
  __syncthreads();
  if (tid < kEntries) out[(size_t)b * kEntries + tid] = halves[0][tid] + halves[1][tid];
  if (tid == 0) arrivals[b] = 0u;  // re-armed for the next launch
}

}  // namespace

extern "C" int a3d_icp_banded(int variant, const void* rot, const void* trans, const void* chunk_base,
                              const void* dy_base, const void* dx_base, const void* source_pack,
                              const void* target_pack, int batch, int nchunks, int g, int h, int w, int radius,
                              float fx, float fy, float cx, float cy, float inv_fx, float inv_fy,
                              float max_dist2, float cos_angle, float max_color2, float huber, void* partials,
                              void* arrivals, void* out, void* stats, void* stream) {
  const BandParams p{nchunks, g, h, w, radius, fx, fy, cx, cy, inv_fx, inv_fy,
                     max_dist2, cos_angle, max_color2, huber};
  const dim3 grid(nchunks * g * kBlocksPerTile, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(rot);
  const auto* t = static_cast<const float*>(trans);
  const auto* cb = static_cast<const int32_t*>(chunk_base);
  const auto* dyb = static_cast<const int32_t*>(dy_base);
  const auto* dxb = static_cast<const int32_t*>(dx_base);
  const auto* src = static_cast<const float*>(source_pack);
  auto* part = static_cast<float*>(partials);
  auto* arr = static_cast<unsigned int*>(arrivals);
  auto* o = static_cast<float*>(out);
  if (variant == 1) {
    icp_banded_kernel<true><<<grid, kThreads, 0, s>>>(r, t, cb, dyb, dxb, src, target_pack, p, part, arr, o,
                                                      nullptr);
  } else {
    icp_banded_kernel<false><<<grid, kThreads, 0, s>>>(r, t, cb, dyb, dxb, src, target_pack, p, part, arr, o,
                                                       static_cast<float*>(stats));
  }
  return (int)cudaGetLastError();
}
