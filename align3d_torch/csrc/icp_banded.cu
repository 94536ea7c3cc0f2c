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
// straight from global memory (L1/L2 serve the neighbours' reuse). The
// reduction is where the design spends its time: the stack's 128 entries
// (two 8x8 blocks, not symmetric in K8, where aw = bf16(a w)) are kept in
// shared memory, a sub-pass of 256 pixels at a time, and each of 128 entries
// is added by two threads over half the pixels each; a wgmma on the bf16
// stack is later work.
//
// Layout: one block a (chunk, group) tile of 16 rows x 128 lanes of one pair,
// 256 threads, 8 sub-passes; in sub-pass q thread t takes row 2q + t / 128
// and lane t % 128, so each thread holds rows s and s + 8 of its lane, which
// the stats fold adds (the TPU kernel's fold8). Each block writes its 128
// sums; the last block of a pair to arrive (an int32 arrival counter per
// pair, shared with K1: launches on one stream run in order) adds the pair's
// partials in tile order, writes the blocks and re-arms the counter. The
// order of every sum is fixed: a rerun is bitwise identical, and a pair's
// blocks at B = 64 are bitwise its B = 1 blocks.
//
// The file is compiled with -fmad=false (_kernels.FILE_FLAGS): each product
// and sum rounds on its own, as in the twin, so the association and the
// gates decide as the twin does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;
constexpr int kLanes = 128;
constexpr int kSubPasses = kChunk * kLanes / kThreads;  // 8
constexpr int kStack = 16;                              // channels of the stack
constexpr int kEntries = 128;                           // two 8x8 blocks
constexpr int kPitch = kThreads + 1;
constexpr int kFinishBatch = 16;

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

// The target's channels at (vi, ui): z, nx, ny, nz and the 9 taps in [0, 1].
template <bool kV4>
__device__ __forceinline__ void load_target(const void* pack, size_t plane, size_t base, float& tz, float& nx,
                                            float& ny, float& nz, float taps[9]) {
  if constexpr (kV4) {
    const int32_t* t = static_cast<const int32_t*>(pack) + base;
    const uint32_t w0 = __ldg(t), w1 = __ldg(t + plane), w2 = __ldg(t + 2 * plane);
    const uint32_t w3 = __ldg(t + 3 * plane), w4 = __ldg(t + 4 * plane);
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
    const float* t = static_cast<const float*>(pack) + base;
    tz = __ldg(t);
    nx = __ldg(t + plane);
    ny = __ldg(t + 2 * plane);
    nz = __ldg(t + 3 * plane);
    const float inv255 = 1.0f / 255.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float word = __ldg(t + (4 + c) * plane);
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

template <bool kV4>
__global__ void __launch_bounds__(kThreads)
icp_banded_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                  const int32_t* __restrict__ chunk_base, const int32_t* __restrict__ dy_base,
                  const int32_t* __restrict__ dx_base, const float* __restrict__ src,
                  const void* __restrict__ tpack, BandParams p, float* __restrict__ partials,
                  unsigned int* __restrict__ arrivals, float* __restrict__ out, float* __restrict__ stats) {
  __shared__ float sa[kStack][kPitch];
  __shared__ float saw[kStack][kPitch];
  __shared__ float halves[2][kEntries];
  __shared__ float sums[kEntries];
  __shared__ bool last;

  const int tile = blockIdx.x, tiles = gridDim.x, b = blockIdx.y;
  const int i = tile / p.g, j = tile % p.g;
  const int tid = threadIdx.x, lane = tid & (kLanes - 1), half = tid >> 7;
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

  float acc = 0.0f;  // this thread's half of entry tid % 128
  const int entry = tid & (kEntries - 1);
  const int sys = entry >> 6, ka = sys * 8 + ((entry >> 3) & 7), la = sys * 8 + (entry & 7);
  float stat_keep[4][3];

#pragma unroll
  for (int q = 0; q < kSubPasses; ++q) {
    const int s = 2 * q + half;
    const size_t at = (size_t)(j * kChunk + s) * kLanes + lane;
    const float z = __ldg(src + src_z + at);
    const float s_int = __ldg(src + src_i + at);
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
    if constexpr (kV4) {
      const float wg = bf16r(w_geom), wc = bf16r(w_color);
#pragma unroll
      for (int c = 0; c < kStack; ++c) {
        const float a16 = bf16r(a[c]);
        sa[c][tid] = a16;
        saw[c][tid] = bf16r(a16 * (c < 8 ? wg : wc));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kStack; ++c) {
        sa[c][tid] = a[c];
        saw[c][tid] = a[c] * (c < 8 ? w_geom : w_color);
      }
    }

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

    __syncthreads();
    const int first = half * kLanes;
#pragma unroll 8
    for (int e = 0; e < kLanes; ++e) acc = acc + saw[ka][first + e] * sa[la][first + e];
    __syncthreads();  // before the next sub-pass overwrites the stack
  }

  halves[half][entry] = acc;
  __syncthreads();
  if (tid < kEntries) {
    partials[((size_t)b * tiles + tile) * kEntries + tid] = halves[0][tid] + halves[1][tid];
    __threadfence();  // the partial is visible device-wide before the arrival
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrivals + b, 1u) == (unsigned)(tiles - 1);
  __syncthreads();
  if (!last) return;

  // The pair's last block: its partials added in tile order (from L2).
  __threadfence();
  if (tid < kEntries) {
    const float* part = partials + (size_t)b * tiles * kEntries + tid;
    float s = 0.0f;
    int t = 0;
    for (; t + kFinishBatch <= tiles; t += kFinishBatch) {
      float vals[kFinishBatch];
#pragma unroll
      for (int e = 0; e < kFinishBatch; ++e) vals[e] = __ldcg(part + (size_t)(t + e) * kEntries);
#pragma unroll
      for (int e = 0; e < kFinishBatch; ++e) s += vals[e];
    }
    for (; t < tiles; ++t) s += __ldcg(part + (size_t)t * kEntries);
    sums[tid] = s;
  }
  __syncthreads();
  if (tid < kEntries) out[(size_t)b * kEntries + tid] = sums[tid];
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
  const dim3 grid(nchunks * g, batch);
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
