// K1: the fused Gauss-Newton step of image ICP, for B frame pairs at once.
//
// Replaces the TPU kernels align3d_tpu/ops/icp_pallas_v4.py::_icp_kernel_v4
// and align3d_tpu/ops/icp_pallas_v3.py::_icp_kernel_v3. It computes what the
// plain align3d_torch/icp/image_icp.py::icp_step computes (and the JAX
// package's icp_step): per source pixel, transform, project, look the target
// up at trunc(u + 0.5), gate on bounds, validity, distance, normal angle and
// colour, form the point-to-plane and photometric residuals and Jacobians
// (bilinear intensity with the re-truncated +0.005 numeric gradient), and
// reduce both systems to two 8x8 blocks [[H, g], [g^T, sum w r^2]] with the
// weight sum at [7, 7].
//
// What bounds it on an H100: memory. Per pixel it reads 12 bytes of source
// point, 2 bytes of mask and luma, and gathers 32 bytes of target geometry
// and 48 bytes of intensity taps; it does ~150 flops. At 640x480 that is
// ~29 MB per iteration, about 9 us at 3.35 TB/s. The TPU kernels banded the
// target and packed it to ints and bf16 because a TPU has no fast random
// gather; the card has one, so this kernel gathers the exact packs directly
// at the projected pixel (the exact association, which the banded kernels
// approximate inside their band), in float32 throughout.
//
// Design: pass 1 runs one thread per source pixel (each thread walks a fixed
// stride of pixels), keeps the 58 sums of both systems in registers, reduces
// them across the warp with shuffles and across the block's warps in shared
// memory, always in the same order, and writes per-block partials. Pass 2
// runs one block per pair and sums the partials in block order. There are no
// float atomics, so a rerun is bitwise identical.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSys = 29;          // 21 H (upper, row-major) + 6 g + sum w r^2 + sum w
constexpr int kVals = 2 * kSys;   // geometric then colour

struct StepParams {
  int n, h, w;
  float fx, fy, cx, cy;
  float max_dist2, max_angle, max_color2, huber;
};

__device__ __forceinline__ float lerp2(float t00, float t01, float t10, float t11,
                                       float fu, float fv) {
  float a = t00 * (1.0f - fu) + t01 * fu;
  float b = t10 * (1.0f - fu) + t11 * fu;
  return a * (1.0f - fv) + b * fv;
}

// acc[off..off+29) += the system terms of one residual with Jacobian j,
// residual r and weight wt, in the expressions of GNSystem.from_residuals.
__device__ __forceinline__ void accumulate(float* acc, int off, const float j[6],
                                           float r, float wt) {
  float jw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) jw[k] = j[k] * wt;
  int idx = off;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int l = k; l < 6; ++l) acc[idx++] += jw[k] * j[l];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[off + 21 + k] += jw[k] * r;
  acc[off + 27] += (wt * r) * r;
  acc[off + 28] += wt;
}

__global__ void __launch_bounds__(kThreads)
icp_step_partials(const float* __restrict__ rot, const float* __restrict__ trans,
                  const float* __restrict__ points, const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ intensity, const float* __restrict__ geo,
                  const float* __restrict__ taps, StepParams p,
                  float* __restrict__ partials) {
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = rot[b * 9 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = trans[b * 3 + k];

  const size_t base = (size_t)b * p.n;
  float acc[kVals];
#pragma unroll
  for (int k = 0; k < kVals; ++k) acc[k] = 0.0f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n; i += nblk * kThreads) {
    if (!mask[base + i]) continue;
    const float* sp = points + (base + i) * 3;
    const float x = sp[0], y = sp[1], z = sp[2];
    const float px = x * R[0] + y * R[1] + z * R[2] + t[0];
    const float py = x * R[3] + y * R[4] + z * R[5] + t[1];
    const float pz = x * R[6] + y * R[7] + z * R[8] + t[2];

    const float safe_z = (pz == 0.0f) ? 1e-12f : pz;
    const float u = px * p.fx / safe_z + p.cx;
    const float v = py * p.fy / safe_z + p.cy;

    // Nearest pixel at trunc(u + 0.5); NaN fails every comparison.
    const float u_int = truncf(u + 0.5f);
    const float v_int = truncf(v + 0.5f);
    if (!(u_int >= 0.0f && u_int < (float)p.w && v_int >= 0.0f && v_int < (float)p.h)) continue;
    const float* g = geo + (base + (size_t)((int)v_int * p.w + (int)u_int)) * 8;
    if (!(g[6] > 0.0f)) continue;
    const float tnx = g[3], tny = g[4], tnz = g[5];
    const float dx = g[0] - px, dy = g[1] - py, dz = g[2] - pz;
    if (!(dx * dx + dy * dy + dz * dz <= p.max_dist2)) continue;
    // Reference quirk: the transformed source POINT against the target
    // normal; a NaN angle is not rejected.
    const float angle = fabsf(acosf(px * tnx + py * tny + pz * tnz));
    if (angle >= p.max_angle) continue;

    float w_geom = 1.0f;
    const float r_geom = dx * tnx + dy * tny + dz * tnz;
    if (p.huber > 0.0f) {
      const float ar = fabsf(r_geom);
      w_geom = (ar <= p.huber) ? 1.0f : p.huber / fmaxf(ar, 1e-30f);
    }
    const float jg[6] = {tnx, tny, tnz,
                         py * tnz - pz * tny, pz * tnx - px * tnz, px * tny - py * tnx};
    accumulate(acc, 0, jg, r_geom, w_geom);

    // Photometric term at the clamped sample position.
    const float us = fminf(fmaxf(u, 0.0f), (float)(p.w - 1));
    const float vs = fminf(fmaxf(v, 0.0f), (float)(p.h - 1));
    const float u0 = truncf(us), v0 = truncf(vs);
    const float* tp = taps + (base + (size_t)((int)v0 * p.w + (int)u0)) * 12;
    float T[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) T[k] = tp[k];
    const float fu = us - u0, fv = vs - v0;
    const float value = lerp2(T[0], T[1], T[3], T[4], fu, fv);

    const float uh_c = us + 0.005f;
    const float u0h = truncf(uh_c);
    const bool cu = u0h > u0;
    const float uh = lerp2(cu ? T[1] : T[0], cu ? T[2] : T[1], cu ? T[4] : T[3],
                           cu ? T[5] : T[4], uh_c - u0h, fv);
    const float vh_c = vs + 0.005f;
    const float v0h = truncf(vh_c);
    const bool cv = v0h > v0;
    const float vh = lerp2(cv ? T[3] : T[0], cv ? T[4] : T[1], cv ? T[6] : T[3],
                           cv ? T[7] : T[4], fu, vh_c - v0h);
    const float du = (uh - value) * 200.0f;
    const float dv = (vh - value) * 200.0f;

    const float r_color = (float)intensity[base + i] * 0.003921569f - value;
    if (!(r_color * r_color <= p.max_color2)) continue;
    const float zz = safe_z * safe_z;
    const float dfx = p.fx / safe_z;
    const float dcx = -px * p.fx / zz;
    const float dfy = p.fy / safe_z;
    const float dcy = -py * p.fy / zz;
    const float cgx = du * dfx, cgy = dv * dfy, cgz = du * dcx + dv * dcy;
    const float jc[6] = {cgx, cgy, cgz,
                         py * cgz - pz * cgy, pz * cgx - px * cgz, px * cgy - py * cgx};
    accumulate(acc, kSys, jc, r_color, w_geom);
  }

  // Block reduction in a fixed order: warp shuffles, then warps in order.
  __shared__ float smem[kWarps][kVals];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kVals; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) smem[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kVals) {
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += smem[wi][threadIdx.x];
    partials[((size_t)b * nblk + blockIdx.x) * kVals + threadIdx.x] = s;
  }
}

// Index of augmented-block entry (i, j) of one system in its 29 sums, or -1.
__device__ __forceinline__ int sum_index(int i, int j) {
  if (i < 6 && j < 6) {
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    return lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
  }
  if (i < 6 && j == 6) return 21 + i;
  if (i == 6 && j < 6) return 21 + j;
  if (i == 6 && j == 6) return 27;
  if (i == 7 && j == 7) return 28;
  return -1;
}

// One block of 128 threads per pair: thread = one entry of the 2x8x8 output.
__global__ void icp_step_finish(const float* __restrict__ partials, int nblk,
                                float* __restrict__ out) {
  const int b = blockIdx.x;
  const int e = threadIdx.x;  // 0..127
  const int sys = e >> 6, i = (e >> 3) & 7, j = e & 7;
  const int k = sum_index(i, j);
  float s = 0.0f;
  if (k >= 0) {
    const float* src = partials + (size_t)b * nblk * kVals + sys * kSys + k;
    for (int blk = 0; blk < nblk; ++blk) s += src[(size_t)blk * kVals];
  }
  out[(size_t)b * 128 + e] = s;
}

}  // namespace

extern "C" int a3d_icp_step(const void* rot, const void* trans, const void* points,
                            const void* mask, const void* intensity, const void* geo,
                            const void* taps, int batch, int n, int h, int w, float fx,
                            float fy, float cx, float cy, float max_dist2, float max_angle,
                            float max_color2, float huber, void* partials, int nblk,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  StepParams p{n, h, w, fx, fy, cx, cy, max_dist2, max_angle, max_color2, huber};
  icp_step_partials<<<dim3(nblk, batch), kThreads, 0, s>>>(
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(intensity), static_cast<const float*>(geo),
      static_cast<const float*>(taps), p, static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icp_step_finish<<<batch, 128, 0, s>>>(static_cast<const float*>(partials), nblk,
                                         static_cast<float*>(out));
  return (int)cudaGetLastError();
}
