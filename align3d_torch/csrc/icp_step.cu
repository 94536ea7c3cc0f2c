// K1: the fused Gauss-Newton step of image ICP, for B frame pairs at once.
//
// Replaces no TPU kernel: it computes the XLA engine's exact step, the plain
// jnp icp_step of align3d_tpu/icp/image_icp.py:54 (the banded Pallas kernels
// _icp_kernel_v3 and _icp_kernel_v4 compute another function; their port is
// K7/K8, csrc/icp_banded.cu). It computes what the plain
// align3d_torch/icp/image_icp.py::icp_step computes: per source pixel,
// transform, project, look the target up at trunc(u + 0.5), gate on bounds,
// validity, distance, normal angle and colour, form the point-to-plane and
// photometric residuals and Jacobians (bilinear intensity with the
// re-truncated +0.005 numeric gradient), and reduce both systems to two 8x8
// blocks [[H, g], [g^T, sum w r^2]] with the weight sum at [7, 7].
//
// What bounds it on an H100: memory, and the latency of the gathers that
// depend on the projection. Per source pixel it streams 12 bytes of point
// and 2 bytes of mask and luma; per valid one it gathers a 32-byte row of
// target geometry and 8 values of the pair's bordered (H+2, W+2) intensity
// map. The TPU kernels banded the target and packed it to ints and bf16
// because a TPU has no fast random gather; the card has one, so this kernel
// gathers at the exact projected pixel (the exact association, which the
// banded kernels approximate inside their band), in float32 throughout. The
// design moves only the bytes the function needs and keeps loads in flight:
//
// - the taps are read from the intensity map itself, tap (dv, du) of base
//   pixel (v0, u0) at map[v0 + dv, u0 + du] (what pack_intensity_taps
//   copies, so no value changes): neighbouring pixels share them through
//   L1, where a pack repeats each value nine times;
// - the geometry row is two read-only 16-byte loads, issued with the taps'
//   loads before the gates that read them;
// - the next pixel's point, mask and luma are loaded before the current
//   pixel's arithmetic;
// - the 58 sums and the pose stay in registers (at most 128 a thread, so
//   2 blocks of 256 threads an SM, without spills).
//
// The per-pixel arithmetic is the plain step's, operation for operation:
// the file builds with -fmad=false (_kernels.FILE_FLAGS), so no product is
// contracted into an FMA, and every expression is written in the twin's
// order (ops/icp_fused.py::icp_step), the Jacobian's 1/z terms as its four
// divisions. A pixel at a gate's boundary (bounds, distance, normal angle,
// colour) then falls the same way here as in the twin, and the counts are
// the twin's; only the sums' order differs.
//
// Reduction: each thread keeps the 58 sums of both systems in registers;
// the block reduces them through a shared-memory transpose, always in the
// same order (on an H100 this beat a shuffle tree per sum, 290 shuffles a
// warp, and a butterfly, which spilled), and writes per-block partials.
// Each thread takes 8 pixels, which spreads the block's fixed cost thinner.
// The number of blocks per pair depends only on the pair's pixel count,
// never on B. The last block of a pair to arrive (an int32 arrival
// counter per pair, incremented after a __threadfence) sums the pair's
// partials in block-index order, writes the blocks and re-arms the counter
// to 0. The sum order does not depend on which block arrives last, and there
// are no float atomics, so a rerun is bitwise identical and a pair's blocks
// at B = 64 are bitwise its B = 1 blocks. Launches that share counters must
// not overlap, so the wrapper keeps one set per device and stream: launches
// on one stream run in order, and launches on two streams use two sets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSys = 29;          // 21 H (upper, row-major) + 6 g + sum w r^2 + sum w
constexpr int kVals = 2 * kSys;   // geometric then colour
constexpr int kMinBlocks = 2;     // resident blocks per SM: at most 128 registers a thread
constexpr int kPitch = kThreads + 8;  // row of the reduction's transpose: 8 mod 32 banks
constexpr int kFinishBatch = 16;  // partials in flight per thread of the final sum

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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
icp_step_kernel(const float* __restrict__ rot, const float* __restrict__ trans,
                const float* __restrict__ points, const uint8_t* __restrict__ mask,
                const uint8_t* __restrict__ intensity, const float* __restrict__ geo,
                const float* __restrict__ imap, StepParams p, float* __restrict__ partials,
                unsigned int* __restrict__ arrivals, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  __shared__ float tr[kSys][kPitch];  // one system's sums, one column per thread
  __shared__ float block_sums[kVals];
  __shared__ float sums[kVals];
  __shared__ bool last;
  float pose[12];  // R row-major, then t
#pragma unroll
  for (int k = 0; k < 12; ++k) pose[k] = k < 9 ? rot[b * 9 + k] : trans[b * 3 + k - 9];

  const size_t base = (size_t)b * p.n;
  const int mw = p.w + 2;
  const float* map = imap + (size_t)b * (p.h + 2) * mw;
  float acc[kVals];
#pragma unroll
  for (int k = 0; k < kVals; ++k) acc[k] = 0.0f;

  const int stride = nblk * kThreads;
  int i = blockIdx.x * kThreads + threadIdx.x;
  // The pixel's streamed inputs, loaded one pixel ahead.
  uint8_t m_next = 0, lum_next = 0;
  float x_next = 0.0f, y_next = 0.0f, z_next = 0.0f;
  if (i < p.n) {
    m_next = __ldg(mask + base + i);
    lum_next = __ldg(intensity + base + i);
    x_next = __ldg(points + (base + i) * 3);
    y_next = __ldg(points + (base + i) * 3 + 1);
    z_next = __ldg(points + (base + i) * 3 + 2);
  }
  for (; i < p.n; i += stride) {
    const uint8_t m = m_next, lum = lum_next;
    const float x = x_next, y = y_next, z = z_next;
    const int next = i + stride;
    if (next < p.n) {
      m_next = __ldg(mask + base + next);
      lum_next = __ldg(intensity + base + next);
      x_next = __ldg(points + (base + next) * 3);
      y_next = __ldg(points + (base + next) * 3 + 1);
      z_next = __ldg(points + (base + next) * 3 + 2);
    }
    if (!m) continue;
    const float px = x * pose[0] + y * pose[1] + z * pose[2] + pose[9];
    const float py = x * pose[3] + y * pose[4] + z * pose[5] + pose[10];
    const float pz = x * pose[6] + y * pose[7] + z * pose[8] + pose[11];

    const float safe_z = (pz == 0.0f) ? 1e-12f : pz;
    const float u = px * p.fx / safe_z + p.cx;
    const float v = py * p.fy / safe_z + p.cy;

    // Nearest pixel at trunc(u + 0.5); NaN fails every comparison.
    const float u_int = truncf(u + 0.5f);
    const float v_int = truncf(v + 0.5f);
    if (!(u_int >= 0.0f && u_int < (float)p.w && v_int >= 0.0f && v_int < (float)p.h)) continue;

    // Both gathers at once: the geometry row, and the taps around the
    // clamped sample position (fmaxf maps NaN to 0, so the base is in range).
    const float4* g4 =
        reinterpret_cast<const float4*>(geo + (base + (size_t)((int)v_int * p.w + (int)u_int)) * 8);
    const float4 ga = __ldg(g4), gb = __ldg(g4 + 1);
    const float us = fminf(fmaxf(u, 0.0f), (float)(p.w - 1));
    const float vs = fminf(fmaxf(v, 0.0f), (float)(p.h - 1));
    const float u0 = truncf(us), v0 = truncf(vs);
    const float* row = map + (size_t)(int)v0 * mw + (int)u0;
    const float t0 = __ldg(row), t1 = __ldg(row + 1), t2 = __ldg(row + 2);
    const float t3 = __ldg(row + mw), t4 = __ldg(row + mw + 1), t5 = __ldg(row + mw + 2);
    const float t6 = __ldg(row + 2 * mw), t7 = __ldg(row + 2 * mw + 1);

    if (!(gb.z > 0.0f)) continue;
    const float tnx = ga.w, tny = gb.x, tnz = gb.y;
    const float dx = ga.x - px, dy = ga.y - py, dz = ga.z - pz;
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
    const float fu = us - u0, fv = vs - v0;
    const float value = lerp2(t0, t1, t3, t4, fu, fv);

    const float uh_c = us + 0.005f;
    const float u0h = truncf(uh_c);
    const bool cu = u0h > u0;
    const float uh = lerp2(cu ? t1 : t0, cu ? t2 : t1, cu ? t4 : t3, cu ? t5 : t4, uh_c - u0h, fv);
    const float vh_c = vs + 0.005f;
    const float v0h = truncf(vh_c);
    const bool cv = v0h > v0;
    const float vh = lerp2(cv ? t3 : t0, cv ? t4 : t1, cv ? t6 : t3, cv ? t7 : t4, fu, vh_c - v0h);
    const float du = (uh - value) * 200.0f;
    const float dv = (vh - value) * 200.0f;

    const float r_color = (float)lum * 0.003921569f - value;
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

  // Block reduction in a fixed order, one system at a time: each thread
  // writes its 29 sums as a column of a shared transpose (no bank
  // conflicts: a row is 8 mod 32 banks long); 8 threads per sum each add
  // 32 entries, strided by 8, and a 3-step shuffle tree joins the 8.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int k = 0; k < kSys; ++k) tr[k][threadIdx.x] = acc[half * kSys + k];
    __syncthreads();
    const int k = threadIdx.x >> 3, q = threadIdx.x & 7;
    float s = 0.0f;
    if (k < kSys) {
#pragma unroll
      for (int e = 0; e < kThreads / 8; ++e) s += tr[k][e * 8 + q];
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (k < kSys && q == 0) block_sums[half * kSys + k] = s;
    __syncthreads();  // before the next system overwrites the transpose
  }

  if (threadIdx.x < kVals) {
    partials[((size_t)b * nblk + blockIdx.x) * kVals + threadIdx.x] = block_sums[threadIdx.x];
    __threadfence();  // the partial is visible device-wide before the arrival
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + b, 1u) == (unsigned)(nblk - 1);
  __syncthreads();
  if (!last) return;

  // The pair's last block: its partials summed in block-index order (read
  // from L2, past this SM's L1), then the (2, 8, 8) blocks.
  __threadfence();
  if (threadIdx.x < kVals) {
    const float* src = partials + (size_t)b * nblk * kVals + threadIdx.x;
    float s = 0.0f;
    int blk = 0;
    for (; blk + kFinishBatch <= nblk; blk += kFinishBatch) {
      float vals[kFinishBatch];
#pragma unroll
      for (int q = 0; q < kFinishBatch; ++q) vals[q] = __ldcg(src + (size_t)(blk + q) * kVals);
#pragma unroll
      for (int q = 0; q < kFinishBatch; ++q) s += vals[q];
    }
    for (; blk < nblk; ++blk) s += __ldcg(src + (size_t)blk * kVals);
    sums[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    const int e = threadIdx.x;
    const int k = sum_index((e >> 3) & 7, e & 7);
    out[(size_t)b * 128 + e] = k >= 0 ? sums[(e >> 6) * kSys + k] : 0.0f;
  }
  if (threadIdx.x == 0) arrivals[b] = 0u;  // re-armed for the next launch
}

}  // namespace

extern "C" int a3d_icp_step(const void* rot, const void* trans, const void* points,
                            const void* mask, const void* intensity, const void* geo,
                            const void* intensity_map, int batch, int n, int h, int w,
                            float fx, float fy, float cx, float cy, float max_dist2,
                            float max_angle, float max_color2, float huber, void* partials,
                            int nblk, void* arrivals, void* out, void* stream) {
  StepParams p{n, h, w, fx, fy, cx, cy, max_dist2, max_angle, max_color2, huber};
  icp_step_kernel<<<dim3(nblk, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(intensity), static_cast<const float*>(geo),
      static_cast<const float*>(intensity_map), p, static_cast<float*>(partials),
      static_cast<unsigned int*>(arrivals), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
