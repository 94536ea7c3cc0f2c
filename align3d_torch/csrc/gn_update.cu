// K11: what the image ICP loop does with a GN iteration's two systems after
// the step, for B pairs in one launch: the plain twin is
// align3d_torch/optim/gauss_newton.py::gn_update_plain (GNSystem.add_weighted,
// mean_squared_residual, solve, Transform.exp and compose, the best-pose
// select), which ran as ~145 PyTorch launches an iteration.
//
// No TPU kernel is replaced: the JAX package runs this as plain jnp inside
// its jitted align (align3d_tpu/icp/image_icp.py), with a float32 solve. The
// port keeps the reference's float64 solve (gaussnewton.rs:84-93).
//
// One thread a pair. It reads the two 8x8 augmented blocks [[H, g], [g^T,
// sum w r^2]] (count at [7, 7]) where the step wrote them (a pair stride, no
// copy), and:
//   1. merges them: H by w1^2 and w2^2 (each rounded to float32 on the host,
//      as a tensor-by-Python-scalar product rounds it), g and sum w r^2 by
//      w1 and w2, the counts unweighted;
//   2. reads the residual sum w r^2 / count (IEEE division) before the update;
//   3. solves H x = g in float64 with an unrolled 6x6 Cholesky (lower, L L^T)
//      and two triangular solves, all in registers (a pivot that is not
//      positive: cholesky_solve6); an empty system (count > 0 false) gives
//      a zero update; the update is cast to float32;
//   4. forms exp(update) @ pose in float32: the quaternion and left-Jacobian
//      Taylor switches at theta^2 < 1e-16 and < 1e-8, quat_to_matrix's
//      2 / max(|q|^2, FLT_MIN), the compose as three products summed in
//      order, as se3.py's _matmul3;
//   5. keeps the new pose as the best where residual < best (strict: a tie
//      keeps the earlier pose and NaN never wins), and writes it as the pose
//      the next step reads, in place. Nothing waits on the host.
//
// The file builds with -fmad=false (_kernels.FILE_FLAGS) and rounds every
// float32 product and sum on its own (__fmul_rn, __fadd_rn), as the twin's
// separate PyTorch ops round them. A few hundred operations a pair: its
// launch is what it costs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
// Python floats as a float32 tensor op rounds them: se3._EPSILON ** 2 and
// se3._EPSILON, the Taylor coefficients, torch.finfo(float32).tiny.
constexpr float kEpsSq = static_cast<float>(1e-16);
constexpr float kEps = static_cast<float>(1e-8);
constexpr float kC48 = static_cast<float>(1.0 / 48.0);
constexpr float kC3840 = static_cast<float>(1.0 / 3840.0);
constexpr float kC8 = static_cast<float>(1.0 / 8.0);
constexpr float kC384 = static_cast<float>(1.0 / 384.0);
constexpr float kTiny = 1.17549435e-38f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, b), c); }

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // lower triangle, row-major

// Cholesky of the merged H (lower triangle, float64) and the solve of
// L L^T x = g. No pivot is tested: one that is not positive gives sqrt's NaN
// (or a zero divisor) and the solves carry it, as the card's cholesky_ex and
// cholesky_solve do (on an H100, at B = 1 and B > 1: a failed factorization
// gave NaN in all six entries, a zero last pivot NaN and an infinity). LAPACK
// on the CPU stops at such a pivot instead and returns finite values there.
__device__ __forceinline__ void cholesky_solve6(double l[21], double x[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    double d = l[tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= l[tri(j, k)] * l[tri(j, k)];
    const double root = sqrt(d);
    l[tri(j, j)] = root;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      double s = l[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= l[tri(i, k)] * l[tri(j, k)];
      l[tri(i, j)] = s / root;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {  // L y = g
    double s = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[tri(i, k)] * x[k];
    x[i] = s / l[tri(i, i)];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {  // L^T x = y
    double s = x[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= l[tri(k, i)] * x[k];
    x[i] = s / l[tri(i, i)];
  }
}

__global__ void __launch_bounds__(kThreads) gn_update_kernel(
    const float* __restrict__ geom, const float* __restrict__ color, long long stride, int pairs, float w1sq,
    float w2sq, float w1, float w2, float* __restrict__ rot, float* __restrict__ trans, float* __restrict__ best_res,
    float* __restrict__ best_rot, float* __restrict__ best_trans) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= pairs) return;
  const float* a1 = geom + b * stride;
  const float* a2 = color + b * stride;

  // 1-2. The merge and the residual, read before the update.
  double l[21];
  double x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) l[tri(i, j)] = add(mul(a1[i * 8 + j], w1sq), mul(a2[i * 8 + j], w2sq));
    x[i] = add(mul(a1[i * 8 + 6], w1), mul(a2[i * 8 + 6], w2));
  }
  const float sq = add(mul(a1[6 * 8 + 6], w1), mul(a2[6 * 8 + 6], w2));
  const float count = add(a1[7 * 8 + 7], a2[7 * 8 + 7]);
  const float residual = __fdiv_rn(sq, count);

  // 3. The float64 solve; zero for an empty system.
  cholesky_solve6(l, x);
  float u[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) u[i] = count > 0.0f ? static_cast<float>(x[i]) : 0.0f;

  // 4. exp(u) = (Q, V v): the quaternion of omega, then its matrix.
  const float o0 = u[3], o1 = u[4], o2 = u[5];
  const float theta_sq = sum3(mul(o0, o0), mul(o1, o1), mul(o2, o2));
  const bool small_q = theta_sq < kEpsSq;
  const float theta = __fsqrt_rn(small_q ? 1.0f : theta_sq);
  const float theta_po4 = mul(theta_sq, theta_sq);
  const float half = mul(0.5f, theta);
  const float imag =
      small_q ? add(sub(0.5f, mul(kC48, theta_sq)), mul(kC3840, theta_po4)) : __fdiv_rn(sinf(half), theta);
  const float real = small_q ? add(sub(1.0f, mul(kC8, theta_sq)), mul(kC384, theta_po4)) : cosf(half);
  const float qw = real, qx = mul(imag, o0), qy = mul(imag, o1), qz = mul(imag, o2);
  const float norm_sq = add(sum3(mul(qw, qw), mul(qx, qx), mul(qy, qy)), mul(qz, qz));
  const float s = __fdiv_rn(2.0f, norm_sq < kTiny ? kTiny : norm_sq);  // NaN stays NaN
  const float sw = mul(s, qw), sx = mul(s, qx), sy = mul(s, qy), sz = mul(s, qz);
  const float wx = mul(sw, qx), wy = mul(sw, qy), wz = mul(sw, qz);
  const float xx = mul(sx, qx), xy = mul(sx, qy), xz = mul(sx, qz);
  const float yy = mul(sy, qy), yz = mul(sy, qz), zz = mul(sz, qz);
  const float re[9] = {sub(1.0f, add(yy, zz)), sub(xy, wz), add(xz, wy),
                       add(xy, wz), sub(1.0f, add(xx, zz)), sub(yz, wx),
                       sub(xz, wy), add(yz, wx), sub(1.0f, add(xx, yy))};

  // The left Jacobian V (its small-angle form below theta^2 = 1e-8) and V v.
  const float om[9] = {0.0f, -o2, o1, o2, 0.0f, -o0, -o1, o0, 0.0f};
  float om_sq[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      om_sq[i * 3 + j] = sum3(mul(om[i * 3], om[j]), mul(om[i * 3 + 1], om[3 + j]), mul(om[i * 3 + 2], om[6 + j]));
    }
  }
  const bool small_j = theta_sq < kEps;
  const float safe_theta_sq = small_j ? 1.0f : theta_sq;
  const float safe_theta = small_j ? 1.0f : theta;
  const float c1 = __fdiv_rn(sub(1.0f, cosf(safe_theta)), safe_theta_sq);
  const float c2 = __fdiv_rn(sub(safe_theta, sinf(safe_theta)), mul(safe_theta_sq, safe_theta));
  float vjac[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    vjac[k] = small_j ? add(eye, mul(0.5f, om[k])) : add(add(eye, mul(c1, om[k])), mul(c2, om_sq[k]));
  }
  float te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    te[i] = sum3(mul(vjac[i * 3], u[0]), mul(vjac[i * 3 + 1], u[1]), mul(vjac[i * 3 + 2], u[2]));
  }

  // exp(u) @ (R, t): R' = Re R, t' = Re t + te, three products summed in order.
  float* r = rot + b * 9;
  float* t = trans + b * 3;
  float r0[9], t0[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r0[k] = r[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) t0[i] = t[i];
  float r1[9], t1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r1[i * 3 + j] = sum3(mul(re[i * 3], r0[j]), mul(re[i * 3 + 1], r0[3 + j]), mul(re[i * 3 + 2], r0[6 + j]));
    }
    t1[i] = add(sum3(mul(re[i * 3], t0[0]), mul(re[i * 3 + 1], t0[1]), mul(re[i * 3 + 2], t0[2])), te[i]);
  }

  // 5. The select (strict <) and the pose the next step reads.
  if (residual < best_res[b]) {
    best_res[b] = residual;
#pragma unroll
    for (int k = 0; k < 9; ++k) best_rot[b * 9 + k] = r1[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) best_trans[b * 3 + i] = t1[i];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = r1[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t1[i];
}

}  // namespace

// geom, color: the (batch, 8, 8) float32 augmented blocks of the step, rows
// of 8 contiguous floats, pair b at b * stride floats; w1sq, w2sq: f32(w1 *
// w1), f32(w2 * w2). rot (batch, 3, 3), trans (batch, 3), best_res (batch,),
// best_rot, best_trans: float32, updated in place.
extern "C" int a3d_gn_update(const void* geom, const void* color, long long stride, int batch, float w1sq, float w2sq,
                             float w1, float w2, void* rot, void* trans, void* best_res, void* best_rot,
                             void* best_trans, void* stream) {
  if (batch <= 0) return 0;
  gn_update_kernel<<<(batch + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const float*>(color), stride, batch, w1sq, w2sq, w1, w2,
      static_cast<float*>(rot), static_cast<float*>(trans), static_cast<float*>(best_res),
      static_cast<float*>(best_rot), static_cast<float*>(best_trans));
  return (int)cudaGetLastError();
}
