// K2 and K3: the data-dependent stages of the bilateral-grid depth filter,
// over a batch of frames (blockIdx.y is the frame; one frame is a batch of
// one). Each frame has its own image, its own color_min read from a device
// array, and a grid of the depth gd given at run time, so a new depth span
// or bucket needs no rebuild. A frame's output does not depend on the batch
// around it: at B = 65 it is bitwise its B = 1 output.
//
// K2 (bilateral_splat) replaces the TPU kernel
// align3d_tpu/ops/bilateral.py::_splat_kernel. Each grid cell (gy, gx, z)
// sums value x weight and weight over the pixels of its static spatial
// window whose range coordinate lands in channel z. The TPU kernel did this
// as a one-hot compare-accumulate because a TPU has no scatter; here one
// thread per cell walks its <= ceil(sigma) x ceil(sigma) window taps in the
// XLA tap order t = a * B + b, so the float32 sums run in the order of the
// plain _splat and the result is bitwise equal to it (an atomic scatter
// would add in a different order on every run). Every product has a 0/1
// factor, and the range coordinate uses round-to-nearest intrinsics that the
// compiler never contracts into an FMA, so no bit can differ. What bounds it:
// ~25 image reads per cell, almost all hits in L1/L2 (neighbouring z of one
// cell read the same pixels), and the 2 x 4 bytes written per cell
// (12.4 MB at the sample1 grid 2 x 111 x 146 x 96): a few microseconds of
// HBM time per frame.
//
// K3 (bilateral_slice) replaces the TPU kernel
// align3d_tpu/ops/bilateral.py::_slice_kernel. One thread per pixel samples
// the normalized grid's value channel trilinearly: y0/y1/ya and x0/x1/xa
// come from the pixel's static coordinates (tables built by the wrapper with
// the plain _slice's expressions), z0/z1/za from the pixel's depth, and the
// thread reads the 8 corners and forms (1 - za) * pmix[z0] + za * pmix[z1]
// with pmix the x-lerp then y-lerp, or ((1 - za) + za) * pmix[z0] when
// z0 == z1, as the one-hot sum of _slice does. The TPU workarounds stay
// out: the x-lerp matmul, the transposed planes, the 8-row lane-slot pack
// and its limit of 8 image rows per grid row. What bounds it: 8 scattered
// 4-byte reads and one 4-byte write per pixel (~11 MB at 640 x 480, served
// mostly from L2, since the 6 MB value grid fits in the 50 MB cache).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColorPad = 2;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
bilateral_splat(const int32_t* __restrict__ images, const int32_t* __restrict__ cmin, int h,
                int w, float inv_sc, const int32_t* __restrict__ ridx,
                const float* __restrict__ rwt, int a_taps, const int32_t* __restrict__ cidx,
                const float* __restrict__ cwt, int b_taps, int gh, int gw, int gd,
                float* __restrict__ grids) {
  const size_t cells = (size_t)gh * gw * gd;
  const size_t cell = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (cell >= cells) return;
  const int32_t* image = images + (size_t)blockIdx.y * h * w;
  float* out = grids + (size_t)blockIdx.y * 2 * cells;
  const float color_min = (float)cmin[blockIdx.y];
  const int z = (int)(cell % gd);
  const int gx = (int)((cell / gd) % gw);
  const int gy = (int)(cell / ((size_t)gd * gw));

  float acc_v = 0.0f, acc_c = 0.0f;
  for (int a = 0; a < a_taps; ++a) {
    const int r = ridx[gy * a_taps + a];
    const float ra = rwt[gy * a_taps + a];
    for (int bt = 0; bt < b_taps; ++bt) {
      const int c = cidx[gx * b_taps + bt];
      const int d = image[(size_t)r * w + c];
      const float val = (float)d;
      const float valid = d > 0 ? 1.0f : 0.0f;
      const float wt = __fmul_rn(valid, __fmul_rn(ra, cwt[gx * b_taps + bt]));
      const int chan =
          __float2int_rz(__fadd_rn(__fmul_rn(__fsub_rn(val, color_min), inv_sc), 0.5f)) +
          kColorPad;
      const float oh = chan == z ? 1.0f : 0.0f;
      acc_c = __fadd_rn(acc_c, __fmul_rn(oh, wt));
      acc_v = __fadd_rn(acc_v, __fmul_rn(oh, __fmul_rn(wt, val)));
    }
  }
  out[cell] = acc_v;
  out[cells + cell] = acc_c;
}

__device__ __forceinline__ float lerp_x(const float* __restrict__ row, int x0, int x1,
                                        float xa, int gd, int z) {
  return __fadd_rn(__fmul_rn(row[(size_t)x0 * gd + z], __fsub_rn(1.0f, xa)),
                   __fmul_rn(row[(size_t)x1 * gd + z], xa));
}

__global__ void __launch_bounds__(kThreads)
bilateral_slice(const float* __restrict__ grids, const int32_t* __restrict__ images,
                const int32_t* __restrict__ cmin, int h, int w, int gh, int gw, int gd,
                float inv_sc, const int32_t* __restrict__ y0t,
                const int32_t* __restrict__ y1t, const float* __restrict__ yat,
                const int32_t* __restrict__ x0t, const int32_t* __restrict__ x1t,
                const float* __restrict__ xat, float* __restrict__ outs) {
  const size_t pix = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= (size_t)h * w) return;
  const int r = (int)(pix / w), c = (int)(pix % w);
  const size_t frame = blockIdx.y;
  const float* value = grids + frame * 2 * gh * gw * gd;  // channel 0 of the frame's grid
  const int32_t* image = images + frame * h * w;
  float* out = outs + frame * h * w;
  const float color_min = (float)cmin[frame];

  const float chan = __fadd_rn(
      __fmul_rn(__fsub_rn((float)image[pix], color_min), inv_sc), (float)kColorPad);
  const int z0 = clampi(__float2int_rz(chan), 0, gd - 1);
  const int z1 = clampi(__float2int_rz(__fadd_rn(chan, 1.0f)), 0, gd - 1);
  const float za = __fsub_rn(chan, (float)z0);

  const size_t plane = (size_t)gw * gd;
  const float* row0 = value + (size_t)y0t[r] * plane;
  const float* row1 = value + (size_t)y1t[r] * plane;
  const int x0 = x0t[c], x1 = x1t[c];
  const float xa = xat[c], ya = yat[r];
  const float one_m_ya = __fsub_rn(1.0f, ya);

  const float m0 = __fadd_rn(__fmul_rn(lerp_x(row0, x0, x1, xa, gd, z0), one_m_ya),
                             __fmul_rn(lerp_x(row1, x0, x1, xa, gd, z0), ya));
  const float one_m_za = __fsub_rn(1.0f, za);
  float result;
  if (z0 == z1) {
    result = __fmul_rn(__fadd_rn(one_m_za, za), m0);
  } else {
    const float m1 = __fadd_rn(__fmul_rn(lerp_x(row0, x0, x1, xa, gd, z1), one_m_ya),
                               __fmul_rn(lerp_x(row1, x0, x1, xa, gd, z1), ya));
    result = __fadd_rn(__fmul_rn(one_m_za, m0), __fmul_rn(za, m1));
  }
  out[pix] = result;
}

}  // namespace

extern "C" int a3d_bilateral_splat(const void* images, const void* cmin, int batch, int h,
                                   int w, float inv_sc, const void* ridx, const void* rwt,
                                   int a_taps, const void* cidx, const void* cwt, int b_taps,
                                   int gh, int gw, int gd, void* out, void* stream) {
  const size_t cells = (size_t)gh * gw * gd;
  const dim3 blocks((unsigned)((cells + kThreads - 1) / kThreads), (unsigned)batch);
  bilateral_splat<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(images), static_cast<const int32_t*>(cmin), h, w, inv_sc,
      static_cast<const int32_t*>(ridx), static_cast<const float*>(rwt), a_taps,
      static_cast<const int32_t*>(cidx), static_cast<const float*>(cwt), b_taps, gh, gw, gd,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int a3d_bilateral_slice(const void* grids, const void* images, const void* cmin,
                                   int batch, int h, int w, int gh, int gw, int gd,
                                   float inv_sc, const void* y0, const void* y1,
                                   const void* ya, const void* x0, const void* x1,
                                   const void* xa, void* out, void* stream) {
  const size_t pixels = (size_t)h * w;
  const dim3 blocks((unsigned)((pixels + kThreads - 1) / kThreads), (unsigned)batch);
  bilateral_slice<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grids), static_cast<const int32_t*>(images),
      static_cast<const int32_t*>(cmin), h, w, gh, gw, gd, inv_sc,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(ya), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const float*>(xa),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
