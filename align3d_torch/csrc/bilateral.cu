// K2 and K3: the data-dependent stages of the bilateral-grid depth filter,
// over a batch of frames (the last grid axis is the frame; one frame is a
// batch of one). Each frame has its own image, its own color_min read from a
// device array, and a grid of the depth gd given at run time, so a new depth
// span or bucket needs no rebuild. A frame's output does not depend on the batch
// around it: at B = 65 it is bitwise its B = 1 output.
//
// K2 (bilateral_splat) replaces the TPU kernel
// align3d_tpu/ops/bilateral.py::_splat_kernel. Each grid cell (gy, gx, z)
// sums value x weight and weight over the pixels of its static spatial
// window whose range coordinate lands in channel z. The TPU kernel did this
// as a one-hot compare-accumulate over every z of a block, because a TPU has
// no scatter. Here one warp owns one (frame, gy, gx) column, whose window
// is a partition of the image (each pixel lies in exactly one column), so
// each pixel is evaluated once. The warp zero-fills the column's gd cells
// of both channels with coalesced stores (16-B stores on the aligned run),
// then takes its window taps 32 at a time in the XLA tap order
// t = a * B + b, one tap per lane: chan, wt and wt * val with the
// round-to-nearest intrinsics of the plain one-hot form, which the compiler
// never contracts into an FMA. __match_any_sync groups the lanes of equal
// chan, and the group's lowest lane stores the cell: the group's terms
// added in ascending tap order, from +0.0 (or from the cell's sum after the
// earlier 32-tap chunks) with __fadd_rn. That is the plain one-hot sum bit
// for bit: every term the one-hot form adds for a non-matching tap, and
// every term of a zero-weight tap, is an exact +-0.0, and adding one to a
// partial sum that started at +0.0 changes no bit. Taps whose chan falls
// outside [0, gd) store nothing (the holes, under the nonzero-minimum
// convention). The ordered loop runs as long as the group is large (up to
// 25 taps on a flat wall) and issues most of the kernel's instructions, so
// while a column's weights are all 1 and its depths sum to at most 2^24, its
// chunks take an exact path instead: there every term and every
// partial sum is an integer float32 holds, so the ordered sum is the exact
// sum, which __popc and __reduce_add_sync give in a few instructions
// (16-bit depths always take it; larger ones fall back to the ordered loop).
// There are no atomics, so a rerun is bitwise identical. What bounds it:
// the grid's bytes, written once (2 x 4 B per cell; 12.4 MB at the sample1
// grid 2 x 111 x 146 x 96), against 1.2 MB of image reads.
//
// K3 (bilateral_slice) replaces the TPU kernel
// align3d_tpu/ops/bilateral.py::_slice_kernel. It samples the grid's value
// channel trilinearly at every pixel: y0/y1/ya and x0/x1/xa come from the
// pixel's static coordinates (tables built by the wrapper with the plain
// _slice's expressions), z0/z1/za from the pixel's depth, and the sample is
// (1 - za) * pmix[z0] + za * pmix[z1] with pmix the x-lerp then y-lerp, or
// ((1 - za) + za) * pmix[z0] when z0 == z1, as the one-hot sum of _slice
// does. One source, two compile-time forms:
// (a) a normalized grid in, the float32 sample out (_slice);
// (b) the blurred grid as the splat and blur leave it: each corner is
//     normalized as it is read, value / count (__fdiv_rn) where count > 0
//     and the value otherwise, which is _normalize's rule cell for cell, and
//     the sample is truncated (__float2int_rz) into the int32 output, the
//     cast the filter applies (_normalize_slice). The filter paths thus
//     write no normalized grid and run no separate cast.
// The TPU workarounds stay out: the x-lerp matmul, the transposed planes, the
// 8-row lane-slot pack and its limit of 8 image rows per grid row. What
// bounds it: the bytes, each pixel's 4-byte depth read and 4-byte output
// written, and the distinct grid cells its pixels sample (4 bytes each in
// (a), value and count in (b)), a few MB per frame. The kernel is latency
// bound: what counts is how many of those scattered loads are in flight. One
// block covers (a segment of) one image row, whose y0/y1/ya are uniform
// across it. The block reads the segment's depths with 16-B loads into
// shared memory and writes its outputs back from there with 16-B stores; in
// between, thread t samples the pixels t, t + T, ... (T threads), so that
// each load, across a warp, covers 32 consecutive pixels, whose corners
// share grid cells (the column tables are read the same way, coalesced).
// A thread works out all its corner offsets and issues all its loads before
// it uses any: 4 pixels (32 loads) in form (a), 1 pixel (16 loads and 8
// divisions, which need the registers) in form (b). Grid offsets within a
// frame are 32-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColorPad = 2;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

constexpr int kSplatColumns = kThreads / 32;  // one warp per grid column
constexpr unsigned kExact = 1u << 24;  // float32 holds every integer up to here

// Build with -DA3D_SPLAT_EXACT=0 to send every chunk through the ordered loop
// (the comparison of align3d_torch/tools/ablate.py); the library keeps 1.
#ifndef A3D_SPLAT_EXACT
#define A3D_SPLAT_EXACT 1
#endif

// Zero n floats at p with the lanes of one warp: scalar stores up to the
// first 16-B boundary, float4 stores over the aligned run, scalar after it.
__device__ __forceinline__ void zero_run(float* p, int n, int lane) {
  int head = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2);
  head = head < n ? head : n;
  if (lane < head) p[lane] = 0.0f;
  float4* body = reinterpret_cast<float4*>(p + head);
  const int quads = (n - head) >> 2;
  for (int i = lane; i < quads; i += 32) body[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int tail = head + 4 * quads;
  if (tail + lane < n) p[tail + lane] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
bilateral_splat(const int32_t* __restrict__ images, const int32_t* __restrict__ cmin, int h,
                int w, float inv_sc, const int32_t* __restrict__ ridx,
                const float* __restrict__ rwt, int a_taps, const int32_t* __restrict__ cidx,
                const float* __restrict__ cwt, int b_taps, int gh, int gw, int gd,
                float* __restrict__ grids) {
  __shared__ float s_wt[kSplatColumns][32], s_wv[kSplatColumns][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gx = blockIdx.x * kSplatColumns + warp, gy = blockIdx.y, frame = blockIdx.z;
  if (gx >= gw) return;  // the whole warp
  const size_t cells = (size_t)gh * gw * gd;
  const int32_t* image = images + (size_t)frame * h * w;
  float* value = grids + (size_t)frame * 2 * cells + ((size_t)gy * gw + gx) * gd;
  float* count = value + cells;
  const float color_min = (float)cmin[frame];

  zero_run(value, gd, lane);
  zero_run(count, gd, lane);
  __syncwarp();  // orders the zero fill before the cells' sums

  const int taps = a_taps * b_taps;
  // The column's depths so far, saturated past kExact, and set past it for
  // good by a weight other than 1: the column is exact while seen <= kExact.
  unsigned seen = 0;
  for (int first = 0; first < taps; first += 32) {
    const int t = first + lane;
    int chan = -1, d = 0;
    float wt = 0.0f, wv = 0.0f;
    if (t < taps) {
      const int a = t / b_taps, bt = t - a * b_taps;
      d = image[(size_t)ridx[gy * a_taps + a] * w + cidx[gx * b_taps + bt]];
      const float val = (float)d;
      wt = __fmul_rn(d > 0 ? 1.0f : 0.0f, __fmul_rn(rwt[gy * a_taps + a], cwt[gx * b_taps + bt]));
      wv = __fmul_rn(wt, val);
      const int c =
          __float2int_rz(__fadd_rn(__fmul_rn(__fsub_rn(val, color_min), inv_sc), 0.5f)) +
          kColorPad;
      if (wt != 0.0f && c >= 0 && c < gd) chan = c;  // a zero-weight tap adds nothing
    }
    const unsigned group = __match_any_sync(0xffffffffu, chan);
    const bool leader = chan >= 0 && lane == __ffs(group) - 1;
    // Exact while every weight so far is 1 and the column's depths so far sum
    // to at most 2^24: then each term and every partial sum is an integer
    // that float32 holds, the ordered sum is exact, and an integer sum in any
    // order gives its bits.
    const unsigned depth = chan >= 0 ? min((unsigned)d, kExact + 1u) : 0u;  // d > 0 where chan >= 0
    seen = min(seen + __reduce_add_sync(0xffffffffu, depth), kExact + 1u);
    if (!__all_sync(0xffffffffu, chan < 0 || wt == 1.0f)) seen = kExact + 1u;
    if (A3D_SPLAT_EXACT && seen <= kExact) {
      const unsigned sum = __reduce_add_sync(group, depth);
      if (leader) {
        count[chan] = __fadd_rn(first == 0 ? 0.0f : count[chan], (float)__popc(group));
        value[chan] = __fadd_rn(first == 0 ? 0.0f : value[chan], (float)sum);
      }
    } else {
      // The ordered sum: the group's lowest lane adds its terms in lane order.
      s_wt[warp][lane] = wt;
      s_wv[warp][lane] = wv;
      __syncwarp();
      if (leader) {
        float acc_c = first == 0 ? 0.0f : count[chan];
        float acc_v = first == 0 ? 0.0f : value[chan];
        for (unsigned m = group; m != 0u; m &= m - 1u) {
          const int j = __ffs(m) - 1;
          acc_c = __fadd_rn(acc_c, s_wt[warp][j]);
          acc_v = __fadd_rn(acc_v, s_wv[warp][j]);
        }
        count[chan] = acc_c;
        value[chan] = acc_v;
      }
    }
    __syncwarp();  // the next chunk reads these cells and rewrites s_wt / s_wv
  }
}

// Pixels of a row segment per thread: form (a) keeps 4 pixels' 32 corner
// loads in flight; form (b), with 16 loads and 8 divisions a pixel, runs
// fastest at 1. Build with -DA3D_SLICE_PIXELS_A=n / -DA3D_SLICE_PIXELS_B=n to
// change them (the comparison of align3d_torch/tools/ablate.py); the
// library keeps 4 and 1.
#ifndef A3D_SLICE_PIXELS_A
#define A3D_SLICE_PIXELS_A 4
#endif
#ifndef A3D_SLICE_PIXELS_B
#define A3D_SLICE_PIXELS_B 1
#endif
template <bool kFused>
__host__ __device__ constexpr int slice_pixels() { return kFused ? A3D_SLICE_PIXELS_B : A3D_SLICE_PIXELS_A; }
constexpr int kCorners = 8;      // (z0, z1) x (y0, y1) x (x0, x1)

template <bool kFused, bool kVec>
__global__ void __launch_bounds__(kThreads)
bilateral_slice(const float* __restrict__ grids, const int32_t* __restrict__ images,
                const int32_t* __restrict__ cmin, int h, int w, int gh, int gw, int gd,
                float inv_sc, const int32_t* __restrict__ y0t,
                const int32_t* __restrict__ y1t, const float* __restrict__ yat,
                const int32_t* __restrict__ x0t, const int32_t* __restrict__ x1t,
                const float* __restrict__ xat, void* __restrict__ outs) {
  // The segment's depths, then (each thread rewriting only its own slots)
  // its outputs' bits.
  constexpr int kSlicePixels = slice_pixels<kFused>();
  __shared__ __align__(16) int32_t s_pix[kSlicePixels * kThreads];
  const int t = threadIdx.x, nt = blockDim.x;
  const int seg = blockIdx.x * nt * kSlicePixels;  // the segment's first column
  const int n = min(w - seg, nt * kSlicePixels);   // its pixels
  const int r = blockIdx.y, frame = blockIdx.z;
  const size_t row_at = ((size_t)frame * h + r) * w + seg;
  if (kVec) {  // 16-B loads (n is a multiple of 4 here)
    for (int i = 4 * t; i < n; i += 4 * nt)
      *reinterpret_cast<int4*>(s_pix + i) = *reinterpret_cast<const int4*>(images + row_at + i);
  } else {
    for (int i = t; i < n; i += nt) s_pix[i] = images[row_at + i];
  }
  __syncthreads();

  const int cells = gh * gw * gd;  // the wrapper keeps 2 * cells below 2^31
  const float* value = grids + (size_t)frame * 2 * cells;  // channel 0 of the frame's grid
  const float color_min = (float)cmin[frame];
  const int plane = gw * gd;
  const int row0 = y0t[r] * plane, row1 = y1t[r] * plane;
  const float ya = yat[r];
  const float one_m_ya = __fsub_rn(1.0f, ya);

  // Every corner's offset first, then every load, then the arithmetic.
  int off[kSlicePixels][kCorners];
  float xa[kSlicePixels], za[kSlicePixels];
  bool flat[kSlicePixels];
#pragma unroll
  for (int k = 0; k < kSlicePixels; ++k) {
    const int i = min(t + k * nt, n - 1);  // past the segment: a repeat, never stored
    const int c = seg + i;
    const float chan = __fadd_rn(
        __fmul_rn(__fsub_rn((float)s_pix[i], color_min), inv_sc), (float)kColorPad);
    const int z0 = clampi(__float2int_rz(chan), 0, gd - 1);
    const int z1 = clampi(__float2int_rz(__fadd_rn(chan, 1.0f)), 0, gd - 1);
    za[k] = __fsub_rn(chan, (float)z0);
    flat[k] = z0 == z1;
    xa[k] = xat[c];
    const int a0 = x0t[c] * gd, a1 = x1t[c] * gd;
    off[k][0] = row0 + a0 + z0, off[k][1] = row0 + a1 + z0;
    off[k][2] = row1 + a0 + z0, off[k][3] = row1 + a1 + z0;
    off[k][4] = row0 + a0 + z1, off[k][5] = row0 + a1 + z1;
    off[k][6] = row1 + a0 + z1, off[k][7] = row1 + a1 + z1;
  }
  float v[kSlicePixels][kCorners], cnt[kSlicePixels][kCorners];
#pragma unroll
  for (int k = 0; k < kSlicePixels; ++k) {
#pragma unroll
    for (int j = 0; j < kCorners; ++j) {
      v[k][j] = __ldg(value + off[k][j]);
      if (kFused) cnt[k][j] = __ldg(value + cells + off[k][j]);
    }
  }

#pragma unroll
  for (int k = 0; k < kSlicePixels; ++k) {
    if (kFused) {
#pragma unroll
      for (int j = 0; j < kCorners; ++j) {
        // An empty cell (count 0, most cells) skips the division, which is
        // a dozen instructions and a branch.
        if (cnt[k][j] > 0.0f) v[k][j] = __fdiv_rn(v[k][j], cnt[k][j]);
      }
    }
    const float one_m_xa = __fsub_rn(1.0f, xa[k]);
    float lx[4];  // the x-lerps of rows (y0, z0), (y1, z0), (y0, z1), (y1, z1)
#pragma unroll
    for (int j = 0; j < 4; ++j) lx[j] = __fadd_rn(__fmul_rn(v[k][2 * j], one_m_xa), __fmul_rn(v[k][2 * j + 1], xa[k]));
    const float m0 = __fadd_rn(__fmul_rn(lx[0], one_m_ya), __fmul_rn(lx[1], ya));
    const float m1 = __fadd_rn(__fmul_rn(lx[2], one_m_ya), __fmul_rn(lx[3], ya));
    const float one_m_za = __fsub_rn(1.0f, za[k]);
    const float res = flat[k] ? __fmul_rn(__fadd_rn(one_m_za, za[k]), m0)
                              : __fadd_rn(__fmul_rn(one_m_za, m0), __fmul_rn(za[k], m1));
    const int i = t + k * nt;
    if (i < n) s_pix[i] = kFused ? __float2int_rz(res) : __float_as_int(res);
  }
  __syncthreads();

  int32_t* out = static_cast<int32_t*>(outs) + row_at;  // int32 values, or float32 bits
  if (kVec) {  // 16-B stores
    for (int i = 4 * t; i < n; i += 4 * nt)
      *reinterpret_cast<int4*>(out + i) = *reinterpret_cast<const int4*>(s_pix + i);
  } else {
    for (int i = t; i < n; i += nt) out[i] = s_pix[i];
  }
}

template <bool kFused, bool kVec>
void launch_slice(dim3 blocks, int threads, cudaStream_t stream, const void* grids, const void* images,
                  const void* cmin, int h, int w, int gh, int gw, int gd, float inv_sc,
                  const void* y0, const void* y1, const void* ya, const void* x0, const void* x1,
                  const void* xa, void* out) {
  bilateral_slice<kFused, kVec><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(grids), static_cast<const int32_t*>(images),
      static_cast<const int32_t*>(cmin), h, w, gh, gw, gd, inv_sc,
      static_cast<const int32_t*>(y0), static_cast<const int32_t*>(y1),
      static_cast<const float*>(ya), static_cast<const int32_t*>(x0),
      static_cast<const int32_t*>(x1), static_cast<const float*>(xa), out);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int a3d_bilateral_splat(const void* images, const void* cmin, int batch, int h,
                                   int w, float inv_sc, const void* ridx, const void* rwt,
                                   int a_taps, const void* cidx, const void* cwt, int b_taps,
                                   int gh, int gw, int gd, void* out, void* stream) {
  const dim3 blocks((unsigned)((gw + kSplatColumns - 1) / kSplatColumns), (unsigned)gh, (unsigned)batch);
  bilateral_splat<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(images), static_cast<const int32_t*>(cmin), h, w, inv_sc,
      static_cast<const int32_t*>(ridx), static_cast<const float*>(rwt), a_taps,
      static_cast<const int32_t*>(cidx), static_cast<const float*>(cwt), b_taps, gh, gw, gd,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// fused = 0: form (a), float32 out; fused = 1: form (b), int32 out.
extern "C" int a3d_bilateral_slice(const void* grids, const void* images, const void* cmin,
                                   int batch, int h, int w, int gh, int gw, int gd,
                                   float inv_sc, const void* y0, const void* y1,
                                   const void* ya, const void* x0, const void* x1,
                                   const void* xa, int fused, void* out, void* stream) {
  const int pixels = fused ? slice_pixels<true>() : slice_pixels<false>();
  const int groups = (w + pixels - 1) / pixels;  // threads a row needs
  const int threads = min(kThreads, (groups + 31) / 32 * 32);
  const dim3 blocks((unsigned)((groups + threads - 1) / threads), (unsigned)h, (unsigned)batch);
  const bool vec = w % 4 == 0 && aligned16(images) && aligned16(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    (vec ? launch_slice<true, true> : launch_slice<true, false>)(
        blocks, threads, s, grids, images, cmin, h, w, gh, gw, gd, inv_sc, y0, y1, ya, x0, x1, xa, out);
  } else {
    (vec ? launch_slice<false, true> : launch_slice<false, false>)(
        blocks, threads, s, grids, images, cmin, h, w, gh, gw, gd, inv_sc, y0, y1, ya, x0, x1, xa, out);
  }
  return (int)cudaGetLastError();
}
