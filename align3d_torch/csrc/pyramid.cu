// K12 pyramid_base_kernel and K13 pyramid_down_kernel: the range-image
// pyramid of B frames, one launch a level. The plain twin is
// align3d_torch/ops/pyramid.py::pyramid_plain (backprojection,
// ops/normals.py::compute_normals, ops/resize.py::resize_nearest_to_mean,
// image.py::py_scale_down, rgb_to_luma_u8, ops/intensity.py::
// build_intensity_map), which ran as ~640 PyTorch launches a 3-level build.
//
// No TPU kernel is replaced: the JAX package builds the pyramid as plain jnp
// (align3d_tpu/range_image.py::build_pyramid_impl) that XLA fuses inside its
// jitted, vmapped build. On the card the same chain of elementwise ops cost
// a launch each: ~9 ms of host dispatch a tracker frame, and ~26 ms of device
// time (each op sweeping every frame) a 65-frame batch step, where the work
// is a few bytes a pixel.
//
// Bound: bytes. A 640x480 frame's level 0 reads the int32 depth and the u8
// colour (7 B a pixel) and writes points and normals (24 B), mask and luma
// (2 B) and the bordered intensity map (4 B): 11.4 MB. A coarser level reads
// the finer points, normals, mask and colour (28 B a finer pixel) and writes
// 33 B a pixel: 11.1 MB at level 1, 2.8 MB at level 2. 25 MB a frame, 1.6 GB
// a 65-frame step, 0.49 ms at 3.35 TB/s; a handful of flops a byte.
//
// Design: one block a 32x8 tile of a level's pixels (a warp a row), a grid of
// (tiles x frames). Each level reads its inputs once and writes each output
// once:
//   K12: the tile's depth and a one-pixel halo are backprojected once into
//        shared memory; the normals' stencil reads its four neighbours there.
//   K13: the 2x2 windows of the finer points and normals are read straight
//        (a warp's windows cover 64 contiguous finer pixels of two rows); the
//        colour blur reads a shared tile of the finer colour with the taps'
//        halo, runs the rows pass there at the even rows, then the columns
//        pass at the even columns.
// (H, W, 3) float32 outputs go out through a shared staging row, so that a
// warp stores 384 contiguous bytes in three coalesced instructions.
//
// Bitwise the twin: the file builds with -fmad=false (_kernels.FILE_FLAGS)
// and every product, sum and quotient is rounded on its own in the twin's
// order (__fmul_rn, __fadd_rn, __fdiv_rn: IEEE division, as a tensor divided
// by a 0-d tensor or by a tensor is). Python's sum starts at the integer 0,
// so each masked sum and squared distance adds 0.0f first (-0.0 becomes
// +0.0); x ** 2 is x * x; the normals' magnitude is the float64 root rounded
// once to float32; constants are the float32 roundings of the twin's Python
// numbers (0.3, 0.59, 0.11, 1e-6, 255).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;  // a warp: pixels of a tile's row
constexpr int kTileH = 8;   // warps: rows of a tile
constexpr int kMaxTaps = 32;

struct BlurTaps {
  float w[kMaxTaps];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }

// rgb_to_luma_u8: (r * 0.3 + g * 0.59) + b * 0.11, truncated.
__device__ __forceinline__ uint8_t luma_u8(uint8_t r, uint8_t g, uint8_t b) {
  const float l = add(add(mul(static_cast<float>(r), 0.3f), mul(static_cast<float>(g), 0.59f)),
                      mul(static_cast<float>(b), 0.11f));
  return static_cast<uint8_t>(static_cast<unsigned>(l));
}

// Pixel (v, u)'s share of build_intensity_map's (h+2, w+2) map: its luma /
// 255, and the border cells the reference fill copies from it. The last
// pixel also writes the six border cells the fill leaves at zero.
__device__ __forceinline__ void write_map(float* __restrict__ map, int h, int w, int v, int u, uint8_t luma) {
  const int w2 = w + 2;
  const float c = __fdiv_rn(static_cast<float>(luma), 255.0f);
  map[v * w2 + u] = c;
  if (v == h - 1 && u <= w - 2) {  // rows h, h+1 copy row h-1, columns 0..w-2
    map[h * w2 + u] = c;
    map[(h + 1) * w2 + u] = c;
  }
  if (u == w - 1 && v <= h - 2) {  // columns w, w+1 copy column w-1, rows 0..h-2
    map[v * w2 + w] = c;
    map[v * w2 + w + 1] = c;
  }
  if (v == h - 1 && u == w - 1) {
    map[h * w2 + w] = c;
    map[(h + 1) * w2 + w + 1] = c;
    map[(h - 1) * w2 + w] = 0.0f;
    map[(h - 1) * w2 + w + 1] = 0.0f;
    map[h * w2 + w - 1] = 0.0f;
    map[h * w2 + w + 1] = 0.0f;
    map[(h + 1) * w2 + w - 1] = 0.0f;
    map[(h + 1) * w2 + w] = 0.0f;
  }
}

// A warp's 32 pixels of (x, y, z) to out (the row's pixel u0), coalesced:
// the values go through the warp's staging row, then lane k of each of
// three stores writes float k * 32 + lane. n: the row's pixels in the image
// (0 where the row is below it). Every lane of the warp calls it.
__device__ __forceinline__ void store_xyz(float* __restrict__ out, float* __restrict__ stage, int lane, int n,
                                          float x, float y, float z) {
  stage[3 * lane] = x;
  stage[3 * lane + 1] = y;
  stage[3 * lane + 2] = z;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = k * kTileW + lane;
    if (i < 3 * n) out[i] = stage[i];
  }
  __syncwarp();
}

// ops/normals.py::_axis_difference for one pixel: central, backward or
// forward difference by the ratio of the squared distances.
__device__ __forceinline__ void axis_difference(const float c[3], const float back[3], const float fwd[3],
                                                float out[3]) {
  float bd = 0.0f, fd = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) bd = add(bd, sq(sub(back[k], c[k])));
#pragma unroll
  for (int k = 0; k < 3; ++k) fd = add(fd, sq(sub(fwd[k], c[k])));
  const float ratio = __fdiv_rn(bd, fd);  // 0/0 is NaN and fails both tests
  const bool central = (ratio < 4.0f) && (ratio > 0.25f);
  const bool back_closer = bd < fd;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = central ? sub(fwd[k], back[k]) : (back_closer ? sub(c[k], back[k]) : sub(fwd[k], c[k]));
}

// ops/resize.py::resize_nearest_to_mean for one pixel's four taps: the
// masked mean, then the valid tap nearest to it (strict <: the first on
// ties), zero where no tap is valid.
__device__ __forceinline__ void nearest_to_mean(const float val[4][3], const float m[4], bool any, float safe,
                                                float out[3]) {
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) s = add(s, mul(val[t][c], m[t]));
    mean[c] = __fdiv_rn(s, safe);
  }
  float best[3] = {val[0][0], val[0][1], val[0][2]};
  float best_d = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) d = add(d, sq(sub(val[t][c], mean[c])));
    d = m[t] > 0.0f ? d : INFINITY;
    if (t == 0) {
      best_d = d;
    } else if (d < best_d) {
      best_d = d;
      best[0] = val[t][0];
      best[1] = val[t][1];
      best[2] = val[t][2];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = any ? best[c] : 0.0f;
}

// K12: level 0 of frame blockIdx.z. Writes mask, points, and where their
// pointers are not null the normals, the luma and the intensity map.
__global__ void __launch_bounds__(kTileW * kTileH)
pyramid_base_kernel(const int32_t* __restrict__ depth, const uint8_t* __restrict__ color,
                    const float* __restrict__ scales, float scale, int h, int w, float fx, float fy, float cx,
                    float cy, float* __restrict__ points, uint8_t* __restrict__ mask, float* __restrict__ normals,
                    uint8_t* __restrict__ intens, float* __restrict__ map) {
  __shared__ float tile[3][kTileH + 2][kTileW + 2];  // backprojected points, one-pixel halo
  __shared__ uint8_t tile_mask[kTileH + 2][kTileW + 2];
  __shared__ float stage[kTileH][3 * kTileW];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int u0 = blockIdx.x * kTileW, v0 = blockIdx.y * kTileH;
  const size_t frame = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const float s = scales != nullptr ? scales[frame] : scale;
  const int32_t* d = depth + frame * plane;

  // RangeImage.from_rgbd: z = depth * scale, x = ((u - cx) * z) / fx,
  // y = ((v - cy) * z) / fy; holes and pixels outside the image (0, 0, 0).
  for (int i = row * kTileW + lane; i < (kTileH + 2) * (kTileW + 2); i += kTileW * kTileH) {
    const int tv = i / (kTileW + 2), tu = i % (kTileW + 2);
    const int v = v0 + tv - 1, u = u0 + tu - 1;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    uint8_t valid = 0;
    if (v >= 0 && v < h && u >= 0 && u < w) {
      const int32_t dv = d[static_cast<size_t>(v) * w + u];
      if (dv > 0) {
        valid = 1;
        z = mul(static_cast<float>(dv), s);
        x = __fdiv_rn(mul(sub(static_cast<float>(u), cx), z), fx);
        y = __fdiv_rn(mul(sub(static_cast<float>(v), cy), z), fy);
      }
    }
    tile[0][tv][tu] = x;
    tile[1][tv][tu] = y;
    tile[2][tv][tu] = z;
    tile_mask[tv][tu] = valid;
  }
  __syncthreads();

  const int v = v0 + row, u = u0 + lane;
  const bool inside = v < h && u < w;
  const int n = v < h ? min(kTileW, w - u0) : 0;
  const size_t pix = frame * plane + static_cast<size_t>(v) * w + u;
  const size_t row_start = frame * plane + static_cast<size_t>(v) * w + u0;
  const int tv = row + 1, tu = lane + 1;
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = tile[k][tv][tu];
  store_xyz(points + 3 * row_start, stage[row], lane, n, c[0], c[1], c[2]);
  if (inside) mask[pix] = tile_mask[tv][tu];

  if (normals != nullptr) {
    // compute_normals: left/right differences, then bottom (row + 1) as the
    // backward and top (row - 1) as the forward neighbour.
    float left[3], right[3], below[3], above[3], lr[3], bt[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      left[k] = tile[k][tv][tu - 1];
      right[k] = tile[k][tv][tu + 1];
      below[k] = tile[k][tv + 1][tu];
      above[k] = tile[k][tv - 1][tu];
    }
    axis_difference(c, left, right, lr);
    axis_difference(c, below, above, bt);
    const float nx = sub(mul(lr[1], bt[2]), mul(lr[2], bt[1]));
    const float ny = sub(mul(lr[2], bt[0]), mul(lr[0], bt[2]));
    const float nz = sub(mul(lr[0], bt[1]), mul(lr[1], bt[0]));
    const float s2 = add(add(mul(nx, nx), mul(ny, ny)), mul(nz, nz));
    const float mag = __double2float_rn(__dsqrt_rn(static_cast<double>(s2)));
    const bool ok = mag > 1e-6f;
    const float safe = ok ? mag : 1.0f;
    store_xyz(normals + 3 * row_start, stage[row], lane, n, ok ? __fdiv_rn(nx, safe) : 0.0f,
              ok ? __fdiv_rn(ny, safe) : 0.0f, ok ? __fdiv_rn(nz, safe) : 0.0f);
  }

  if (intens != nullptr && inside) {
    const uint8_t* px = color + 3 * pix;
    const uint8_t l = luma_u8(px[0], px[1], px[2]);
    intens[pix] = l;
    write_map(map + frame * (static_cast<size_t>(h) + 2) * (w + 2), h, w, v, u, l);
  }
}

// K13: the level below (h, w) -> (dh, dw) = (h / 2, w / 2) of frame
// blockIdx.z. Points and normals (where not null): the 2x2 window at
// (trunc(v * ratio_v), trunc(u * ratio_u)), clamped, by nearest-to-mean.
// Colour: py_scale_down's blur, taps lo .. lo + ntaps - 1 with replicated
// borders, rows pass at row 2v then columns pass at column 2u, clamped to
// [0, 255] and truncated. Luma and map as K12.
__global__ void __launch_bounds__(kTileW * kTileH)
pyramid_down_kernel(const float* __restrict__ points, const float* __restrict__ normals,
                    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ colors, int h, int w, int dh,
                    int dw, float ratio_v, float ratio_u, int lo, int ntaps, BlurTaps taps,
                    float* __restrict__ out_points, float* __restrict__ out_normals, uint8_t* __restrict__ out_mask,
                    uint8_t* __restrict__ out_colors, uint8_t* __restrict__ out_intens,
                    float* __restrict__ out_map) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float stage[kTileH][3 * kTileW];
  __shared__ float wts[kMaxTaps];  // the taps' weights: a parameter indexed at run time would go to the stack
  const int rows_t = 2 * (kTileH - 1) + ntaps, cols_t = 2 * (kTileW - 1) + ntaps;
  uint8_t* ctile = smem;  // (rows_t, cols_t, 3) finer colour, clamped
  float* rpass = reinterpret_cast<float*>(smem + ((rows_t * cols_t * 3 + 15) & ~15));  // (kTileH, cols_t, 3)
  const int lane = threadIdx.x, row = threadIdx.y, tid = row * kTileW + lane;
  const int u0 = blockIdx.x * kTileW, v0 = blockIdx.y * kTileH;
  const size_t frame = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w, dplane = static_cast<size_t>(dh) * dw;
  const int fv0 = 2 * v0 + lo, fu0 = 2 * u0 + lo;  // finer pixel of the tile's (0, 0) local cell

  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) wts[k] = taps.w[k];
  }
  const uint8_t* fc = colors + 3 * frame * plane;
  for (int i = tid; i < rows_t * cols_t; i += kTileW * kTileH) {
    const int r = i / cols_t, cc = i % cols_t;
    const int fv = min(max(fv0 + r, 0), h - 1), fu = min(max(fu0 + cc, 0), w - 1);
    const uint8_t* px = fc + 3 * (static_cast<size_t>(fv) * w + fu);
    ctile[3 * i] = px[0];
    ctile[3 * i + 1] = px[1];
    ctile[3 * i + 2] = px[2];
  }
  __syncthreads();
  // Rows pass at the tile's even finer rows, at every column of the tile:
  // acc = w0 x0, then acc + wk xk in tap order.
  for (int i = tid; i < kTileH * cols_t * 3; i += kTileW * kTileH) {
    const int oi = i / (cols_t * 3), rest = i % (cols_t * 3);
    const uint8_t* col = ctile + 2 * oi * cols_t * 3 + rest;
    float acc = mul(wts[0], static_cast<float>(col[0]));
    for (int k = 1; k < ntaps; ++k) acc = add(acc, mul(wts[k], static_cast<float>(col[k * cols_t * 3])));
    rpass[i] = acc;
  }
  __syncthreads();

  const int v = v0 + row, u = u0 + lane;
  const bool inside = v < dh && u < dw;
  const int n = v < dh ? min(kTileW, dw - u0) : 0;
  const size_t pix = frame * dplane + static_cast<size_t>(v) * dw + u;
  const size_t row_start = frame * dplane + static_cast<size_t>(v) * dw + u0;

  // The 2x2 window: trunc of the float32 product, clamped into the finer level.
  const int sv = static_cast<int>(mul(static_cast<float>(v), ratio_v));
  const int su = static_cast<int>(mul(static_cast<float>(u), ratio_u));
  size_t tap[4];
  float m[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int tv = min(sv + (t >> 1), h - 1), tu = min(su + (t & 1), w - 1);
    tap[t] = frame * plane + static_cast<size_t>(tv) * w + tu;
    m[t] = (inside && mask[tap[t]]) ? 1.0f : 0.0f;
  }
  const float count = add(add(add(m[0], m[1]), m[2]), m[3]);
  const bool any = count > 0.0f;
  const float safe = any ? count : 1.0f;

  float val[4][3], out[3] = {0.0f, 0.0f, 0.0f};
  if (inside) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < 3; ++c) val[t][c] = __ldg(points + 3 * tap[t] + c);
    nearest_to_mean(val, m, any, safe, out);
  }
  store_xyz(out_points + 3 * row_start, stage[row], lane, n, out[0], out[1], out[2]);
  if (inside) out_mask[pix] = any ? 1 : 0;
  if (normals != nullptr) {
    if (inside) {
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 3; ++c) val[t][c] = __ldg(normals + 3 * tap[t] + c);
      nearest_to_mean(val, m, any, safe, out);
    }
    store_xyz(out_normals + 3 * row_start, stage[row], lane, n, out[0], out[1], out[2]);
  }

  if (inside) {
    // Columns pass at finer column 2u: local column 2 * lane + k.
    uint8_t rgb[3];
    const float* rp = rpass + (row * cols_t + 2 * lane) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = mul(wts[0], rp[c]);
      for (int k = 1; k < ntaps; ++k) acc = add(acc, mul(wts[k], rp[3 * k + c]));
      acc = fminf(fmaxf(acc, 0.0f), 255.0f);
      rgb[c] = static_cast<uint8_t>(static_cast<unsigned>(acc));
      out_colors[3 * pix + c] = rgb[c];
    }
    if (out_intens != nullptr) {
      const uint8_t l = luma_u8(rgb[0], rgb[1], rgb[2]);
      out_intens[pix] = l;
      write_map(out_map + frame * (static_cast<size_t>(dh) + 2) * (dw + 2), dh, dw, v, u, l);
    }
  }
}

size_t down_smem_bytes(int ntaps) {
  const int rows_t = 2 * (kTileH - 1) + ntaps, cols_t = 2 * (kTileW - 1) + ntaps;
  return ((rows_t * cols_t * 3 + 15) & ~15) + sizeof(float) * kTileH * cols_t * 3;
}

}  // namespace

extern "C" int a3d_pyramid_base(const void* depth, const void* color, const void* scales, float scale, int batch,
                                int h, int w, float fx, float fy, float cx, float cy, void* points, void* mask,
                                void* normals, void* intens, void* map, void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  pyramid_base_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(depth), static_cast<const uint8_t*>(color), static_cast<const float*>(scales),
      scale, h, w, fx, fy, cx, cy, static_cast<float*>(points), static_cast<uint8_t*>(mask),
      static_cast<float*>(normals), static_cast<uint8_t*>(intens), static_cast<float*>(map));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int a3d_pyramid_down(const void* points, const void* normals, const void* mask, const void* colors,
                                int batch, int h, int w, int dh, int dw, float ratio_v, float ratio_u, int lo,
                                int ntaps, const float* weights, void* out_points, void* out_normals, void* out_mask,
                                void* out_colors, void* out_intens, void* out_map, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  BlurTaps taps{};
  for (int k = 0; k < ntaps; ++k) taps.w[k] = weights[k];
  const dim3 block(kTileW, kTileH);
  const dim3 grid((dw + kTileW - 1) / kTileW, (dh + kTileH - 1) / kTileH, batch);
  pyramid_down_kernel<<<grid, block, down_smem_bytes(ntaps), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(normals), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(colors), h, w, dh, dw, ratio_v, ratio_u, lo, ntaps, taps,
      static_cast<float*>(out_points), static_cast<float*>(out_normals), static_cast<uint8_t*>(out_mask),
      static_cast<uint8_t*>(out_colors), static_cast<uint8_t*>(out_intens), static_cast<float*>(out_map));
  return static_cast<int>(cudaGetLastError());
}
