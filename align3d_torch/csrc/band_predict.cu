// K9 and K10: the banded engines' band prediction, bit for bit the plain
// twins of align3d_torch/ops/icp_pallas_v3.py (source_centroids_plain,
// predict_bases_centroid_plain), which give the JAX package's bits.
//
// No TPU kernel is replaced. The JAX package computes source_centroids
// (align3d_tpu/ops/icp_pallas_v3.py:203) and predict_bases_centroid (:250) in
// plain jnp, which XLA fuses into the jitted align that also launches the
// Pallas kernel (align3d_tpu/icp/image_icp.py:278 and :285). As PyTorch ops
// driven from the host they were ~516 launches an align (the centroids' sums
// in XLA's order, one add a launch) and ~50 a GN iteration; here each is one
// launch.
//
// K9, once an align. For each (pair, chunk, group) tile of 16 rows x 128
// lanes of the source depth z: six sums over the tile, m = (z > 0), the ray
// times depth (dirx z, diry z), z, row m and col m, then the means. XLA's CPU
// reduction, which the twin reproduces, adds each 16-row x 32-lane window
// element by element in row-major order from +0.0, then the four window sums
// in order from +0.0. Three of the six channels are integers below 2^24 (a
// tile's count and its sums of rows and of columns, for images of at most
// 8192 rows and columns), exact in any order, so the block sums them as ints.
// The other three are float chains whose order fixes the bits: twelve threads
// (4 windows x 3 channels) each run one chain of 512 dependent adds out of
// shared memory. One block a tile, 128 threads; the tile's 8 KB of z is read
// once, coalesced. Bytes bound it on paper (4 B a pixel); what a block spends
// is its chain of 512 dependent adds. So no lane picks its term by its channel
// inside the chain, and each row's 32 terms are formed before its 32 adds: the
// chain waits on the adds alone (a first build that picked each term's factor
// by channel inside the chain took ~95 cycles a step, 24.7 us a launch at one
// 640x480 pair against 4.8 us now, on an H100).
//
// K10, once a GN iteration. One thread a (pair, chunk): each group's centroid
// under the pose, ((r0 x + r1 y) + r2 z) + t; projected with IEEE divisions
// (safe_z = 1e-12 where pz == 0); the row and column displacements to the
// group's mean pixel, rounded half to even (0 for an empty group); the chunk's
// band start from the count-weighted mean row displacement of its groups,
// added in group order. It reads the pose on the device: no host sync. A few
// hundred operations a pair: its launch is what it costs.
//
// The file builds with -fmad=false (_kernels.FILE_FLAGS) and rounds every
// product and sum on its own (__fmul_rn, __fadd_rn), as the twin's separate
// PyTorch ops round them; rintf rounds half to even, as torch.round.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;    // source rows a chunk
constexpr int kLanes = 128;   // lanes a group
constexpr int kWindow = 32;   // XLA's CPU reduce window: 16 rows x 32 lanes
constexpr int kWindows = kLanes / kWindow;
constexpr int kPad = kWindow + 1;  // a window's row in shared memory: the four windows' chains read four banks
constexpr int kHalo = 8;
constexpr int kCentroidThreads = kLanes;  // a thread a lane of the tile
constexpr int kChains = 3 * kWindows;     // (window, channel) chains of the float channels
constexpr int kPredictThreads = 128;

__global__ void __launch_bounds__(kCentroidThreads) source_centroids_kernel(
    const float* __restrict__ source, int nchunks, int groups, float cx, float cy, float inv_fx, float inv_fy,
    float* __restrict__ pbar, float* __restrict__ rowbar, float* __restrict__ colbar, float* __restrict__ cnt) {
  __shared__ float zs[kChunk * kWindows * kPad];
  __shared__ float dirx[kWindows * kPad];
  __shared__ int int_sums[3][kCentroidThreads / 32];
  __shared__ float window_sums[3][kWindows];

  const int tile = blockIdx.x;  // (pair * nchunks + chunk) * groups + group
  const int group = tile % groups;
  const int pc = tile / groups;  // pair * nchunks + chunk
  const int chunk = pc % nchunks;
  // The tile's rows are contiguous: the pack is (B, nchunks, 2, 16 G, 128), rows j-major, channel 0 is z.
  const float* z = source + (static_cast<long long>(pc) * 2 * groups + group) * (kChunk * kLanes);

  const int t = threadIdx.x;
  const int w = t / kWindow, l = t % kWindow;
  const int col = group * kLanes + t;
  int count = 0, rows = 0;
#pragma unroll
  for (int s = 0; s < kChunk; ++s) {
    const float v = z[s * kLanes + t];
    zs[(s * kWindows + w) * kPad + l] = v;
    const int m = v > 0.0f;  // NaN: 0
    count += m;
    rows += m * (chunk * kChunk + s);
  }
  dirx[w * kPad + l] = __fmul_rn(__fsub_rn(static_cast<float>(col), cx), inv_fx);
  int cols = count * col;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, o);
    rows += __shfl_xor_sync(0xffffffffu, rows, o);
    cols += __shfl_xor_sync(0xffffffffu, cols, o);
  }
  if (l == 0) {
    int_sums[0][w] = count;
    int_sums[1][w] = rows;
    int_sums[2][w] = cols;
  }
  __syncthreads();

  if (t < kChains) {  // window t / 3; channel t % 3: dirx z, diry z, z
    const int cw = t / 3, ch = t % 3;
    // A term is (lane factor x row factor) x z: one of the two factors is
    // 1, so their product is exact and no lane branches on its channel.
    float lane_factor[kWindow];
#pragma unroll
    for (int e = 0; e < kWindow; ++e) lane_factor[e] = ch == 0 ? dirx[cw * kPad + e] : 1.0f;
    float acc = 0.0f;
    for (int s = 0; s < kChunk; ++s) {
      const float row = static_cast<float>(chunk * kChunk + s);
      const float row_factor = ch == 1 ? __fmul_rn(__fsub_rn(row, cy), inv_fy) : 1.0f;
      const float* zrow = zs + (s * kWindows + cw) * kPad;
      float term[kWindow];  // a row's 32 terms first, then its 32 dependent adds
#pragma unroll
      for (int e = 0; e < kWindow; ++e) term[e] = __fmul_rn(__fmul_rn(lane_factor[e], row_factor), zrow[e]);
#pragma unroll
      for (int e = 0; e < kWindow; ++e) acc = __fadd_rn(acc, term[e]);
    }
    window_sums[ch][cw] = acc;
  }
  __syncthreads();

  if (t < 4) {  // threads 0-2: pbar's three coordinates; thread 3: cnt, rowbar, colbar
    int sums[3] = {0, 0, 0};
    for (int q = 0; q < kCentroidThreads / 32; ++q) {
      for (int c = 0; c < 3; ++c) sums[c] += int_sums[c][q];
    }
    const float n = static_cast<float>(sums[0]);
    const float safe = fmaxf(n, 1.0f);
    if (t < 3) {
      float total = 0.0f;
      for (int q = 0; q < kWindows; ++q) total = __fadd_rn(total, window_sums[t][q]);
      pbar[tile * 3 + t] = __fdiv_rn(total, safe);
    } else {
      cnt[tile] = n;
      rowbar[tile] = __fdiv_rn(static_cast<float>(sums[1]), safe);
      colbar[tile] = __fdiv_rn(static_cast<float>(sums[2]), safe);
    }
  }
}

__global__ void __launch_bounds__(kPredictThreads) predict_bases_kernel(
    const float* __restrict__ rot, const float* __restrict__ trans, const float* __restrict__ pbar,
    const float* __restrict__ rowbar, const float* __restrict__ colbar, const float* __restrict__ cnt, int pairs,
    int nchunks, int groups, float fx, float fy, float cx, float cy, int base_max, int* __restrict__ chunk_base,
    int* __restrict__ dy_base, int* __restrict__ dx_base) {
  const int pc = blockIdx.x * kPredictThreads + threadIdx.x;  // pair * nchunks + chunk
  if (pc >= pairs * nchunks) return;
  const int b = pc / nchunks, chunk = pc % nchunks;
  const float* r = rot + b * 9;
  const float* tr = trans + b * 3;
  float count = 0.0f, weighted = 0.0f;
  for (int g = 0; g < groups; ++g) {
    const int tile = pc * groups + g;
    const float x = pbar[tile * 3], y = pbar[tile * 3 + 1], zc = pbar[tile * 3 + 2];
    float p[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[3 * i], x), __fmul_rn(r[3 * i + 1], y)),
                                 __fmul_rn(r[3 * i + 2], zc)),
                       tr[i]);
    }
    const float safe_z = p[2] == 0.0f ? 1e-12f : p[2];  // -0.0 too
    const float u = __fadd_rn(__fdiv_rn(__fmul_rn(p[0], fx), safe_z), cx);
    const float v = __fadd_rn(__fdiv_rn(__fmul_rn(p[1], fy), safe_z), cy);
    const float dyf = __fsub_rn(v, rowbar[tile]);
    const float dxf = __fsub_rn(u, colbar[tile]);
    const float n = cnt[tile];
    const bool have = n > 0.0f;
    // A float -> int32 cast saturates and takes NaN to 0, as PyTorch's on the card.
    dy_base[tile] = static_cast<int>(have ? rintf(dyf) : 0.0f);
    dx_base[tile] = static_cast<int>(have ? rintf(dxf) : 0.0f);
    count = __fadd_rn(count, n);
    weighted = __fadd_rn(weighted, __fmul_rn(have ? dyf : 0.0f, n));
  }
  const float mean = __fdiv_rn(weighted, fmaxf(count, 1.0f));
  // int32 arithmetic that wraps, as the twin's int32 tensors do.
  const unsigned start = static_cast<unsigned>(chunk * kChunk) + static_cast<unsigned>(static_cast<int>(rintf(mean))) -
                         static_cast<unsigned>(kHalo);
  chunk_base[pc] = min(max(static_cast<int>(start), 0), base_max);
}

}  // namespace

// source: (batch, nchunks, 2, 16 groups, 128) float32; out: pbar (batch, nchunks,
// groups, 3), rowbar, colbar, cnt (batch, nchunks, groups), float32.
extern "C" int a3d_source_centroids(const void* source, int batch, int nchunks, int groups, float cx, float cy,
                                    float inv_fx, float inv_fy, void* pbar, void* rowbar, void* colbar, void* cnt,
                                    void* stream) {
  const long long tiles = static_cast<long long>(batch) * nchunks * groups;
  if (tiles <= 0) return 0;
  source_centroids_kernel<<<static_cast<unsigned>(tiles), kCentroidThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(source), nchunks, groups, cx, cy, inv_fx, inv_fy, static_cast<float*>(pbar),
      static_cast<float*>(rowbar), static_cast<float*>(colbar), static_cast<float*>(cnt));
  return (int)cudaGetLastError();
}

// rot (batch, 3, 3), trans (batch, 3) and K9's outputs, float32; out:
// chunk_base (batch, nchunks), dy_base, dx_base (batch, nchunks, groups), int32.
// base_max: the largest band start, max(hp - min(32, hp), 0).
extern "C" int a3d_predict_bases(const void* rot, const void* trans, const void* pbar, const void* rowbar,
                                 const void* colbar, const void* cnt, int batch, int nchunks, int groups, float fx,
                                 float fy, float cx, float cy, int base_max, void* chunk_base, void* dy_base,
                                 void* dx_base, void* stream) {
  const int n = batch * nchunks;
  if (n <= 0) return 0;
  predict_bases_kernel<<<(n + kPredictThreads - 1) / kPredictThreads, kPredictThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rot), static_cast<const float*>(trans), static_cast<const float*>(pbar),
      static_cast<const float*>(rowbar), static_cast<const float*>(colbar), static_cast<const float*>(cnt), batch,
      nchunks, groups, fx, fy, cx, cy, base_max, static_cast<int*>(chunk_base), static_cast<int*>(dy_base),
      static_cast<int*>(dx_base));
  return (int)cudaGetLastError();
}
