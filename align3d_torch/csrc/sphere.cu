// K6: the viewers' fitted-sphere centres, numpy's mean of an (N, 3) float32
// array along axis 0, bit for bit, for every node of a scene in one launch.
//
// No TPU kernel is replaced: the JAX package fits its viewers' camera with
// numpy on the host (align3d_tpu/viz/sphere.py:29, Sphere3D.from_points).
// The port fits on the device where the points are, because copying a
// preview's 8.4 M world points to the host and running numpy's mean there
// cost more than the render the fit serves (chip_smoke.py phase 10a).
//
// What it computes: numpy's float32 axis-0 reduction adds the rows one after
// another, starting from row 0 (s = x_0, then s = fl(s + x_i) in row order),
// then divides each column's sum by N in float64 (numpy 2 promotes the float32
// sums against its intp count) and rounds the quotient to float32. For
// N <= 2^24 that is also the float32 quotient numpy 1 takes (a float64
// quotient rounded to float32 is correctly rounded, 53 >= 2 x 24 + 2).
//
// A sequential float32 sum has no exact parallel form, so one thread a column
// adds its column in row order; the block's other warps stage the next chunk
// of rows in shared memory meanwhile (two buffers), so the adding threads
// never wait on global memory. The nodes' points lie one after another in one
// array (node b's rows are [offsets[b], offsets[b + 1])); one block a node, so
// the nodes' chains run side by side. What bounds a block is its chain of N
// dependent float32 adds (~4 cycles each: ~0.6 ms at 262 k rows), not the
// 12 N bytes it reads: the function itself is a sequential chain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoaders = kThreads - 32;  // warps 1..7 stage; lanes 0-2 of warp 0 add
constexpr int kRows = 1024;               // rows a chunk: 12 KB a buffer

__global__ void __launch_bounds__(kThreads) column_mean(const float* __restrict__ all_points,
                                                        const long long* __restrict__ offsets,
                                                        float* __restrict__ out) {
  __shared__ float buf[2][kRows * 3];
  const int tid = threadIdx.x;
  const long long first_row = offsets[blockIdx.x];
  const long long n = offsets[blockIdx.x + 1] - first_row;
  if (n <= 0) return;
  const float* points = all_points + first_row * 3;
  const long long chunks = (n + kRows - 1) / kRows;

  auto stage = [&](long long chunk, int b) {
    const long long first = chunk * kRows * 3;
    const long long count = (n - chunk * kRows < kRows ? n - chunk * kRows : kRows) * 3;
    for (long long i = tid - 32; i < count; i += kLoaders) buf[b][i] = points[first + i];
  };

  if (tid >= 32) stage(0, 0);
  __syncthreads();
  float sum = 0.0f;
  for (long long chunk = 0; chunk < chunks; ++chunk) {
    const int b = static_cast<int>(chunk & 1);
    if (tid >= 32) {
      if (chunk + 1 < chunks) stage(chunk + 1, b ^ 1);
    } else if (tid < 3) {
      const int rows = static_cast<int>(n - chunk * kRows < kRows ? n - chunk * kRows : kRows);
      int r = 0;
      if (chunk == 0) {
        sum = buf[b][tid];  // numpy starts from row 0 itself, not from +0.0
        r = 1;
      }
#pragma unroll 8
      for (; r < rows; ++r) sum = __fadd_rn(sum, buf[b][r * 3 + tid]);
    }
    __syncthreads();
  }
  if (tid < 3) {
    out[blockIdx.x * 3 + tid] = __double2float_rn(__ddiv_rn(static_cast<double>(sum), static_cast<double>(n)));
  }
}

}  // namespace

// points: (sum N_b, 3) float32; offsets: (nodes + 1,) int64 on the device;
// out: (nodes, 3) float32.
extern "C" int a3d_column_mean(const void* points, const void* offsets, int nodes, void* out, void* stream) {
  if (nodes <= 0) return 0;
  column_mean<<<nodes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const long long*>(offsets), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
