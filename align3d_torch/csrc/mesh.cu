// K5: mesh vertex normals.
//
// Replaces the TPU kernel align3d_tpu/ops/mesh.py::_mesh_kernel (through
// _banded_call / _banded_eval, used by MeshNormals). The TPU kernel DMA'd a
// vertex band and a face-corner band per 1024-vertex chunk and did every
// gather as a lane select, because a TPU has no fast random gather; that
// needs a mesh whose ordering keeps the bands narrow and a vertex degree of
// at most 16. The card gathers directly, so the bands, their limits and the
// band analysis go, and any topology runs.
//
// What it computes: per face n = cross(p1 - p0, p2 - p0), divided by
// sqrt(nx*nx + ny*ny + nz*nz) when that is > 0, the zero vector of a
// degenerate face kept (reference mesh.rs:12-27); per vertex the left fold of
// its incident faces' normals in face order over D slots, a padding slot
// adding the zero normal (+0.0, so a -0.0 sum becomes +0.0, as in the plain
// twin), divided by the incident-face count, not renormalised: an isolated
// vertex gives 0/0 = NaN, as the reference does. The arithmetic uses
// round-to-nearest intrinsics in the plain twin's order (ops/mesh.py), so
// the two agree bitwise. No atomics.
//
// What bounds it on the H100: bytes, each input read once and the output
// written once: per vertex its point (12 B), its count (4 B), D table slots
// (8 B each) and its output (12 B). At 204,800 faces that is 7.8 MB (2.3 us at
// 3.35 TB/s); at 3,276,800 faces 124.8 MB (37 us).
//
// The design (A3D_MESH_DESIGN 1, the library's): ONE launch, one thread per
// vertex, no face buffer; each thread recomputes the normal of each incident
// face (every face is evaluated by its 3 corners). Measured (tools/ablate.py
// mesh_designs), what moved a recomputing kernel was its loads, not its
// arithmetic: through a face-id table a face evaluation makes 12 scattered
// 4-byte loads (3 corner ids, 9 coordinates), each warp load touching
// several cache lines. So MeshNormals precomputes a corner table,
// slot-major (D, N, 2) int32: slot d of vertex v holds the two other corners
// of its d-th face, in the face's cyclic order after v, and v's place in the
// face (0, 1, 2) in the top two bits of the first word (all ones: a padding
// slot). A face evaluation is then one coalesced 8-byte table load and 6
// coordinate loads; v's own point is loaded once. The corners are put back
// in the face's own order before the cross product, so the bits are the face
// normal's. A3D_MESH_SLOTS slots' loads go out together.
//
// Designs kept for the ablation (-D builds into build/ablate/), all over the
// face-id incidence table (slot-major (D, N), padded with F, except design 0):
//   0: the earlier two launches, a face pass writing an (F + 1, 3) buffer,
//      then a vertex pass over a row-major (N, D) table;
//   2: one cooperative persistent launch: a grid-stride face pass into the
//      buffer, a grid barrier, a grid-stride vertex pass;
//   3: one launch, one thread per vertex recomputing its faces from the
//      face-id table, A3D_MESH_SLOTS slots' loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef A3D_MESH_DESIGN
#define A3D_MESH_DESIGN 1
#endif
#ifndef A3D_MESH_SLOTS
#define A3D_MESH_SLOTS 2
#endif
#ifndef A3D_MESH_THREADS
#define A3D_MESH_THREADS 128
#endif

#if A3D_MESH_DESIGN == 2
#include <cooperative_groups.h>
#endif

namespace {

constexpr int kThreads = A3D_MESH_THREADS;

// The unit normal of the face with corners a, b, c; zero when degenerate.
// The plain twin's order of operations, each rounded once.
__device__ __forceinline__ float3 face_normal(float3 a, float3 b, float3 c) {
  const float ax = __fsub_rn(b.x, a.x), ay = __fsub_rn(b.y, a.y), az = __fsub_rn(b.z, a.z);
  const float bx = __fsub_rn(c.x, a.x), by = __fsub_rn(c.y, a.y), bz = __fsub_rn(c.z, a.z);
  float3 n;
  n.x = __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
  n.y = __fsub_rn(__fmul_rn(az, bx), __fmul_rn(ax, bz));
  n.z = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
  const float mag = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(n.x, n.x), __fmul_rn(n.y, n.y)), __fmul_rn(n.z, n.z)));
  if (mag > 0.0f) {
    n.x = __fdiv_rn(n.x, mag);
    n.y = __fdiv_rn(n.y, mag);
    n.z = __fdiv_rn(n.z, mag);
  }
  return n;
}

__device__ __forceinline__ float3 load_point(const float* __restrict__ points, uint32_t i) {
  const float* p = points + 3 * (size_t)i;
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

// acc (+)= n: the first slot starts the fold, every later one adds.
__device__ __forceinline__ void fold(float3& acc, float3 n, bool first) {
  if (first) {
    acc = n;
  } else {
    acc.x = __fadd_rn(acc.x, n.x), acc.y = __fadd_rn(acc.y, n.y), acc.z = __fadd_rn(acc.z, n.z);
  }
}

__device__ __forceinline__ void write_mean(float* __restrict__ out, int v, float3 acc, float c) {
  out[3 * (size_t)v] = __fdiv_rn(acc.x, c);
  out[3 * (size_t)v + 1] = __fdiv_rn(acc.y, c);
  out[3 * (size_t)v + 2] = __fdiv_rn(acc.z, c);
}

#if A3D_MESH_DESIGN == 1

constexpr uint32_t kPad = 3u;  // the place of a padding slot
constexpr uint32_t kIdMask = (1u << 30) - 1;

__global__ void __launch_bounds__(kThreads)
mesh_normals(const float* __restrict__ points, const int2* __restrict__ table, const float* __restrict__ counts,
             int n_vertices, int degree, float* __restrict__ out) {
  constexpr int S = A3D_MESH_SLOTS;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vertices) return;
  const float3 pv = load_point(points, (uint32_t)v);
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  for (int d0 = 0; d0 < degree; d0 += S) {
    uint32_t place[S], b[S];
    float3 pa[S], pb[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int2 e = d0 + j < degree ? __ldg(table + (size_t)(d0 + j) * n_vertices + v) : make_int2(-1, -1);
      place[j] = (uint32_t)e.x >> 30;
      b[j] = (uint32_t)e.y;
      pa[j] = place[j] != kPad ? load_point(points, (uint32_t)e.x & kIdMask) : pv;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) pb[j] = place[j] != kPad ? load_point(points, b[j]) : pv;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (d0 + j >= degree) break;
      // The face's corners in its own order, c[place] = v, then a, then b,
      // chosen by selects (no divergence). A padding slot has a = b = v, and
      // the normal of (v, v, v) is exactly (+0.0, +0.0, +0.0).
      const uint32_t k = place[j];
      const float3 c0 = k == 0 ? pv : (k == 1 ? pb[j] : pa[j]);
      const float3 c1 = k == 0 ? pa[j] : (k == 1 ? pv : pb[j]);
      const float3 c2 = k == 0 ? pb[j] : (k == 1 ? pa[j] : pv);
      fold(acc, face_normal(c0, c1, c2), d0 + j == 0);
    }
  }
  write_mean(out, v, acc, __ldg(counts + v));
}

#elif A3D_MESH_DESIGN == 3

__global__ void __launch_bounds__(kThreads)
mesh_normals(const float* __restrict__ points, const int32_t* __restrict__ faces, int n_faces,
             const int32_t* __restrict__ table, const float* __restrict__ counts, int n_vertices,
             int degree, float* __restrict__ out) {
  constexpr int S = A3D_MESH_SLOTS;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vertices) return;
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  for (int d0 = 0; d0 < degree; d0 += S) {
    int f[S];
#pragma unroll
    for (int j = 0; j < S; ++j) f[j] = d0 + j < degree ? __ldg(table + (size_t)(d0 + j) * n_vertices + v) : n_faces;
    int corner[S][3];
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) corner[j][k] = f[j] < n_faces ? __ldg(faces + 3 * (size_t)f[j] + k) : 0;
    float3 p[S][3];
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        p[j][k] = f[j] < n_faces ? load_point(points, corner[j][k]) : make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (d0 + j >= degree) break;
      const float3 n = f[j] < n_faces ? face_normal(p[j][0], p[j][1], p[j][2]) : make_float3(0.0f, 0.0f, 0.0f);
      fold(acc, n, d0 + j == 0);
    }
  }
  write_mean(out, v, acc, __ldg(counts + v));
}

#else  // designs 0 and 2 go through a face buffer of F + 1 rows, the last zero

__device__ __forceinline__ void face_row(const float* __restrict__ points, const int32_t* __restrict__ faces,
                                         int n_faces, float* __restrict__ fn, int f) {
  float3 n = make_float3(0.0f, 0.0f, 0.0f);
  if (f < n_faces) {
    const int32_t* c = faces + 3 * (size_t)f;
    n = face_normal(load_point(points, c[0]), load_point(points, c[1]), load_point(points, c[2]));
  }
  fn[3 * (size_t)f] = n.x;
  fn[3 * (size_t)f + 1] = n.y;
  fn[3 * (size_t)f + 2] = n.z;
}

// The fold of vertex v's slots; `slot` is the stride between its slots in
// the table (1 for a row-major (N, D) table, N for a slot-major one).
__device__ __forceinline__ void vertex_row(const float* fn, const int32_t* __restrict__ row, size_t slot,
                                           const float* __restrict__ counts, int v, int degree,
                                           float* __restrict__ out) {
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  for (int d = 0; d < degree; ++d) {
    const float* nd = fn + 3 * (size_t)row[d * slot];
    fold(acc, make_float3(nd[0], nd[1], nd[2]), d == 0);
  }
  write_mean(out, v, acc, counts[v]);
}

#if A3D_MESH_DESIGN == 0

__global__ void __launch_bounds__(kThreads)
face_normals(const float* __restrict__ points, const int32_t* __restrict__ faces, int n_faces,
             float* __restrict__ fn) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f <= n_faces) face_row(points, faces, n_faces, fn, f);
}

__global__ void __launch_bounds__(kThreads)
vertex_normals(const float* __restrict__ fn, const int32_t* __restrict__ table,
               const float* __restrict__ counts, int n_vertices, int degree, float* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v < n_vertices) vertex_row(fn, table + (size_t)v * degree, 1, counts, v, degree, out);
}

#else  // A3D_MESH_DESIGN == 2

// Not __restrict__ on fn: this launch writes it, then reads it after the
// barrier, so the reads must not go through the read-only path.
__global__ void __launch_bounds__(kThreads)
mesh_normals(const float* __restrict__ points, const int32_t* __restrict__ faces, int n_faces,
             const int32_t* __restrict__ table, const float* __restrict__ counts, int n_vertices,
             int degree, float* fn, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  for (int f = first; f <= n_faces; f += stride) face_row(points, faces, n_faces, fn, f);
  grid.sync();
  for (int v = first; v < n_vertices; v += stride)
    vertex_row(fn, table + v, (size_t)n_vertices, counts, v, degree, out);
}

#endif
#endif

}  // namespace

#if A3D_MESH_DESIGN == 1

extern "C" int a3d_mesh_normals(const void* points, const void* table, const void* counts, int n_vertices,
                                int degree, void* out, void* stream) {
  if (n_vertices <= 0) return 0;
  mesh_normals<<<(n_vertices + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int2*>(table), static_cast<const float*>(counts),
      n_vertices, degree, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

#elif A3D_MESH_DESIGN == 3

extern "C" int a3d_mesh_normals(const void* points, const void* faces, int n_faces, const void* table,
                                const void* counts, int n_vertices, int degree, void* out, void* stream) {
  if (n_vertices <= 0) return 0;
  mesh_normals<<<(n_vertices + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const int32_t*>(faces), n_faces,
      static_cast<const int32_t*>(table), static_cast<const float*>(counts), n_vertices, degree,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

#elif A3D_MESH_DESIGN == 0

extern "C" int a3d_mesh_normals(const void* points, const void* faces, int n_faces, const void* table,
                                const void* counts, int n_vertices, int degree, void* face_buf, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  face_normals<<<(n_faces + 1 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(points), static_cast<const int32_t*>(faces), n_faces,
      static_cast<float*>(face_buf));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_vertices > 0) {
    vertex_normals<<<(n_vertices + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float*>(face_buf), static_cast<const int32_t*>(table),
        static_cast<const float*>(counts), n_vertices, degree, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

#else  // A3D_MESH_DESIGN == 2

extern "C" int a3d_mesh_normals(const void* points, const void* faces, int n_faces, const void* table,
                                const void* counts, int n_vertices, int degree, void* face_buf, void* out,
                                void* stream) {
  static int resident = 0;  // co-resident blocks of the whole card, found once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mesh_normals, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
  }
  const int work = n_faces + 1 > n_vertices ? n_faces + 1 : n_vertices;
  int blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  const float* p = static_cast<const float*>(points);
  const int32_t* f = static_cast<const int32_t*>(faces);
  const int32_t* t = static_cast<const int32_t*>(table);
  const float* c = static_cast<const float*>(counts);
  float* fn = static_cast<float*>(face_buf);
  float* o = static_cast<float*>(out);
  void* args[] = {&p, &f, &n_faces, &t, &c, &n_vertices, &degree, &fn, &o};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)mesh_normals, dim3(blocks), dim3(kThreads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#endif
