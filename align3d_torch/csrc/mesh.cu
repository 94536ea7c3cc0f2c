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
// Two launches. The face pass runs one thread per face: it gathers the three
// corners, takes n = cross(p1 - p0, p2 - p0) and divides by
// sqrt(nx*nx + ny*ny + nz*nz) when that is > 0, keeping the zero vector of a
// degenerate face (reference mesh.rs:12-27). It writes an (F + 1, 3) buffer
// whose last row is zero. The vertex pass runs one thread per vertex: it
// folds its D incidence-table slots from left to right in face order
// (padding slots point at the zero row) and divides by the incident-face
// count, not renormalising; an isolated vertex gives 0/0 = NaN, as the
// reference does. The arithmetic uses round-to-nearest intrinsics in the
// plain twin's order (ops/mesh.py), so the two agree bitwise. No atomics.
//
// What bounds it on the H100: memory traffic, ~60 bytes per face (12-byte
// index row, three 12-byte corner gathers, 12-byte write) and 4 x (D + 4)
// bytes per vertex plus D 12-byte gathers of face normals, which mostly hit
// L2 for a coherently ordered mesh. At 204,800 faces that is ~20 MB, a few
// microseconds of HBM time; the launches cost more than the work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
face_normals(const float* __restrict__ points, const int32_t* __restrict__ faces, int n_faces,
             float* __restrict__ fn) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f > n_faces) return;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (f < n_faces) {
    const float* p0 = points + 3 * (size_t)faces[3 * (size_t)f];
    const float* p1 = points + 3 * (size_t)faces[3 * (size_t)f + 1];
    const float* p2 = points + 3 * (size_t)faces[3 * (size_t)f + 2];
    const float ax = __fsub_rn(p1[0], p0[0]), ay = __fsub_rn(p1[1], p0[1]), az = __fsub_rn(p1[2], p0[2]);
    const float bx = __fsub_rn(p2[0], p0[0]), by = __fsub_rn(p2[1], p0[1]), bz = __fsub_rn(p2[2], p0[2]);
    nx = __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
    ny = __fsub_rn(__fmul_rn(az, bx), __fmul_rn(ax, bz));
    nz = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
    const float mag =
        __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)), __fmul_rn(nz, nz)));
    if (mag > 0.0f) {
      nx = __fdiv_rn(nx, mag);
      ny = __fdiv_rn(ny, mag);
      nz = __fdiv_rn(nz, mag);
    }
  }
  fn[3 * (size_t)f] = nx;
  fn[3 * (size_t)f + 1] = ny;
  fn[3 * (size_t)f + 2] = nz;
}

__global__ void __launch_bounds__(kThreads)
vertex_normals(const float* __restrict__ fn, const int32_t* __restrict__ table,
               const float* __restrict__ counts, int n_vertices, int degree,
               float* __restrict__ out) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vertices) return;
  const int32_t* row = table + (size_t)v * degree;
  const float* n0 = fn + 3 * (size_t)row[0];
  float ax = n0[0], ay = n0[1], az = n0[2];
  for (int d = 1; d < degree; ++d) {
    const float* nd = fn + 3 * (size_t)row[d];
    ax = __fadd_rn(ax, nd[0]);
    ay = __fadd_rn(ay, nd[1]);
    az = __fadd_rn(az, nd[2]);
  }
  const float c = counts[v];
  out[3 * (size_t)v] = __fdiv_rn(ax, c);
  out[3 * (size_t)v + 1] = __fdiv_rn(ay, c);
  out[3 * (size_t)v + 2] = __fdiv_rn(az, c);
}

}  // namespace

extern "C" int a3d_mesh_normals(const void* points, const void* faces, int n_faces,
                                const void* table, const void* counts, int n_vertices, int degree,
                                void* face_buf, void* out, void* stream) {
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
