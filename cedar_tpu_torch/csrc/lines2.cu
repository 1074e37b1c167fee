// K4: one zebra colour of 2D line relaxation, x-lines or y-lines.
//
// Replaces the Pallas kernel cedar_tpu/ops/pallas_lines2.py `_sweep_kernel`
// (called by `_color_call` <- `line_relax_x` / `line_relax_y`): for every
// line of the active colour, form the off-line right-hand side, solve the
// tridiagonal system along the line, write the line.  The math and the
// term order are ops/lines2.py of this package (`line_rhs_x`, `_factor`,
// `tridiag_solve`; reference BMG2_SymStd_relax_lines_{x,y}.f90):
//   rhs  = b + S(i,j) q(i,j-1) + S(i,j+1) q(i,j+1) [+ the 4 corner terms]
//   LDLᵀ: l_i = e_i / d_{i-1},  d_i = a_i - l_i e_i      (e_i = -W(i,j))
//         z_i = r_i - l_i z_{i-1},  w_i = z_i (1/d_i)
//         x_{n-1} = w_{n-1},  x_i = w_i - l_{i+1} x_{i+1}
// The y entry swaps the roles of the axes and reads the operands where
// they lie: its rhs is the x rhs of the transposed stencil (lines2.
// transpose_so: W<->S, SW->SWᵀ, NW->NWᵀ) in the same term order, so it
// rounds as the plain version's transposed sweep does, without the
// per-sweep transposes of pallas_lines2.line_relax_y.
//
// What bounds it on the H100: latency.  A line is a chain of 2n dependent
// steps (an IEEE division and a multiply-subtract forward, a
// multiply-subtract back) and only the lines of one colour are
// independent: 1024 lines of 2048 steps at 2048², 32 warps for 132 SMs.
// Design, two launches per colour:
//  1. `rhs_*`: the rhs of every point of the active lines, one thread a
//     point (fully parallel, coalesced), into a scratch buffer;
//  2. `solve_*`: one thread per active line runs the recurrence, factoring
//     on the fly (no setup workspace, as the Pallas kernel reads none).
//     It reads the diagonal, the off-diagonal and the rhs kChunk steps at
//     a time into registers before running those steps, so a chunk pays
//     one memory latency instead of one per step (the compiler does not
//     overlap the loads of later steps by itself, probably because of the
//     division's slow-path branch).
//     The forward pass stores l_i and w_i (over the rhs) in the scratch;
//     the backward pass writes q.
// Measured on an H100 (PERF.md, Findings): a single pass with one thread
// per line and no chunking took 5.9 ms for a 2048² 9-point f32 x-line
// sweep, one memory latency per step; this design takes ~1.1 ms.  The
// TPU kernel's PCR-to-stride-16 plus interleaved Thomas (more parallel
// lanes, another rounding) is the obvious later redesign.
//
// Scratch layout, per colour: x-lines step-major, s * ((ny+1)/2) + t
// (adjacent threads, adjacent lines: coalesced); y-lines line-major,
// t * ny + s (the row's own operands are contiguous along the line too, so
// a thread's chunk loads share 32-byte sectors).
//
// In place is race-free: the rhs of line j reads q only on lines j +- 1,
// which belong to the other colour, and a thread writes only its own line
// (the Python wrapper, ops/cuda_lines2.py, refuses aliased operands and
// other stencil kinds).  Couplings whose neighbour lies outside the grid
// (S(i, j+1) at j = ny-1, W(i+1, j) at i = nx-1, and the corners) read as
// exactly 0, as the zero-filled shifts of the plain version give.

#include "stencil2.cuh"

namespace cedar {
namespace {

constexpr int kLineBlock = 32;  // threads (lines) per block of the solve

// rhs_x, rhs_y and solve_line are in stencil2.cuh, shared with K10.

// rbuf[z * ((ny+1)/2) + t]: the rhs of step z of x-line t (column 2t+parity)
template <typename T, bool NINE>
__global__ void rhs_x_kernel(const T* __restrict__ so, const T* __restrict__ q,
                             const T* __restrict__ b, T* __restrict__ rbuf,
                             int nx, int ny, int parity) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = 2 * t + parity;
  if (j >= ny || z >= nx) return;
  rbuf[(long long)z * ((ny + 1) / 2) + t] = rhs_x<T, NINE>(
      so, q, b, (long long)nx * ny, (long long)z * ny + j, ny, z > 0,
      z + 1 < nx, j > 0, j + 1 < ny);
}

// rbuf[t * ny + w]: the rhs of step w of y-line t (row 2t+parity)
template <typename T, bool NINE>
__global__ void rhs_y_kernel(const T* __restrict__ so, const T* __restrict__ q,
                             const T* __restrict__ b, T* __restrict__ rbuf,
                             int nx, int ny, int parity) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = 2 * t + parity;
  if (i >= nx || w >= ny) return;
  rbuf[(long long)t * ny + w] = rhs_y<T, NINE>(
      so, q, b, (long long)nx * ny, (long long)i * ny + w, ny, i > 0,
      i + 1 < nx, w > 0, w + 1 < ny);
}

// x-lines: thread t solves column j = 2t + parity along z = 0..nx-1.
template <typename T>
__global__ void solve_x_kernel(const T* __restrict__ so, T* __restrict__ q,
                               T* __restrict__ lw, int nx, int ny,
                               int parity) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = 2 * t + parity;
  if (j >= ny) return;
  const long long P = (long long)nx * ny;
  const int stride = (ny + 1) / 2;
  T* rbuf = lw;
  T* lbuf = lw + (long long)nx * stride;
  solve_line<T>(so + j, so + W * P + j, rbuf + t, lbuf + t, q + j, nx, ny,
                stride, ny);
}

// y-lines: thread t solves row i = 2t + parity along w = 0..ny-1.
template <typename T>
__global__ void solve_y_kernel(const T* __restrict__ so, T* __restrict__ q,
                               T* __restrict__ lw, int nx, int ny,
                               int parity) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = 2 * t + parity;
  if (i >= nx) return;
  const long long P = (long long)nx * ny;
  const long long row = (long long)i * ny;
  T* rbuf = lw;
  T* lbuf = lw + (long long)ny * ((nx + 1) / 2);
  solve_line<T>(so + row, so + S * P + row, rbuf + (long long)t * ny,
                lbuf + (long long)t * ny, q + row, ny, 1, 1, 1);
}

template <typename T, bool Y>
int launch(const void* so_, void* q_, const void* b_, void* lw_, int nx,
           int ny, int nine, int parity, cudaStream_t st) {
  const int nactive = ((Y ? nx : ny) - parity + 1) / 2;
  if (nactive <= 0) return 0;
  const T* so = (const T*)so_;
  const T* b = (const T*)b_;
  T* q = (T*)q_;
  T* lw = (T*)lw_;
  const dim3 block(kBlockX, kBlockY);
  const dim3 lines((nactive + kLineBlock - 1) / kLineBlock);
  if (Y) {
    const dim3 grid = grid_for(nactive, ny);
    if (nine)
      rhs_y_kernel<T, true><<<grid, block, 0, st>>>(so, q, b, lw, nx, ny, parity);
    else
      rhs_y_kernel<T, false><<<grid, block, 0, st>>>(so, q, b, lw, nx, ny, parity);
    solve_y_kernel<T><<<lines, kLineBlock, 0, st>>>(so, q, lw, nx, ny, parity);
  } else {
    const dim3 grid = grid_for(nx, nactive);
    if (nine)
      rhs_x_kernel<T, true><<<grid, block, 0, st>>>(so, q, b, lw, nx, ny, parity);
    else
      rhs_x_kernel<T, false><<<grid, block, 0, st>>>(so, q, b, lw, nx, ny, parity);
    solve_x_kernel<T><<<lines, kLineBlock, 0, st>>>(so, q, lw, nx, ny, parity);
  }
  return (int)cudaGetLastError();
}

template <bool Y>
int dispatch(int dtype, const void* so, void* q, const void* b, void* lw,
             int nx, int ny, int nine, int parity, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kFloat32)
    return launch<float, Y>(so, q, b, lw, nx, ny, nine, parity, st);
  if (dtype == kFloat64)
    return launch<double, Y>(so, q, b, lw, nx, ny, nine, parity, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cedar

extern "C" {

// One zebra colour of x-line relaxation (lines along the first axis, one
// per column of the given parity), in place on q (nx, ny): two kernel
// launches.  lw is scratch of 2 * nx * ((ny + 1) / 2) elements.
// Returns cudaGetLastError().
int cedar_line2_x(int dtype, const void* so, void* q, const void* b,
                  void* lw, int nx, int ny, int nine, int parity,
                  void* stream) {
  return cedar::dispatch<false>(dtype, so, q, b, lw, nx, ny, nine, parity,
                                stream);
}

// One zebra colour of y-line relaxation (lines along the second axis, one
// per row of the given parity), in place on q (nx, ny): two kernel
// launches.  lw is scratch of 2 * ny * ((nx + 1) / 2) elements.
// Returns cudaGetLastError().
int cedar_line2_y(int dtype, const void* so, void* q, const void* b,
                  void* lw, int nx, int ny, int nine, int parity,
                  void* stream) {
  return cedar::dispatch<true>(dtype, so, q, b, lw, nx, ny, nine, parity,
                               stream);
}

}  // extern "C"
