// K10: nsweeps whole line-xy smooths over a batch of independent 2D planes,
// with the residual b - A q as an optional last phase: the embedded plane
// solvers' smoothing in 3D plane relaxation (ops/planes3.py).
//
// Replaces the Pallas kernel cedar_tpu/ops/pallas_planes2.py `_smooth_kernel`
// (called by `_smooth_call` <- `line_xy_smooth_batched`, `line_xy_smooth`,
// `line_xy_nsmooth_res`).  One smooth, for each plane, is
//   DOWN: x-lines of parity 1, then 0; then y-lines of parity 1, then 0;
//   UP:   y-lines of parity 0, then 1; then x-lines of parity 0, then 1,
// i.e. K4's zebra line sweeps composed as ly(lx(q)) / lx(ly(q)).  The math
// and the term order are those of K4 (lines2.cu) and of the plain version,
// ops/cuda_planes2.py (ops/lines2.py `sweep_x_torch` / `sweep_y_torch`,
// then ops/stencil2.py `residual`), through the device functions K1 and K4
// share (stencil2.cuh), so the kernel and its plain version round alike.
//
// Layout: q, b and res (nb, nx, ny); the stencil (ndir, nb, nx, ny), the
// batch axis after the direction axis, so stencil plane d of batch plane p
// sits at so + d * nb*nx*ny + p * nx*ny.  Every shape runs unpadded (the
// TPU kernel pads nx to 16 and ny to 128); lines of 1, 2 or 3 points
// included.
//
// What bounds it on the H100: latency.  A colour pass is a chain of 2n
// dependent steps per line (an IEEE division and a multiply-subtract
// forward, a multiply-subtract back), and a smooth is four such passes one
// after the other; only the lines of one colour of one plane are
// independent.  Its bytes are small: a (64, 128, 128) f32 5-point batch
// reads 3 stencil planes, b and q and writes q, about 25 MB, which fits the
// 50 MB L2.  Design, one launch for the whole call:
//  * one block per plane, looping over the sweeps and their four colour
//    passes with a block barrier between phases;
//  * in each pass the block's threads first write the rhs of every point
//    of the active lines into the plane's scratch (K4's rhs pass: x-lines
//    step-major, y-lines line-major), then one thread a line runs K4's
//    chunked LDLᵀ recurrence, factored on the fly (no setup workspace);
//  * with a residual, a last phase writes b - A q, one thread a point.
// q, b, the stencil and the scratch stay in device memory (L2-resident at
// the sizes above); keeping q in shared memory is later work.
//
// In place is race-free: a pass's rhs reads q only on lines of the other
// colour, its solves write only their own lines, and the barriers order
// the phases (the Python wrapper refuses aliased operands and other
// stencil kinds).

#include <algorithm>

#include "stencil2.cuh"

namespace cedar {
namespace {

constexpr int kThreads = 128;  // threads per block (= per plane)

// One zebra colour of x-lines (columns j = 2t + parity) of one plane.
// Scratch: rbuf[z * ((ny+1)/2) + t] holds the rhs (then w), lbuf the l.
template <typename T, bool NINE>
__device__ void pass_x(const T* __restrict__ so, T* q,
                       const T* __restrict__ b, T* lw, long long P, int nx,
                       int ny, int parity) {
  const int nactive = (ny - parity + 1) / 2;
  const int stride = (ny + 1) / 2;
  T* rbuf = lw;
  T* lbuf = lw + (long long)nx * stride;
  const long long work = (long long)nx * nactive;
  for (long long k = threadIdx.x; k < work; k += blockDim.x) {
    const int z = (int)(k / nactive), t = (int)(k % nactive);
    const int j = 2 * t + parity;
    rbuf[(long long)z * stride + t] = rhs_x<T, NINE>(
        so, q, b, P, (long long)z * ny + j, ny, z > 0, z + 1 < nx, j > 0,
        j + 1 < ny);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nactive; t += blockDim.x) {
    const int j = 2 * t + parity;
    solve_line<T>(so + j, so + W * P + j, rbuf + t, lbuf + t, q + j, nx, ny,
                  stride, ny);
  }
  __syncthreads();
}

// One zebra colour of y-lines (rows i = 2t + parity) of one plane.
// Scratch: rbuf[t * ny + w] holds the rhs (then w), lbuf the l.
template <typename T, bool NINE>
__device__ void pass_y(const T* __restrict__ so, T* q,
                       const T* __restrict__ b, T* lw, long long P, int nx,
                       int ny, int parity) {
  const int nactive = (nx - parity + 1) / 2;
  T* rbuf = lw;
  T* lbuf = lw + (long long)ny * ((nx + 1) / 2);
  const long long work = (long long)nactive * ny;
  for (long long k = threadIdx.x; k < work; k += blockDim.x) {
    const int t = (int)(k / ny), w = (int)(k % ny);
    const int i = 2 * t + parity;
    rbuf[k] = rhs_y<T, NINE>(so, q, b, P, (long long)i * ny + w, ny, i > 0,
                             i + 1 < nx, w > 0, w + 1 < ny);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nactive; t += blockDim.x) {
    const long long row = (long long)(2 * t + parity) * ny;
    solve_line<T>(so + row, so + S * P + row, rbuf + (long long)t * ny,
                  lbuf + (long long)t * ny, q + row, ny, 1, 1, 1);
  }
  __syncthreads();
}

// Block p smooths plane p in place; res (or nullptr) takes b - A q.
template <typename T, bool NINE>
__global__ void __launch_bounds__(kThreads)
    smooth_kernel(const T* __restrict__ so, T* q, const T* __restrict__ b,
                  T* __restrict__ res, T* scratch, int nb, int nx, int ny,
                  int up, int nsweeps, long long per_plane) {
  using A = Arith<T>;
  const int p = blockIdx.x;
  const long long N = (long long)nx * ny;
  const long long P = nb * N;
  so += p * N;
  q += p * N;
  b += p * N;
  T* lw = scratch + p * per_plane;
  for (int s = 0; s < nsweeps; ++s) {
    if (!up) {
      pass_x<T, NINE>(so, q, b, lw, P, nx, ny, 1);
      pass_x<T, NINE>(so, q, b, lw, P, nx, ny, 0);
      pass_y<T, NINE>(so, q, b, lw, P, nx, ny, 1);
      pass_y<T, NINE>(so, q, b, lw, P, nx, ny, 0);
    } else {
      pass_y<T, NINE>(so, q, b, lw, P, nx, ny, 0);
      pass_y<T, NINE>(so, q, b, lw, P, nx, ny, 1);
      pass_x<T, NINE>(so, q, b, lw, P, nx, ny, 0);
      pass_x<T, NINE>(so, q, b, lw, P, nx, ny, 1);
    }
  }
  if (res == nullptr) return;
  res += p * N;
  for (long long k = threadIdx.x; k < N; k += blockDim.x) {
    const int z = (int)(k / ny), w = (int)(k % ny);
    // (b + Σ coupling·q_nb) - O·q, as stencil2.residual
    res[k] = A::sub(A::add(b[k], offdiag<T, NINE>(so, q, P, z, w, nx, ny)),
                    A::mul(so[k], q[k]));
  }
}

template <typename T>
int launch(const void* so, void* q, const void* b, void* res, void* scratch,
           int nb, int nx, int ny, int nine, int up, int nsweeps,
           cudaStream_t st) {
  if (nb <= 0 || nx <= 0 || ny <= 0) return 0;
  const long long per_plane = 2 * std::max((long long)nx * ((ny + 1) / 2),
                                            (long long)ny * ((nx + 1) / 2));
  if (nine)
    smooth_kernel<T, true><<<nb, kThreads, 0, st>>>(
        (const T*)so, (T*)q, (const T*)b, (T*)res, (T*)scratch, nb, nx, ny,
        up, nsweeps, per_plane);
  else
    smooth_kernel<T, false><<<nb, kThreads, 0, st>>>(
        (const T*)so, (T*)q, (const T*)b, (T*)res, (T*)scratch, nb, nx, ny,
        up, nsweeps, per_plane);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// nsweeps line-xy smooths (up = 0: DOWN order, 1: UP) of the nb planes of
// q (nb, nx, ny), in place, then res = b - A q when res is not null: one
// kernel launch.  scratch holds 2 * max(nx * ((ny+1)/2), ny * ((nx+1)/2))
// elements per plane.  Returns cudaGetLastError().
int cedar_line_xy_smooth2(int dtype, const void* so, void* q, const void* b,
                          void* res, void* scratch, int nb, int nx, int ny,
                          int nine, int up, int nsweeps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch<float>(so, q, b, res, scratch, nb, nx, ny, nine, up,
                                nsweeps, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch<double>(so, q, b, res, scratch, nb, nx, ny, nine, up,
                                 nsweeps, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
