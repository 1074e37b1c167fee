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
// What bounds it on the H100: the dependent chains of the line solves.
// Only the lines of one colour of one plane are independent, and a smooth
// is four colour passes one after the other.  Its bytes are small: a (64,
// 128, 128) f32 5-point batch reads 3 stencil planes, b and q and writes
// q, about 25 MB, which fits the 50 MB L2.
// Design, one launch for the whole call, a block a plane (the first
// design ran 128 threads a plane, an rhs pass into a device-memory
// scratch and one thread a line running the LDLᵀ recurrence: 2·128
// dependent steps a pass, 0.57 ms for 2 smooths + the residual of a (64,
// 128, 128) 5-point f32 batch on the H100):
//  * each of the block's colour passes stages its active lines into shared
//    memory (stencil2.cuh `stage_lines`, K4's staging), solves them there
//    (`solve_lines`: PCR to stride h, then Thomas on the interleaved
//    systems, for lines of 64 points or more; the LDLᵀ recurrence below)
//    and writes them back to q (`store_lines`), with block barriers
//    between.  A line takes two buffers of npad rows of 4 values (4 KB for
//    a 128-point f32 line), so a pass runs in groups of as many lines as
//    the shared memory the wrapper gives holds (ops/cuda_planes2.py: 48 of
//    the 64 lines of a 128² f32 plane).  A 128-point line's pass is
//    log2 h PCR steps and 2·128/h dependent Thomas steps (h = 8);
//  * the block has up to 1024 threads (4 rows a thread);
//  * with a residual, a last phase writes b - A q, one thread a point.
// q, b and the stencil stay in device memory (L2-resident at the sizes
// above).  What remains: 64 planes are 64 blocks for 132 SMs, and a pass
// of a 128² f32 plane is two groups one after the other; a cluster of
// blocks a plane is later work.  Measured: PERF.md, Findings.
//
// One-direction mode (axes 1: x-lines only, 2: y-lines only; 3 is the
// line-xy smooth): K4's zebra sweep of every plane of a batch, the batched
// K4 of plane relaxation's line-x and line-y plane smoothers (the JAX
// package's zebra line sweep batched by its `custom_vmap`,
// cedar_tpu/ops/pallas_lines2.py `_vmap_core`), nsweeps of them
// and the residual in one launch.  A smooth is then the x (y) passes of
// the order above, DOWN parity 1 then 0, UP 0 then 1: K4's colour order
// (ops/lines2.py `colour_order`), and each line is solved as K4 solves it.
// Planes are never periodic (the JAX package builds its plane solvers
// non-periodic, cedar_tpu/ops/planes3.py `setup_planes`), so no cyclic
// line is needed.
//
// Both modes take the full PCR stride too (hx, hy from pcr_stride's
// `full`: a plane-config's solver.ml-relax.enabled), each line then solved
// by the full-length PCR as K4 solves it with the full stride.
//
// In place is race-free: a pass's rhs reads q only on lines of the other
// colour, its solves write only their own lines, and the barriers order
// the phases (the Python wrapper refuses aliased operands and other
// stencil kinds).

#include "stencil2.cuh"

namespace cedar {
namespace {

// One zebra colour of x-lines (Y false: columns 2t + parity) or y-lines
// (rows 2t + parity) of one plane, `lines` lines a group, in place on q.
template <typename T, bool NINE, bool Y>
__device__ void pass(const T* __restrict__ so, T* q, const T* __restrict__ b,
                     Row<T>* base, long long P, int nx, int ny, int parity,
                     int h, int lines) {
  const int nactive = ((Y ? nx : ny) - parity + 1) / 2;
  for (int t0 = 0; t0 < nactive; t0 += lines) {
    const Lines<T> L(base, lines, min(lines, nactive - t0), Y ? ny : nx, h);
    stage_lines<T, NINE, Y>(L, so, q, b, P, nx, ny, parity, t0);
    __syncthreads();
    const Row<T>* x = solve_lines(L);
    __syncthreads();
    store_lines<T, Y>(L, x, q, ny, parity, t0);
    __syncthreads();
  }
}

struct Plan {
  int hx, hy, lx, ly;     // PCR strides and lines a group, x and y passes
  long long per_plane;    // scratch elements a plane (0: shared memory)
};

// Block p smooths plane p in place; res (or nullptr) takes b - A q.
template <typename T, bool NINE>
__global__ void __launch_bounds__(1024)
    smooth_kernel(const T* __restrict__ so, T* q, const T* __restrict__ b,
                  T* __restrict__ res, T* scratch, int nb, int nx, int ny,
                  int up, int nsweeps, int axes, Plan pl) {
  using A = Arith<T>;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int p = blockIdx.x;
  const long long N = (long long)nx * ny;
  const long long P = nb * N;
  so += p * N;
  q += p * N;
  b += p * N;
  Row<T>* base = pl.per_plane
                     ? reinterpret_cast<Row<T>*>(scratch + p * pl.per_plane)
                     : reinterpret_cast<Row<T>*>(smem_raw);
  const bool xl = axes & 1, yl = axes & 2;
  for (int s = 0; s < nsweeps; ++s) {
    if (!up) {
      if (xl) {
        pass<T, NINE, false>(so, q, b, base, P, nx, ny, 1, pl.hx, pl.lx);
        pass<T, NINE, false>(so, q, b, base, P, nx, ny, 0, pl.hx, pl.lx);
      }
      if (yl) {
        pass<T, NINE, true>(so, q, b, base, P, nx, ny, 1, pl.hy, pl.ly);
        pass<T, NINE, true>(so, q, b, base, P, nx, ny, 0, pl.hy, pl.ly);
      }
    } else {
      if (yl) {
        pass<T, NINE, true>(so, q, b, base, P, nx, ny, 0, pl.hy, pl.ly);
        pass<T, NINE, true>(so, q, b, base, P, nx, ny, 1, pl.hy, pl.ly);
      }
      if (xl) {
        pass<T, NINE, false>(so, q, b, base, P, nx, ny, 0, pl.hx, pl.lx);
        pass<T, NINE, false>(so, q, b, base, P, nx, ny, 1, pl.hx, pl.lx);
      }
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
           int nb, int nx, int ny, int nine, int up, int nsweeps, int axes,
           const Plan& pl, cudaStream_t st) {
  if (nb <= 0 || nx <= 0 || ny <= 0) return 0;
  if (axes < 1 || axes > 3 || pl.lx <= 0 || pl.ly <= 0 || pl.hx < 0 ||
      pl.hy < 0 || (pl.per_plane > 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  // the rows a group of the passes that run
  const long long rows =
      std::max((axes & 1) ? (long long)pl.lx * line_pad(nx, pl.hx) : 1,
               (axes & 2) ? (long long)pl.ly * line_pad(ny, pl.hy) : 1);
  const size_t smem = pl.per_plane ? 0 : lines_bytes<T>(rows, 1);
  auto fn = nine ? smooth_kernel<T, true> : smooth_kernel<T, false>;
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<nb, line_threads(rows), smem, st>>>(
      (const T*)so, (T*)q, (const T*)b, (T*)res, (T*)scratch, nb, nx, ny,
      up, nsweeps, axes, pl);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// nsweeps line-xy smooths (up = 0: DOWN order, 1: UP) of the nb planes of
// q (nb, nx, ny), in place, then res = b - A q when res is not null: one
// kernel launch.  axes: 3 line-xy, 1 x-lines only, 2 y-lines only (the
// one-direction mode).  hx, hy: the PCR interleave strides of the x-lines
// (nx points) and y-lines (ny points), ops/lines2.pcr_stride (0: the LDLᵀ
// recurrence); lx, ly: lines a group of an x or y pass; scratch: null to
// hold a group in shared memory, or per_plane elements a plane (8 * the
// larger of lx * npad_x and ly * npad_y of the passes that run, npad:
// stencil2.cuh `line_pad`).  Returns cudaGetLastError().
int cedar_line_xy_smooth2(int dtype, const void* so, void* q, const void* b,
                          void* res, void* scratch, int nb, int nx, int ny,
                          int nine, int up, int nsweeps, int axes, int hx,
                          int hy, int lx, int ly, long long per_plane,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Plan pl{hx, hy, lx, ly, per_plane};
  if (dtype == cedar::kFloat32)
    return cedar::launch<float>(so, q, b, res, scratch, nb, nx, ny, nine, up,
                                nsweeps, axes, pl, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch<double>(so, q, b, res, scratch, nb, nx, ny, nine, up,
                                 nsweeps, axes, pl, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
