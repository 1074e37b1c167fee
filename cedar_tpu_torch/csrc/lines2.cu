// K4: one zebra colour of 2D line relaxation, x-lines or y-lines.
//
// Replaces the Pallas kernel cedar_tpu/ops/pallas_lines2.py `_sweep_kernel`
// (called by `_color_call` <- `line_relax_x` / `line_relax_y`; its solve is
// `_solve_all_lines`): for every line of the active colour, form the
// off-line right-hand side, solve the tridiagonal system along the line,
// write the line.  The math and the term order are ops/lines2.py of this
// package (`line_rhs_x`, `line_coeffs_x`, `pcr_solve`; `_factor` and
// `tridiag_solve` for short lines; reference
// BMG2_SymStd_relax_lines_{x,y}.f90):
//   rhs = b + S(i,j) q(i,j-1) + S(i,j+1) q(i,j+1) [+ the 4 corner terms]
//   lines of pcr_stride h > 0 (n >= 64 points): log2 h PCR steps, then
//   Thomas on the h interleaved systems (stencil2.cuh `solve_lines`);
//   shorter lines: the LDLᵀ recurrence, one thread a line.  Under
//   solver.ml-relax.enabled the wrapper passes the full stride (h the power
//   of two at or above n: all log2 h PCR steps, then r / dg, cedar_tpu's
//   `_pcr_solve`, the XLA solve ml-relax selects); the same kernel, its
//   lines padded to h rows, so fewer fit a block (ops/cuda_lines2.group).
// The y entry swaps the roles of the axes and reads the operands where
// they lie: its rhs is the x rhs of the transposed stencil (lines2.
// transpose_so: W<->S, SW->SWᵀ, NW->NWᵀ) in the same term order, so it
// rounds as the plain version's transposed sweep does.
//
// What bounds it on the H100: the dependent chains of the solve and the
// column access of x-lines.  A line's Thomas recurrence is a chain of 2n
// dependent steps (each with an IEEE division), and only the lines of one
// colour are independent: 1024 lines of 2048 points at 2048², 32 warps for
// 132 SMs.  PCR to stride h cuts the chain to log2 h block-wide steps plus
// 2n/h dependent steps, with h threads a line.
// Design, one launch a colour (the first design took two: an rhs
// pass into a device-memory scratch, then one thread a line running the
// recurrence from it in 16-step load chunks, 1.07 / 1.19 ms for a 2048²
// 9-point f32 x / y sweep on the H100):
//  * a block takes `lines` adjacent active lines (3 of 2048 f32 points:
//    two buffers of npad rows of 4 values a line, 64 KB) and stages them
//    into shared memory (stencil2.cuh `stage_lines`): the rhs from b, q and
//    the off-line couplings, the diagonal and the two couplings along the
//    line; y-lines are rows, read whole;
//  * x-lines are columns: a block alone would read runs of 2·lines+1
//    columns a row.  So x-lines run in clusters of kCluster blocks that
//    stage and store together (`line_x_cluster`): each block
//    takes a kCluster-th of the rows of all the cluster's lines, runs of
//    2·kCluster·lines columns, and writes each row into the shared memory
//    of the block that owns its line (distributed shared memory);
//  * the block solves its lines in shared memory (`solve_lines`): each PCR
//    step reads a row and its neighbours at ±h' from one buffer and writes
//    the new row to the other, then a barrier; then lines·h threads run
//    Thomas over the interleaved systems;
//  * the solutions go back to q from shared memory (`store_lines`).
// A line too long for the shared memory the wrapper gives it
// (ops/cuda_lines2.LINE_SMEM) keeps its buffers in a device-memory scratch
// instead, one line a block, in the same code.
// Measured on an H100 (PERF.md, Findings): 0.29 / 0.21 ms for a 2048²
// 9-point f32 x / y sweep, 7.3× / 5.4× its bytes bound; without the
// clusters x took 0.37.
//
// In place is race-free: the rhs of line j reads q only on lines j +- 1,
// which belong to the other colour, and a block writes only its own lines
// (the Python wrapper, ops/cuda_lines2.py, refuses aliased operands and
// other stencil kinds).  Couplings whose neighbour lies outside the grid
// (S(i, j+1) at j = ny-1, W(i+1, j) at i = nx-1, and the corners) read as
// exactly 0, as the zero-filled shifts of the plain version give.
//
// Periodic grids (template flag PER, the axes in a Wrap; the JAX package
// solves them in XLA, cedar_tpu/ops/lines2.py `_cyclic_solve` and
// `_line_rhs_x` with `periodic`): across a periodic axis the rhs reads
// the neighbour lines with wrap-around (line 0 and the last line are
// neighbours, of different colours: the line count must be even, and the
// entry points refuse an odd one).  Along a periodic axis a line is
// cyclic: it is staged twice, with the rhs and with the Sherman–Morrison
// vector u, as two lines of the modified matrix (stencil2.cuh
// `line_row_wrap`), both solved by the same code as every line; a thread
// a line then forms its factor (v·y)/(1 + v·z) (`cyclic_factor`) and its
// points are stored as y - z times it (`cyclic_value`).  A block holds
// half as many cyclic lines (ops/cuda_lines2.group).

#include <cooperative_groups.h>

#include "stencil2.cuh"

namespace cedar {
namespace {

// Blocks of a cluster that stage and store x-lines together.
constexpr int kCluster = 4;

// y-lines: block b solves the active lines b*lines .. b*lines + lines - 1
// of the colour `parity` (the rows 2t + parity).
template <typename T, bool NINE, bool PER>
__global__ void __launch_bounds__(1024)
    line_y_kernel(const T* __restrict__ so, T* q, const T* __restrict__ b,
                  Row<T>* scratch, int nx, int ny, int parity, int h,
                  int lines, Wrap wr) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const int t0 = blockIdx.x * lines;
  const long long P = (long long)nx * ny;
  if constexpr (!PER) {
    Row<T>* base = scratch
                       ? scratch + 2LL * blockIdx.x * lines * line_pad(ny, h)
                       : reinterpret_cast<Row<T>*>(smem_raw);
    const Lines<T> L(base, lines, min(lines, (nx - parity + 1) / 2 - t0), ny,
                     h);
    stage_lines<T, NINE, true>(L, so, q, b, P, nx, ny, parity, t0);
    __syncthreads();
    const Row<T>* x = solve_lines(L);
    __syncthreads();
    store_lines<T, true>(L, x, q, ny, parity, t0);
  } else {
    const int slots = wr.y ? 2 : 1;  // cyclic lines: two systems each
    Row<T>* base =
        scratch ? scratch + 2LL * blockIdx.x * slots * lines * line_pad(ny, h)
                : reinterpret_cast<Row<T>*>(smem_raw);
    const Lines<T> L(base, slots * lines,
                     slots * min(lines, (nx - parity + 1) / 2 - t0), ny, h);
    stage_lines_wrap<T, NINE, true>(L, so, q, b, P, nx, ny, parity, t0, wr,
                                    slots);
    __syncthreads();
    Row<T>* x = const_cast<Row<T>*>(solve_lines(L));
    __syncthreads();
    store_lines_wrap<T, true>(L, x, q, so, P, ny, parity, t0, slots);
  }
}

// x-lines (the columns 2t + parity), a cluster of kCluster blocks: block r
// of the cluster holds the lines c0 + r*lines .. c0 + r*lines + lines - 1
// and solves them, as line_y_kernel's block does its rows, but the cluster
// stages and stores its lines together, each block a kCluster-th of the
// rows of every line of the cluster, into and from the owning block's
// buffers (its shared memory, or its share of the scratch).  A row of the
// cluster's lines is then a run of 2·kCluster·lines columns, not
// 2·lines.
//
// PER: a periodic grid.  A cyclic line (wr.x) takes two consecutive
// systems (slots) of its owner's buffers, and the store combines them.
template <typename T, bool NINE, bool PER>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(1024)
    line_x_cluster(const T* __restrict__ so, T* q, const T* __restrict__ b,
                   Row<T>* scratch, int nx, int ny, int parity, int h,
                   int lines, Wrap wr) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int npad = line_pad(nx, h);
  const int c0 = blockIdx.x / kCluster * kCluster * lines;
  const int ncl = min(kCluster * lines, (ny - parity + 1) / 2 - c0);
  const int slots = PER && wr.x ? 2 : 1;  // cyclic lines: two systems each
  // rows of two buffers
  const long long per_block = 2LL * slots * lines * npad;
  Row<T>* own = scratch ? scratch + blockIdx.x * per_block
                        : reinterpret_cast<Row<T>*>(smem_raw);
  auto base_of = [&](int r) -> Row<T>* {
    return scratch ? own + (r - rank) * per_block : cl.map_shared_rank(own, r);
  };
  const Lines<T> L(own, slots * lines,
                   slots * max(0, min(lines, ncl - rank * lines)), nx, h);
  const int share = (npad + kCluster - 1) / kCluster;
  const int i0 = rank * share, rows = max(0, min(share, npad - i0));
  const long long P = (long long)nx * ny;
  if constexpr (!PER) {
    for (int k = threadIdx.x; k < ncl * rows; k += blockDim.x) {
      const int l = k % ncl, i = i0 + k / ncl;
      base_of(l / lines)[(l % lines) * npad + i] = line_row<T, NINE, false>(
          so, q, b, P, nx, ny, 2 * (c0 + l) + parity, i);
    }
  } else {
    const int ns = ncl * slots;  // the cluster's systems
    for (int k = threadIdx.x; k < ns * rows; k += blockDim.x) {
      const int l = k % ns / slots, u = k % slots, i = i0 + k / ns;
      base_of(l / lines)[((l % lines) * slots + u) * npad + i] =
          line_row_wrap<T, NINE, false>(so, q, b, P, nx, ny,
                                        2 * (c0 + l) + parity, i, wr, u);
    }
  }
  cl.sync();
  const long long x = solve_lines(L) - own;  // the same buffer in every block
  if (slots == 2) {
    // the factors of the block's own cyclic lines (cyclic_factor)
    __syncthreads();
    for (int l = threadIdx.x; l < L.nl / 2; l += blockDim.x) {
      Row<T>* y = own + x + 2LL * l * npad;
      cyclic_factor<T, false>(y, y + npad, nx, so, P, ny,
                              2 * (c0 + rank * lines + l) + parity);
    }
  }
  cl.sync();
  for (int k = threadIdx.x; k < ncl * rows; k += blockDim.x) {
    const int l = k % ncl, i = i0 + k / ncl;
    if (i >= nx) continue;
    const Row<T>* y = base_of(l / lines) + x + (l % lines) * slots * npad;
    q[(long long)i * ny + 2 * (c0 + l) + parity] =
        slots == 1 ? y[i].r : cyclic_value(y, y + npad, i);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

template <typename T, bool NINE, bool Y, bool PER>
int launch_kind(const T* so, T* q, const T* b, Row<T>* scratch, int nx,
                int ny, int parity, int h, int lines, Wrap wr,
                cudaStream_t st) {
  const int n = Y ? ny : nx;
  const int nactive = ((Y ? nx : ny) - parity + 1) / 2;
  if (nactive <= 0 || n <= 0) return 0;
  if (lines <= 0 || h < 0) return (int)cudaErrorInvalidValue;
  // across a periodic axis the line count must be even
  if ((Y ? wr.x : wr.y) && ((Y ? nx : ny) & 1))
    return (int)cudaErrorInvalidValue;
  const int slots = (Y ? wr.y : wr.x) ? 2 : 1;  // cyclic: two systems a line
  const int npad = line_pad(n, h);
  const size_t smem = scratch ? 0 : lines_bytes<T>((long long)slots * lines,
                                                   npad);
  auto fn = Y ? line_y_kernel<T, NINE, PER> : line_x_cluster<T, NINE, PER>;
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (nactive + lines - 1) / lines;
  if (!Y) blocks = (blocks + kCluster - 1) / kCluster * kCluster;
  fn<<<blocks, line_threads((long long)slots * lines * npad), smem, st>>>(
      so, q, b, scratch, nx, ny, parity, h, lines, wr);
  return (int)cudaGetLastError();
}

template <bool Y>
int dispatch(int dtype, const void* so, void* q, const void* b,
             void* scratch, int nx, int ny, int nine, int parity, int h,
             int lines, int px, int py, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Wrap wr;
  wr.x = px != 0;
  wr.y = py != 0;
  const bool per = wr.x || wr.y;
#define CEDAR_LINE2_P(T, NINE)                                              \
  return per ? launch_kind<T, NINE, Y, true>(                               \
                   (const T*)so, (T*)q, (const T*)b, (Row<T>*)scratch, nx,  \
                   ny, parity, h, lines, wr, st)                            \
             : launch_kind<T, NINE, Y, false>(                              \
                   (const T*)so, (T*)q, (const T*)b, (Row<T>*)scratch, nx,  \
                   ny, parity, h, lines, wr, st)
#define CEDAR_LINE2(T)          \
  if (nine) {                   \
    CEDAR_LINE2_P(T, true);     \
  } else {                      \
    CEDAR_LINE2_P(T, false);    \
  }
  if (dtype == kFloat32) CEDAR_LINE2(float);
  if (dtype == kFloat64) CEDAR_LINE2(double);
#undef CEDAR_LINE2
#undef CEDAR_LINE2_P
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cedar

extern "C" {

// One zebra colour of x-line relaxation (lines along the first axis, one
// per column of the given parity), in place on q (nx, ny): one kernel
// launch.  h: the PCR interleave stride of a line of nx points
// (ops/lines2.pcr_stride; 0 for the LDLᵀ recurrence); lines: active lines
// a block; scratch: null to hold the lines in shared memory, or
// 8 * lines * npad elements a block (npad: stencil2.cuh `line_pad`), the
// blocks of the active lines rounded up to a multiple of kCluster (twice
// the elements for cyclic lines); px, py: the periodic axes (1 periodic).
// Returns cudaGetLastError().
int cedar_line2_x(int dtype, const void* so, void* q, const void* b,
                  void* scratch, int nx, int ny, int nine, int parity, int h,
                  int lines, int px, int py, void* stream) {
  return cedar::dispatch<false>(dtype, so, q, b, scratch, nx, ny, nine,
                                parity, h, lines, px, py, stream);
}

// One zebra colour of y-line relaxation (lines along the second axis, one
// per row of the given parity), in place on q (nx, ny): one kernel launch;
// the arguments as cedar_line2_x's, h that of a line of ny points.
// Returns cudaGetLastError().
int cedar_line2_y(int dtype, const void* so, void* q, const void* b,
                  void* scratch, int nx, int ny, int nine, int parity, int h,
                  int lines, int px, int py, void* stream) {
  return cedar::dispatch<true>(dtype, so, q, b, scratch, nx, ny, nine,
                               parity, h, lines, px, py, stream);
}

}  // extern "C"
