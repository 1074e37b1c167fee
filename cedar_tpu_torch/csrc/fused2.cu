// K11 (fused sweep), K12 (sweep + residual + restriction) and K13
// (interp-add + sweep): the fused fine-level kernels of the 2D V-cycle.
//
// K11 replaces the Pallas kernel cedar_tpu/ops/pallas2_split.py
// `_sweep_kernel_split` (called by `point_relax_split`): all colour phases
// of one multicolour sweep, then optionally the residual b - A q or the
// per-block partial sums of res² that the solve loop's convergence norm
// adds up.  K12 replaces cedar_tpu/ops/pallas_transfer2.py
// `_sweep_restrict_kernel` (`sweep_restrict_split`): the last pre-sweep,
// its residual and the coarse rhs cb = Pᵀ res in one pass; the residual
// is written only on request.  K13 replaces `_interp_sweep_kernel`
// (`interp_sweep_split`): the residual of the pre-smoothed iterate
// recomputed on chip, q + P qc + res/diag, then the first post-sweep (+
// the residual or the partial sums).  The Pallas kernels work on the
// lane-parity-split layout that Mosaic needs; these work on the dense
// (nx, ny) grid and compute what those compute.  The math is
// ops/fused2.py's plain versions, which compose relax2.sweep_torch,
// stencil2.residual, interp2.restrict_torch and interp2.interp_add_torch;
// the arithmetic comes from stencil2.cuh (`offdiag_at`) and transfer2.cuh
// (`restrict_value`, `interp_value`), so each output equals the separate
// kernels K1, K2 and K3 in sequence bit for bit.
//
// What bounds them on the H100: bytes.  A sweep does about 1 flop per
// byte.  The dense sequence moves q through device memory once per colour
// phase and the residual once more; a fused kernel reads q once and writes
// it once, and reads the stencil planes, b, CI and qc once each.
//
// Design: a block owns an output tile of kTZ x TW points and loads q over
// the tile plus a halo of H rings, a region kRW = 64 columns wide (TW = 64
// - 2H), into shared memory.  All colour phases run there, with
// __syncthreads() between them, as the Pallas kernels run them on a VMEM
// row slab with an 8-row halo.  The stencil planes, b, CI and qc are
// read-only and come from device memory through the read-only path; only
// q lives in shared memory (with K12's residual tile, and K13's incoming q
// beside the interpolated one).  A phase updates a point from its
// neighbours, so each phase leaves one more ring of the halo stale, and so
// does a residual read from the tile.  The halos, with P = 2 phases
// (5-point) or 4 (9-point):
//   K11: H = P, + 1 with the residual or the norm;
//   K12: H = P + 1 (the residual) + 1 (restriction reads fine rows
//        2k-1 .. 2k+1; the high side would not need it);
//   K13: H = 1 (the recomputed pre-sweep residual) + P, + 1 with the
//        residual or the norm.
// Colours anchor to global indices (relax2.color_order; K11 also takes an
// origin).  A phase maps its threads onto its own colour's points only
// (every other column of a row; every other row too for 9-point), one
// column a lane: the region's 64 columns hold at most 32 of one colour.
// Points outside the grid are never updated and their couplings
// contribute exactly zero, so any grid shape works, down to a few points.
//
// Out of place: a block reads q_in over its tile and halo while other
// blocks write their tiles.  Updated in place, a block could read a
// neighbour's updated interior as its halo, a race that is wrong only
// sometimes.  So each kernel reads q_in and writes a separate q_out (the
// wrappers in ops/cuda_fused2.py allocate it).
//
// K12's tiles start at even fine indices, so each coarse point (2k, 2m)
// has exactly one owner block.  The norm epilogue writes one partial a
// block (the sum of res² over the block's own points, in no fixed order
// against the plain version's sum) into a buffer of
// cedar_fused2_partials entries; the caller sums the buffer.

#include "stencil2.cuh"
#include "transfer2.cuh"

namespace cedar {
namespace {

constexpr int kTZ = 32;                       // output rows a block
constexpr int kThreads = kBlockX * kBlockY;   // 256
// output modes of K11 and K13
constexpr int kNone = 0, kRes = 1, kNorm = 2;

// the region's columns: two of a warp's rows; a 9-point f64 K13 with its
// two buffers and H = 6 takes 2 x 44 x 64 x 8 bytes = 45 KB of shared memory
constexpr int kRW = 2 * kBlockX;

// The halos of the header note, with or without the residual / norm
// epilogue ("epi").
__host__ __device__ constexpr int phases_of(bool nine) { return nine ? 4 : 2; }
__host__ __device__ constexpr int sweep_halo(bool nine, bool epi) {
  return phases_of(nine) + epi;  // K11
}
__host__ __device__ constexpr int sweep_restrict_halo(bool nine) {
  return phases_of(nine) + 2;  // K12
}
__host__ __device__ constexpr int interp_sweep_halo(bool nine, bool epi) {
  return 1 + phases_of(nine) + epi;  // K13
}

__device__ __forceinline__ bool in_grid(int z, int w, int nx, int ny) {
  return z >= 0 && z < nx && w >= 0 && w < ny;
}

// s (RZ x kRW) = q over global rows [z0, z0 + RZ), columns [w0, w0 +
// kRW); points outside the grid hold 0 (never read: their couplings are
// zero).
template <typename T, int RZ>
__device__ void load_region(T* s, const T* __restrict__ q, int z0, int w0,
                            int nx, int ny) {
  for (int r = threadIdx.y; r < RZ; r += kBlockY) {
    const int z = z0 + r;
    for (int c = threadIdx.x; c < kRW; c += kBlockX) {
      const int w = w0 + c;
      s[r * kRW + c] =
          in_grid(z, w, nx, ny) ? q[(long long)z * ny + w] : T(0);
    }
  }
}

// b - A q at grid point (z, w), held at local (r, c) of the tile s.
template <typename T, bool NINE>
__device__ __forceinline__ T residual_at(const T* s, int r, int c,
                                         const T* __restrict__ so,
                                         const T* __restrict__ b, int z,
                                         int w, int nx, int ny) {
  using A = Arith<T>;
  const long long i = (long long)z * ny + w;
  const T* qp = s + r * kRW + c;
  return A::sub(A::add(b[i], offdiag_at<T, NINE>(so, (long long)nx * ny, z,
                                                 w, nx, ny, qp, kRW)),
                A::mul(so[i], *qp));
}

// The colour phases of one sweep on the tile s (RZ x kRW).  Phase k
// updates its colour's points at depth >= d0 + k (the depth of a local
// point is its distance in rings from the region's edge): if q is right at
// depth >= d0 - 1 before, it is right at depth >= d0 - 1 + ncolors after.
// colors packs the colour codes in sweep order, 4 bits each
// (ops/cuda_fused2.py).  Lane x takes the x-th point of the colour in a
// row; 9-point colours also skip every other row.
template <typename T, bool NINE, int RZ>
__device__ void phases(T* s, const T* __restrict__ so,
                       const T* __restrict__ b, int z0, int w0, int nx,
                       int ny, int colors, int ncolors, int oz, int ow,
                       int d0) {
  using A = Arith<T>;
  const long long P = (long long)nx * ny;
  for (int k = 0; k < ncolors; ++k) {
    const int color = (colors >> (4 * k)) & 15;
    const int lo = d0 + k;
    // 5-point: (gz + gw) % 2 == color; 9-point: color = 2 cw + cz, rows
    // with gz % 2 == cz, columns with gw % 2 == cw (gz = z + oz, gw = w +
    // ow; & 1 is the parity of negative indices too)
    const int r0 = NINE ? lo + (((color & 1) - z0 - oz - lo) & 1) : lo;
    const int rstep = NINE ? 2 * kBlockY : kBlockY;
    for (int r = r0 + (NINE ? 2 : 1) * threadIdx.y; r < RZ - lo; r += rstep) {
      const int z = z0 + r;
      if (z < 0 || z >= nx) continue;
      const int cpar = NINE ? (color >> 1) : color - (z + oz);
      const int c = lo + ((cpar - w0 - ow - lo) & 1) + 2 * threadIdx.x;
      const int w = w0 + c;
      if (c >= kRW - lo || w < 0 || w >= ny) continue;
      const long long i = (long long)z * ny + w;
      T* qp = s + r * kRW + c;
      *qp = A::mul(A::add(b[i], offdiag_at<T, NINE>(so, P, z, w, nx, ny, qp,
                                                    kRW)),
                   A::div(T(1), so[i]));
    }
    __syncthreads();
  }
}

// The sum of v over the block, returned to thread (0, 0).
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int t = threadIdx.y * kBlockX + threadIdx.x;
  if ((t & 31) == 0) warp_sums[t >> 5] = v;
  __syncthreads();
  T tot = T(0);
  if (t == 0)
    for (int k = 0; k < kThreads / 32; ++k) tot += warp_sums[k];
  return tot;
}

// The epilogue of K11 and K13: the block's own points of s (local rows and
// columns from H) to q_out, then the residual to res (kRes) or the sum of
// its squares to partials[block] (kNorm).
template <typename T, bool NINE, int H>
__device__ void store_tile(const T* s, T* __restrict__ q_out,
                           T* __restrict__ res, T* __restrict__ partials,
                           const T* __restrict__ so, const T* __restrict__ b,
                           int z0, int w0, int nx, int ny, int mode) {
  using A = Arith<T>;
  constexpr int TW = kRW - 2 * H;
  T acc = T(0);
  for (int r = H + threadIdx.y; r < H + kTZ; r += kBlockY) {
    const int z = z0 + r;
    if (z >= nx) break;
    for (int c = H + threadIdx.x; c < H + TW; c += kBlockX) {
      const int w = w0 + c;
      if (w >= ny) break;
      const long long i = (long long)z * ny + w;
      q_out[i] = s[r * kRW + c];
      if (mode == kNone) continue;
      const T rv = residual_at<T, NINE>(s, r, c, so, b, z, w, nx, ny);
      if (mode == kRes)
        res[i] = rv;
      else
        acc = A::add(acc, A::mul(rv, rv));
    }
  }
  if (mode == kNorm) {
    const T tot = block_sum(acc);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
  }
}

// K11: one multicolour sweep of q_in into q_out (+ res / partials).
template <typename T, bool NINE, int H>
__global__ void __launch_bounds__(kThreads)
sweep_fused(const T* __restrict__ so, const T* __restrict__ q_in,
            const T* __restrict__ b, T* __restrict__ q_out,
            T* __restrict__ res, T* __restrict__ partials, int nx, int ny,
            int colors, int ncolors, int oz, int ow, int mode) {
  constexpr int TW = kRW - 2 * H, RZ = kTZ + 2 * H;
  __shared__ T s[RZ * kRW];
  const int z0 = blockIdx.y * kTZ - H, w0 = blockIdx.x * TW - H;
  load_region<T, RZ>(s, q_in, z0, w0, nx, ny);
  __syncthreads();
  phases<T, NINE, RZ>(s, so, b, z0, w0, nx, ny, colors, ncolors, oz, ow, 1);
  store_tile<T, NINE, H>(s, q_out, res, partials, so, b, z0, w0, nx, ny,
                         mode);
}

// K12: the last pre-sweep of q_in into q_out, its residual (to res when
// emit_res) and cb = Pᵀ res at the coarse points the tile owns.
template <typename T, bool NINE>
__global__ void __launch_bounds__(kThreads)
sweep_restrict_fused(const T* __restrict__ so, const T* __restrict__ q_in,
                     const T* __restrict__ b, const T* __restrict__ ci_p,
                     T* __restrict__ q_out, T* __restrict__ res,
                     T* __restrict__ cb, int nx, int ny, int nxc, int nyc,
                     int colors, int ncolors, int emit_res) {
  constexpr int H = sweep_restrict_halo(NINE);
  constexpr int TW = kRW - 2 * H, RZ = kTZ + 2 * H;
  // the residual over fine rows [zt - 1, zt + kTZ), columns [wt - 1, wt + TW)
  constexpr int SZ = kTZ + 1, SW = TW + 1;
  __shared__ T s[RZ * kRW];
  __shared__ T sr[SZ * SW];
  const int zt = blockIdx.y * kTZ, wt = blockIdx.x * TW;  // even
  const int z0 = zt - H, w0 = wt - H;
  load_region<T, RZ>(s, q_in, z0, w0, nx, ny);
  __syncthreads();
  phases<T, NINE, RZ>(s, so, b, z0, w0, nx, ny, colors, ncolors, 0, 0, 1);
  for (int r = threadIdx.y; r < SZ; r += kBlockY) {
    const int z = zt - 1 + r;
    for (int c = threadIdx.x; c < SW; c += kBlockX) {
      const int w = wt - 1 + c;
      sr[r * SW + c] = in_grid(z, w, nx, ny)
          ? residual_at<T, NINE>(s, r + H - 1, c + H - 1, so, b, z, w, nx,
                                 ny)
          : T(0);
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kTZ; r += kBlockY) {
    const int z = zt + r;
    if (z >= nx) break;
    for (int c = threadIdx.x; c < TW; c += kBlockX) {
      const int w = wt + c;
      if (w >= ny) break;
      const long long i = (long long)z * ny + w;
      q_out[i] = s[(r + H) * kRW + c + H];
      if (emit_res) res[i] = sr[(r + 1) * SW + c + 1];
    }
  }
  const CI<T> ci = ci_of(ci_p, 0, 1, nxc, nyc);
  auto fine = [&](int z, int w) -> T {
    return in_grid(z, w, nx, ny) ? sr[(z - zt + 1) * SW + (w - wt + 1)]
                                    : T(0);
  };
  for (int r = threadIdx.y; r < kTZ / 2; r += kBlockY) {
    const int zc = zt / 2 + r;
    if (zc >= nxc) break;
    for (int c = threadIdx.x; c < TW / 2; c += kBlockX) {
      const int wc = wt / 2 + c;
      if (wc >= nyc) break;
      cb[(long long)zc * nyc + wc] = restrict_value(ci, fine, zc, wc);
    }
  }
}

// K13: q = q_in + P qc + res/diag (res = b - A q_in, recomputed), then one
// multicolour sweep into q_out (+ res / partials).
template <typename T, bool NINE, int H>
__global__ void __launch_bounds__(kThreads)
interp_sweep_fused(const T* __restrict__ ci_p, const T* __restrict__ qc,
                   const T* __restrict__ so, const T* __restrict__ b,
                   const T* __restrict__ q_in, T* __restrict__ q_out,
                   T* __restrict__ res, T* __restrict__ partials, int nx,
                   int ny, int nxc, int nyc, int colors, int ncolors,
                   int mode) {
  using A = Arith<T>;
  constexpr int TW = kRW - 2 * H, RZ = kTZ + 2 * H;
  __shared__ T s_pre[RZ * kRW];  // q_in
  __shared__ T s[RZ * kRW];      // the interpolated q, then the swept one
  const int z0 = blockIdx.y * kTZ - H, w0 = blockIdx.x * TW - H;
  load_region<T, RZ>(s_pre, q_in, z0, w0, nx, ny);
  __syncthreads();
  // K3's expression, q + (P qc (+ res / diag off the coincident points)),
  // with the pre-sweep residual read from s_pre: right at depth >= 1
  const CI<T> ci = ci_of(ci_p, 0, 1, nxc, nyc);
  for (int r = 1 + threadIdx.y; r < RZ - 1; r += kBlockY) {
    const int z = z0 + r;
    for (int c = 1 + threadIdx.x; c < kRW - 1; c += kBlockX) {
      const int w = w0 + c;
      if (!in_grid(z, w, nx, ny)) continue;
      T v = interp_value(ci, qc, z, w, nxc, nyc);
      if ((z | w) & 1)
        v = A::add(v, A::div(residual_at<T, NINE>(s_pre, r, c, so, b, z, w,
                                                  nx, ny),
                             so[(long long)z * ny + w]));
      s[r * kRW + c] = A::add(s_pre[r * kRW + c], v);
    }
  }
  __syncthreads();
  phases<T, NINE, RZ>(s, so, b, z0, w0, nx, ny, colors, ncolors, 0, 0, 2);
  store_tile<T, NINE, H>(s, q_out, res, partials, so, b, z0, w0, nx, ny,
                         mode);
}

// the grid of a kernel with halo H on an (nx, ny) grid
inline dim3 tiles(int h, int nx, int ny) {
  const int tw = kRW - 2 * h;
  return dim3((ny + tw - 1) / tw, (nx + kTZ - 1) / kTZ);
}

template <typename T, bool NINE, int H>
int launch_sweep_h(const void* so, const void* q_in, const void* b,
                   void* q_out, void* res, void* partials, int nx, int ny,
                   int colors, int ncolors, int oz, int ow, int mode,
                   cudaStream_t st) {
  sweep_fused<T, NINE, H><<<tiles(H, nx, ny), dim3(kBlockX, kBlockY), 0,
                            st>>>(
      (const T*)so, (const T*)q_in, (const T*)b, (T*)q_out, (T*)res,
      (T*)partials, nx, ny, colors, ncolors, oz, ow, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sweep(const void* so, const void* q_in, const void* b, void* q_out,
                 void* res, void* partials, int nx, int ny, int nine,
                 int colors, int ncolors, int oz, int ow, int mode,
                 cudaStream_t st) {
  auto fn = launch_sweep_h<T, false, sweep_halo(false, false)>;
  if (nine && mode != kNone)
    fn = launch_sweep_h<T, true, sweep_halo(true, true)>;
  else if (nine)
    fn = launch_sweep_h<T, true, sweep_halo(true, false)>;
  else if (mode != kNone)
    fn = launch_sweep_h<T, false, sweep_halo(false, true)>;
  return fn(so, q_in, b, q_out, res, partials, nx, ny, colors, ncolors, oz,
            ow, mode, st);
}

template <typename T>
int launch_sweep_restrict(const void* so, const void* q_in, const void* b,
                          const void* ci, void* q_out, void* res, void* cb,
                          int nx, int ny, int nxc, int nyc, int nine,
                          int colors, int ncolors, int emit_res,
                          cudaStream_t st) {
  const dim3 grid = tiles(sweep_restrict_halo(nine), nx, ny);
  const dim3 block(kBlockX, kBlockY);
  if (nine)
    sweep_restrict_fused<T, true><<<grid, block, 0, st>>>(
        (const T*)so, (const T*)q_in, (const T*)b, (const T*)ci, (T*)q_out,
        (T*)res, (T*)cb, nx, ny, nxc, nyc, colors, ncolors, emit_res);
  else
    sweep_restrict_fused<T, false><<<grid, block, 0, st>>>(
        (const T*)so, (const T*)q_in, (const T*)b, (const T*)ci, (T*)q_out,
        (T*)res, (T*)cb, nx, ny, nxc, nyc, colors, ncolors, emit_res);
  return (int)cudaGetLastError();
}

template <typename T, bool NINE, int H>
int launch_interp_sweep_h(const void* ci, const void* qc, const void* so,
                          const void* b, const void* q_in, void* q_out,
                          void* res, void* partials, int nx, int ny, int nxc,
                          int nyc, int colors, int ncolors, int mode,
                          cudaStream_t st) {
  interp_sweep_fused<T, NINE, H><<<tiles(H, nx, ny), dim3(kBlockX, kBlockY),
                                   0, st>>>(
      (const T*)ci, (const T*)qc, (const T*)so, (const T*)b, (const T*)q_in,
      (T*)q_out, (T*)res, (T*)partials, nx, ny, nxc, nyc, colors, ncolors,
      mode);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp_sweep(const void* ci, const void* qc, const void* so,
                        const void* b, const void* q_in, void* q_out,
                        void* res, void* partials, int nx, int ny, int nxc,
                        int nyc, int nine, int colors, int ncolors, int mode,
                        cudaStream_t st) {
  auto fn = launch_interp_sweep_h<T, false, interp_sweep_halo(false, false)>;
  if (nine && mode != kNone)
    fn = launch_interp_sweep_h<T, true, interp_sweep_halo(true, true)>;
  else if (nine)
    fn = launch_interp_sweep_h<T, true, interp_sweep_halo(true, false)>;
  else if (mode != kNone)
    fn = launch_interp_sweep_h<T, false, interp_sweep_halo(false, true)>;
  return fn(ci, qc, so, b, q_in, q_out, res, partials, nx, ny, nxc, nyc,
            colors, ncolors, mode, st);
}

}  // namespace
}  // namespace cedar

extern "C" {

// The number of norm partials (of blocks) of K11 (interp = 0) or K13
// (interp = 1) with the norm epilogue on an (nx, ny) grid.
int cedar_fused2_partials(int interp, int nine, int nx, int ny) {
  const dim3 g = cedar::tiles(interp ? cedar::interp_sweep_halo(nine, true)
                                     : cedar::sweep_halo(nine, true),
                              nx, ny);
  return (int)(g.x * g.y);
}

// K11: q_out = one sweep of q_in; mode 0 nothing more, 1 res = b - A q_out,
// 2 partials[block] = Σ res² over the block.  Returns cudaGetLastError().
int cedar_sweep2_fused(int dtype, const void* so, const void* q_in,
                       const void* b, void* q_out, void* res, void* partials,
                       int nx, int ny, int nine, int colors, int ncolors,
                       int oz, int ow, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_sweep<float>(so, q_in, b, q_out, res, partials, nx,
                                      ny, nine, colors, ncolors, oz, ow, mode,
                                      st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_sweep<double>(so, q_in, b, q_out, res, partials, nx,
                                       ny, nine, colors, ncolors, oz, ow, mode,
                                       st);
  return (int)cudaErrorInvalidValue;
}

// K12: q_out = one sweep of q_in, res = b - A q_out (written when
// emit_res), cb (nxc, nyc) = Pᵀ res.  Returns cudaGetLastError().
int cedar_sweep_restrict2(int dtype, const void* so, const void* q_in,
                          const void* b, const void* ci, void* q_out,
                          void* res, void* cb, int nx, int ny, int nxc,
                          int nyc, int nine, int colors, int ncolors,
                          int emit_res, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_sweep_restrict<float>(so, q_in, b, ci, q_out, res, cb,
                                               nx, ny, nxc, nyc, nine, colors,
                                               ncolors, emit_res, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_sweep_restrict<double>(so, q_in, b, ci, q_out, res,
                                                cb, nx, ny, nxc, nyc, nine,
                                                colors, ncolors, emit_res, st);
  return (int)cudaErrorInvalidValue;
}

// K13: q_out = one sweep of q_in + P qc + (b - A q_in) / diag; mode as K11.
// Returns cudaGetLastError().
int cedar_interp_sweep2(int dtype, const void* ci, const void* qc,
                        const void* so, const void* b, const void* q_in,
                        void* q_out, void* res, void* partials, int nx,
                        int ny, int nxc, int nyc, int nine, int colors,
                        int ncolors, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp_sweep<float>(ci, qc, so, b, q_in, q_out, res,
                                             partials, nx, ny, nxc, nyc, nine,
                                             colors, ncolors, mode, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp_sweep<double>(ci, qc, so, b, q_in, q_out, res,
                                              partials, nx, ny, nxc, nyc, nine,
                                              colors, ncolors, mode, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
