// The tile design of the 2D sweep, shared by K11 (fused2.cu: the fused
// cycle's extra sweeps, + the residual or the norm partials) and K1's
// streamed regime (sweep2.cu: a dense level too large for one block's
// shared memory), so that the two cannot drift apart.
//
// A block owns an output tile of kTZ x TW points and loads q over the tile
// plus a halo of H rings, a region kRW = 64 columns wide (TW = 64 - 2H),
// into shared memory.  All colour phases run there, with __syncthreads()
// between them, as the Pallas kernels run them on a VMEM row slab with an
// 8-row halo.  The stencil planes and b are read-only and come from device
// memory through the read-only path; only q lives in shared memory.  A
// phase updates a point from its neighbours, so each phase leaves one more
// ring of the halo stale, and so does a residual read from the tile: H = P
// phases (2 for 5-point, 4 for 9-point), + 1 with the residual or the norm.
// Colours anchor to global indices (relax2.color_order; an origin shifts
// them).  A phase maps its threads onto its own colour's points only (every
// other column of a row; every other row too for 9-point), one column a
// lane: the region's 64 columns hold at most 32 of one colour.  Points
// outside the grid are never updated and their couplings contribute exactly
// zero, so any grid shape works, down to a few points.
//
// Out of place: a block reads q_in over its tile and halo while other
// blocks write their tiles, so the kernel reads q_in and writes a separate
// q_out.  The norm epilogue writes one partial a block (the sum of res²
// over the block's own points, in no fixed order against the plain
// version's sum) into a buffer of one entry a block (`tiles`); the caller
// sums it.
//
// Periodic grids (K1's periodic mode, `sweep_wrap`; the counterpart of the
// Pallas sweep's `periodic` mode): the region's halo is loaded with
// wrap-around, a region point outside the grid on a periodic axis stands
// for its wrapped point and is updated as that one is, and the couplings
// wrap (stencil2.cuh `offdiag_at` with PER).  With even extents along the
// periodic axes the colouring is consistent around the wrap and a phase
// updates in place as above.  An odd extent along a periodic axis puts the
// last point and the first, which are neighbours, into one colour: there
// (JAC) a phase computes its colour's points from the values before the
// phase, as the plain version's masked update does, into registers, and
// writes them after a barrier.
#pragma once

#include "stencil2.cuh"

namespace cedar {
namespace {

constexpr int kTZ = 32;                       // output rows a block
constexpr int kThreads = kBlockX * kBlockY;   // 256
// output modes: nothing more, the residual, the norm partials
constexpr int kNone = 0, kRes = 1, kNorm = 2;

// the region's columns: two of a warp's rows
constexpr int kRW = 2 * kBlockX;

// colour phases a sweep: 5-point red-black, 9-point four colours
__host__ __device__ constexpr int phases_of(bool nine) { return nine ? 4 : 2; }
// the halo of the header note, with or without the residual / norm
// epilogue ("epi")
__host__ __device__ constexpr int sweep_halo(bool nine, bool epi) {
  return phases_of(nine) + epi;
}

__device__ __forceinline__ bool in_grid(int z, int w, int nx, int ny) {
  return z >= 0 && z < nx && w >= 0 && w < ny;
}

// s (RZ x kRW) = q over global rows [z0, z0 + RZ), columns [w0, w0 +
// kRW); points outside the grid hold 0 (never read: their couplings are
// zero).
// With PER the periodic axes of wr wrap.
template <typename T, int RZ, bool PER = false>
__device__ void load_region(T* s, const T* __restrict__ q, int z0, int w0,
                            int nx, int ny, Wrap wr = Wrap{}) {
  for (int r = threadIdx.y; r < RZ; r += kBlockY) {
    int z = z0 + r;
    if constexpr (PER)
      if (wr.x) z = wrap_index(z, nx);
    for (int c = threadIdx.x; c < kRW; c += kBlockX) {
      int w = w0 + c;
      if constexpr (PER)
        if (wr.y) w = wrap_index(w, ny);
      s[r * kRW + c] =
          in_grid(z, w, nx, ny) ? q[(long long)z * ny + w] : T(0);
    }
  }
}

// b - A q at grid point (z, w), held at local (r, c) of the tile s.
template <typename T, bool NINE, bool PER = false>
__device__ __forceinline__ T residual_at(const T* s, int r, int c,
                                         const T* __restrict__ so,
                                         long long sd,
                                         const T* __restrict__ b, int z,
                                         int w, int nx, int ny,
                                         Wrap wr = Wrap{}) {
  using A = Arith<T>;
  const long long i = (long long)z * ny + w;
  const T* qp = s + r * kRW + c;
  return A::sub(A::add(b[i], offdiag_at<T, NINE, PER>(so, sd, z, w, nx, ny,
                                                      qp, kRW, wr)),
                A::mul(so[i], *qp));
}

// The colour phases of one sweep on the tile s (RZ x kRW).  Phase k
// updates its colour's points at depth >= d0 + k (the depth of a local
// point is its distance in rings from the region's edge): if q is right at
// depth >= d0 - 1 before, it is right at depth >= d0 - 1 + ncolors after.
// colors packs the colour codes in sweep order, 4 bits each
// (ops/cuda_fused2.py).  Lane x takes the x-th point of the colour in a
// row; 9-point colours also skip every other row.
//
// With PER a region point on a periodic axis stands for its wrapped grid
// point (extents even along the periodic axes: the wrapped point has the
// parity of the unwrapped one, so the mapping above holds).
template <typename T, bool NINE, int RZ, bool PER = false>
__device__ void phases(T* s, const T* __restrict__ so, long long P,
                       const T* __restrict__ b, int z0, int w0, int nx,
                       int ny, int colors, int ncolors, int oz, int ow,
                       int d0, Wrap wr = Wrap{}) {
  using A = Arith<T>;
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
      int zg = z;
      if constexpr (PER)
        if (wr.x) zg = wrap_index(z, nx);
      if (zg < 0 || zg >= nx) continue;
      const int cpar = NINE ? (color >> 1) : color - (z + oz);
      const int c = lo + ((cpar - w0 - ow - lo) & 1) + 2 * threadIdx.x;
      int wg = w0 + c;
      if constexpr (PER)
        if (wr.y) wg = wrap_index(wg, ny);
      if (c >= kRW - lo || wg < 0 || wg >= ny) continue;
      const long long i = (long long)zg * ny + wg;
      T* qp = s + r * kRW + c;
      *qp = A::mul(A::add(b[i], offdiag_at<T, NINE, PER>(so, P, zg, wg, nx,
                                                         ny, qp, kRW, wr)),
                   A::div(T(1), so[i]));
    }
    __syncthreads();
  }
}

// phases for an odd extent along a periodic axis (JAC in the header note):
// the colour of a region point is that of its wrapped grid point, and a
// phase writes its colour's points only after every thread has computed
// them from the values before the phase.  A thread takes the region points
// t, t + kThreads, ... (U of them), in registers.
template <typename T, bool NINE, int RZ>
__device__ void phases_jacobi(T* s, const T* __restrict__ so, long long P,
                              const T* __restrict__ b, int z0, int w0,
                              int nx, int ny, int colors, int ncolors,
                              int oz, int ow, int d0, Wrap wr) {
  using A = Arith<T>;
  constexpr int U = (RZ * kRW + kThreads - 1) / kThreads;
  const int t = threadIdx.y * kBlockX + threadIdx.x;
  for (int k = 0; k < ncolors; ++k) {
    const int color = (colors >> (4 * k)) & 15;
    const int lo = d0 + k;
    T v[U];
    unsigned act = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = t + u * kThreads, r = e / kRW, c = e % kRW;
      if (e >= RZ * kRW || r < lo || r >= RZ - lo || c < lo || c >= kRW - lo)
        continue;
      int zg = z0 + r, wg = w0 + c;
      if (wr.x) zg = wrap_index(zg, nx);
      if (wr.y) wg = wrap_index(wg, ny);
      if (!in_grid(zg, wg, nx, ny)) continue;
      const int pz = (zg + oz) & 1, pw = (wg + ow) & 1;
      if (NINE ? color != 2 * pw + pz : color != ((pz + pw) & 1)) continue;
      const long long i = (long long)zg * ny + wg;
      v[u] = A::mul(A::add(b[i], offdiag_at<T, NINE, true>(
                                     so, P, zg, wg, nx, ny, s + e, kRW, wr)),
                    A::div(T(1), so[i]));
      act |= 1u << u;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (act >> u & 1) s[t + u * kThreads] = v[u];
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

// The epilogue: the block's own points of s (local rows and
// columns from H) to q_out, then the residual to res (kRes) or the sum of
// its squares to partials[block] (kNorm).
template <typename T, bool NINE, int H, bool PER = false>
__device__ void store_tile(const T* s, T* __restrict__ q_out,
                           T* __restrict__ res, T* __restrict__ partials,
                           const T* __restrict__ so, long long sd,
                           const T* __restrict__ b, int z0, int w0, int nx,
                           int ny, int mode, Wrap wr = Wrap{}) {
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
      const T rv =
          residual_at<T, NINE, PER>(s, r, c, so, sd, b, z, w, nx, ny, wr);
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

// One multicolour sweep of q_in into q_out (+ res / partials) on each of
// nb independent planes, blockIdx.z the plane: q, b and res (nb, nx, ny),
// the stencil (ndir, nb, nx, ny), so that stencil plane d of plane p sits
// at so + d * nb*nx*ny + p * nx*ny.  Colours anchor to each plane's own
// origin.  The norm partials (kNorm) are for one plane (nb = 1).
template <typename T, bool NINE, int H>
__global__ void __launch_bounds__(kThreads)
sweep_fused(const T* __restrict__ so, const T* __restrict__ q_in,
            const T* __restrict__ b, T* __restrict__ q_out,
            T* __restrict__ res, T* __restrict__ partials, int nx, int ny,
            int colors, int ncolors, int oz, int ow, int mode, int nb) {
  constexpr int TW = kRW - 2 * H, RZ = kTZ + 2 * H;
  __shared__ T s[RZ * kRW];
  const long long N = (long long)nx * ny, pz = blockIdx.z * N;
  so += pz;
  q_in += pz;
  b += pz;
  q_out += pz;
  if (mode == kRes) res += pz;
  const int z0 = blockIdx.y * kTZ - H, w0 = blockIdx.x * TW - H;
  load_region<T, RZ>(s, q_in, z0, w0, nx, ny);
  __syncthreads();
  phases<T, NINE, RZ>(s, so, nb * N, b, z0, w0, nx, ny, colors, ncolors, oz,
                      ow, 1);
  store_tile<T, NINE, H>(s, q_out, res, partials, so, nb * N, b, z0, w0, nx,
                         ny, mode);
}

// K1's periodic mode: sweep_fused with the halo loaded and the couplings
// read with wrap-around on the axes of wr; JAC for an odd extent along one
// of them (the header note).  Residual (kRes) or nothing (kNone).
template <typename T, bool NINE, int H, bool JAC>
__global__ void __launch_bounds__(kThreads)
sweep_wrap(const T* __restrict__ so, const T* __restrict__ q_in,
           const T* __restrict__ b, T* __restrict__ q_out,
           T* __restrict__ res, int nx, int ny, int colors, int ncolors,
           int oz, int ow, int mode, Wrap wr) {
  constexpr int RZ = kTZ + 2 * H;
  __shared__ T s[RZ * kRW];
  const int z0 = blockIdx.y * kTZ - H, w0 = blockIdx.x * (kRW - 2 * H) - H;
  const long long P = (long long)nx * ny;
  load_region<T, RZ, true>(s, q_in, z0, w0, nx, ny, wr);
  __syncthreads();
  if (JAC)
    phases_jacobi<T, NINE, RZ>(s, so, P, b, z0, w0, nx, ny, colors, ncolors,
                               oz, ow, 1, wr);
  else
    phases<T, NINE, RZ, true>(s, so, P, b, z0, w0, nx, ny, colors, ncolors,
                              oz, ow, 1, wr);
  store_tile<T, NINE, H, true>(s, q_out, res, nullptr, so, P, b, z0, w0, nx,
                               ny, mode, wr);
}

// the grid of a tile kernel with halo H on nb planes of (nx, ny)
inline dim3 tiles(int h, int nx, int ny, int nb = 1) {
  const int tw = kRW - 2 * h;
  return dim3((ny + tw - 1) / tw, (nx + kTZ - 1) / kTZ, nb);
}

template <typename T, bool NINE, int H>
int launch_sweep_h(const void* so, const void* q_in, const void* b,
                   void* q_out, void* res, void* partials, int nx, int ny,
                   int colors, int ncolors, int oz, int ow, int mode, int nb,
                   cudaStream_t st) {
  sweep_fused<T, NINE, H><<<tiles(H, nx, ny, nb), dim3(kBlockX, kBlockY), 0,
                            st>>>(
      (const T*)so, (const T*)q_in, (const T*)b, (T*)q_out, (T*)res,
      (T*)partials, nx, ny, colors, ncolors, oz, ow, mode, nb);
  return (int)cudaGetLastError();
}

// nb planes (the norm partials for one only)
template <typename T>
int launch_sweep(const void* so, const void* q_in, const void* b, void* q_out,
                 void* res, void* partials, int nx, int ny, int nine,
                 int colors, int ncolors, int oz, int ow, int mode, int nb,
                 cudaStream_t st) {
  if (nb < 1 || nb > 65535 || (mode == kNorm && nb != 1))
    return (int)cudaErrorInvalidValue;
  auto fn = launch_sweep_h<T, false, sweep_halo(false, false)>;
  if (nine && mode != kNone)
    fn = launch_sweep_h<T, true, sweep_halo(true, true)>;
  else if (nine)
    fn = launch_sweep_h<T, true, sweep_halo(true, false)>;
  else if (mode != kNone)
    fn = launch_sweep_h<T, false, sweep_halo(false, true)>;
  return fn(so, q_in, b, q_out, res, partials, nx, ny, colors, ncolors, oz,
            ow, mode, nb, st);
}

template <typename T, bool NINE, int H, bool JAC>
int launch_wrap_h(const void* so, const void* q_in, const void* b,
                  void* q_out, void* res, int nx, int ny, int colors,
                  int ncolors, int oz, int ow, int mode, Wrap wr,
                  cudaStream_t st) {
  sweep_wrap<T, NINE, H, JAC><<<tiles(H, nx, ny), dim3(kBlockX, kBlockY), 0,
                                st>>>(
      (const T*)so, (const T*)q_in, (const T*)b, (T*)q_out, (T*)res, nx, ny,
      colors, ncolors, oz, ow, mode, wr);
  return (int)cudaGetLastError();
}

template <typename T, bool JAC>
int launch_wrap_jac(const void* so, const void* q_in, const void* b,
                    void* q_out, void* res, int nx, int ny, int nine,
                    int colors, int ncolors, int oz, int ow, int mode,
                    Wrap wr, cudaStream_t st) {
  auto fn = launch_wrap_h<T, false, sweep_halo(false, false), JAC>;
  if (nine && mode != kNone)
    fn = launch_wrap_h<T, true, sweep_halo(true, true), JAC>;
  else if (nine)
    fn = launch_wrap_h<T, true, sweep_halo(true, false), JAC>;
  else if (mode != kNone)
    fn = launch_wrap_h<T, false, sweep_halo(false, true), JAC>;
  return fn(so, q_in, b, q_out, res, nx, ny, colors, ncolors, oz, ow, mode,
            wr, st);
}

// K1's periodic mode on the tile kernel (kNone or kRes): the Jacobi phases
// where an extent along a periodic axis is odd.
template <typename T>
int launch_sweep_wrap(const void* so, const void* q_in, const void* b,
                      void* q_out, void* res, int nx, int ny, int nine,
                      int colors, int ncolors, int oz, int ow, int mode,
                      Wrap wr, cudaStream_t st) {
  if (mode == kNorm) return (int)cudaErrorInvalidValue;
  const bool jac = (wr.x && (nx & 1)) || (wr.y && (ny & 1));
  auto fn = jac ? launch_wrap_jac<T, true> : launch_wrap_jac<T, false>;
  return fn(so, q_in, b, q_out, res, nx, ny, nine, colors, ncolors, oz, ow,
            mode, wr, st);
}

}  // namespace
}  // namespace cedar
