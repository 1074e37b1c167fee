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
// K11 and K12, the tile design: a block owns an output tile of kTZ x TW
// points and loads q over the tile plus a halo of H rings, a region kRW =
// 64 columns wide (TW = 64 - 2H), into shared memory.  All colour phases
// run there, with __syncthreads() between them, as the Pallas kernels run
// them on a VMEM row slab with an 8-row halo.  The stencil planes, b and
// CI are read-only and come from device memory through the read-only
// path; only q lives in shared memory (with K12's residual tile).  A phase
// updates a point from its neighbours, so each phase leaves one more ring
// of the halo stale, and so does a residual read from the tile.  The
// halos, with P = 2 phases (5-point) or 4 (9-point):
//   K11: H = P, + 1 with the residual or the norm;
//   K12: H = P + 1 (the residual) + 1 (restriction reads fine rows
//        2k-1 .. 2k+1; the high side would not need it).
// Colours anchor to global indices (relax2.color_order; K11 also takes an
// origin).  A phase maps its threads onto its own colour's points only
// (every other column of a row; every other row too for 9-point), one
// column a lane: the region's 64 columns hold at most 32 of one colour.
// Points outside the grid are never updated and their couplings
// contribute exactly zero, so any grid shape works, down to a few points.
//
// K13, the row march (`ring2`), the 2D form of fused3.cu's `ring3`: a
// block owns a strip of 2 NT - 2H columns (a region of 2 NT columns with H
// = 1 + P (+ 1 with the residual or the norm) columns of halo on each
// side) and a chunk of rows, and marches down its chunk (with H halo rows
// at each end) one row a step.  Stage 1 (the recomputed residual of q_in
// plus the interpolation) runs on row p - 1 at step p, colour stage s on
// row p - s, the epilogue (the residual or the norm) on row p - H; the
// rows between stages are exact for the reason fused3.cu's header note
// gives.  Rows of q_in, b and the stencil planes arrive in shared-memory
// rings by cp.async (async.cuh) kAhead steps before the step that first
// reads them, CI and qc by coarse row (a CI row serves fine rows 2k - 1
// and 2k, a qc row 2k - 1 .. 2k + 1), one commit group a step; the swept
// q lives in a ring of its own.  Thread t takes region columns 2t and 2t +
// 1 in every stage (a colour stage the one of its colour), so that a
// 5-point stage reads the row the stage before updated only at its own
// columns: one barrier a step publishes the step's copies and frees the
// slots the next copies overwrite; 9-point couplings reach diagonally into
// the next row, so each 9-point stage ends with a barrier.  Rows are
// colour-compact (a row's even columns, then its odd ones), so that a
// stage's stride-2 reads are conflict-free.  A block has NT = 128 threads;
// the chunk and the grid come from the wrapper's plan (ops/cuda_fused2.py
// `plan`: the chunk that runs the grid in whole waves of resident blocks),
// checked at launch against `Ring2`.
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
// cedar_fused2_partials entries (K13: its plan's blocks); the caller sums
// the buffer.

#include "async.cuh"
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

// The epilogue of K11: the block's own points of s (local rows and
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

// ---------------------------------------------------------------------------
// K13: the row march (see the header note).

// Build settings of tools/tune_fused2.py only: the parts of `ring2` that a
// timing probe skips (bit 0: the q_pre row copies, 1: the CI and qc
// copies, 2: the stencil and b copies, 3: the barriers, 4: the residual of
// the norm); 0 in every other build.
#ifndef CEDAR_FUSED2_PROBE
#define CEDAR_FUSED2_PROBE 0
#endif
constexpr int kProbe = CEDAR_FUSED2_PROBE;
// steps between a copy's issue and its first read (tools/tune_fused2.py
// builds others)
#ifndef CEDAR_FUSED2_AHEAD
#define CEDAR_FUSED2_AHEAD 1
#endif
constexpr int kAhead = CEDAR_FUSED2_AHEAD;
static_assert(kAhead == 1 || kAhead == 2, "copies one or two steps ahead");
// threads a block (tools/tune_fused2.py builds others)
#ifndef CEDAR_FUSED2_THREADS
#define CEDAR_FUSED2_THREADS 128
#endif
constexpr int kRingThreads = CEDAR_FUSED2_THREADS;
static_assert(kRingThreads % 32 == 0 && kRingThreads <= 1024,
              "whole warps a block");

// The layout of a K13 block of NT threads (a strip of 2 NT region
// columns); ops/cuda_fused2.py `interp_words` mirrors it and the launch
// checks the plan against it.  Rings of region rows: the swept q (rows p -
// SE - 1 .. p - 1), q_pre (p - 2 .. p + 2), the stencil planes and b (p -
// SE .. p + 2); CI (two coarse rows of 8 weights) and qc (three coarse
// rows) over the strip's nt + 2 coarse columns.
template <bool NINE, int EPI>
struct Ring2 {
  static constexpr int SP = 1 + phases_of(NINE);  // the last colour stage
  static constexpr int SE = SP + (EPI != kNone), H = SE;
  static constexpr int WQ = SE + 1, WP = 3 + kAhead, WS = SE + 1 + kAhead;
  static constexpr int NSB = (NINE ? 5 : 3) + 1;  // stencil planes and b
  static constexpr int NT = kRingThreads, CW = NT + 2;
  static constexpr size_t WORDS =
      (size_t)2 * NT * (WQ + WP + WS * NSB) + (size_t)(2 * 8 + 3) * CW;
};

// The sum of v over a block of NW warps in a row, returned to thread 0.
template <int NW, typename T>
__device__ T block_sum_row(T v) {
  __shared__ T warp_sums[NW];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T tot = T(0);
  if (threadIdx.x == 0)
    for (int k = 0; k < NW; ++k) tot += warp_sums[k];
  return tot;
}

struct RingDims2 {
  int nx, ny, nxc, nyc, cz, colors;
};

// K13 on a strip of region columns and a chunk of rows: q = q_in + P qc +
// res/diag (res = b - A q_in, recomputed), then one multicolour sweep into
// q_out (+ res / partials).  Thread t takes region columns 2t and 2t + 1 in
// every stage (a colour stage: the one of its colour).
template <typename T, bool NINE, int EPI>
__global__ void __launch_bounds__(kRingThreads)
ring2(const T* __restrict__ ci_p, const T* __restrict__ qc_p,
      const T* __restrict__ so, const T* __restrict__ b,
      const T* __restrict__ q_in, T* __restrict__ q_out, T* __restrict__ res,
      T* __restrict__ partials, const RingDims2 a) {
  using A = Arith<T>;
  using R = Ring2<NINE, EPI>;
  constexpr int SP = R::SP, SE = R::SE, H = R::H, NSB = R::NSB;
  constexpr int BI = NSB - 1;  // b's array in a stencil slot
  constexpr int NT = R::NT, nt = NT, rw = 2 * NT, tw = rw - 2 * H;
  constexpr int cw = R::CW;
  const int nx = a.nx, ny = a.ny;
  const long long P = (long long)nx * ny;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  auto qs = [&](int x) { return sm + ((x + 8 * R::WQ) % R::WQ) * rw; };
  T* const pbase = sm + R::WQ * rw;
  auto ps = [&](int x) { return pbase + ((x + 8 * R::WP) % R::WP) * rw; };
  T* const sbase = pbase + R::WP * rw;
  auto ss = [&](int x) {
    return sbase + ((x + 8 * R::WS) % R::WS) * NSB * rw;
  };
  T* const cbase = sbase + R::WS * NSB * rw;
  auto cis = [&](int k) { return cbase + (k & 1) * 8 * cw; };
  auto qcs = [&](int k) { return cbase + 16 * cw + (k % 3) * cw; };

  const int t = threadIdx.x;
  const int wt = blockIdx.x * tw, zt = blockIdx.y * a.cz;
  const int w0 = wt - H, mc0 = w0 >> 1;  // the strip's first column, coarse
  const int xe = min(zt + a.cz, nx);     // own rows [zt, xe)
  // colour-compact position of region column c (even columns, then odd)
  auto cpos = [&](int c) { return (c & 1) * nt + (c >> 1); };
  auto valid = [&](int x, int s) {
    return x >= max(zt - H + s, 0) && x < min(zt + a.cz + H - s, nx);
  };

  // --- the copies ---------------------------------------------------------
  // row x of a grid array into a ring slot, zero off the grid: thread t
  // copies columns t and t + nt
  int goff[2], soff[2];
  bool gin[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = t + nt * j, w = w0 + c;
    gin[j] = w >= 0 && w < ny;
    goff[j] = gin[j] ? w : 0;
    soff[j] = cpos(c);
  }
  auto copy_row = [&](T* dst, const T* src, int x) {
    const T* sp = src + (long long)x * ny;
#pragma unroll
    for (int j = 0; j < 2; ++j) copy_async(dst + soff[j], sp + goff[j], gin[j]);
  };
  const long long cplane = (long long)(a.nxc + 1) * (a.nyc + 1);
  // coarse row k of CI (8 weights) and of qc over the strip's coarse
  // columns, zero off the arrays
  auto copy_ci = [&](int k) {
    T* d = cis(k);
    for (int e = t; e < 8 * cw; e += nt) {
      const int dd = e / cw, m = mc0 + e % cw;
      const bool in = k >= 0 && k <= a.nxc && m >= 0 && m <= a.nyc;
      copy_async(d + e,
                 ci_p + (in ? dd * cplane + (long long)k * (a.nyc + 1) + m : 0),
                 in);
    }
  };
  auto copy_qc = [&](int k) {
    T* d = qcs(k);
    for (int e = t; e < cw; e += nt) {
      const int m = mc0 + e;
      const bool in = k >= 0 && k < a.nxc && m >= 0 && m < a.nyc;
      copy_async(d + e, qc_p + (in ? (long long)k * a.nyc + m : 0), in);
    }
  };
  const int p0 = max(zt - H, 0), load_end = min(zt + a.cz + H, nx);
  const int x1 = max(zt - H + 1, 0);  // the first stage-1 row
  // every copy that step u reads first, as one commit group
  auto issue = [&](int u) {
    if (u < load_end) {
      if (!(kProbe & 1)) copy_row(ps(u), q_in, u);
      if (!(kProbe & 4)) {
        T* d = ss(u);
#pragma unroll
        for (int s = 0; s < NSB - 1; ++s) copy_row(d + s * rw, so + s * P, u);
        copy_row(d + BI * rw, b, u);
      }
    }
    // stage 1 at row x = u - 1 reads CI row (x + 1) >> 1 and qc rows
    // x >> 1 and (x + 1) >> 1
    const int x = u - 1;
    if (!(kProbe & 2) && valid(x, 1) && (x == x1 || (x & 1))) {
      copy_ci((x + 1) >> 1);
      if (x == x1) copy_qc(x >> 1);
      if (x & 1) copy_qc((x + 1) >> 1);
    }
    commit_async();
  };

  // --- the stages ---------------------------------------------------------
  // Σ coupling · q at row x, region column c (grid column w): the stencil
  // and b from the ring, q through q0 (the point in its row of a ring whose
  // rows are dq words apart); in a colour-compact row the w + 1 and w - 1
  // neighbours of a column of parity c & 1 lie WP and WM words away
  auto offd = [&](int x, int c, int w, const T* q0, long long up,
                  long long dn) -> T {
    const int o = cpos(c);
    const int WPo = (c & 1) ? 1 - nt : nt, WMo = (c & 1) ? -nt : nt - 1;
    const bool zl = x > 0, zh = x + 1 < nx, wl = w > 0, wh = w + 1 < ny;
    const T* s0 = ss(x) + o;
    const T* s1 = ss(x + 1) + o;
    // every read is made whether or not the neighbour lies on the grid
    // (all stay inside the rings), so that none waits on a branch
    return offdiag_terms2<T, NINE>([&](int dz, int dw, int d) -> T {
      const bool ok = (dz < 0 ? zl : dz > 0 ? zh : true) &&
                      (dw < 0 ? wl : dw > 0 ? wh : true);
      const T sv = (dz > 0 ? s1 : s0)[d * rw + (dw > 0 ? WPo : 0)];
      const T* qr = q0 + (dz < 0 ? dn : dz > 0 ? up : 0);
      const T qv = qr[dw > 0 ? WPo : dw < 0 ? WMo : 0];
      return ok ? A::mul(sv, qv) : T(0);
    });
  };
  // b - A q at row x, column c (q as offd reads it)
  auto residual = [&](int x, int c, int w, const T* q0, long long up,
                      long long dn) -> T {
    const T* s0 = ss(x) + cpos(c);
    return A::sub(A::add(s0[BI * rw], offd(x, c, w, q0, up, dn)),
                  A::mul(s0[0], *q0));
  };
  auto ci_at = [&](int d, int k, int m) -> T { return cis(k)[d * cw + m - mc0]; };
  auto qc_at = [&](int k, int m) -> T { return qcs(k)[m - mc0]; };

  T acc = T(0);
#pragma unroll
  for (int u = 0; u < kAhead; ++u) issue(p0 + u);
  // A stage hands each point to the next stage in the same thread: stage
  // s + 1 at row x - 1 reads row x (5-point) only at its own column, which
  // stage s updated earlier in the same step; so 5-point stages need one
  // barrier a step, which also publishes the copies of row p and frees the
  // slots that step p + kAhead's copies overwrite.  9-point couplings reach
  // diagonally into the next row: each 9-point stage ends with a barrier.
  for (int p = p0; p < xe + SE; ++p) {
    wait_async<kAhead - 1>();
    if (!(kProbe & 8)) __syncthreads();
    issue(p + kAhead);

    {
      // stage 1: K3's expression, q_pre + (P qc (+ res/diag off the
      // coincident points)), with res = b - A q_pre from the q_pre ring; a
      // thread's two columns in turn, so that the points of a warp share a
      // parity class
      const int x = p - 1;
      if (valid(x, 1)) {
        const T* pw = ps(x);
        const long long up = ps(x + 1) - pw, dn = ps(x - 1) - pw;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 2 * t + j, w = w0 + c;
          if (c < 1 || c >= rw - 1 || w < 0 || w >= ny) continue;
          const T* q0 = pw + cpos(c);
          T v = interp_at<T>(ci_at, qc_at, x, w);
          if ((x | w) & 1)
            v = A::add(v, A::div(residual(x, c, w, q0, up, dn),
                                 ss(x)[cpos(c)]));
          qs(x)[cpos(c)] = A::add(*q0, v);
        }
      }
      if (NINE && !(kProbe & 8)) __syncthreads();
    }

    // the colour phases: q = (b + Σ coupling·q_nb) * (1/P) at the colour's
    // points; 5-point (x + w) % 2 == color, 9-point color = 2 cw + cz, rows
    // with x % 2 == cz, columns with w % 2 == cw
#pragma unroll
    for (int k = 0; k < phases_of(NINE); ++k) {
      const int s = 2 + k, x = p - s;
      const int color = (a.colors >> (4 * k)) & 15;
      if (valid(x, s) && (!NINE || ((x - color) & 1) == 0)) {
        const int cpar = NINE ? color >> 1 : color - x;
        const int c = 2 * t + ((cpar - w0) & 1), w = w0 + c;
        if (c >= s && c < rw - s && w >= 0 && w < ny) {
          T* q0 = qs(x) + cpos(c);
          const long long up = qs(x + 1) - qs(x), dn = qs(x - 1) - qs(x);
          const T* s0 = ss(x) + cpos(c);
          *q0 = A::mul(A::add(s0[BI * rw], offd(x, c, w, q0, up, dn)),
                       A::div(T(1), s0[0]));
        }
      }
      if (NINE && !(kProbe & 8)) __syncthreads();
    }

    {
      // row p - SP is final: its own columns to q_out
      const int x = p - SP;
      if (x >= zt && x < xe) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 2 * t + j, w = w0 + c;
          if (c >= H && c < H + tw && w < ny)
            q_out[(long long)x * ny + w] = qs(x)[cpos(c)];
        }
      }
    }

    if constexpr (EPI == kRes || EPI == kNorm) {
      // the residual of the block's own points of row p - SE
      const int x = p - SE;
      if (x >= zt && x < xe) {
        const long long up = qs(x + 1) - qs(x), dn = qs(x - 1) - qs(x);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 2 * t + j, w = w0 + c;
          if (c < H || c >= H + tw || w >= ny) continue;
          const T* q0 = qs(x) + cpos(c);
          const T rv = (kProbe & 16) ? *q0 : residual(x, c, w, q0, up, dn);
          if (EPI == kRes)
            res[(long long)x * ny + w] = rv;
          else
            acc = A::add(acc, A::mul(rv, rv));
        }
      }
    }
  }
  wait_async<0>();

  if constexpr (EPI == kNorm) {
    const T tot = block_sum_row<NT / 32>(acc);
    if (t == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
  }
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

// The plan of a K13 launch (ops/cuda_fused2.py `plan`): threads a block,
// rows a chunk, the grid (strips, chunks) and shared-memory bytes.
struct Plan2 {
  int nt, cz, gw, gc;
  long long smem;
};

template <typename T, bool NINE, int EPI>
int launch_ring2(const void* ci, const void* qc, const void* so,
                 const void* b, const void* q_in, void* q_out, void* res,
                 void* partials, int nx, int ny, int nxc, int nyc,
                 int colors, const Plan2& p, cudaStream_t st) {
  using R = Ring2<NINE, EPI>;
  constexpr int TW = 2 * R::NT - 2 * R::H;
  // the plan must be this variant's and cover the grid once
  if (p.nt != R::NT || p.smem != (long long)(R::WORDS * sizeof(T)) ||
      p.cz < 1 || p.gw != (ny + TW - 1) / TW || p.gc != (nx + p.cz - 1) / p.cz)
    return (int)cudaErrorInvalidValue;
  const RingDims2 d{nx, ny, nxc, nyc, p.cz, colors};
  auto fn = ring2<T, NINE, EPI>;
  // above 48 KB with block_sum_row's static array included
  if (p.smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<dim3(p.gw, p.gc), dim3(R::NT), p.smem, st>>>(
      (const T*)ci, (const T*)qc, (const T*)so, (const T*)b, (const T*)q_in,
      (T*)q_out, (T*)res, (T*)partials, d);
  return (int)cudaGetLastError();
}

// K13 with `nine` and epilogue `mode` on plan p (go true), or the
// shared-memory bytes of that variant (-1: none such)
template <typename T>
int interp_planned(bool go, const void* ci, const void* qc, const void* so,
                   const void* b, const void* q_in, void* q_out, void* res,
                   void* partials, int nx, int ny, int nxc, int nyc,
                   int nine, int colors, int mode, const Plan2& p,
                   cudaStream_t st) {
#define CEDAR_K13(NINE, EPI)                                                \
  if (!go) return (int)(Ring2<NINE, EPI>::WORDS * sizeof(T));              \
  return launch_ring2<T, NINE, EPI>(ci, qc, so, b, q_in, q_out, res,        \
                                    partials, nx, ny, nxc, nyc, colors, p, st)
  if (nine) {
    switch (mode) {
      case kNone: CEDAR_K13(true, kNone);
      case kRes: CEDAR_K13(true, kRes);
      case kNorm: CEDAR_K13(true, kNorm);
    }
  } else {
    switch (mode) {
      case kNone: CEDAR_K13(false, kNone);
      case kRes: CEDAR_K13(false, kRes);
      case kNorm: CEDAR_K13(false, kNorm);
    }
  }
#undef CEDAR_K13
  return go ? (int)cudaErrorInvalidValue : -1;
}

}  // namespace
}  // namespace cedar

extern "C" {

// The number of norm partials (of blocks) of K11 with the norm epilogue
// on an (nx, ny) grid (K13's: its plan's blocks).
int cedar_fused2_partials(int nine, int nx, int ny) {
  const dim3 g = cedar::tiles(cedar::sweep_halo(nine, true), nx, ny);
  return (int)(g.x * g.y);
}

// The threads a K13 block, and the steps between a K13 copy's issue and
// its first read.
int cedar_fused2_threads() { return cedar::kRingThreads; }
int cedar_fused2_ahead() { return cedar::kAhead; }

// The shared-memory bytes of the K13 kernel (nine, mode 0-2), or -1 if
// none is built: what ops/cuda_fused2.py `plan` computes.
int cedar_fused2_interp_smem(int dtype, int nine, int mode) {
  const cedar::Plan2 p{0, 0, 0, 0, 0};
  if (dtype == cedar::kFloat32)
    return cedar::interp_planned<float>(false, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nullptr,
                                        nullptr, 0, 0, 0, 0, nine, 0, mode,
                                        p, nullptr);
  if (dtype == cedar::kFloat64)
    return cedar::interp_planned<double>(false, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, nullptr, nullptr,
                                         nullptr, 0, 0, 0, 0, nine, 0, mode,
                                         p, nullptr);
  return -1;
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

// K13: q_out = one sweep of q_in + P qc + (b - A q_in) / diag; mode as
// K11; on the plan (nt, cz, gw, gc, smem) of ops/cuda_fused2.py `plan`.
// Returns a CUDA error code (0 on success).
int cedar_interp_sweep2(int dtype, const void* ci, const void* qc,
                        const void* so, const void* b, const void* q_in,
                        void* q_out, void* res, void* partials, int nx,
                        int ny, int nxc, int nyc, int nine, int colors,
                        int mode, int nt, int cz, int gw, int gc,
                        long long smem, void* stream) {
  const cedar::Plan2 p{nt, cz, gw, gc, smem};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::interp_planned<float>(true, ci, qc, so, b, q_in, q_out,
                                        res, partials, nx, ny, nxc, nyc,
                                        nine, colors, mode, p, st);
  if (dtype == cedar::kFloat64)
    return cedar::interp_planned<double>(true, ci, qc, so, b, q_in, q_out,
                                         res, partials, nx, ny, nxc, nyc,
                                         nine, colors, mode, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
