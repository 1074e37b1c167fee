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
// the arithmetic comes from stencil2.cuh (`offdiag_terms2`) and
// transfer2.cuh (`restrict_value`, `interp_at`), so each output equals the
// separate kernels K1, K2 and K3 in sequence bit for bit.
//
// What bounds them on the H100: bytes.  A sweep does about 1 flop per
// byte.  The dense sequence moves q through device memory once per colour
// phase and the residual once more; a fused kernel reads q once and writes
// it once, and reads the stencil planes, b, CI and qc once each.
//
// K11 is the tile design of tile2.cuh (shared with K1's streamed regime).
//
// K12 and K13, the row march (`ring2`), the 2D form of fused3.cu's
// `ring3`: a block owns a strip of 2 NT - 2H columns (a region of 2 NT
// columns with H columns of halo on each side) and a chunk of rows, and
// marches down its chunk (with H halo rows at each end) one row a step.
// K13: stage 1 (the recomputed residual of q_in plus the interpolation)
// runs on row p - 1 at step p, colour stage s on row p - s, the epilogue
// (the residual or the norm) on row p - SE; H = SE = 1 + P (+ 1 with the
// epilogue), P = 2 colour phases (5-point) or 4 (9-point).  K12: colour
// stage s on row p - s (its q rows are q_in's, copied in), the residual on
// row p - SE (SE = P + 1) over the strip and one column more on its low
// side, into a ring of four rows in shared memory (and to res on request),
// and the restriction of the strip's coarse points of coarse row k at the
// step after fine rows 2k - 1 .. 2k + 1 hold their residuals (row p - SE -
// 2 at step p), as K15 does; its restriction reads fine row and column 2k -
// 1, so H = SE + 1.  The rows between stages are exact for the reason
// fused3.cu's header note gives.  Rows of q_in (K13: q_pre), b and the
// stencil planes arrive in shared-memory rings by cp.async (async.cuh)
// kAhead steps before the step that first reads them, CI (and K13's qc) by
// coarse row (K13: a CI row serves fine rows 2k - 1 and 2k, a qc row 2k - 1
// .. 2k + 1; K12: CI rows k and k + 1 serve coarse row k), one commit group
// a step; K13's swept q lives in a ring of its own.  Thread t takes region
// columns 2t and 2t + 1 in every stage (a colour stage the one of its
// colour), so that a 5-point stage reads the row the stage before updated
// only at its own columns: one barrier a step publishes the step's copies
// (and K12's residual rows) and frees the slots the next copies overwrite;
// 9-point couplings reach diagonally into the next row, so each 9-point
// stage ends with a barrier.  Rows are colour-compact (a row's even
// columns, then its odd ones), so that a stage's stride-2 reads, and the
// restriction's, are conflict-free.  A block has NT = 128 threads; the
// chunk and the grid come from the wrapper's plan (ops/cuda_fused2.py
// `plan`: the chunk that runs the grid in whole waves of resident blocks),
// checked at launch against `Ring2`.
//
// Out of place: a block reads q_in over its region and halo while other
// blocks write their own points.  Updated in place, a block could read a
// neighbour's updated interior as its halo, a race that is wrong only
// sometimes.  So each kernel reads q_in and writes a separate q_out (the
// wrappers in ops/cuda_fused2.py allocate it).
//
// K12's strips and chunks start at even fine indices (its plan's chunks
// are even), so each coarse point (2k, 2m) has exactly one owner block.
// The norm epilogue writes one partial a block (the sum of res² over the
// block's own points, in no fixed order against the plain version's sum)
// into a buffer of cedar_fused2_partials entries (K13: its plan's blocks);
// the caller sums the buffer.

#include "async.cuh"
#include "tile2.cuh"
#include "transfer2.cuh"

namespace cedar {
namespace {

// ---------------------------------------------------------------------------
// K12 and K13: the row march (see the header note).

// K12's epilogue: the residual into its ring, then the restriction
constexpr int kRestrict = 3;

// Build settings of tools/tune_fused2.py only: the parts of `ring2` that a
// timing probe skips (bit 0: the q_in / q_pre row copies, 1: the CI and qc
// copies, 2: the stencil and b copies, 3: the barriers, 4: the residual of
// the epilogue (K13's norm, K12's), 5: K12's restriction sum); 0 in every
// other build.
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
// an SM's shared memory, of which each resident block takes 1 KB more
// than its own (ops/cuda_build.py SM_SMEM)
constexpr size_t kSmSmem = 233472;

// The layout of a K12 (EPI kRestrict) or K13 (EPI kNone / kRes / kNorm)
// block of NT threads (a strip of 2 NT region columns);
// ops/cuda_fused2.py `ring_words` mirrors it and the launch checks the
// plan against it.  Rings of region rows: q (K13: the swept q, rows p - SE
// - 1 .. p - 1; K12: q_in copied in, rows p - SE - 1 .. p + kAhead),
// K13's q_pre (p - 2 .. p + kAhead + 1), the stencil planes and b (p - SE
// .. p + kAhead), K12's residual (p - SE - 3 .. p - SE); then coarse rows
// of the 8 CI weights (K13: two, and three of qc, over the region's nt + 2
// coarse columns; K12: three, over the strip's nt - H + 1).
template <bool NINE, int EPI>
struct Ring2 {
  static constexpr bool K12 = EPI == kRestrict;
  static constexpr int SP = !K12 + phases_of(NINE);  // the last colour stage
  static constexpr int SE = SP + (EPI != kNone);     // the residual's stage
  static constexpr int H = SE + K12;
  static constexpr int WQ = K12 ? SE + 2 + kAhead : SE + 1;
  static constexpr int WP = K12 ? 0 : 3 + kAhead;
  static constexpr int WS = SE + 1 + kAhead;
  static constexpr int WR = K12 ? 4 : 0;
  static constexpr int NSB = (NINE ? 5 : 3) + 1;  // stencil planes and b
  static constexpr int NT = kRingThreads, CW = NT + 2;
  // K12's CI rows: a copy lands in the slot that the restriction of two
  // coarse rows before read (kAhead <= 2 steps before its own)
  static constexpr int NCI = K12 ? 3 : 2;
  static constexpr int NC = 8 * NCI + (K12 ? 0 : 3);
  static constexpr size_t WORDS =
      (size_t)2 * NT * (WQ + WP + WS * NSB + WR) + (size_t)NC * CW;
  // blocks an SM that the plan counts on (ops/cuda_fused2.py `plan`):
  // as many as the shared memory takes, within the SM's threads; the
  // kernel's registers must leave room for them (chip_smoke.py checks)
  template <typename T>
  static constexpr int per_sm() {
    const size_t n = kSmSmem / (WORDS * sizeof(T) + 1024);
    const int most = 2048 / NT < 32 ? 2048 / NT : 32;
    return n < (size_t)most ? (int)n : most;
  }
  // the registers a thread that leave room for per_sm blocks of NT
  // threads, in the allocation unit of 8
  template <typename T>
  static constexpr int max_regs() {
    const int r = 65536 / (per_sm<T>() * NT) / 8 * 8;
    return r < 255 ? r : 255;
  }
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
  int nx, ny, nxc, nyc, cz, colors, emit_res;
};

// K12 (EPI kRestrict): one multicolour sweep of q_in into q_out, its
// residual (to res when a.emit_res) and cb = Pᵀ res into out.  K13 (EPI
// kNone / kRes / kNorm): q = q_in + P qc + res/diag (res = b - A q_in,
// recomputed), then one multicolour sweep into q_out (+ res, or the norm
// partials into out).  On a strip of region columns and a chunk of rows;
// thread t takes region columns 2t and 2t + 1 in every stage (a colour
// stage: the one of its colour).
//
// Every variant holds its registers to what the plan's blocks an SM leave
// (left free, a float32 5-point K13 took 103 to 117 registers, room for 4
// blocks where the plan counts on 5, and ran its grid in two waves).  A
// cap by __maxnreg__ was faster than one by __launch_bounds__' blocks an
// SM, which took the float32 5-point variants down to 53-56 registers
// (PERF.md §6).
template <typename T, bool NINE, int EPI>
__global__ void __maxnreg__((Ring2<NINE, EPI>::template max_regs<T>()))
ring2(const T* __restrict__ ci_p, const T* __restrict__ qc_p,
      const T* __restrict__ so, const T* __restrict__ b,
      const T* __restrict__ q_in, T* __restrict__ q_out, T* __restrict__ res,
      T* __restrict__ out, const RingDims2 a) {
  using A = Arith<T>;
  using R = Ring2<NINE, EPI>;
  constexpr bool K12 = R::K12;
  constexpr int SP = R::SP, SE = R::SE, H = R::H, NSB = R::NSB;
  constexpr int BI = NSB - 1;  // b's array in a stencil slot
  constexpr int NT = R::NT, nt = NT, rw = 2 * NT, tw = rw - 2 * H;
  constexpr int cw = R::CW;
  // the coarse columns a CI row copy covers: K13 the region's, K12 the
  // strip's own and one more
  constexpr int ncc = K12 ? tw / 2 + 1 : cw;
  const int nx = a.nx, ny = a.ny;
  const long long P = (long long)nx * ny;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  auto qs = [&](int x) { return sm + ((x + 8 * R::WQ) % R::WQ) * rw; };
  T* const pbase = sm + R::WQ * rw;
  constexpr int WP = R::WP > 0 ? R::WP : 1;
  auto ps = [&](int x) { return pbase + ((x + 8 * WP) % WP) * rw; };
  T* const sbase = pbase + R::WP * rw;
  auto ss = [&](int x) {
    return sbase + ((x + 8 * R::WS) % R::WS) * NSB * rw;
  };
  T* const rbase = sbase + R::WS * NSB * rw;
  auto rs = [&](int x) { return rbase + ((x + 8 * 4) % 4) * rw; };
  T* const cbase = rbase + R::WR * rw;
  auto cis = [&](int k) { return cbase + (k % R::NCI) * 8 * cw; };
  auto qcs = [&](int k) { return cbase + 16 * cw + (k % 3) * cw; };

  const int t = threadIdx.x;
  const int wt = blockIdx.x * tw, zt = blockIdx.y * a.cz;
  const int w0 = wt - H;  // the strip's first region column
  const int mc0 = K12 ? wt >> 1 : w0 >> 1;  // the first coarse column copied
  const int xe = min(zt + a.cz, nx);        // own rows [zt, xe)
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
  // coarse row k of CI (8 weights) and of qc over the copied coarse
  // columns, zero off the arrays
  auto copy_ci = [&](int k) {
    T* d = cis(k);
    for (int e = t; e < 8 * ncc; e += nt) {
      const int dd = e / ncc, m = mc0 + e % ncc;
      const bool in = k >= 0 && k <= a.nxc && m >= 0 && m <= a.nyc;
      copy_async(d + dd * cw + e % ncc,
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
  const int x1 = max(zt - H + 1, 0);  // K13's first stage-1 row
  // every copy that step u reads first, as one commit group
  auto issue = [&](int u) {
    if (u < load_end) {
      if (!(kProbe & 1)) copy_row(K12 ? qs(u) : ps(u), q_in, u);
      if (!(kProbe & 4)) {
        T* d = ss(u);
#pragma unroll
        for (int s = 0; s < NSB - 1; ++s) copy_row(d + s * rw, so + s * P, u);
        copy_row(d + BI * rw, b, u);
      }
    }
    if constexpr (K12) {
      // the restriction at step u, of fine row xr = u - SE - 2, reads CI
      // rows xr / 2 and xr / 2 + 1
      const int xr = u - SE - 2;
      if (!(kProbe & 2) && xr >= zt && xr < xe && !(xr & 1)) {
        if (xr == zt) copy_ci(xr >> 1);
        copy_ci((xr >> 1) + 1);
      }
    } else {
      // stage 1 at row x = u - 1 reads CI row (x + 1) >> 1 and qc rows
      // x >> 1 and (x + 1) >> 1
      const int x = u - 1;
      if (!(kProbe & 2) && valid(x, 1) && (x == x1 || (x & 1))) {
        copy_ci((x + 1) >> 1);
        if (x == x1) copy_qc(x >> 1);
        if (x & 1) copy_qc((x + 1) >> 1);
      }
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
  auto ci_at = [&](int d, int k, int m) -> T {
    return cis(k)[d * cw + m - mc0];
  };
  auto qc_at = [&](int k, int m) -> T { return qcs(k)[m - mc0]; };

  T acc = T(0);
#pragma unroll
  for (int u = 0; u < kAhead; ++u) issue(p0 + u);
  // A stage hands each point to the next stage in the same thread: stage
  // s + 1 at row x - 1 reads row x (5-point) only at its own column, which
  // stage s updated earlier in the same step; so 5-point stages need one
  // barrier a step, which also publishes the copies of row p (and K12's
  // residual rows) and frees the slots that step p + kAhead's copies
  // overwrite.  9-point couplings reach diagonally into the next row: each
  // 9-point stage ends with a barrier.  K12 restricts fine row p - SE - 2
  // at step p: two steps more.
  for (int p = p0; p < xe + SE + (K12 ? 2 : 0); ++p) {
    wait_async<kAhead - 1>();
    if (!(kProbe & 8)) __syncthreads();
    issue(p + kAhead);

    if constexpr (!K12) {
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
      const int s = !K12 + 1 + k, x = p - s;
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

    if constexpr (K12) {
      {
        // the residual of row p - SE over the strip and the column below
        // it into the residual ring (the restriction reads fine row and
        // column 2k - 1), and to res at the block's own points on request
        const int x = p - SE;
        if (x >= max(zt - 1, 0) && x < xe) {
          const long long up = qs(x + 1) - qs(x), dn = qs(x - 1) - qs(x);
          T* dst = rs(x);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 2 * t + j, w = w0 + c;
            if (c < H - 1 || c >= H + tw || w < 0 || w >= ny) continue;
            const T* q0 = qs(x) + cpos(c);
            const T rv = (kProbe & 16) ? *q0 : residual(x, c, w, q0, up, dn);
            dst[cpos(c)] = rv;
            if (a.emit_res && x >= zt && c >= H)
              res[(long long)x * ny + w] = rv;
          }
        }
      }
      // cb at the coarse points of fine row xr = p - SE - 2 that the block
      // owns (an even row of the chunk; thread t the strip's t-th coarse
      // column): its residual rows xr - 1 .. xr + 1 were written in the
      // steps before, so the step's barrier covers them
      const int xr = p - SE - 2;
      if (xr >= zt && xr < xe && !(xr & 1)) {
        const int k = xr >> 1, m = (wt >> 1) + t;
        if (t < tw / 2 && k < a.nxc && m < a.nyc) {
          auto fine = [&](int z, int w) -> T {
            return (z >= 0 && z < nx && w >= 0 && w < ny)
                       ? rs(z)[cpos(w - w0)]
                       : T(0);
          };
          out[(long long)k * a.nyc + m] =
              (kProbe & 32) ? fine(xr, 2 * m)
                            : restrict_value(ci_at, fine, k, m);
        }
      }
    }
  }
  wait_async<0>();

  if constexpr (EPI == kNorm) {
    const T tot = block_sum_row<NT / 32>(acc);
    if (t == 0) out[blockIdx.y * gridDim.x + blockIdx.x] = tot;
  }
}

// The plan of a K12 or K13 launch (ops/cuda_fused2.py `plan`): threads a
// block, rows a chunk, the grid (strips, chunks) and shared-memory bytes.
struct Plan2 {
  int nt, cz, gw, gc;
  long long smem;
};

// What ring_planned does: launch, or report the variant's shared-memory
// bytes or the blocks of it that an SM holds.
enum Query { kLaunch, kSmem, kOccupancy };

// Blocks of the variant an SM holds with its shared memory, registers and
// threads (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative
// CUDA error.
template <typename T, bool NINE, int EPI>
int occupancy2() {
  using R = Ring2<NINE, EPI>;
  auto fn = ring2<T, NINE, EPI>;
  const int smem = (int)(R::WORDS * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, R::NT, smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, bool NINE, int EPI>
int launch_ring2(const void* ci, const void* qc, const void* so,
                 const void* b, const void* q_in, void* q_out, void* res,
                 void* out, const RingDims2& d, const Plan2& p,
                 cudaStream_t st) {
  using R = Ring2<NINE, EPI>;
  constexpr int TW = 2 * R::NT - 2 * R::H;
  // the plan must be this variant's and cover the grid once; K12's chunks
  // start at even rows
  if (p.nt != R::NT || p.smem != (long long)(R::WORDS * sizeof(T)) ||
      p.cz < 1 || (R::K12 && (p.cz & 1)) || d.cz != p.cz ||
      p.gw != (d.ny + TW - 1) / TW || p.gc != (d.nx + p.cz - 1) / p.cz)
    return (int)cudaErrorInvalidValue;
  auto fn = ring2<T, NINE, EPI>;
  // above 48 KB with block_sum_row's static array included
  if (p.smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<dim3(p.gw, p.gc), dim3(R::NT), p.smem, st>>>(
      (const T*)ci, (const T*)qc, (const T*)so, (const T*)b, (const T*)q_in,
      (T*)q_out, (T*)res, (T*)out, d);
  return (int)cudaGetLastError();
}

// K12 (mode kRestrict) or K13 (mode kNone / kRes / kNorm) with `nine`:
// launched on plan p, or its shared-memory bytes or occupancy (query q; -1:
// no such variant)
template <typename T>
int ring_planned(Query q, const void* ci, const void* qc, const void* so,
                 const void* b, const void* q_in, void* q_out, void* res,
                 void* out, const RingDims2& d, int nine, int mode,
                 const Plan2& p, cudaStream_t st) {
#define CEDAR_RING2(NINE, EPI)                                              \
  if (q == kSmem) return (int)(Ring2<NINE, EPI>::WORDS * sizeof(T));       \
  if (q == kOccupancy) return occupancy2<T, NINE, EPI>();                   \
  return launch_ring2<T, NINE, EPI>(ci, qc, so, b, q_in, q_out, res, out,   \
                                    d, p, st)
  if (nine) {
    switch (mode) {
      case kNone: CEDAR_RING2(true, kNone);
      case kRes: CEDAR_RING2(true, kRes);
      case kNorm: CEDAR_RING2(true, kNorm);
      case kRestrict: CEDAR_RING2(true, kRestrict);
    }
  } else {
    switch (mode) {
      case kNone: CEDAR_RING2(false, kNone);
      case kRes: CEDAR_RING2(false, kRes);
      case kNorm: CEDAR_RING2(false, kNorm);
      case kRestrict: CEDAR_RING2(false, kRestrict);
    }
  }
#undef CEDAR_RING2
  return q == kLaunch ? (int)cudaErrorInvalidValue : -1;
}

template <typename... Args>
int ring_dtype(int dtype, Query q, Args... args) {
  if (dtype == kFloat32) return ring_planned<float>(q, args...);
  if (dtype == kFloat64) return ring_planned<double>(q, args...);
  return q == kLaunch ? (int)cudaErrorInvalidValue : -1;
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

// The threads a K12 / K13 block, and the steps between a copy's issue and
// its first read.
int cedar_fused2_threads() { return cedar::kRingThreads; }
int cedar_fused2_ahead() { return cedar::kAhead; }

// The shared-memory bytes of the K12 (mode 3) or K13 (nine, mode 0-2)
// kernel, or -1 if none is built: what ops/cuda_fused2.py `plan` computes;
// with occupancy 1, the blocks of it that an SM holds (a negative CUDA
// error on failure), which the plan's blocks an SM must not exceed.
int cedar_fused2_smem(int dtype, int nine, int mode, int occupancy) {
  const cedar::Plan2 p{0, 0, 0, 0, 0};
  const cedar::RingDims2 d{0, 0, 0, 0, 0, 0, 0};
  return cedar::ring_dtype(
      dtype, occupancy ? cedar::kOccupancy : cedar::kSmem, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, d, nine, mode, p,
      (cudaStream_t) nullptr);
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
                                      1, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_sweep<double>(so, q_in, b, q_out, res, partials, nx,
                                       ny, nine, colors, ncolors, oz, ow, mode,
                                       1, st);
  return (int)cudaErrorInvalidValue;
}

// K12: q_out = one sweep of q_in, res = b - A q_out (written when
// emit_res), cb (nxc, nyc) = Pᵀ res; on the plan (nt, cz, gw, gc, smem) of
// ops/cuda_fused2.py `plan`.  Returns a CUDA error code (0 on success).
int cedar_sweep_restrict2(int dtype, const void* so, const void* q_in,
                          const void* b, const void* ci, void* q_out,
                          void* res, void* cb, int nx, int ny, int nxc,
                          int nyc, int nine, int colors, int emit_res, int nt,
                          int cz, int gw, int gc, long long smem,
                          void* stream) {
  const cedar::Plan2 p{nt, cz, gw, gc, smem};
  const cedar::RingDims2 d{nx, ny, nxc, nyc, cz, colors, emit_res};
  return cedar::ring_dtype(dtype, cedar::kLaunch, ci, nullptr, so, b, q_in,
                           q_out, res, cb, d, nine, cedar::kRestrict, p,
                           (cudaStream_t)stream);
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
  const cedar::RingDims2 d{nx, ny, nxc, nyc, cz, colors, 0};
  return cedar::ring_dtype(dtype, cedar::kLaunch, ci, qc, so, b, q_in, q_out,
                           res, partials, d, nine, mode, p,
                           (cudaStream_t)stream);
}

}  // extern "C"
