// K14 (fused sweep), K15 (sweep + residual + restriction) and K16
// (interp-add + sweep): the fused fine-level kernels of the 3D V-cycle.
//
// K14 replaces the Pallas kernels cedar_tpu/ops/pallas3_split.py
// `_sweep_kernel3` (`_sweep_call3`, `point_relax_split3`) and its
// wavefront schedule pallas3_stream.py `_stream_kernel3` /
// `_stream_kernel3_panel` (`_stream_call3`, `point_relax_stream3`): all
// colour phases of one multicolour sweep, then optionally the residual
// b - A q or the per-block partial sums of res² that the solve loop's
// convergence norm adds up.  K15 replaces `_sweep_restrict_kernel3`
// (`sweep_restrict_split3`; with K14 it also covers the wavefront
// `sweep_restrict_stream3`): the last pre-sweep, its residual and the
// coarse rhs cb = Pᵀ res in one pass; the residual is written only on
// request.  K16 replaces `_interp_sweep_kernel3` (`interp_sweep_split3`)
// and the 7-point wavefront `_stream_kernel3_interp` /
// `_stream_kernel3_panel_interp` (`interp_sweep_stream3`): the residual of
// the pre-smoothed iterate recomputed on chip, q + res/diag + P qc, then
// the first post-sweep (+ the residual or the partial sums).  The Pallas
// kernels work on the octant-split layout that Mosaic needs; these work on
// the dense (nx, ny, nz) grid and compute what those compute.  Here: the
// 7-point K14, K15 and K16 (`ring3`) and the 27-point K14's marches
// (`pass27`).  A 27-point K15 or K16 is a sweep on K6's route (sweep3.cu,
// or these marches) with the edge kernel (edge3.cu) after or before it,
// composed by ops/cuda_fused3.py.  K6's levels above one block (sweep3.cu)
// run on K14 too: the 7-point ring march and, for float32 levels of 96³ or
// more, the 27-point marches.  The math is
// ops/fused3.py's plain versions, which compose relax3.sweep3_torch,
// stencil3.residual, interp3.restrict_torch and interp3.interp_add_torch;
// the arithmetic comes from stencil3.cuh (`offdiag_terms`) and
// transfer3.cuh (`restrict_value`, `interp_with`), so each output equals
// the separate kernels K6, K7 and K8 in sequence bit for bit.
//
// What bounds them on the H100: bytes, at ~0.5 flop a byte; what they
// lose to is latency (PERF.md §6: the time of each part, measured by
// skipping it).
//
// The 27-point K14 (`pass27`) runs a sweep's colours, a launch a march of
// up to kStages27 colours (cedar_fused3_pass27_stages): a block owns a y-z
// tile and an x chunk and marches along x one plane a step; colour stage s
// updates plane p - s at step p (one in-place copy of each plane serves
// every stage: no point couples to its own colour), each stage staling one
// ring of halo, so the region carries a halo of as many rings and planes as
// stages; a ring of q planes is filled by cp.async two steps ahead.  The
// wrapper gives a march an aligned pair of positions of the colour order
// (one y and z parity), so that its colours read the same stencil rows.
// The colours of a march alternate in x parity, so a colour stage works on
// every other step; on a step where it works, each thread
// updates one point of the stage's colour, whose 27 stencil values and b
// it gathered by cp.async into slots of its own on the stage's previous
// working step (float32 with at most 4 stages; otherwise they are read from
// device memory), so that no stage waits on device memory.  A step has one
// barrier, and one more after each colour stage that works.  A warp takes a
// pair of region rows; the tile rows, the x chunk and the grid come from
// the wrapper's plan (ops/cuda_fused3.py `pass27_plan`), checked at launch
// against `Pass27`.  No epilogue rides in a march (it would add a ring of
// halo and registers that spill): a 27-point sweep whose residual or norm
// is asked for is followed by a launch of its own (ops/cuda3.py).
//
// The ring design (`ring3`): the 7-point K14, K15 and K16 read every plane
// a stage needs from rings of slots in shared memory, filled by cp.async
// (async.cuh: 4- or 8-byte elements, zero-filled off the grid) one step
// before the step that first reads them, one commit group a step: q (K16:
// q_pre), b and, in f32, the stencil planes 0-3, and K15's CI at its own
// coarse points (two coarse planes: each serves two fine steps); no register
// holds a prefetched plane.  K16's CI weights and coarse values, and the f64
// stencil, are read from device memory, asked into L2 one step ahead
// (through the ring they cost more than they saved).  One barrier a step,
// after the wait for the step's own copies, publishes them and frees the
// slots that the step's copies overwrite; K15 restricts plane p - SE - 2 at
// step p, so that its residual window (four planes) needs no barrier of its
// own and the restriction overlaps the other warps' stages.  A block has a
// warp for each region row, which keeps its points through every stage; rows
// are colour-compact (a row's even columns, then its odd ones), so that a
// colour phase's reads are conflict-free and, with the column parity a
// constant, each read is a constant offset from the point's pointers.  The
// tile rows, the x chunk and the grid come from the wrapper's plan
// (ops/cuda_fused3.py `plan`, checked at launch against `Ring`): the largest
// built tile rows that fit a block (K15, K16: 12 or 10 in f32, 4 or 2 in
// f64, one block an SM; the 7-point K14, the colour stages and a residual or
// norm epilogue only, is built with 20 in f32 and 8 in f64), and the chunk
// that runs the grid in the fewest steps a block slot.  The 7-point K14 took 0.30 ms a 256³
// sweep where the earlier window design took 0.37 (PERF.md §6).
//
// Out of place: a block reads q_in over its region while other blocks
// write their tiles, so each kernel reads q_in and writes a separate
// q_out (the wrappers in ops/cuda_fused3.py allocate it).  K15's tiles and
// chunks start at even indices, so each coarse point (2i, 2j, 2k) has
// exactly one owner block; its residual window covers the tile plus the
// low ring (the restriction reads fine indices 2c - 1 .. 2c + 1).  The
// norm epilogue writes one partial a block (the sum of res² over the
// block's own points, in no fixed order against the plain version's sum):
// the plan's blocks for the 7-point K14 and K16; the caller sums them.
// K14-K16 launch on the wrapper's plan, which the launch checks against the
// kernel's own.

#include "async.cuh"
#include "stencil3.cuh"
#include "transfer3.cuh"

namespace cedar {
namespace {

constexpr int kRW = 64;                  // region columns (z)
// epilogues: nothing, the residual, the norm partials, residual + restrict
constexpr int kNone = 0, kRes = 1, kNorm = 2, kRestrict = 3;
// colour phases of a 7-point pass (both of a sweep), the stage of the
// last phase, of the residual epilogue, and their number: the halo H in
// rings and planes
constexpr int kPhases = 2;
__host__ __device__ constexpr int last_phase(bool interp) {
  return interp + kPhases;
}
__host__ __device__ constexpr int epi_stage(bool interp, int epi) {
  return last_phase(interp) + (epi != kNone);
}
__host__ __device__ constexpr int halo(bool interp, int epi) {
  return epi_stage(interp, epi) + (epi == kRestrict);
}

struct Args {
  const void *so, *q_in, *b, *ci, *qc;
  void *q_out, *res, *cb, *partials;
  int nx, ny, nz, nxc, nyc, nzc, colors, ox, oy, oz, emit_res;
};

// the integer arguments of a launch (the pointers go as __restrict__
// kernel parameters, so that the read-only ones take the read-only path)
struct Dims {
  int nx, ny, nz, nxc, nyc, nzc, cx, colors, ox, oy, oz, emit_res;
};

// The sum of v over the block of NW warps, returned to thread 0.
template <int NW, typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[NW];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int t = threadIdx.y * 32 + threadIdx.x;
  if ((t & 31) == 0) warp_sums[t >> 5] = v;
  __syncthreads();
  T tot = T(0);
  if (t == 0)
    for (int k = 0; k < NW; ++k) tot += warp_sums[k];
  return tot;
}

// The plan of a K15 or K16 launch (ops/cuda_fused3.py `plan`): tile rows,
// x chunk, grid and shared-memory bytes.
struct KPlan {
  int ty, cx, gz, gy, gc;
  long long smem;
};

// ---------------------------------------------------------------------------
// 7-point K15 and K16: the ring design (see the header note).

constexpr int kAhead = 1;  // steps between a copy's issue and its first read
// The 7-point K14 caps its registers as for two blocks an SM: 2-3% faster
// than one at 256³ (39 registers against 46 on its 20 tile rows; copies two
// steps ahead bought nothing; PERF.md §6)
constexpr int kMinBlocks14 = 2;
// the tile rows built, float32 and float64: K15 and K16 two each, of which
// the plan takes one; the 7-point K14 one each (20 rows beat 12 in float32,
// PERF.md §6; tools/tune_fused3.py builds others with -DCEDAR_K14_ROWS)
constexpr int kRingRows[2][2] = {{12, 10}, {4, 2}};
#ifndef CEDAR_K14_ROWS
#define CEDAR_K14_ROWS 20
#endif
constexpr int kRingRows14[2] = {CEDAR_K14_ROWS, 8};
constexpr size_t rnd4(size_t w) { return (w + 3) & ~size_t(3); }

// The compile-time layout of a 7-point K14 (INTERP false, EPI kNone /
// kRes / kNorm), K15 (INTERP false, EPI kRestrict) or K16 (INTERP true, EPI
// kNone / kRes / kNorm) variant with tiles of TY rows; ops/cuda_fused3.py
// `ring_words` mirrors WORDS and the launch checks that the two agree.
template <typename T, bool INTERP, int EPI, int TY>
struct Ring {
  // the stencil's planes 0-3 go through the ring too (float32)
  static constexpr bool ST = sizeof(T) == 4;
  // K14: registers capped for MINB blocks an SM
  static constexpr bool K14 = !INTERP && EPI != kRestrict;
  static constexpr int AH = kAhead;
  static constexpr int MINB = K14 ? kMinBlocks14 : 1;
  static constexpr int SP = last_phase(INTERP);
  static constexpr int SE = epi_stage(INTERP, EPI);
  static constexpr int H = halo(INTERP, EPI);
  static constexpr int RY = TY + 2 * H, TZ = kRW - 2 * H, PL = RY * kRW;
  // slots with AH planes in flight: q (K14, K15: loaded, stage s reading
  // back to plane p - SE - 1; K16: the interpolated q, written), K16's
  // q_pre, b (+ stencil)
  static constexpr int WQ = INTERP ? SE + 1 : SE + 2 + AH;
  static constexpr int WP = INTERP ? 3 + AH : 0;
  static constexpr int WS = SE + 1 + AH;
  static constexpr int NSB = ST ? 5 : 1;  // arrays a b slot
  // K15: the CI of the block's coarse points and the next ones (two coarse
  // planes), the residual window (tile and low ring, four planes)
  static constexpr int CY = TY / 2 + 1, CZ = TZ / 2 + 1, CIP = 26 * CY * CZ;
  static constexpr int RWR = TZ + 1, RPL = (TY + 1) * RWR;
  static constexpr size_t OP = rnd4((size_t)WQ * PL);
  static constexpr size_t OS = OP + rnd4((size_t)WP * PL);
  static constexpr size_t OC = OS + rnd4((size_t)WS * NSB * PL);
  static constexpr bool RS = EPI == kRestrict;
  static constexpr size_t OR = OC + (RS ? rnd4(2 * (size_t)CIP) : 0);
  static constexpr size_t WORDS = OR + (RS ? 4 * (size_t)RPL : 0);
  static constexpr size_t BYTES = WORDS * sizeof(T);
  static constexpr int NW = RY;  // a warp a region row
};

// Build settings of tools/tune_fused3.py only: the parts of ring3 and
// pass27 that a timing probe skips (bit 0: the coarse side's copies or L2
// prefetch, 1: the b and stencil copies, 2: the colour phases, 3: the
// barriers; pass27: 4 the stencil gathers, 5 the colour stages); 0 in every
// other build.
#ifndef CEDAR_FUSED3_PROBE
#define CEDAR_FUSED3_PROBE 0
#endif
constexpr int kProbe = CEDAR_FUSED3_PROBE;

struct RingDims {
  int nx, ny, nz, nxc, nyc, nzc, cx, colors, ox, oy, oz, emit_res;
};

// colour-compact position of region column c: a row holds its even
// columns, then its odd ones, so that the points of one colour phase,
// and their z neighbours, are consecutive words
__device__ __forceinline__ int cpos(int c) { return ((c & 1) << 5) | (c >> 1); }

// 7-point K14 (INTERP false, EPI kNone / kRes / kNorm; q_in is q), K15
// (INTERP false, EPI kRestrict) or K16 (INTERP true, EPI kNone / kRes /
// kNorm; q_in is q_pre) on a y-z tile and an x chunk: warp w takes region
// row w, lane l columns 2l and 2l + 1, in every stage (a colour phase: the
// one of its colour).  Colours anchor at (x + ox, y + oy, z + oz): K15 and
// K16 take a zero origin.
template <typename T, bool INTERP, int EPI, int TY>
__global__ void __launch_bounds__(32 * Ring<T, INTERP, EPI, TY>::NW,
                                  Ring<T, INTERP, EPI, TY>::MINB)
ring3(const T* __restrict__ so, const T* __restrict__ q_in,
      const T* __restrict__ b, const T* __restrict__ ci_p,
      const T* __restrict__ qc_p, T* __restrict__ q_out, T* __restrict__ res,
      T* __restrict__ cb, T* __restrict__ partials, const RingDims a) {
  using A = Arith<T>;
  using R = Ring<T, INTERP, EPI, TY>;
  constexpr bool ST = R::ST;
  constexpr int SP = R::SP, SE = R::SE, H = R::H;
  constexpr int RY = R::RY, TZ = R::TZ, PL = R::PL, NW = R::NW;
  constexpr int NT = 32 * NW;
  constexpr int NSB = R::NSB, BI = ST ? 4 : 0;  // b's array in a slot
  constexpr int CY = R::CY, CZ = R::CZ, RWR = R::RWR;

  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long sy = nz, sx = (long long)ny * nz, N = sx * nx;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  // the ring slot of plane x (x >= -8)
  auto qs = [&](int x) { return sm + ((x + 8 * R::WQ) % R::WQ) * PL; };
  constexpr int WP = R::WP > 0 ? R::WP : 1;
  auto ps = [&](int x) { return sm + R::OP + ((x + 8 * WP) % WP) * PL; };
  auto ss = [&](int x) {
    return sm + R::OS + ((x + 8 * R::WS) % R::WS) * NSB * PL;
  };
  auto cis = [&](int c) { return sm + R::OC + (c & 1) * R::CIP; };
  auto rs = [&](int x) { return sm + R::OR + ((x + 8 * 4) % 4) * R::RPL; };

  const int zt = blockIdx.x * TZ, yt = blockIdx.y * TY, xt = blockIdx.z * a.cx;
  const int z0 = zt - H, y0 = yt - H;  // the region's origin
  const int xe = min(xt + a.cx, nx);   // own planes [xt, xe)
  const int lane = threadIdx.x, r = threadIdx.y;  // r: the warp's row
  const int tid = r * 32 + lane;
  const int y = y0 + r;
  auto valid = [&](int x, int s) {
    return x >= max(xt - H + s, 0) && x < min(xt + a.cx + H - s, nx);
  };

  // --- the copies ---------------------------------------------------------
  // plane x of a grid array into a slot, zero off the grid: thread (r,
  // lane) copies columns lane and lane + 32 of row r
  int goff[2], soff[2];
  bool gin[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = lane + 32 * j, z = z0 + c;
    gin[j] = y >= 0 && y < ny && z >= 0 && z < nz;
    goff[j] = gin[j] ? y * nz + z : 0;
    soff[j] = r * kRW + cpos(c);
  }
  auto copy_plane = [&](T* dst, const T* src, int x) {
    const T* sp = src + x * sx;
#pragma unroll
    for (int j = 0; j < 2; ++j) copy_async(dst + soff[j], sp + goff[j], gin[j]);
  };
  // lines of 128 bytes into L2: the f64 stencil's planes at plane x, and
  // K16's coarse side
  constexpr int LINE = 128 / sizeof(T);
  auto prefetch_so = [&](int x) {
    constexpr int NLN = kRW / LINE;
    for (int e = tid; e < 4 * RY * NLN; e += NT) {
      const int d = e / (RY * NLN), rr = (e / NLN) % RY, k = e % NLN;
      const int yy = y0 + rr, z = max(z0 + k * LINE, 0);
      if (yy >= 0 && yy < ny && z < nz && z0 + (k + 1) * LINE > 0)
        prefetch_l2(so + d * N + x * sx + yy * sy + z);
    }
  };
  const long long cplane = (long long)(a.nxc + 1) * (a.nyc + 1) * (a.nzc + 1);
  const CI3<T> cig = make_ci(ci_p, a.nxc, a.nyc, a.nzc);
  // K16: the coarse rows and columns that the stage-1 points read
  constexpr int CRY = RY / 2 + 1, CRW = kRW / 2 + 1;
  constexpr int CNL = (CRW + LINE - 1) / LINE + 1;  // lines a coarse row
  const int cy0 = (y0 + 1) >> 1, cz0 = (z0 + 1) >> 1;
  auto prefetch_ci = [&](int c) {
    for (int e = tid; e < 26 * CRY * CNL; e += NT) {
      const int d = e / (CRY * CNL), j = cy0 + (e / CNL) % CRY;
      const int k = max(cz0 + (e % CNL) * LINE, 0);
      if (c <= a.nxc && j >= 0 && j <= a.nyc && k <= a.nzc && k < cz0 + CRW)
        prefetch_l2(ci_p + d * cplane +
                    ((long long)c * (a.nyc + 1) + j) * (a.nzc + 1) + k);
    }
  };
  auto prefetch_qc = [&](int c) {
    for (int e = tid; e < CRY * CNL; e += NT) {
      const int yc = cy0 + e / CNL, zc = max(cz0 + (e % CNL) * LINE, 0);
      if (c < a.nxc && yc >= 0 && yc < a.nyc && zc < a.nzc && zc < cz0 + CRW)
        prefetch_l2(qc_p + ((long long)c * a.nyc + yc) * a.nzc + zc);
    }
  };
  // K15: CI plane c at the block's coarse points and the next ones into
  // slot c % 2 ([26][CY][CZ]), zero off the array: a thread takes one
  // (row, column) through the directions
  const int yc0 = yt / 2, zc0 = zt / 2;
  auto copy_ci = [&](int c) {
    T* dst = cis(c);
    for (int e = tid; e < CY * CZ; e += NT) {
      const int j = yc0 + e / CZ, k = zc0 + e % CZ;
      const bool in = c <= a.nxc && j <= a.nyc && k <= a.nzc;
      const T* src =
          ci_p + (in ? ((long long)c * (a.nyc + 1) + j) * (a.nzc + 1) + k : 0);
#pragma unroll 2
      for (int d = 0; d < 26; ++d)
        copy_async(dst + d * CY * CZ + e, src + (in ? d * cplane : 0), in);
    }
  };

  const int p0 = max(xt - H, 0), load_end = min(xt + a.cx + H, nx);
  const int x1 = max(xt - H + 1, 0);  // K16's first stage-1 plane
  // every copy that step t reads first, as one commit group
  auto issue = [&](int t) {
    if (t < load_end) {
      copy_plane(INTERP ? ps(t) : qs(t), q_in, t);
      if (!(kProbe & 2)) {
        T* d = ss(t);
        copy_plane(d + BI * PL, b, t);
        if constexpr (ST) {
#pragma unroll
          for (int s = 0; s < 4; ++s) copy_plane(d + s * PL, so + s * N, t);
        } else {
          prefetch_so(t);
        }
      }
    }
    if constexpr (INTERP) {
      // stage 1 at plane x = t - 1 reads CI plane (x + 1) >> 1 and qc
      // planes x >> 1 and, at odd x, x / 2 + 1
      const int x = t - 1;
      if (!(kProbe & 1) && valid(x, 1) && (x == x1 || (x & 1))) {
        prefetch_ci((x + 1) >> 1);
        if (x == x1) prefetch_qc(x >> 1);
        if (x & 1) prefetch_qc((x >> 1) + 1);
      }
    } else if constexpr (EPI == kRestrict) {
      // the restriction at plane x = t - SE - 2 reads CI planes x / 2 and
      // x / 2 + 1: the one slot that the restriction two steps before
      // read is free by now
      const int x = t - SE - 2;
      if (!(kProbe & 1) && x >= xt && x < xe && (x & 1) == 0) {
        if (x == xt) copy_ci(x >> 1);
        copy_ci((x >> 1) + 1);
      }
    }
    commit_async();
  };

  // --- the stages ---------------------------------------------------------
  // A point (x, y, z), region column c, as the stages read it: the stencil
  // through s0 and s1 (planes x and x + 1 at the point), b, q through qm,
  // q0, qp (planes x - 1 .. x + 1 at the point), and which of its
  // neighbours lie on the grid.  A stage evaluates its points whether or
  // not they lie on the grid and stores only those that do, so that a
  // thread's points run as independent chains: y and z are clamped to the
  // grid here (the values of a clamped point are never stored).
  struct Pt {
    const T *s0, *s1, *bp, *qm, *q0, *qp;
    bool xl, xh, yl, yh, zl, zh;
  };
  const int ycl = min(max(y, 0), ny - 1);  // y clamped to the grid
  auto point = [&](int x, int z, int c, const T* qm, const T* q0,
                   const T* qp) {
    const int o = r * kRW + cpos(c);
    z = min(max(z, 0), nz - 1);
    Pt t;
    if constexpr (ST) {
      t.s0 = ss(x) + o;
      t.s1 = ss(x + 1) + o;
    } else {
      t.s0 = so + (x * sx + ycl * sy + z);
      t.s1 = t.s0 + sx;
    }
    t.bp = ss(x) + BI * PL + o;
    t.qm = qm + o;
    t.q0 = q0 + o;
    t.qp = qp + o;
    t.xl = x > 0, t.xh = x + 1 < nx, t.yl = ycl > 0, t.yh = ycl + 1 < ny;
    t.zl = z > 0, t.zh = z + 1 < nz;
    return t;
  };
  // Σ coupling · q over the neighbours (offdiag_terms' order).  In a
  // colour-compact row the z + 1 and z - 1 neighbours of a column of
  // parity pc lie ZP and ZM words away: with pc a literal every read is a
  // constant offset from the point's pointers.
  auto offd = [&](int pc, const Pt& t) -> T {
    const int ZP = pc ? -31 : 32, ZM = pc ? -32 : 31;
    return offdiag_terms<T, false>([&](int dx, int dy, int dz, int P) -> T {
      const bool ok = (dx < 0 ? t.xl : dx > 0 ? t.xh : true) &&
                      (dy < 0 ? t.yl : dy > 0 ? t.yh : true) &&
                      (dz < 0 ? t.zl : dz > 0 ? t.zh : true);
      if (!ok) return T(0);
      const T* qx = dx < 0 ? t.qm : dx > 0 ? t.qp : t.q0;
      const T* sp = dx > 0 ? t.s1 : t.s0;
      T sv;
      if constexpr (ST)
        sv = sp[P * PL + (dy > 0 ? kRW : 0) + (dz > 0 ? ZP : 0)];
      else
        sv = sp[P * N + (dy > 0 ? sy : 0) + (dz > 0 ? 1 : 0)];
      return A::mul(sv, qx[dy * kRW + (dz > 0 ? ZP : dz < 0 ? ZM : 0)]);
    });
  };
  // b - A q at the point
  auto residual = [&](int pc, const Pt& t) -> T {
    return A::sub(A::add(*t.bp, offd(pc, t)), A::mul(t.s0[0], *t.q0));
  };

  T acc = T(0);
  const bool yin = y >= 0 && y < ny;
  const bool own_row = r >= H && r < H + TY && y < ny;
#pragma unroll
  for (int t = 0; t < R::AH; ++t) issue(p0 + t);
  // A stage hands each point to the next stage in the same thread: stage
  // s + 1 at plane x - 1 reads plane x only at its own point, which stage
  // s updated earlier in the same step; so the stages need one barrier a
  // step, which also publishes the copies of plane p and frees the slots
  // that step p + AH's copies overwrite.  (K15 restricts plane p - SE - 2
  // at step p: one step more.)
  for (int p = p0; p < xe + H + R::RS; ++p) {
    wait_async<R::AH - 1>();
    if (!(kProbe & 8)) __syncthreads();
    issue(p + R::AH);

    if constexpr (INTERP) {
      // stage 1: K8's expression, q_pre + (res/diag (off the coincident
      // points) + P qc), with res = b - A q_pre from the q_pre ring.  A
      // lane's two columns in turn, so that the points of a warp share a
      // parity class (one branch of interp_with); the class's loads go
      // first and the residual overlaps them
      const int x = p - 1;
      if (valid(x, 1) && r >= 1 && r < RY - 1 && yin) {
        T* dst = qs(x);
        const T *pm = ps(x - 1), *pw = ps(x), *pp = ps(x + 1);
        const int c = 2 * lane, z = z0 + c;
        const QC3<T> qcg{qc_p, a.nxc, a.nyc, a.nzc};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const Pt t = point(x, z + j, c + j, pm, pw, pp);
          if (c + j >= 1 && c + j < kRW - 1 && z + j >= 0 && z + j < nz)
            dst[t.q0 - pw] = A::add(
                *t.q0, interp_with<T>(cig, qcg, x, y, z + j, [&] {
                  return A::div(residual(j, t), t.s0[0]);
                }));
        }
      }
    }

    // the colour phases: q = (b + Σ coupling·q_nb) * (1/P) at the
    // colour's points, (x + ox + y + oy + z + oz) % 2 == color
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = INTERP + 1 + k, x = p - s;
      const int color = (a.colors >> (4 * k)) & 15;
      if (!(kProbe & 4) && valid(x, s) && r >= s && r < RY - s) {
        T* qx = qs(x);
        const int pc = (color - x - a.ox - y - a.oy - z0 - a.oz) & 1;
        const int c = 2 * lane + pc, z = z0 + c;
        const Pt t = point(x, z, c, qs(x - 1), qx, qs(x + 1));
        const T v = A::mul(A::add(*t.bp, offd(pc, t)), A::div(T(1), t.s0[0]));
        if (yin && c >= s && c < kRW - s && z >= 0 && z < nz)
          qx[t.q0 - qx] = v;
      }
    }

    {
      // plane p - SP is final: its own tile to q_out
      const int x = p - SP;
      if (x >= xt && x < xe && own_row) {
        const T* src = qs(x);
        T* dst = q_out + x * sx + y * sy;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 2 * lane + j, z = z0 + c;
          if (c >= H && c < H + TZ && z < nz) dst[z] = src[r * kRW + cpos(c)];
        }
      }
    }

    if constexpr (EPI == kRes || EPI == kNorm) {
      // the residual of the block's own points of plane p - SE
      const int x = p - SE;
      if (x >= xt && x < xe && own_row) {
        const T *qm = qs(x - 1), *q0 = qs(x), *qp = qs(x + 1);
        const int c = 2 * lane, z = z0 + c;
        const T rv0 = residual(0, point(x, z, c, qm, q0, qp));
        const T rv1 = residual(1, point(x, z + 1, c + 1, qm, q0, qp));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const T rv = j ? rv1 : rv0;
          if (c + j < H || c + j >= H + TZ || z + j >= nz) continue;
          if (EPI == kRes)
            res[x * sx + y * sy + z + j] = rv;
          else
            acc = A::add(acc, A::mul(rv, rv));
        }
      }
    }

    if constexpr (EPI == kRestrict) {
      // the residual of plane p - SE over the tile and its low ring (zero
      // off the grid) into the residual window, and to res on request
      const int x = p - SE;
      if (x >= max(xt - 1, 0) && x < xe && r >= H - 1 && r < H + TY) {
        const T *qm = qs(x - 1), *q0 = qs(x), *qp = qs(x + 1);
        T* dst = rs(x) + (r - H + 1) * RWR - H + 1;
        const bool own = a.emit_res && x >= xt && r >= H;
        const int c = 2 * lane, z = z0 + c;
        const T rv0 = residual(0, point(x, z, c, qm, q0, qp));
        const T rv1 = residual(1, point(x, z + 1, c + 1, qm, q0, qp));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (c + j < H - 1 || c + j >= H + TZ) continue;
          const bool in = yin && z + j >= 0 && z + j < nz;
          const T rv = in ? (j ? rv1 : rv0) : T(0);
          if (in && own && c + j >= H) res[x * sx + y * sy + z + j] = rv;
          dst[c + j] = rv;
        }
      }
      // cb at the coarse points of plane p - SE - 2 that the block owns
      // (an even plane of the chunk): its residual planes were written in
      // the steps before, so the step's barrier covers them and the
      // restriction overlaps the other warps' stages
      const int xr = p - SE - 2;
      if (xr >= xt && xr < xe && (xr & 1) == 0) {
        const int xc = xr >> 1;
        auto ci_at = [&](int d, int i, int j, int k) -> T {
          return cis(i)[(d * CY + j - yc0) * CZ + k - zc0];
        };
        for (int e = tid; e < (TY / 2) * (TZ / 2); e += NT) {
          const int yc = yc0 + e / (TZ / 2), zc = zc0 + e % (TZ / 2);
          if (yc >= a.nyc || zc >= a.nzc) continue;
          auto fine = [&](int ox, int oy, int oz) -> T {
            const int fx = xr + ox, fy = 2 * yc + oy, fz = 2 * zc + oz;
            return (fx >= 0 && fx < nx && fy >= 0 && fy < ny && fz >= 0 &&
                    fz < nz)
                       ? rs(fx)[(fy - yt + 1) * RWR + (fz - zt + 1)]
                       : T(0);
          };
          cb[((long long)xc * a.nyc + yc) * a.nzc + zc] =
              restrict_value(ci_at, fine, xc, yc, zc);
        }
      }
    }
  }
  wait_async<0>();

  if constexpr (EPI == kNorm) {
    const T tot = block_sum<NW>(acc);
    if (tid == 0)
      partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x] = tot;
  }
}

template <typename T, bool INTERP, int EPI, int TY>
int launch_ring(const Args& a, const KPlan& p, cudaStream_t st) {
  using R = Ring<T, INTERP, EPI, TY>;
  // the plan must be this variant's and cover the grid once, with tiles
  // and chunks at even indices
  if (p.smem != (long long)R::BYTES || p.cx < 2 || (p.cx & 1) ||
      p.gz != (a.nz + R::TZ - 1) / R::TZ || p.gy != (a.ny + TY - 1) / TY ||
      p.gc != (a.nx + p.cx - 1) / p.cx)
    return (int)cudaErrorInvalidValue;
  const RingDims d{a.nx,  a.ny, a.nz,     a.nxc, a.nyc, a.nzc,
                   p.cx,  a.colors, a.ox, a.oy, a.oz, a.emit_res};
  auto fn = ring3<T, INTERP, EPI, TY>;
  // above 48 KB with block_sum's static array included
  if (R::BYTES + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<dim3(p.gz, p.gy, p.gc), dim3(32, R::NW), R::BYTES, st>>>(
      (const T*)a.so, (const T*)a.q_in, (const T*)a.b, (const T*)a.ci,
      (const T*)a.qc, (T*)a.q_out, (T*)a.res, (T*)a.cb, (T*)a.partials, d);
  return (int)cudaGetLastError();
}

// a 7-point ring variant on the plan's tile rows, launched (go true), or
// the shared-memory bytes of that variant (-1: not built)
template <typename T, bool INTERP, int EPI>
int ring_rows(bool go, const Args& a, const KPlan& p, cudaStream_t st) {
  constexpr int D = sizeof(T) == 8;
  if constexpr (!INTERP && EPI != kRestrict) {
    constexpr int T0 = kRingRows14[D];
    if (p.ty == T0)
      return go ? launch_ring<T, INTERP, EPI, T0>(a, p, st)
                : (int)Ring<T, INTERP, EPI, T0>::BYTES;
  } else {
    constexpr int T0 = kRingRows[D][0], T1 = kRingRows[D][1];
    if (p.ty == T0)
      return go ? launch_ring<T, INTERP, EPI, T0>(a, p, st)
                : (int)Ring<T, INTERP, EPI, T0>::BYTES;
    if (p.ty == T1)
      return go ? launch_ring<T, INTERP, EPI, T1>(a, p, st)
                : (int)Ring<T, INTERP, EPI, T1>::BYTES;
  }
  return go ? (int)cudaErrorInvalidValue : -1;
}

// ---------------------------------------------------------------------------
// 27-point K14: the march of several colours (`pass27`, see the header
// note).

// colour stages a march, and so a launch (tools/tune_fused3.py builds
// others)
#ifndef CEDAR_K14_STAGES
#define CEDAR_K14_STAGES 2
#endif
constexpr int kStages27 = CEDAR_K14_STAGES;
static_assert(kStages27 >= 1 && kStages27 <= 8, "1 to 8 colours a march");
constexpr int kAhead27 = 2;  // steps between a copy's issue and its use
constexpr int kVals = 28;    // a point's 27 stencil values and b
constexpr int kNoColor = 15; // a colour code that names no colour
// warps a block at most: 12 (170 registers a thread) where each thread
// gathers its stencil values for three or four colour stages, else 16
constexpr int kMaxWarps27 = kStages27 >= 3 && kStages27 <= 4 ? 12 : 16;

// the value slot of the (dx, dy, dz) term of a point (13: the diagonal)
__host__ __device__ constexpr int val_of(int dx, int dy, int dz) {
  return (dx + 1) * 9 + (dy + 1) * 3 + dz + 1;
}

// The layout of a 27-point K14 block with tiles of ty rows
// (ops/cuda_fused3.py `pass27_words` mirrors it; the launch checks the plan
// against it): a warp for each pair of region rows, the q ring, and in
// float32 with at most 4 stages a point's stencil values and b for each
// colour stage and thread.
template <typename T>
struct Pass27 {
  static constexpr int NPH = kStages27, H = NPH;
  static constexpr int TZ = kRW - 2 * H;
  static constexpr bool ST = sizeof(T) == 4 && NPH <= 4;
  static constexpr int WQ = NPH + 2 + kAhead27;  // planes p - H - 1 .. p + 2
  static __host__ __device__ constexpr int ry(int ty) { return ty + 2 * H; }
  static __host__ __device__ constexpr int threads(int ty) {
    return 16 * ry(ty);
  }
  static __host__ __device__ constexpr size_t words(int ty) {
    return (size_t)WQ * ry(ty) * kRW +
           (ST ? (size_t)NPH * kVals * threads(ty) : 0);
  }
  // tile rows a launch may take: even, at most kMaxWarps27 warps
  static __host__ __device__ constexpr bool takes(int ty) {
    return ty >= 2 && (ty & 1) == 0 && ry(ty) <= 2 * kMaxWarps27;
  }
};

// A point of a 27-point K14 march as offd27 reads it: q0 at the point in
// the q ring, whose planes x + 1 and x - 1 lie dq and dm words on and
// whose colour-compact rows put the z + 1 and z - 1 neighbours of a column
// of parity cp 32 or -31 and 31 or -32 words away; whether each neighbour
// lies on the grid.
template <typename T>
struct Pt27 {
  const T* q0;
  long long dq, dm;
  int cp;
  bool xl, xh, yl, yh, zl, zh;
  // whether the (dx, dy, dz) neighbour lies on the grid
  __device__ __forceinline__ bool on(int dx, int dy, int dz) const {
    return (dx < 0 ? xl : dx > 0 ? xh : true) &&
           (dy < 0 ? yl : dy > 0 ? yh : true) &&
           (dz < 0 ? zl : dz > 0 ? zh : true);
  }
};

// Σ coupling · q over the neighbours of a 27-point K14 point
// (offdiag_terms' order), the stencil value of a term from the point's
// slots (value k at vs[k * nt]) or, vs null, from device memory (s0: the
// point in so).  Every read is made whether or not the neighbour lies on
// the grid (from the point itself where it does not), so that none waits
// on a branch and all of a point's reads are in flight together.
template <typename T>
__device__ __forceinline__ T offd27(const Pt27<T>& t, const T* vs, int nt,
                                    const T* __restrict__ s0, const Dims& a) {
  using A = Arith<T>;
  const long long sy = a.nz, sx = (long long)a.ny * a.nz, N = sx * a.nx;
  const int ZP = t.cp ? -31 : 32, ZM = t.cp ? -32 : 31;
  return offdiag_terms<T, true>([&](int dx, int dy, int dz, int P) -> T {
    const bool ok = t.on(dx, dy, dz);
    const T sval =
        vs ? vs[val_of(dx, dy, dz) * nt]
           : s0[ok ? P * N + (dx > 0 ? sx : 0) + (dy > 0 ? sy : 0) +
                         (dz > 0 ? 1 : 0)
                   : 0];
    const T* qx = t.q0 + (dx < 0 ? t.dm : dx > 0 ? t.dq : 0);
    const T qv = qx[dy * kRW + (dz > 0 ? ZP : dz < 0 ? ZM : 0)];
    return ok ? A::mul(sval, qv) : T(0);
  });
}

// 27-point K14: one march on a y-z tile and an x chunk, NPH colour stages
// (codes in a.colors, 4 bits each, kNoColor past the last).  Warp w takes
// region rows 2w and 2w + 1, lane l columns 2l and 2l + 1; a colour stage
// gives each thread one point (the row and column of the colour's
// parities), so that it can gather that point's stencil values by cp.async
// for its stage's next active step into its own slots, which only it reads.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps27, 1)
pass27(const T* __restrict__ so, const T* __restrict__ q_in,
       const T* __restrict__ b, T* __restrict__ q_out, const Dims a,
       const int ty) {
  using A = Arith<T>;
  using L = Pass27<T>;
  constexpr int NPH = L::NPH, H = L::H, TZ = L::TZ;
  constexpr int WQ = L::WQ;
  constexpr bool ST = L::ST;
  const int RY = L::ry(ty), PL = RY * kRW, NT = L::threads(ty);

  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long sy = nz, sx = (long long)ny * nz, N = sx * nx;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  auto qs = [&](int x) { return sm + ((x + 8 * WQ) % WQ) * PL; };
  T* const sv = sm + (size_t)WQ * PL;  // [stage][value][thread]

  const int zt = blockIdx.x * TZ, yt = blockIdx.y * ty, xt = blockIdx.z * a.cx;
  const int z0 = zt - H, y0 = yt - H;
  const int xe = min(xt + a.cx, nx);
  const int lane = threadIdx.x, w = threadIdx.y, tid = w * 32 + lane;
  auto valid = [&](int x, int s) {
    return x >= max(xt - H + s, 0) && x < min(xt + a.cx + H - s, nx);
  };

  // the q ring: thread (w, lane) copies columns lane and lane + 32 of rows
  // 2w and 2w + 1
  int goff[4], soff[4];
  bool gin[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 2 * w + (j >> 1), c = lane + 32 * (j & 1);
    const int y = y0 + r, z = z0 + c;
    gin[j] = y >= 0 && y < ny && z >= 0 && z < nz;
    goff[j] = gin[j] ? y * nz + z : 0;
    soff[j] = r * kRW + cpos(c);
  }
  const int p0 = max(xt - H, 0), load_end = min(xt + a.cx + H, nx);
  auto issue_q = [&](int t) {
    if (t >= load_end) return;
    T* d = qs(t);
    const T* src = q_in + t * sx;
#pragma unroll
    for (int j = 0; j < 4; ++j) copy_async(d + soff[j], src + goff[j], gin[j]);
  };

  // colour stage k (s = k + 1) at step p: plane p - s, the thread's point
  // (row r, column c) of the colour's parities, and whether it runs
  auto color_of = [&](int k) { return (a.colors >> (4 * k)) & 15; };
  auto stage_on = [&](int k, int p) {
    const int color = color_of(k), x = p - k - 1;
    return color != kNoColor && valid(x, k + 1) &&
           ((x + a.ox - color) & 1) == 0;
  };
  int pr[NPH], pc[NPH];
  bool pin[NPH];  // the point lies on the grid at depth >= s in y and z
#pragma unroll
  for (int k = 0; k < NPH; ++k) {
    const int color = color_of(k) & 7, s = k + 1;
    pr[k] = 2 * w + ((((color >> 1) & 1) - y0 - a.oy) & 1);
    pc[k] = 2 * lane + ((((color >> 2) & 1) - z0 - a.oz) & 1);
    const int y = y0 + pr[k], z = z0 + pc[k];
    pin[k] = pr[k] >= s && pr[k] < RY - s && pc[k] >= s && pc[k] < kRW - s &&
             y >= 0 && y < ny && z >= 0 && z < nz;
  }
  // float32: the stencil values and b of stage k's point at step t into
  // the thread's slots (zero where the neighbour is off the grid)
  auto gather = [&](int t) {
    if constexpr (ST && !(kProbe & 16)) {
#pragma unroll
      for (int k = 0; k < NPH; ++k) {
        if (!pin[k] || !stage_on(k, t)) continue;
        const int x = t - k - 1, y = y0 + pr[k], z = z0 + pc[k];
        const long long i = x * sx + y * sy + z;
        T* d = sv + (size_t)k * kVals * NT + tid;
        const bool xl = x > 0, xh = x + 1 < nx, yl = y > 0, yh = y + 1 < ny;
        const bool zl = z > 0, zh = z + 1 < nz;
        offdiag_terms<T, true>([&](int dx, int dy, int dz, int P) -> T {
          const bool ok = (dx < 0 ? xl : dx > 0 ? xh : true) &&
                          (dy < 0 ? yl : dy > 0 ? yh : true) &&
                          (dz < 0 ? zl : dz > 0 ? zh : true);
          copy_async(d + val_of(dx, dy, dz) * NT,
                     so + (ok ? P * N + i + (dx > 0 ? sx : 0) +
                                    (dy > 0 ? sy : 0) + (dz > 0 ? 1 : 0)
                              : 0),
                     ok);
          return T(0);
        });
        copy_async(d + val_of(0, 0, 0) * NT, so + i, true);
        copy_async(d + (kVals - 1) * NT, b + i, true);
      }
    }
  };

  // a point of plane x, region row r, column c as offd27 reads it
  auto at = [&](int x, int y, int z, int r, int c) {
    return Pt27<T>{qs(x) + r * kRW + cpos(c), qs(x + 1) - qs(x),
                   qs(x - 1) - qs(x), c & 1, x > 0, x + 1 < nx, y > 0,
                   y + 1 < ny, z > 0, z + 1 < nz};
  };

#pragma unroll
  for (int t = 0; t < kAhead27; ++t) {
    issue_q(p0 + t);
    gather(p0 + t);
    commit_async();
  }
  // One barrier a step publishes the copies of plane p and frees the slots
  // that step p + 2's copies overwrite; each colour stage that runs ends
  // with a barrier (27-point couplings reach diagonally into the plane the
  // stage before updated).  A stage's slots are refilled for its next
  // active step (p + 2: the colours of a pass alternate in x parity) after
  // that barrier.
  for (int p = p0; p < xe + NPH; ++p) {
    wait_async<kAhead27 - 1>();
    if (!(kProbe & 8)) __syncthreads();
    issue_q(p + kAhead27);

#pragma unroll
    for (int k = 0; k < NPH; ++k) {
      if (!stage_on(k, p)) continue;
      const int x = p - k - 1;
      if (pin[k] && !(kProbe & 32)) {
        const int r = pr[k], c = pc[k], y = y0 + r, z = z0 + c;
        const long long i = x * sx + y * sy + z;
        T* qx = qs(x) + r * kRW + cpos(c);
        if constexpr (ST) {
          const T* vs = sv + (size_t)k * kVals * NT + tid;
          *qx = A::mul(A::add(vs[(kVals - 1) * NT],
                              offd27<T>(at(x, y, z, r, c), vs, NT, nullptr, a)),
                       A::div(T(1), vs[val_of(0, 0, 0) * NT]));
        } else {
          *qx = A::mul(
              A::add(b[i], offd27<T>(at(x, y, z, r, c), nullptr, 0, so + i,
                                     a)),
              A::div(T(1), so[i]));
        }
      }
      if (!(kProbe & 8)) __syncthreads();
    }

    {
      // plane p - NPH is final: the block's own points to q_out
      const int x = p - NPH;
      if (x >= xt && x < xe) {
        const T* src = qs(x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 2 * w + (j >> 1), c = 2 * lane + (j & 1);
          const int y = y0 + r, z = z0 + c;
          if (r >= H && r < H + ty && y < ny && c >= H && c < H + TZ &&
              z < nz)
            q_out[x * sx + y * sy + z] = src[r * kRW + cpos(c)];
        }
      }
    }

    gather(p + kAhead27);
    commit_async();
  }
  wait_async<0>();
}

template <typename T>
int launch_pass27(const Args& a, const KPlan& p, cudaStream_t st) {
  using L = Pass27<T>;
  // the plan must be this kernel's and cover the grid once
  if (!L::takes(p.ty) || p.smem != (long long)(L::words(p.ty) * sizeof(T)) ||
      p.cx < 1 || p.gz != (a.nz + L::TZ - 1) / L::TZ ||
      p.gy != (a.ny + p.ty - 1) / p.ty || p.gc != (a.nx + p.cx - 1) / p.cx)
    return (int)cudaErrorInvalidValue;
  const Dims d{a.nx, a.ny, a.nz, a.nxc, a.nyc, a.nzc, p.cx, a.colors,
               a.ox, a.oy, a.oz, 0};
  auto fn = pass27<T>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<dim3(p.gz, p.gy, p.gc), dim3(32, L::threads(p.ty) / 32), p.smem,
       st>>>((const T*)a.so, (const T*)a.q_in, (const T*)a.b, (T*)a.q_out, d,
             p.ty);
  return (int)cudaGetLastError();
}

// a 27-point K14 march on plan p (go true), or the shared-memory bytes of
// the kernel with p's tile rows (-1: none such)
template <typename T>
int pass27_planned(bool go, const Args& a, const KPlan& p, cudaStream_t st) {
  if (go) return launch_pass27<T>(a, p, st);
  return Pass27<T>::takes(p.ty) ? (int)(Pass27<T>::words(p.ty) * sizeof(T))
                                : -1;
}

// K15 (interp false, mode kRestrict), K16 (interp true, mode kNone /
// kRes / kNorm) or the 7-point K14 (interp false, mode kNone / kRes /
// kNorm), 7-point all of them (the ring design), launched on plan p (go
// true); or the shared-memory bytes of the kernel with p's tile rows (-1:
// none such).
template <typename T>
int planned(bool go, const Args& a, int interp, int mode, const KPlan& p,
            cudaStream_t st) {
  switch (mode) {
    case kNone:
      return interp ? ring_rows<T, true, kNone>(go, a, p, st)
                    : ring_rows<T, false, kNone>(go, a, p, st);
    case kRes:
      return interp ? ring_rows<T, true, kRes>(go, a, p, st)
                    : ring_rows<T, false, kRes>(go, a, p, st);
    case kNorm:
      return interp ? ring_rows<T, true, kNorm>(go, a, p, st)
                    : ring_rows<T, false, kNorm>(go, a, p, st);
    case kRestrict:
      if (!interp) return ring_rows<T, false, kRestrict>(go, a, p, st);
  }
  return go ? (int)cudaErrorInvalidValue : -1;
}

int planned_dtype(int dtype, bool go, const Args& a, int interp, int mode,
                  const KPlan& p, cudaStream_t st) {
  if (dtype == kFloat32) return planned<float>(go, a, interp, mode, p, st);
  if (dtype == kFloat64) return planned<double>(go, a, interp, mode, p, st);
  return go ? (int)cudaErrorInvalidValue : -1;
}

}  // namespace
}  // namespace cedar

extern "C" {

// The colours a 27-point K14 march (and launch) takes at most.
int cedar_fused3_pass27_stages() { return cedar::kStages27; }

// The shared-memory bytes of the 27-point K14 kernel with tiles of ty rows,
// or -1 if it takes no such tiles: what ops/cuda_fused3.py `pass27_plan`
// computes.
int cedar_fused3_pass27_smem(int dtype, int ty) {
  const cedar::Args a{};
  const cedar::KPlan p{ty, 0, 0, 0, 0, 0};
  if (dtype == cedar::kFloat32)
    return cedar::pass27_planned<float>(false, a, p, nullptr);
  if (dtype == cedar::kFloat64)
    return cedar::pass27_planned<double>(false, a, p, nullptr);
  return -1;
}

// The blocks an SM that the 7-point K14's registers are capped for, and its
// tile rows in dtype (ops/cuda_fused3.py `plan` reads them).
int cedar_fused3_ring14_blocks() { return cedar::kMinBlocks14; }
int cedar_fused3_ring14_rows(int dtype) {
  return dtype == cedar::kFloat64 ? cedar::kRingRows14[1]
                                  : cedar::kRingRows14[0];
}

// The shared-memory bytes of the 7-point K15 (interp 0, mode 3), K16
// (interp 1, mode 0-2) or K14 (interp 0, mode 0-2) kernel with tiles of ty
// rows, or -1 if none is built: what ops/cuda_fused3.py `plan` computes.
int cedar_fused3_smem(int dtype, int interp, int mode, int ty) {
  const cedar::Args a{};
  const cedar::KPlan p{ty, 0, 0, 0, 0, 0};
  return cedar::planned_dtype(dtype, false, a, interp, mode, p, nullptr);
}

// The 7-point K14 on the ring design: q_out = one whole sweep of q_in
// (colour codes packed 4 bits each in order), then mode 0 nothing more, 1
// res = b - A q_out, 2 partials[block] = Σ res² over the block; on the plan
// (ty, cx, gz, gy, gc, smem) of ops/cuda_fused3.py `plan`.  Returns a CUDA
// error code.
int cedar_sweep3_ring(int dtype, const void* so, const void* q_in,
                      const void* b, void* q_out, void* res, void* partials,
                      int nx, int ny, int nz, int colors, int ox, int oy,
                      int oz, int mode, int ty, int cx, int gz, int gy,
                      int gc, long long smem, void* stream) {
  const cedar::Args a{so, q_in, b, nullptr, nullptr, q_out, res, nullptr,
                      partials, nx, ny, nz, 0, 0, 0, colors, ox, oy, oz, 0};
  const cedar::KPlan p{ty, cx, gz, gy, gc, smem};
  if (mode == cedar::kRestrict) return (int)cudaErrorInvalidValue;
  return cedar::planned_dtype(dtype, true, a, 0, mode, p,
                              (cudaStream_t)stream);
}

// 27-point K14: q_out = one march of up to cedar_fused3_pass27_stages()
// colours of q_in (codes packed as above, 15 past the last), on the plan
// (ty, cx, gz, gy, gc, smem) of ops/cuda_fused3.py `pass27_plan`.  Returns
// a CUDA error code.
int cedar_pass27(int dtype, const void* so, const void* q_in, const void* b,
                 void* q_out, int nx, int ny, int nz, int colors, int ox,
                 int oy, int oz, int ty, int cx, int gz, int gy, int gc,
                 long long smem, void* stream) {
  const cedar::Args a{so, q_in, b, nullptr, nullptr, q_out, nullptr, nullptr,
                      nullptr, nx, ny, nz, 0, 0, 0, colors, ox, oy, oz, 0};
  const cedar::KPlan p{ty, cx, gz, gy, gc, smem};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::pass27_planned<float>(true, a, p, st);
  if (dtype == cedar::kFloat64)
    return cedar::pass27_planned<double>(true, a, p, st);
  return (int)cudaErrorInvalidValue;
}

// The 7-point K15: q_out = one sweep of q_in (colour codes as above), res
// = b - A q_out (written when emit_res), cb (nxc, nyc, nzc) = Pᵀ res, on
// the plan (ty, cx, gz, gy, gc, smem) of ops/cuda_fused3.py.  Returns a
// CUDA error code.
int cedar_sweep_restrict3(int dtype, const void* so, const void* q_in,
                          const void* b, const void* ci, void* q_out,
                          void* res, void* cb, int nx, int ny, int nz,
                          int nxc, int nyc, int nzc, int colors,
                          int emit_res, int ty, int cx, int gz, int gy,
                          int gc, long long smem, void* stream) {
  const cedar::Args a{so, q_in, b, ci, nullptr, q_out, res, cb, nullptr,
                      nx, ny, nz, nxc, nyc, nzc, colors, 0, 0, 0, emit_res};
  const cedar::KPlan p{ty, cx, gz, gy, gc, smem};
  return cedar::planned_dtype(dtype, true, a, 0, cedar::kRestrict, p,
                              (cudaStream_t)stream);
}

// The 7-point K16: q_out = one sweep of q_pre + (b - A q_pre) / diag + P
// qc; mode as K14; plan as K15.  Returns a CUDA error code.
int cedar_interp_sweep3(int dtype, const void* ci, const void* qc,
                        const void* so, const void* b, const void* q_pre,
                        void* q_out, void* res, void* partials, int nx,
                        int ny, int nz, int nxc, int nyc, int nzc,
                        int colors, int mode, int ty, int cx, int gz, int gy,
                        int gc, long long smem, void* stream) {
  const cedar::Args a{so, q_pre, b, ci, qc, q_out, res, nullptr, partials,
                      nx, ny, nz, nxc, nyc, nzc, colors, 0, 0, 0, 0};
  const cedar::KPlan p{ty, cx, gz, gy, gc, smem};
  return cedar::planned_dtype(dtype, true, a, 1, mode, p,
                              (cudaStream_t)stream);
}

}  // extern "C"
