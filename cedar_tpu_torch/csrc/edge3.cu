// The 27-point edge kernel (`edge3`): the parts of the 27-point K15 and K16
// that are not a sweep, each computed from the current iterate in one
// plane march, without smoothing.
//
// Replaces, with K6's sweep (sweep3.cu, fused3.cu `pass27`) before or after
// it, the Pallas kernels cedar_tpu/ops/pallas3_split.py
// `_sweep_restrict_kernel3` (`sweep_restrict_split3`: the last pre-sweep,
// its residual and the coarse rhs cb = Pᵀ res) and `_interp_sweep_kernel3`
// (`interp_sweep_split3`: the residual of the pre-smoothed iterate
// recomputed, q + res/diag + P qc, then the first post-sweep) on 27-point
// levels.  The 27-point K15 is the DOWN sweep on K6's route, then this
// kernel in mode `restrict`; the 27-point K16 this kernel in mode `interp`,
// then the UP sweep on K6's route (ops/cuda_fused3.py).  Modes:
//
//   restrict  res = b - A q on chip, cb = Pᵀ res, res written on request;
//   res       res = b - A q;
//   norm      one partial sum of res² a block (the convergence norm);
//   interp    q_out = q_pre + (b - A q_pre)/diag + P qc (K8's expression).
//
// Its math is ops/fused3.py's plain versions (stencil3.residual,
// interp3.restrict_torch, interp3.interp_add_torch); the sums come from
// stencil3.cuh (`offdiag_terms`) and transfer3.cuh (`restrict_value`,
// `interp_with`), with __fmul_rn / __fadd_rn, so that each output equals
// the plain version bit for bit.
//
// The design: a block owns a y-z tile (ty rows, TZ columns: 64 in float32,
// 32 in float64) and marches along an x chunk of cx planes, one plane a
// step.  The planes a step reads arrive by cp.async (async.cuh) one step
// ahead, as one commit group a step, into rings in shared memory: q (or
// q_pre) planes x - 1 .. x + 1 over the window and a ring of halo, and the
// 14 stencil planes of x-planes x and x + 1 (a 27-point residual reads the
// stencil at the point and the mirrored values at 13 neighbours, 9 of them
// in plane x + 1), each over the window and a high ring.  A ring row keeps
// grid column zt at a 16-byte boundary, so that where nz allows (a
// multiple of 16 bytes a row) the tile's columns come by 16-byte copies
// through L2 and only the ring's edge columns by element copies.  One
// barrier a step, after the wait for the step's own copies, publishes them
// and frees the slots that the step's copies overwrite: at step p the
// block computes the residual of plane p - 1 while the copies of plane
// p + 1 fly.  A thread holds at most two window points, the same in every
// step, and their b values, read into registers a step ahead; every read
// of a ring is made whether or not the neighbour lies on the grid (the
// rings are zero-filled off it) and the coupling is masked, as `pass27`
// does.  In modes res and norm a thread's two residual chains run
// together; beside the restriction, one after the other (together they
// spilled registers).
//
// `restrict`: the residual window is the tile and its low ring (the
// restriction reads fine indices 2c - 1 .. 2c + 1) and goes into a ring of
// four planes; the restriction of plane p - 3 runs at step p, by the
// block's last threads before their residuals, so that its window (planes
// p - 4 .. p - 2) was written in the steps before and the step's barrier
// covers it: the restriction needs no barrier of its own.  Tiles and
// chunks start at even indices, so each coarse point (2i, 2j, 2k) has
// exactly one owner block.  The CI planes of the next restriction and
// (interp) the CI and coarse planes of the next plane are asked into L2
// one step ahead.  `interp` gives each warp the points of one z parity
// (its even columns, then its odd ones), so that a warp's points share a
// parity class of interp_with in float32; a thread's two points go one
// after the other (the loads of both first spilled registers).
//
// What bounds it on the H100: bytes (14 stencil planes, q and b a point,
// and CI; about 0.5 flop a byte).  Out of place: q is read over a halo
// while other blocks write theirs, so no output may alias an input.

#include "async.cuh"
#include "stencil3.cuh"
#include "transfer3.cuh"

namespace cedar {
namespace {

// modes (ops/cuda_fused3.py `_RES`, `_NORM`, `_RESTRICT`, `_INTERP`)
constexpr int kRes = 1, kNorm = 2, kRestrict = 3, kInterp = 4;
// threads a block (tools/tune_fused3.py builds others)
#ifndef CEDAR_EDGE3_THREADS
#define CEDAR_EDGE3_THREADS 512
#endif
constexpr int kThreads = CEDAR_EDGE3_THREADS;
static_assert(kThreads % 64 == 0 && kThreads <= 1024, "whole warp pairs");
// Build settings of tools/tune_fused3.py only: the parts that a timing
// probe skips (bit 0: the stencil copies, 1: the residual, 2: the
// restriction or the interpolation's coarse side, 3: the barriers); 0 in
// every other build.
#ifndef CEDAR_EDGE3_PROBE
#define CEDAR_EDGE3_PROBE 0
#endif
constexpr int kProbe = CEDAR_EDGE3_PROBE;

// The layout of an edge block of MODE with tiles of ty rows
// (ops/cuda_fused3.py `edge_words` mirrors `words`; the launch checks the
// plan against it): over the residual window of rows(ty) x RC points (the
// tile, and for `restrict` its low ring), four q planes of the window and
// a ring of halo, three x-planes of the 14 stencil arrays over the window
// and a high ring, in rows of PW words with grid column zt at word V (a
// 16-byte boundary), and for `restrict` four residual planes.
template <typename T, int MODE>
struct Edge {
  static constexpr int V = 16 / sizeof(T);             // elements a 16 bytes
  static constexpr int TZ = sizeof(T) == 4 ? 64 : 32;  // own columns
  static constexpr int LO = MODE == kRestrict;         // the low ring
  static constexpr int RC = TZ + LO, PW = TZ + 2 * V, C0 = V - LO;
  static constexpr int WQ = 4, WS = 3, WR = LO ? 4 : 0;
  static __host__ __device__ constexpr int rows(int ty) { return ty + LO; }
  static __host__ __device__ constexpr long long qplane(int ty) {
    return (long long)(rows(ty) + 2) * PW;
  }
  static __host__ __device__ constexpr long long splane(int ty) {
    return (long long)(rows(ty) + 1) * PW;
  }
  static __host__ __device__ constexpr long long rplane(int ty) {
    return (long long)rows(ty) * RC;
  }
  static __host__ __device__ constexpr long long words(int ty) {
    return WQ * qplane(ty) + WS * 14 * splane(ty) + WR * rplane(ty);
  }
};

struct EdgeDims {
  int nx, ny, nz, nxc, nyc, nzc, ty, cx, emit_res;
};

// The sum of v over the block, returned to thread 0.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T tot = T(0);
  if (threadIdx.x == 0)
    for (int k = 0; k < kThreads / 32; ++k) tot += warp_sums[k];
  return tot;
}

// One edge pass (see the header note) on a y-z tile and an x chunk; VEC:
// the tile's columns by 16-byte copies.  restrict: out is cb and res the
// residual (written when emit_res); res: out the residual; norm: out the
// partials, one a block; interp: q_in is q_pre and out q_out.
template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
edge3(const T* __restrict__ so, const T* __restrict__ q_in,
      const T* __restrict__ b, const T* __restrict__ ci_p,
      const T* __restrict__ qc_p, T* __restrict__ out, T* __restrict__ res,
      const EdgeDims a) {
  using A = Arith<T>;
  using E = Edge<T, MODE>;
  constexpr int V = E::V, TZ = E::TZ, LO = E::LO, RC = E::RC, PW = E::PW;
  constexpr int C0 = E::C0;
  const int ty = a.ty, RR = E::rows(ty);
  const long long QP = E::qplane(ty), SP = E::splane(ty), RP = E::rplane(ty);
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long sy = nz, sx = (long long)ny * nz, N = sx * nx;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const sq = reinterpret_cast<T*>(smem);
  T* const ss = sq + E::WQ * QP;
  T* const sr = ss + E::WS * 14 * SP;
  // the ring slot of plane x (x >= -8)
  auto qs = [&](int x) { return sq + ((x + 8 * E::WQ) % E::WQ) * QP; };
  auto st = [&](int x) { return ss + ((x + 8 * E::WS) % E::WS) * 14 * SP; };
  auto rs = [&](int x) { return sr + ((x + 8 * 4) % 4) * RP; };

  const int zt = blockIdx.x * TZ, yt = blockIdx.y * ty, xt = blockIdx.z * a.cx;
  const int xe = min(xt + a.cx, nx);  // own planes [xt, xe)
  const int y0 = yt - LO, z0 = zt - LO;  // the residual window's origin
  const int xr0 = max(xt - LO, 0);      // its first plane
  const int tid = threadIdx.x;

  // --- the copies ---------------------------------------------------------
  // rows [y1, y1 + nrow) of plane x of the n arrays of src (stride N),
  // columns zt - nleft .. zt + TZ, into ring rows of PW words (column zt at
  // V), zero off the grid: the tile's columns by 16-byte copies (VEC) or
  // element copies, the edge columns by element copies
  auto copy_rows = [&](T* dst, long long dstride, const T* src, int n,
                       int x, int nrow, int y1, int nleft) {
    constexpr int NCH = VEC ? TZ / V : TZ;  // copies of the tile's columns
    const int W = nleft + NCH + 1;
    const T* sp = src + x * sx;
    for (int e = tid; e < nrow * W; e += kThreads) {
      const int r = e / W, c = e - r * W;
      const int y = y1 + r;
      const bool yin = y >= 0 && y < ny;
      if (VEC && c >= nleft && c < nleft + NCH) {
        const int z = zt + (c - nleft) * V;
        const bool in = yin && z < nz;
        T* d = dst + r * PW + V + (z - zt);
        const T* g = sp + (in ? y * sy + z : 0);
#pragma unroll 7
        for (int k = 0; k < n; ++k)
          copy_async16(d + k * dstride, g + k * N, in);
      } else {
        const int z = c < nleft ? zt - nleft + c
                                : (VEC ? zt + TZ : zt - nleft + c);
        const bool in = yin && z >= 0 && z < nz;
        T* d = dst + r * PW + V + (z - zt);
        const T* g = sp + (in ? y * sy + z : 0);
#pragma unroll 7
        for (int k = 0; k < n; ++k) copy_async(d + k * dstride, g + k * N, in);
      }
    }
  };
  auto copy_q = [&](int x) {
    copy_rows(qs(x), 0, q_in, 1, x, RR + 2, y0 - 1, LO + 1);
  };
  auto copy_s = [&](int x) {
    if (!(kProbe & 1)) copy_rows(st(x), SP, so, 14, x, RR + 1, y0, LO);
  };

  // lines of 128 bytes into L2: rows [r1, r1 + nr) and columns [c1, c1 +
  // nc) of plane c of the d arrays of an (np, n1, n2) array at p
  constexpr int LINE = 128 / sizeof(T);
  auto prefetch = [&](const T* p, long long plane, int np, int n1, int n2,
                      int d, int c, int r1, int nr, int c1, int nc) {
    if (c < 0 || c >= np) return;
    const int nl = (nc + LINE - 1) / LINE + 1;  // lines a row
    for (int e = tid; e < d * nr * nl; e += kThreads) {
      const int k = e / (nr * nl), j = r1 + (e / nl) % nr;
      const int z = max(c1, 0) + (e % nl) * LINE;
      if (j >= 0 && j < n1 && z < n2 && z < c1 + nc)
        prefetch_l2(p + k * plane + ((long long)c * n1 + j) * n2 + z);
    }
  };
  const long long cplane = (long long)(a.nxc + 1) * (a.nyc + 1) * (a.nzc + 1);
  const CI3<T> ci = make_ci(ci_p, a.nxc, a.nyc, a.nzc);
  const QC3<T> qcg{qc_p, a.nxc, a.nyc, a.nzc};
  const int yc0 = yt / 2, zc0 = zt / 2;  // the block's first coarse point

  // --- the thread's points --------------------------------------------------
  // window points tid and tid + kThreads (the plan keeps the window within
  // two a thread): row i, column j (interp: a warp's points one z parity),
  // whether the point exists and lies on the grid
  int pi[2], pj[2];
  bool pe[2], pin[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = tid + k * kThreads;
    pe[k] = e < RR * RC;
    pi[k] = pe[k] ? e / RC : 0;
    const int c = pe[k] ? e - pi[k] * RC : 0;
    pj[k] = MODE == kInterp ? (c < TZ / 2 ? 2 * c : 2 * (c - TZ / 2) + 1) : c;
    const int y = y0 + pi[k], z = z0 + pj[k];
    pin[k] = pe[k] && y >= 0 && y < ny && z >= 0 && z < nz;
  }
  // b at the thread's points of plane x, zero off the grid
  auto load_b = [&](int x, T* bv) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      bv[k] = pin[k] ? b[x * sx + (y0 + pi[k]) * sy + z0 + pj[k]] : T(0);
  };

  // --- the residual ---------------------------------------------------------
  // b - A q at window point (i, j) of plane x from the rings, b given; the
  // diagonal into *diag
  auto residual = [&](int x, int i, int j, T bv, T* diag) -> T {
    const T *qm = qs(x - 1), *q0 = qs(x), *qp = qs(x + 1);
    const T *s0 = st(x), *s1 = st(x + 1);
    const int y = y0 + i, z = z0 + j;
    const bool xl = x > 0, xh = x + 1 < nx, yl = y > 0, yh = y + 1 < ny;
    const bool zl = z > 0, zh = z + 1 < nz;
    const int oq = (i + 1) * PW + C0 + j, os = i * PW + C0 + j;
    const T offd = offdiag_terms<T, true>([&](int dx, int dy, int dz,
                                              int P) -> T {
      const bool ok = (dx < 0 ? xl : dx > 0 ? xh : true) &&
                      (dy < 0 ? yl : dy > 0 ? yh : true) &&
                      (dz < 0 ? zl : dz > 0 ? zh : true);
      const T sv = (dx > 0 ? s1 : s0)[P * SP + os + (dy > 0 ? PW : 0) +
                                      (dz > 0 ? 1 : 0)];
      const T qv = (dx < 0 ? qm : dx > 0 ? qp : q0)[oq + dy * PW + dz];
      return ok ? A::mul(sv, qv) : T(0);
    });
    *diag = s0[os];
    return A::sub(A::add(bv, offd), A::mul(s0[os], q0[oq]));
  };

  // the restriction of plane xr (an even plane of the chunk) at the
  // block's coarse points, by the last threads of the block
  auto restrict_plane = [&](int xr) {
    const int xc = xr >> 1;
    const int e = kThreads - 1 - tid;
    if (e >= (ty / 2) * (TZ / 2)) return;
    const int yc = yc0 + e / (TZ / 2), zc = zc0 + e % (TZ / 2);
    if (yc >= a.nyc || zc >= a.nzc) return;
    auto fine = [&](int ox, int oy, int oz) -> T {
      const int fx = xr + ox, fy = 2 * yc + oy, fz = 2 * zc + oz;
      return (fx >= 0 && fx < nx && fy >= 0 && fy < ny && fz >= 0 && fz < nz)
                 ? rs(fx)[(fy - y0) * RC + (fz - z0)]
                 : T(0);
    };
    out[((long long)xc * a.nyc + yc) * a.nzc + zc] =
        restrict_value(ci, fine, xc, yc, zc);
  };

  // b of the plane whose residual the step computes, and of the next
  T acc = T(0), bcur[2] = {T(0), T(0)}, bnext[2] = {T(0), T(0)};
  // the prologue's group: q planes xr0 - 1 and xr0, the stencil of xr0
  if (xr0 > 0) copy_q(xr0 - 1);
  copy_q(xr0);
  copy_s(xr0);
  commit_async();
  const int pend = MODE == kRestrict ? xe + 3 : xe + 1;
  for (int p = xr0; p < pend; ++p) {
    wait_async<0>();
    if (!(kProbe & 8)) __syncthreads();
    // the group of step p: q and the stencil of plane p + 1 (first read
    // at step p + 1)
    if (p + 1 < nx && p + 1 <= xe) {
      copy_q(p + 1);
      copy_s(p + 1);
    }
    commit_async();
    bcur[0] = bnext[0], bcur[1] = bnext[1];
    if (p < xe) load_b(p, bnext);

    // cb at the coarse points of plane p - 3: its residual planes p - 4
    // .. p - 2 were written in the steps before, so the step's barrier
    // covers them
    const int xr = p - 3;
    if (MODE == kRestrict && xr >= xt && xr < xe && (xr & 1) == 0 &&
        !(kProbe & 4))
      restrict_plane(xr);

    const int x = p - 1;
    if (x >= xr0 && x < xe && !(kProbe & 2)) {
      if constexpr (MODE == kInterp) {
        // each point's class loads go first and its residual overlaps
        // them (interp_with); a thread's two points one after the other
        // (the loads of both first spilled registers)
        if (pin[0]) {
          // point 1 off the grid or missing: point 0 again (not stored)
          const int k1 = pin[1] ? 1 : 0;
          const int yy[2] = {y0 + pi[0], y0 + pi[k1]};
          const int zz[2] = {z0 + pj[0], z0 + pj[k1]};
          T v[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (k && !pin[1]) continue;
            if (kProbe & 4) {
              T d;
              v[k] = residual(x, pi[k], pj[k], bcur[k], &d);
            } else {
              v[k] = interp_with<T>(ci, qcg, x, yy[k], zz[k], [&] {
                T d;
                const T r = residual(x, pi[k], pj[k], bcur[k], &d);
                return A::div(r, d);
              });
            }
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (k && !pin[1]) continue;
            const T q0 = qs(x)[(pi[k] + 1) * PW + C0 + pj[k]];
            out[x * sx + yy[k] * sy + zz[k]] = A::add(q0, v[k]);
          }
        }
      } else {
        // two independent residual chains, but one at a time beside the
        // restriction, whose registers and theirs together spill
        constexpr int kChains = MODE == kRestrict ? 1 : 2;
        T d[2], r[2];
#pragma unroll kChains
        for (int k = 0; k < 2; ++k)
          r[k] = residual(x, pi[k], pj[k], bcur[k], &d[k]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (!pe[k]) continue;
          const int y = y0 + pi[k], z = z0 + pj[k];
          if constexpr (MODE == kRestrict) {
            rs(x)[pi[k] * RC + pj[k]] = r[k];
            if (a.emit_res && pin[k] && x >= xt && pi[k] >= LO && pj[k] >= LO)
              res[x * sx + y * sy + z] = r[k];
          } else if constexpr (MODE == kRes) {
            if (pin[k]) out[x * sx + y * sy + z] = r[k];
          } else {
            if (pin[k]) acc = A::add(acc, A::mul(r[k], r[k]));
          }
        }
      }
    }

    if constexpr (MODE == kRestrict) {
      // the CI planes of the next restriction (plane p - 2) into L2
      const int xn = p - 2;
      if (xn >= xt && xn < xe && (xn & 1) == 0 && !(kProbe & 4)) {
        for (int c = xn >> 1; c <= (xn >> 1) + 1; ++c)
          prefetch(ci_p, cplane, a.nxc + 1, a.nyc + 1, a.nzc + 1, 26, c, yc0,
                   ty / 2 + 1, zc0, TZ / 2 + 1);
      }
    } else if constexpr (MODE == kInterp) {
      // the CI plane and the coarse planes of the next plane (p) into L2
      if (p >= xr0 && p < xe && !(kProbe & 4)) {
        const int cy = y0 >> 1, cz = z0 >> 1;
        prefetch(ci_p, cplane, a.nxc + 1, a.nyc + 1, a.nzc + 1, 26,
                 (p >> 1) + (p & 1), cy, ty / 2 + 2, cz, TZ / 2 + 2);
        for (int c = p >> 1; c <= (p >> 1) + (p & 1); ++c)
          prefetch(qc_p, 0, a.nxc, a.nyc, a.nzc, 1, c, cy, ty / 2 + 2, cz,
                   TZ / 2 + 2);
      }
    }
  }
  wait_async<0>();

  if constexpr (MODE == kNorm) {
    const T tot = block_sum(acc);
    if (tid == 0)
      out[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
          blockIdx.x] = tot;
  }
}

// The plan of an edge launch (ops/cuda_fused3.py `edge_plan`): tile rows,
// x chunk, grid and shared-memory bytes.
struct EdgePlan {
  int ty, cx, gz, gy, gc;
  long long smem;
};

template <typename T, int MODE>
int launch(const void* so, const void* q, const void* b, const void* ci,
           const void* qc, void* out, void* res, const EdgeDims& d,
           const EdgePlan& p, cudaStream_t st) {
  using E = Edge<T, MODE>;
  // the plan must be this variant's and cover the grid once, with tiles
  // and chunks at even indices and at most two window points a thread; no
  // output may alias an input
  if (p.ty < 2 || (p.ty & 1) || p.cx < 2 || (p.cx & 1) ||
      E::rows(p.ty) * E::RC > 2 * kThreads ||
      p.smem != E::words(p.ty) * (long long)sizeof(T) ||
      p.gz != (d.nz + E::TZ - 1) / E::TZ || p.gy != (d.ny + p.ty - 1) / p.ty ||
      p.gc != (d.nx + p.cx - 1) / p.cx || out == q || out == b ||
      out == so || (res && (res == q || res == b)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row of so and q starts at a 16-byte boundary
  const bool vec = d.nz % E::V == 0 && (size_t)so % 16 == 0 &&
                   (size_t)q % 16 == 0;
  auto fn = vec ? edge3<T, MODE, true> : edge3<T, MODE, false>;
  // above 48 KB with block_sum's static array included
  if (p.smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<dim3(p.gz, p.gy, p.gc), kThreads, p.smem, st>>>(
      (const T*)so, (const T*)q, (const T*)b, (const T*)ci, (const T*)qc,
      (T*)out, (T*)res, d);
  return (int)cudaGetLastError();
}

// an edge variant launched (go true), or its shared-memory bytes with
// tiles of ty rows (-1: no such mode)
template <typename T>
long long planned(bool go, int mode, const void* so, const void* q,
                  const void* b, const void* ci, const void* qc, void* out,
                  void* res, const EdgeDims& d, const EdgePlan& p,
                  cudaStream_t st) {
#define CEDAR_EDGE(M)                                                        \
  case M:                                                                    \
    return go ? launch<T, M>(so, q, b, ci, qc, out, res, d, p, st)           \
              : Edge<T, M>::words(p.ty) * (long long)sizeof(T);
  switch (mode) {
    CEDAR_EDGE(kRes)
    CEDAR_EDGE(kNorm)
    CEDAR_EDGE(kRestrict)
    CEDAR_EDGE(kInterp)
  }
#undef CEDAR_EDGE
  return go ? (long long)cudaErrorInvalidValue : -1;
}

}  // namespace
}  // namespace cedar

extern "C" {

// The threads of an edge block, and its own tile columns in dtype
// (ops/cuda_fused3.py `edge_plan` reads them).
int cedar_edge3_threads() { return cedar::kThreads; }
int cedar_edge3_cols(int dtype) {
  return dtype == cedar::kFloat64 ? cedar::Edge<double, cedar::kRes>::TZ
                                  : cedar::Edge<float, cedar::kRes>::TZ;
}

// The shared-memory bytes of the edge kernel in mode with tiles of ty rows
// (-1: no such mode or dtype): what ops/cuda_fused3.py `edge_plan` computes.
int cedar_edge3_smem(int dtype, int mode, int ty) {
  const cedar::EdgeDims d{};
  const cedar::EdgePlan p{ty, 0, 0, 0, 0, 0};
  if (dtype == cedar::kFloat32)
    return (int)cedar::planned<float>(false, mode, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, d,
                                      p, nullptr);
  if (dtype == cedar::kFloat64)
    return (int)cedar::planned<double>(false, mode, nullptr, nullptr,
                                       nullptr, nullptr, nullptr, nullptr,
                                       nullptr, d, p, nullptr);
  return -1;
}

// The edge kernel in mode (1 res, 2 norm, 3 restrict, 4 interp) on the
// 27-point (nx, ny, nz) level: restrict out = cb (nxc, nyc, nzc) = Pᵀ (b -
// A q), res = b - A q when emit_res; res out = b - A q; norm out[block] =
// Σ (b - A q)² over the block's points; interp out = q + (b - A q)/diag + P
// qc (q is q_pre); on the plan (ty, cx, gz, gy, gc, smem) of
// ops/cuda_fused3.py `edge_plan`.  Returns a CUDA error code.
int cedar_edge3(int dtype, int mode, const void* so, const void* q,
                const void* b, const void* ci, const void* qc, void* out,
                void* res, int nx, int ny, int nz, int nxc, int nyc, int nzc,
                int emit_res, int ty, int cx, int gz, int gy, int gc,
                long long smem, void* stream) {
  const cedar::EdgeDims d{nx, ny, nz, nxc, nyc, nzc, ty, cx, emit_res};
  const cedar::EdgePlan p{ty, cx, gz, gy, gc, smem};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return (int)cedar::planned<float>(true, mode, so, q, b, ci, qc, out, res,
                                      d, p, st);
  if (dtype == cedar::kFloat64)
    return (int)cedar::planned<double>(true, mode, so, q, b, ci, qc, out,
                                       res, d, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
