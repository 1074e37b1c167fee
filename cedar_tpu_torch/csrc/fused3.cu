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
// the dense (nx, ny, nz) grid and compute what those compute.  The math is
// ops/fused3.py's plain versions, which compose relax3.sweep3_torch,
// stencil3.residual, interp3.restrict_torch and interp3.interp_add_torch;
// the arithmetic comes from stencil3.cuh (`offdiag_at`) and transfer3.cuh
// (`restrict_value`, `interp_value`), so each output equals the separate
// kernels K6, K7 and K8 in sequence bit for bit.
//
// What bounds them on the H100: bytes.  A 7-point sweep reads 4 stencil
// planes, b and q and writes q (about 0.5 flop per byte); the dense
// sequence moves q through device memory once per colour phase and once
// more for the residual, and K6 idles the threads of the other colours.
//
// Design: 2.5D blocking, the Hopper form of the TPU's wavefront
// (pallas3_stream.py:1-29).  A block owns a y-z tile of TY x TZ points
// and a chunk of cx planes along x, and marches along x through its chunk
// one plane a step.  A pass is a list of stages (K16's interpolation, the
// colour phases, the residual epilogue, K15's restriction); at step p the
// block holds planes up to p in rolling windows of planes in shared memory
// and applies stage s to plane p - s, s = 1, 2, ...  Stage s at plane x
// reads planes x - 1 .. x + 1 of the window.  That is exact: plane x + 1
// holds the state after stage s - 1 (it got stage s - 1 earlier in the
// same step), plane x - 1 the state after stage s, which differs from the
// state after s - 1 only at points of the colour of stage s, and a point
// couples to no point of its own colour.  So one in-place copy of each
// plane serves every stage.
//
// Each stage also stales one ring of the y-z region and one plane at each
// end of the chunk, so the region carries a halo of H = (number of
// stages) rings and the chunk H planes at each end, recomputed by the
// neighbouring blocks: stage s updates points at depth >= s (the depth of
// a point is its distance in rings or planes from the region's edge; the
// grid's own boundary counts as infinitely deep, its couplings are zero).
// The region is kRW = 64 columns (z) wide, TZ = 64 - 2H, and TY + 2H rows.
//
// Latency, not bandwidth, is what this loses to: a step's stages are a
// short chain of dependent work on one plane, and a load from device
// memory waits ~1 µs.  So plane p + 1 is prefetched into registers while
// the stages of step p run, and stored into the windows at the end of the
// step; for a 7-point f32 pass the stencil planes and b are windowed too
// (the 27-point stencil's 14 planes, and f64, would not fit), so that its
// stages read shared memory only, apart from K16's CI and coarse values
// and K15's CI.  In a 7-point pass a thread keeps its points through
// every stage of a step (see the step loop), so the stages need no
// barrier between them.  A phase maps its threads onto its own colour's
// points only, so no thread idles on another colour.  K16 gives each
// warp the points of one parity class at a time and issues the class's
// CI and coarse loads before it recomputes the residual
// (transfer3.cuh `interp_with`).
//
// A 27-point sweep runs as eight passes of one colour (cedar_fused3_colors;
// K14 for each pass but the last of a pre-sweep, which is K15, and the
// first of a post-sweep, which is K16), as the JAX kernel splits a sweep
// into passes when one does not fit (pallas3_split.py `_plan_split`): its
// couplings reach diagonally into the next plane, so its stages need a
// barrier each, its so planes come from device memory, and each phase of a
// pass adds a ring of halo on a grid that is already small (128³ at most
// on the 256³ problem's 27-point levels).  Smaller blocks (8 warps, 4 an
// SM) hide the latency of those loads.  The x chunk length cx is chosen
// so that the card gets about kTargetBlocks blocks, and at least 2H
// planes, to bound the recomputed halo planes.
//
// Out of place: a block reads q_in over its region while other blocks
// write their tiles, so each kernel reads q_in and writes a separate
// q_out (the wrappers in ops/cuda_fused3.py allocate it).  K15's tiles and
// chunks start at even indices, so each coarse point (2i, 2j, 2k) has
// exactly one owner block; its residual window covers the tile plus the
// low ring (the restriction reads fine indices 2c - 1 .. 2c + 1).  The
// norm epilogue writes one partial a block (the sum of res² over the
// block's own points, in no fixed order against the plain version's sum)
// into a buffer of cedar_fused3_partials entries; the caller sums it.

#include "stencil3.cuh"
#include "transfer3.cuh"

namespace cedar {
namespace {

constexpr int kRW = 64;                  // region columns (z)
// epilogues: nothing, the residual, the norm partials, residual + restrict
constexpr int kNone = 0, kRes = 1, kNorm = 2, kRestrict = 3;
// blocks a launch aims at: four for each of the H100's 132 SMs
constexpr int kTargetBlocks = 528;
constexpr int kTileRows = 16;            // TY
// warps a block and resident blocks an SM, at least: 7-point, 27-point
constexpr int kWarps7 = 16, kMinBlocks7 = 1;
constexpr int kWarps27 = 8, kMinBlocks27 = 4;
constexpr int kStaged = 5;               // windowed arrays: so planes 0-3, b
constexpr int kPhases27 = 1;             // 27-point colours a pass

__host__ __device__ constexpr int warps_of(bool ts) {
  return ts ? kWarps27 : kWarps7;
}
__host__ __device__ constexpr int min_blocks(bool ts) {
  return ts ? kMinBlocks27 : kMinBlocks7;
}
// colour phases of a pass (a 7-point sweep is one pass)
__host__ __device__ constexpr int phases_of(bool ts) {
  return ts ? kPhases27 : 2;
}
// the stage of the last phase, of the residual epilogue, and their number:
// the halo H in rings and planes
__host__ __device__ constexpr int last_phase(bool ts, bool interp) {
  return interp + phases_of(ts);
}
__host__ __device__ constexpr int epi_stage(bool ts, bool interp, int epi) {
  return last_phase(ts, interp) + (epi != kNone);
}
__host__ __device__ constexpr int halo(bool ts, bool interp, int epi) {
  return epi_stage(ts, interp, epi) + (epi == kRestrict);
}
// the stencil planes and b windowed in shared memory: 7-point f32
__host__ __device__ constexpr bool staged(bool ts, int elem) {
  return !ts && elem == 4;
}
// planes a window holds: q (or K16's interpolated q), stage s reading back
// to plane p - SE - 1 while plane p + 1 arrives; K16's q_pre (p - 2 .. p);
// the stencil and b (p - SE .. p)
__host__ __device__ constexpr int q_slots(bool ts, bool interp, int epi) {
  return epi_stage(ts, interp, epi) + (interp ? 1 : 2);
}
__host__ __device__ constexpr int s_slots(bool ts, bool interp, int epi) {
  return epi_stage(ts, interp, epi) + 1;
}
constexpr int kPreSlots = 3, kResSlots = 3;

__host__ __device__ constexpr size_t smem_words(bool ts, bool interp,
                                                int epi, int elem) {
  const int h = halo(ts, interp, epi), ry = kTileRows + 2 * h;
  const int tz = kRW - 2 * h, pl = ry * kRW;
  return (size_t)q_slots(ts, interp, epi) * pl +
         (interp ? kPreSlots * pl : 0) +
         (staged(ts, elem) ? (size_t)kStaged * s_slots(ts, interp, epi) * pl
                           : 0) +
         (epi == kRestrict ? kResSlots * (kTileRows + 1) * (tz + 1) : 0);
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

struct Plan {
  dim3 grid;
  int cx;
  size_t smem;
};

inline Plan plan(bool ts, bool interp, int epi, int nx, int ny, int nz,
                 int elem) {
  const int h = halo(ts, interp, epi), tz = kRW - 2 * h;
  const int gz = (nz + tz - 1) / tz, gy = (ny + kTileRows - 1) / kTileRows;
  const int chunks = (kTargetBlocks + gz * gy - 1) / (gz * gy);
  int cx = (nx + chunks - 1) / chunks;
  cx += cx & 1;
  if (cx < 2 * h) cx = 2 * h;
  return Plan{dim3(gz, gy, (nx + cx - 1) / cx), cx,
              smem_words(ts, interp, epi, elem) * elem};
}

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

// One pass on a y-z tile and an x chunk (see the header note).  K14:
// INTERP false, EPI kNone / kRes / kNorm; K15: EPI kRestrict; K16: INTERP
// true (q_in is q_pre).  Region row r goes to warp r % NW and columns 2l,
// 2l + 1 to lane l (a phase: the one of its colour; 27-point phases take
// the rows of their colour only).
template <typename T, bool TS, bool INTERP, int EPI>
__global__ void __launch_bounds__(32 * warps_of(TS), min_blocks(TS))
fused3(const T* __restrict__ so, const T* __restrict__ q_in,
       const T* __restrict__ b, const T* __restrict__ ci_p,
       const T* __restrict__ qc, T* __restrict__ q_out, T* __restrict__ res,
       T* __restrict__ cb, T* __restrict__ partials, const Dims a) {
  using A = Arith<T>;
  constexpr bool ST = staged(TS, sizeof(T));
  constexpr int NPH = phases_of(TS);
  constexpr int SP = last_phase(TS, INTERP);
  constexpr int SE = epi_stage(TS, INTERP, EPI);
  constexpr int H = halo(TS, INTERP, EPI);
  constexpr int WQ = q_slots(TS, INTERP, EPI), WS = s_slots(TS, INTERP, EPI);
  constexpr int TY = kTileRows, TZ = kRW - 2 * H, RY = TY + 2 * H;
  constexpr int PL = RY * kRW;              // one plane of the region
  constexpr int RW = TZ + 1, RPL = (TY + 1) * RW;  // residual window plane
  constexpr int NW = warps_of(TS), NT = 32 * NW;
  constexpr int NL = (PL + NT - 1) / NT;    // loads a thread
  // rows a warp takes in a stage (27-point phases: rows of one parity);
  // unrolled for 7-point, where it overlaps the rows' loads, but not for
  // 27-point, whose 64-register budget it would spill
  constexpr int MR = (RY + NW - 1) / NW, MR2 = (RY / 2 + NW - 1) / NW;
  constexpr int UR = TS ? 1 : MR;
  constexpr int NS = ST ? kStaged : 0;

  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long sy = nz, sx = (long long)ny * nz, N = sx * nx;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);      // WQ planes of q
  T* spre = sq + WQ * PL;                  // q_pre planes (K16)
  T* sso = spre + (INTERP ? kPreSlots * PL : 0);  // stencil and b planes
  T* sres = sso + (ST ? kStaged * WS * PL : 0);   // residual planes (K15)
  // the window slot of plane x (x >= -8)
  auto slot = [&](int x) { return sq + ((x + 8 * WQ) % WQ) * PL; };
  auto pslot = [&](int x) { return spre + ((x + 8 * kPreSlots) % kPreSlots) * PL; };
  auto sslot = [&](int x) { return sso + ((x + 8 * WS) % WS) * kStaged * PL; };
  auto rslot = [&](int x) { return sres + ((x + 8 * kResSlots) % kResSlots) * RPL; };

  const int zt = blockIdx.x * TZ, yt = blockIdx.y * TY, xt = blockIdx.z * a.cx;
  const int z0 = zt - H, y0 = yt - H;  // the region's origin
  const int xe = min(xt + a.cx, nx);   // own planes [xt, xe)
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  // stage s runs at plane x where x lies at depth >= s in the chunk
  auto valid = [&](int x, int s) {
    return x >= max(xt - H + s, 0) && x < min(xt + a.cx + H - s, nx);
  };
  // b - A q at (x, y, z), held at offset o of the window planes (lo, mid,
  // hi) of q
  auto residual_at = [&](const T* qm, const T* q0, const T* qp, int o, int x,
                         int y, int z) -> T {
    const long long i = x * sx + y * sy + z;
    const T* s0 = ST ? sslot(x) + o : so + i;
    const T* sp = ST ? sslot(x + 1) + o : so + i + sx;
    const T bv = ST ? s0[4 * PL] : b[i];
    return A::sub(
        A::add(bv, offdiag_at<T, TS>(s0, sp, ST ? PL : N, ST ? kRW : sy,
                                     x > 0, x + 1 < nx, y > 0, y + 1 < ny,
                                     z > 0, z + 1 < nz, qm + o, q0 + o,
                                     qp + o, kRW)),
        A::mul(s0[0], q0[o]));
  };

  // plane x of the input (and of so and b when windowed) into registers,
  // zero off the grid (never read: their couplings are zero); thread tid
  // takes column tid % 64 of rows tid / 64 + 8k
  T vq[NL], vs[NS > 0 ? NS : 1][NL];
  auto prefetch = [&](int x) {
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int e = tid + k * NT, r = e / kRW, c = e % kRW;
      const int y = y0 + r, z = z0 + c;
      const bool in = e < PL && y >= 0 && y < ny && z >= 0 && z < nz;
      const long long i = x * sx + y * sy + z;
      vq[k] = in ? q_in[i] : T(0);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        vs[s][k] = in ? (s < 4 ? so[s * N + i] : b[i]) : T(0);
    }
  };
  auto commit = [&](int x) {
    T* dq = INTERP ? pslot(x) : slot(x);
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int e = tid + k * NT;
      if (e >= PL) break;
      dq[e] = vq[k];
#pragma unroll
      for (int s = 0; s < NS; ++s) sslot(x)[s * PL + e] = vs[s][k];
    }
  };

  const CI3<T> ci = make_ci(ci_p, a.nxc, a.nyc, a.nzc);
  T acc = T(0);
  const int p0 = max(xt - H, 0), load_end = min(xt + a.cx + H, nx);
  prefetch(p0);
  commit(p0);
  __syncthreads();
  // A 7-point stage hands each point to the next stage in the same thread:
  // row r of the region belongs to warp r % NW and columns 2l, 2l + 1
  // to lane l, in every stage.  Stage s + 1 at plane x - 1 reads plane x
  // only at its own point, which stage s updated earlier in the same
  // thread, and its in-plane neighbours were final a step before; so the
  // stages of a step need no barrier between them.  27-point couplings
  // reach diagonally into the next plane, so its stages do.  The barrier
  // at the end of a step lets the prefetched plane overwrite the oldest
  // slots.
  for (int p = p0; p < xe + H; ++p) {
    const bool more = p + 1 < load_end;
    if (more) prefetch(p + 1);

    if (INTERP) {
      // stage 1: K8's expression, q_pre + (res/diag (off the coincident
      // points) + P qc), with res = b - A q_pre from the q_pre window
      const int x = p - 1;
      if (valid(x, 1)) {
        T* dst = slot(x);
        const T *pm = pslot(x - 1), *p0w = pslot(x), *pp = pslot(x + 1);
#pragma unroll UR
        for (int m = 0; m < MR; ++m) {
          const int r = warp + NW * m;
          const int y = y0 + r;
          if (r < 1 || r >= RY - 1 || y < 0 || y >= ny) continue;
          // a lane's two columns in turn, so that the points of a warp
          // share a parity class (one branch of interp_with)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 2 * lane + j, z = z0 + c;
            if (c < 1 || c >= kRW - 1 || z < 0 || z >= nz) continue;
            const int o = r * kRW + c;
            dst[o] = A::add(
                p0w[o], interp_with(ci, qc, x, y, z, a.nxc, a.nyc, a.nzc, [&] {
                  return A::div(residual_at(pm, p0w, pp, o, x, y, z),
                                ST ? sslot(x)[o] : so[x * sx + y * sy + z]);
                }));
          }
        }
      }
      if (TS) __syncthreads();
    }

    // the colour phases: q = (b + Σ coupling·q_nb) * (1/P) at the
    // colour's points; colours anchor at (x + ox, y + oy, z + oz):
    // 7-point (gx + gy + gz) % 2 == color, 27-point gx % 2 == color & 1,
    // gy % 2 == color >> 1 & 1, gz % 2 == color >> 2 & 1.  27-point
    // phases run on the planes and rows of the colour's parities only.
#pragma unroll
    for (int k = 0; k < NPH; ++k) {
      const int s = INTERP + 1 + k, x = p - s;
      const int color = (a.colors >> (4 * k)) & 15;
      if (valid(x, s) && (!TS || ((x + a.ox - color) & 1) == 0)) {
        const int r0 = TS ? s + ((((color >> 1) & 1) - y0 - a.oy - s) & 1) : 0;
        T* qx = slot(x);
        const T *qm = slot(x - 1), *qp = slot(x + 1);
#pragma unroll UR
        for (int m = 0; m < (TS ? MR2 : MR); ++m) {
          const int r = r0 + (TS ? 2 : 1) * (warp + NW * m);
          const int y = y0 + r;
          if (r < s || r >= RY - s || y < 0 || y >= ny) continue;
          const int cpar =
              TS ? (color >> 2) & 1 : color - (x + a.ox) - (y + a.oy);
          const int c = 2 * lane + ((cpar - z0 - a.oz) & 1);
          const int z = z0 + c;
          if (c < s || c >= kRW - s || z < 0 || z >= nz) continue;
          const long long i = x * sx + y * sy + z;
          const int o = r * kRW + c;
          const T* s0 = ST ? sslot(x) + o : so + i;
          const T* sp = ST ? sslot(x + 1) + o : so + i + sx;
          const T bv = ST ? s0[4 * PL] : b[i];
          qx[o] = A::mul(
              A::add(bv, offdiag_at<T, TS>(s0, sp, ST ? PL : N, ST ? kRW : sy,
                                           x > 0, x + 1 < nx, y > 0,
                                           y + 1 < ny, z > 0, z + 1 < nz,
                                           qm + o, qx + o, qp + o, kRW)),
              A::div(T(1), s0[0]));
        }
      }
      if (TS) __syncthreads();
    }

    {
      // plane p - SP is final: its own tile to q_out
      const int x = p - SP;
      if (x >= xt && x < xe) {
        const T* src = slot(x);
#pragma unroll UR
        for (int m = 0; m < MR; ++m) {
          const int r = warp + NW * m;
          const int y = y0 + r;
          if (r < H || r >= H + TY || y >= ny) continue;
          T* dst = q_out + x * sx + y * sy;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 2 * lane + j, z = z0 + c;
            if (c >= H && c < H + TZ && z < nz) dst[z] = src[r * kRW + c];
          }
        }
      }
    }

    if (EPI == kRes || EPI == kNorm) {
      // the residual of the block's own points of plane p - SE
      const int x = p - SE;
      if (x >= xt && x < xe) {
        const T *qm = slot(x - 1), *q0 = slot(x), *qp = slot(x + 1);
#pragma unroll UR
        for (int m = 0; m < MR; ++m) {
          const int r = warp + NW * m;
          const int y = y0 + r;
          if (r < H || r >= H + TY || y >= ny) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 2 * lane + j, z = z0 + c;
            if (c < H || c >= H + TZ || z >= nz) continue;
            const T rv = residual_at(qm, q0, qp, r * kRW + c, x, y, z);
            if (EPI == kRes)
              res[x * sx + y * sy + z] = rv;
            else
              acc = A::add(acc, A::mul(rv, rv));
          }
        }
      }
    }

    if (EPI == kRestrict) {
      // the residual of plane p - SE over the tile and its low ring (zero
      // off the grid) into the residual window, and to res on request
      const int x = p - SE;
      if (x >= max(xt - 1, 0) && x < xe) {
        const T *qm = slot(x - 1), *q0 = slot(x), *qp = slot(x + 1);
        T* dst = rslot(x);
#pragma unroll UR
        for (int m = 0; m < MR; ++m) {
          const int r = warp + NW * m;
          if (r < H - 1 || r >= H + TY) continue;
          const int y = y0 + r;
          const bool own = a.emit_res && x >= xt && r >= H;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 2 * lane + j, z = z0 + c;
            if (c < H - 1 || c >= H + TZ) continue;
            T rv = T(0);
            if (y >= 0 && y < ny && z >= 0 && z < nz) {
              rv = residual_at(qm, q0, qp, r * kRW + c, x, y, z);
              if (own && c >= H) res[x * sx + y * sy + z] = rv;
            }
            dst[(r - H + 1) * RW + (c - H + 1)] = rv;
          }
        }
      }
    }

    __syncthreads();
    if (EPI == kRestrict) {
      // cb at the coarse points of plane p - SE - 1 that the block owns
      // (an even plane of the chunk)
      const int x = p - SE - 1;
      if (x >= xt && x < xe && (x & 1) == 0) {
        const int xc = x >> 1;
        for (int e = tid; e < (TY / 2) * (TZ / 2); e += NT) {
          const int yc = yt / 2 + e / (TZ / 2), zc = zt / 2 + e % (TZ / 2);
          if (yc >= a.nyc || zc >= a.nzc) continue;
          auto fine = [&](int ox, int oy, int oz) -> T {
            const int fx = x + ox, fy = 2 * yc + oy, fz = 2 * zc + oz;
            return (fx >= 0 && fx < nx && fy >= 0 && fy < ny && fz >= 0 &&
                    fz < nz)
                       ? rslot(fx)[(fy - yt + 1) * RW + (fz - zt + 1)]
                       : T(0);
          };
          cb[((long long)xc * a.nyc + yc) * a.nzc + zc] =
              restrict_value(ci, fine, xc, yc, zc);
        }
      }
    }
    if (more) commit(p + 1);
    __syncthreads();
  }

  if (EPI == kNorm) {
    const T tot = block_sum<NW>(acc);
    if (tid == 0)
      partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
               blockIdx.x] = tot;
  }
}

template <typename T, bool TS, bool INTERP, int EPI>
int launch(const Args& a, cudaStream_t st) {
  const Plan pl = plan(TS, INTERP, EPI, a.nx, a.ny, a.nz, sizeof(T));
  const Dims d{a.nx, a.ny, a.nz, a.nxc, a.nyc, a.nzc, pl.cx, a.colors,
               a.ox, a.oy, a.oz, a.emit_res};
  auto fn = fused3<T, TS, INTERP, EPI>;
  // above 48 KB with block_sum's static array included
  if (pl.smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<pl.grid, dim3(32, warps_of(TS)), pl.smem, st>>>(
      (const T*)a.so, (const T*)a.q_in, (const T*)a.b, (const T*)a.ci,
      (const T*)a.qc, (T*)a.q_out, (T*)a.res, (T*)a.cb, (T*)a.partials, d);
  return (int)cudaGetLastError();
}

// K14 (INTERP false) or K16 (INTERP true) with epilogue `mode`; a 27-point
// K16 pass is the first of two and takes none.
template <typename T, bool INTERP>
int launch_mode(const Args& a, int ts, int mode, cudaStream_t st) {
  if (ts) {
    if constexpr (INTERP) {
      return mode == kNone ? launch<T, true, true, kNone>(a, st)
                           : (int)cudaErrorInvalidValue;
    } else {
      switch (mode) {
        case kNone: return launch<T, true, false, kNone>(a, st);
        case kRes: return launch<T, true, false, kRes>(a, st);
        case kNorm: return launch<T, true, false, kNorm>(a, st);
      }
      return (int)cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    case kNone: return launch<T, false, INTERP, kNone>(a, st);
    case kRes: return launch<T, false, INTERP, kRes>(a, st);
    case kNorm: return launch<T, false, INTERP, kNorm>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool INTERP>
int launch_dtype(int dtype, const Args& a, int ts, int mode,
                 cudaStream_t st) {
  if (dtype == kFloat32) return launch_mode<float, INTERP>(a, ts, mode, st);
  if (dtype == kFloat64) return launch_mode<double, INTERP>(a, ts, mode, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cedar

extern "C" {

// The colours a pass takes: 2 (a whole 7-point sweep) or, 27-point, the
// 8 colours of a sweep in 8 / cedar_fused3_colors(1) passes.
int cedar_fused3_colors(int ts) { return cedar::phases_of(ts); }

// The number of norm partials (of blocks) of a K14 (interp = 0) or K16
// (interp = 1) pass with the norm epilogue on an (nx, ny, nz) grid.
int cedar_fused3_partials(int interp, int ts, int nx, int ny, int nz) {
  const cedar::Plan pl = cedar::plan(ts, interp, cedar::kNorm, nx, ny, nz, 4);
  return (int)(pl.grid.x * pl.grid.y * pl.grid.z);
}

// K14: q_out = one pass (2 colours 7-point, 4 of the 8 27-point) of q_in;
// colors packs the colour codes in order, 4 bits each; mode 0 nothing
// more, 1 res = b - A q_out, 2 partials[block] = Σ res² over the block.
// Returns a CUDA error code (0 on success).
int cedar_sweep3_fused(int dtype, const void* so, const void* q_in,
                       const void* b, void* q_out, void* res, void* partials,
                       int nx, int ny, int nz, int ts, int colors, int ox,
                       int oy, int oz, int mode, void* stream) {
  const cedar::Args a{so, q_in, b, nullptr, nullptr, q_out, res, nullptr,
                      partials, nx, ny, nz, 0, 0, 0, colors, ox, oy, oz, 0};
  return cedar::launch_dtype<false>(dtype, a, ts, mode, (cudaStream_t)stream);
}

// K15: q_out = one pass of q_in, res = b - A q_out (written when
// emit_res), cb (nxc, nyc, nzc) = Pᵀ res.  Returns a CUDA error code.
int cedar_sweep_restrict3(int dtype, const void* so, const void* q_in,
                          const void* b, const void* ci, void* q_out,
                          void* res, void* cb, int nx, int ny, int nz,
                          int nxc, int nyc, int nzc, int ts, int colors,
                          int emit_res, void* stream) {
  const cedar::Args a{so, q_in, b, ci, nullptr, q_out, res, cb, nullptr,
                      nx, ny, nz, nxc, nyc, nzc, colors, 0, 0, 0, emit_res};
  cudaStream_t st = (cudaStream_t)stream;
  using cedar::kRestrict;
  if (dtype == cedar::kFloat32)
    return ts ? cedar::launch<float, true, false, kRestrict>(a, st)
              : cedar::launch<float, false, false, kRestrict>(a, st);
  if (dtype == cedar::kFloat64)
    return ts ? cedar::launch<double, true, false, kRestrict>(a, st)
              : cedar::launch<double, false, false, kRestrict>(a, st);
  return (int)cudaErrorInvalidValue;
}

// K16: q_out = one pass of q_pre + (b - A q_pre) / diag + P qc; mode as
// K14 (0 only for 27-point, whose second pass is a K14).  Returns a CUDA
// error code.
int cedar_interp_sweep3(int dtype, const void* ci, const void* qc,
                        const void* so, const void* b, const void* q_pre,
                        void* q_out, void* res, void* partials, int nx,
                        int ny, int nz, int nxc, int nyc, int nzc, int ts,
                        int colors, int mode, void* stream) {
  const cedar::Args a{so, q_pre, b, ci, qc, q_out, res, nullptr, partials,
                      nx, ny, nz, nxc, nyc, nzc, colors, 0, 0, 0, 0};
  return cedar::launch_dtype<true>(dtype, a, ts, mode, (cudaStream_t)stream);
}

}  // extern "C"
