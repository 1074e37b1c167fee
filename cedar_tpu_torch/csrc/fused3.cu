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
// the dense (nx, ny, nz) grid and compute what those compute.  K6's levels
// above one block (sweep3.cu) run on K14 too: the 7-point ring march and,
// for float32 levels of 128³ or more, the 27-point marches.  The math is
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
// The window design (`fused3`, 27-point only since the 7-point K14 moved to
// the ring design): 2.5D blocking, the Hopper form of the TPU's
// wavefront (pallas3_stream.py:1-29).  A block owns a y-z tile of TY x TZ
// points and a chunk of cx planes along x, and marches along x through
// its chunk one plane a step.  A pass is a list of stages (K16's
// interpolation, the colour phases, the residual epilogue, K15's
// restriction); at step p the block holds planes up to p in rolling
// windows of planes in shared memory and applies stage s to plane p - s,
// s = 1, 2, ...  Stage s at plane x reads planes x - 1 .. x + 1 of the
// window.  That is exact: plane x + 1 holds the state after stage s - 1
// (it got stage s - 1 earlier in the same step), plane x - 1 the state
// after stage s, which differs from the state after s - 1 only at points
// of the colour of stage s, and a point couples to no point of its own
// colour.  So one in-place copy of each plane serves every stage.
//
// Each stage also stales one ring of the y-z region and one plane at each
// end of the chunk, so the region carries a halo of H = (number of
// stages) rings and the chunk H planes at each end, recomputed by the
// neighbouring blocks: stage s updates points at depth >= s (the depth of
// a point is its distance in rings or planes from the region's edge; the
// grid's own boundary counts as infinitely deep, its couplings are zero).
// The region is kRW = 64 columns (z) wide, TZ = 64 - 2H, and TY + 2H rows.
//
// Plane p + 1 of q is prefetched into registers while the stages of step p
// run, and stored into the windows at the end of the step; the stencil's
// 14 planes and b come from device memory.  A phase maps its threads onto
// its own colour's points only, so no thread idles on another colour.
// K16 gives each warp the points of one
// parity class at a time and issues the class's CI and coarse loads
// before it recomputes the residual (transfer3.cuh `interp_with`).
//
// The 27-point K15 and K16 run one colour of a sweep each (the last of a
// pre-sweep, the first of a post-sweep; phases_of) on the window
// design, as the JAX kernel splits a sweep into passes when one does not
// fit (pallas3_split.py `_plan_split`): its couplings reach diagonally
// into the next plane, so its stages need a barrier each, its so planes
// come from device memory, and each phase of a pass adds a ring of halo on
// a grid that is already small (128³ at most on the 256³ problem's
// 27-point levels).  Smaller blocks (8 warps, 4 an SM) hide the latency
// of those loads.  The x chunk length cx is chosen so that the card gets
// about kTargetBlocks blocks, and at least 2H planes, to bound the
// recomputed halo planes.
//
// The 27-point K14 (`pass27`) runs the other colours, a launch a march of
// up to kStages27 colours (cedar_fused3_pass27_stages): the march of the
// window design, with a ring of q planes filled by cp.async two steps
// ahead.  The wrapper gives a march an aligned pair of positions of the
// colour order (one y and z parity), so that its colours read the same
// stencil rows.  The colours of a march alternate in x parity, so a colour
// stage works on every other step; on a step where it works, each thread
// updates one point of the stage's colour, whose 27 stencil values and b
// it gathered by cp.async into slots of its own on the stage's previous
// working step (float32 with at most 4 stages; otherwise they are read from
// device memory), so that no stage waits on device memory.  A step has one
// barrier, and one more after each colour stage that works.  A warp takes a
// pair of region rows; the tile rows, the x chunk and the grid come from
// the wrapper's plan (ops/cuda_fused3.py `pass27_plan`), checked at launch
// against `Pass27`.  A 27-point sweep whose residual or norm is asked for
// runs its last colour as a one-colour K14 of the window design (`fused3`),
// whose epilogue follows the colour's stage in the same march; in a march
// of two colours the epilogue would add a ring of halo and registers that
// spill.
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
// sweep where the window design took 0.37 (PERF.md §6).  The 27-point K15
// and K16 stay on `fused3`: on the card every ring
// variant measured for them (two to four blocks an SM, a copy warp, the
// coarse side through L2) was slower (PERF.md §6; tools/tune_fused3.py).
//
// Out of place: a block reads q_in over its region while other blocks
// write their tiles, so each kernel reads q_in and writes a separate
// q_out (the wrappers in ops/cuda_fused3.py allocate it).  K15's tiles and
// chunks start at even indices, so each coarse point (2i, 2j, 2k) has
// exactly one owner block; its residual window covers the tile plus the
// low ring (the restriction reads fine indices 2c - 1 .. 2c + 1).  The
// norm epilogue writes one partial a block (the sum of res² over the
// block's own points, in no fixed order against the plain version's sum):
// cedar_fused3_partials entries for the 27-point K14, the plan's blocks for
// the 7-point K14 and K16; the caller sums them.  K14-K16 launch on the
// wrapper's plan, which the launch checks against the kernel's own.

#include "async.cuh"
#include "stencil3.cuh"
#include "transfer3.cuh"

namespace cedar {
namespace {

constexpr int kRW = 64;                  // region columns (z)
// epilogues: nothing, the residual, the norm partials, residual + restrict
constexpr int kNone = 0, kRes = 1, kNorm = 2, kRestrict = 3;
// blocks a launch aims at: four for each of the H100's 132 SMs
constexpr int kTargetBlocks = 528;
constexpr int kTileRows = 16;            // TY of the window design
// the window design's warps a block and resident blocks an SM, at least
constexpr int kWarps27 = 8, kMinBlocks27 = 4;

// colour phases of a pass: both of a 7-point sweep (the ring design), one
// 27-point colour (the window design)
__host__ __device__ constexpr int phases_of(bool ts) { return ts ? 1 : 2; }
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
// planes a window holds: q (or K16's interpolated q), stage s reading back
// to plane p - SE - 1 while plane p + 1 arrives; K16's q_pre (p - 2 .. p)
__host__ __device__ constexpr int q_slots(bool interp, int epi) {
  return epi_stage(true, interp, epi) + (interp ? 1 : 2);
}
constexpr int kPreSlots = 3, kResSlots = 3;

// the shared-memory words of a window-design block
__host__ __device__ constexpr size_t smem_words(bool interp, int epi) {
  const int h = halo(true, interp, epi), ry = kTileRows + 2 * h;
  const int tz = kRW - 2 * h, pl = ry * kRW;
  return (size_t)q_slots(interp, epi) * pl + (interp ? kPreSlots * pl : 0) +
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

// the plan of a window-design launch
inline Plan plan(bool interp, int epi, int nx, int ny, int nz, int elem) {
  const int h = halo(true, interp, epi), tz = kRW - 2 * h;
  const int gz = (nz + tz - 1) / tz, gy = (ny + kTileRows - 1) / kTileRows;
  const int chunks = (kTargetBlocks + gz * gy - 1) / (gz * gy);
  int cx = (nx + chunks - 1) / chunks;
  cx += cx & 1;
  if (cx < 2 * h) cx = 2 * h;
  return Plan{dim3(gz, gy, (nx + cx - 1) / cx), cx,
              smem_words(interp, epi) * elem};
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

// One 27-point pass on a y-z tile and an x chunk (see the header note).
// K14: INTERP false, EPI kRes / kNorm; K15: EPI kRestrict; K16: INTERP true
// (q_in is q_pre), EPI kNone.  Region row r goes to warp r % NW and columns
// 2l, 2l + 1 to lane l (a phase: the one of its colour, on the rows of its
// colour only).
template <typename T, bool INTERP, int EPI>
__global__ void __launch_bounds__(32 * kWarps27, kMinBlocks27)
fused3(const T* __restrict__ so, const T* __restrict__ q_in,
       const T* __restrict__ b, const T* __restrict__ ci_p,
       const T* __restrict__ qc, T* __restrict__ q_out, T* __restrict__ res,
       T* __restrict__ cb, T* __restrict__ partials, const Dims a) {
  using A = Arith<T>;
  constexpr int NPH = phases_of(true);
  constexpr int SP = last_phase(true, INTERP);
  constexpr int SE = epi_stage(true, INTERP, EPI);
  constexpr int H = halo(true, INTERP, EPI);
  constexpr int WQ = q_slots(INTERP, EPI);
  constexpr int TY = kTileRows, TZ = kRW - 2 * H, RY = TY + 2 * H;
  constexpr int PL = RY * kRW;              // one plane of the region
  constexpr int RW = TZ + 1, RPL = (TY + 1) * RW;  // residual window plane
  constexpr int NW = kWarps27, NT = 32 * NW;
  constexpr int NL = (PL + NT - 1) / NT;    // loads a thread
  // rows a warp takes in a stage (a phase: rows of one parity), not
  // unrolled: it would spill the 64-register budget
  constexpr int MR = (RY + NW - 1) / NW, MR2 = (RY / 2 + NW - 1) / NW;

  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long sy = nz, sx = (long long)ny * nz, N = sx * nx;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);      // WQ planes of q
  T* spre = sq + WQ * PL;                  // q_pre planes (K16)
  T* sres = spre + (INTERP ? kPreSlots * PL : 0);  // residual planes (K15)
  // the window slot of plane x (x >= -8)
  auto slot = [&](int x) { return sq + ((x + 8 * WQ) % WQ) * PL; };
  auto pslot = [&](int x) { return spre + ((x + 8 * kPreSlots) % kPreSlots) * PL; };
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
    const T* s0 = so + i;
    return A::sub(
        A::add(b[i], offdiag_at<T, true>(s0, s0 + sx, N, sy, x > 0,
                                         x + 1 < nx, y > 0, y + 1 < ny,
                                         z > 0, z + 1 < nz, qm + o, q0 + o,
                                         qp + o, kRW)),
        A::mul(s0[0], q0[o]));
  };

  // plane x of the input into registers, zero off the grid (never read:
  // their couplings are zero); thread tid takes column tid % 64 of rows
  // tid / 64 + 8k
  T vq[NL];
  auto prefetch = [&](int x) {
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int e = tid + k * NT, r = e / kRW, c = e % kRW;
      const int y = y0 + r, z = z0 + c;
      const bool in = e < PL && y >= 0 && y < ny && z >= 0 && z < nz;
      const long long i = x * sx + y * sy + z;
      vq[k] = in ? q_in[i] : T(0);
    }
  };
  auto commit = [&](int x) {
    T* dq = INTERP ? pslot(x) : slot(x);
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int e = tid + k * NT;
      if (e >= PL) break;
      dq[e] = vq[k];
    }
  };

  const CI3<T> ci = make_ci(ci_p, a.nxc, a.nyc, a.nzc);
  T acc = T(0);
  const int p0 = max(xt - H, 0), load_end = min(xt + a.cx + H, nx);
  prefetch(p0);
  commit(p0);
  __syncthreads();
  // 27-point couplings reach diagonally into the next plane, so each stage
  // ends with a barrier.  The barrier at the end of a step lets the
  // prefetched plane overwrite the oldest slots.
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
#pragma unroll 1
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
                                so[x * sx + y * sy + z]);
                }));
          }
        }
      }
      __syncthreads();
    }

    // the colour phase: q = (b + Σ coupling·q_nb) * (1/P) at the colour's
    // points, gx % 2 == color & 1, gy % 2 == color >> 1 & 1, gz % 2 ==
    // color >> 2 & 1 (colours anchor at (x + ox, y + oy, z + oz)), on the
    // planes and rows of the colour's parities only
#pragma unroll
    for (int k = 0; k < NPH; ++k) {
      const int s = INTERP + 1 + k, x = p - s;
      const int color = (a.colors >> (4 * k)) & 15;
      if (valid(x, s) && ((x + a.ox - color) & 1) == 0) {
        const int r0 = s + ((((color >> 1) & 1) - y0 - a.oy - s) & 1);
        T* qx = slot(x);
        const T *qm = slot(x - 1), *qp = slot(x + 1);
#pragma unroll 1
        for (int m = 0; m < MR2; ++m) {
          const int r = r0 + 2 * (warp + NW * m);
          const int y = y0 + r;
          if (r < s || r >= RY - s || y < 0 || y >= ny) continue;
          const int c = 2 * lane + ((((color >> 2) & 1) - z0 - a.oz) & 1);
          const int z = z0 + c;
          if (c < s || c >= kRW - s || z < 0 || z >= nz) continue;
          const long long i = x * sx + y * sy + z;
          const int o = r * kRW + c;
          const T* s0 = so + i;
          qx[o] = A::mul(
              A::add(b[i], offdiag_at<T, true>(s0, s0 + sx, N, sy, x > 0,
                                               x + 1 < nx, y > 0, y + 1 < ny,
                                               z > 0, z + 1 < nz, qm + o,
                                               qx + o, qp + o, kRW)),
              A::div(T(1), s0[0]));
        }
      }
      __syncthreads();
    }

    {
      // plane p - SP is final: its own tile to q_out
      const int x = p - SP;
      if (x >= xt && x < xe) {
        const T* src = slot(x);
#pragma unroll 1
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
#pragma unroll 1
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
#pragma unroll 1
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


// The plan of a K15 or K16 launch (ops/cuda_fused3.py `plan`): tile rows,
// x chunk, grid and shared-memory bytes.
struct KPlan {
  int ty, cx, gz, gy, gc;
  long long smem;
};

// A `fused3` launch on its own plan; the 27-point K15 and K16 pass the
// wrapper's (want), which must be that plan.
template <typename T, bool INTERP, int EPI>
int launch(const Args& a, const KPlan* want, cudaStream_t st) {
  const Plan pl = plan(INTERP, EPI, a.nx, a.ny, a.nz, sizeof(T));
  if (want && (want->ty != kTileRows || want->cx != pl.cx ||
               want->gz != (int)pl.grid.x || want->gy != (int)pl.grid.y ||
               want->gc != (int)pl.grid.z ||
               want->smem != (long long)pl.smem))
    return (int)cudaErrorInvalidValue;
  const Dims d{a.nx, a.ny, a.nz, a.nxc, a.nyc, a.nzc, pl.cx, a.colors,
               a.ox, a.oy, a.oz, a.emit_res};
  auto fn = fused3<T, INTERP, EPI>;
  // above 48 KB with block_sum's static array included
  if (pl.smem + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<pl.grid, dim3(32, kWarps27), pl.smem, st>>>(
      (const T*)a.so, (const T*)a.q_in, (const T*)a.b, (const T*)a.ci,
      (const T*)a.qc, (T*)a.q_out, (T*)a.res, (T*)a.cb, (T*)a.partials, d);
  return (int)cudaGetLastError();
}

// The 27-point K14 on the window design with epilogue `mode`: one colour,
// the last of a sweep whose residual or norm is asked for (`pass27` runs
// the others).
template <typename T>
int launch_sweep(const Args& a, int mode, cudaStream_t st) {
  switch (mode) {
    case kRes: return launch<T, false, kRes>(a, nullptr, st);
    case kNorm: return launch<T, false, kNorm>(a, nullptr, st);
  }
  return (int)cudaErrorInvalidValue;
}

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
  static constexpr int SP = last_phase(false, INTERP);
  static constexpr int SE = epi_stage(false, INTERP, EPI);
  static constexpr int H = halo(false, INTERP, EPI);
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
// kRes / kNorm, 27-point kNone only) or the 7-point K14 (interp false, mode
// kNone / kRes / kNorm) launched on plan p (go true); or the shared-memory
// bytes of the kernel with p's tile rows (-1: none such).  7-point: the
// ring design; 27-point: the window design.
template <typename T>
int planned(bool go, const Args& a, int ts, int interp, int mode,
            const KPlan& p, cudaStream_t st) {
  const int bad = go ? (int)cudaErrorInvalidValue : -1;
  if (ts) {
    if (interp ? mode != kNone : mode != kRestrict) return bad;
    if (!go)
      return p.ty == kTileRows ? (int)(smem_words(interp, mode) * sizeof(T))
                               : -1;
    return interp ? launch<T, true, kNone>(a, &p, st)
                  : launch<T, false, kRestrict>(a, &p, st);
  }
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
      return interp ? bad : ring_rows<T, false, kRestrict>(go, a, p, st);
  }
  return bad;
}

int planned_dtype(int dtype, bool go, const Args& a, int ts, int interp,
                  int mode, const KPlan& p, cudaStream_t st) {
  if (dtype == kFloat32) return planned<float>(go, a, ts, interp, mode, p, st);
  if (dtype == kFloat64)
    return planned<double>(go, a, ts, interp, mode, p, st);
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

// The number of norm partials (of blocks) of a one-colour 27-point K14 of
// the window design with the norm epilogue on an (nx, ny, nz) grid.
int cedar_fused3_partials(int nx, int ny, int nz) {
  const cedar::Plan pl = cedar::plan(false, cedar::kNorm, nx, ny, nz, 4);
  return (int)(pl.grid.x * pl.grid.y * pl.grid.z);
}

// The blocks an SM that the 7-point K14's registers are capped for, and its
// tile rows in dtype (ops/cuda_fused3.py `plan` reads them).
int cedar_fused3_ring14_blocks() { return cedar::kMinBlocks14; }
int cedar_fused3_ring14_rows(int dtype) {
  return dtype == cedar::kFloat64 ? cedar::kRingRows14[1]
                                  : cedar::kRingRows14[0];
}

// The shared-memory bytes of the K15 (interp 0, mode 3), K16 (interp 1,
// mode 0-2) or 7-point K14 (ts 0, interp 0, mode 0-2) kernel with tiles of
// ty rows, or -1 if none is built: what ops/cuda_fused3.py `plan` computes.
int cedar_fused3_smem(int dtype, int ts, int interp, int mode, int ty) {
  const cedar::Args a{};
  const cedar::KPlan p{ty, 0, 0, 0, 0, 0};
  return cedar::planned_dtype(dtype, false, a, ts, interp, mode, p, nullptr);
}

// The 27-point K14 on the window design: q_out = one colour of q_in (code
// in colors), then mode 1 res = b - A q_out or 2 partials[block] = Σ res²
// over the block.  Returns a CUDA error code (0 on success).
int cedar_sweep3_fused(int dtype, const void* so, const void* q_in,
                       const void* b, void* q_out, void* res, void* partials,
                       int nx, int ny, int nz, int colors, int ox, int oy,
                       int oz, int mode, void* stream) {
  const cedar::Args a{so, q_in, b, nullptr, nullptr, q_out, res, nullptr,
                      partials, nx, ny, nz, 0, 0, 0, colors, ox, oy, oz, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32) return cedar::launch_sweep<float>(a, mode, st);
  if (dtype == cedar::kFloat64) return cedar::launch_sweep<double>(a, mode, st);
  return (int)cudaErrorInvalidValue;
}

// The 7-point K14 on the ring design: q_out = one whole sweep of q_in
// (colour codes packed as above), then mode 0 nothing more, 1 res = b -
// A q_out, 2 partials[block] = Σ res² over the block; on the plan (ty, cx,
// gz, gy, gc, smem) of ops/cuda_fused3.py `plan`.  Returns a CUDA error
// code.
int cedar_sweep3_ring(int dtype, const void* so, const void* q_in,
                      const void* b, void* q_out, void* res, void* partials,
                      int nx, int ny, int nz, int colors, int ox, int oy,
                      int oz, int mode, int ty, int cx, int gz, int gy,
                      int gc, long long smem, void* stream) {
  const cedar::Args a{so, q_in, b, nullptr, nullptr, q_out, res, nullptr,
                      partials, nx, ny, nz, 0, 0, 0, colors, ox, oy, oz, 0};
  const cedar::KPlan p{ty, cx, gz, gy, gc, smem};
  if (mode == cedar::kRestrict) return (int)cudaErrorInvalidValue;
  return cedar::planned_dtype(dtype, true, a, 0, 0, mode, p,
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

// K15: q_out = one pass of q_in, res = b - A q_out (written when
// emit_res), cb (nxc, nyc, nzc) = Pᵀ res, on the plan (ty, cx, gz, gy,
// gc, smem) of ops/cuda_fused3.py.  Returns a CUDA error code.
int cedar_sweep_restrict3(int dtype, const void* so, const void* q_in,
                          const void* b, const void* ci, void* q_out,
                          void* res, void* cb, int nx, int ny, int nz,
                          int nxc, int nyc, int nzc, int ts, int colors,
                          int emit_res, int ty, int cx, int gz, int gy,
                          int gc, long long smem, void* stream) {
  const cedar::Args a{so, q_in, b, ci, nullptr, q_out, res, cb, nullptr,
                      nx, ny, nz, nxc, nyc, nzc, colors, 0, 0, 0, emit_res};
  const cedar::KPlan p{ty, cx, gz, gy, gc, smem};
  return cedar::planned_dtype(dtype, true, a, ts, 0, cedar::kRestrict, p,
                              (cudaStream_t)stream);
}

// K16: q_out = one pass of q_pre + (b - A q_pre) / diag + P qc; mode as
// K14 (0 only for 27-point, whose second pass is a K14); plan as K15.
// Returns a CUDA error code.
int cedar_interp_sweep3(int dtype, const void* ci, const void* qc,
                        const void* so, const void* b, const void* q_pre,
                        void* q_out, void* res, void* partials, int nx,
                        int ny, int nz, int nxc, int nyc, int nzc, int ts,
                        int colors, int mode, int ty, int cx, int gz, int gy,
                        int gc, long long smem, void* stream) {
  const cedar::Args a{so, q_pre, b, ci, qc, q_out, res, nullptr, partials,
                      nx, ny, nz, nxc, nyc, nzc, colors, 0, 0, 0, 0};
  const cedar::KPlan p{ty, cx, gz, gy, gc, smem};
  return cedar::planned_dtype(dtype, true, a, ts, 1, mode, p,
                              (cudaStream_t)stream);
}

}  // extern "C"
