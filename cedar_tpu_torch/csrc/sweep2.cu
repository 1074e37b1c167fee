// K1: one 2D multicolour Gauss-Seidel sweep (+ the residual b - A q), one
// launch a sweep.
//
// Replaces the Pallas kernel cedar_tpu/ops/pallas2.py `_sweep_kernel`
// (called by `_point_relax_call` / `point_relax`), which runs all colour
// phases of a sweep and the optional residual in one kernel on a
// VMEM-resident row slab.  Its math is ops/relax2.py (masked phase update)
// and ops/stencil2.py (`offdiag_apply`, `residual`) of this package; the
// arithmetic comes from stencil2.cuh (`offdiag_terms2`), so a sweep equals
// relax2.sweep_torch bit for bit.
//
// What bounds it on the H100: bytes at the fine levels, and below them the
// latency of a launch and of its few dependent steps.  A sweep reads the
// coupling planes (3 for 5-point, 5 for 9-point), b and q and writes q:
// about 1 flop per byte.  On the V-cycle's main path K1 runs on the dense
// levels only (256² down to 8²), where each launch costs a few µs of
// latency whatever it moves, so a sweep is one launch at every shape, in
// one of two regimes that the wrapper's plan picks (ops/cuda2.py `plan`)
// and the launch checks:
//
// - Resident (`sweep_resident`): a level whose stencil planes, q and b fit
//   one block's shared memory (9-point float32 up to 90², float64 up to
//   64²) is loaded once by cp.async (16 bytes a copy where the arrays
//   allow), all colour phases run there with block barriers between them,
//   then the residual; the sweep is written once, to q_out.  One block on
//   one SM: its load is bound by what one SM can take in, so larger levels
//   go streamed (a cluster of blocks holding a level in distributed shared
//   memory was slower than the streamed launch at 128² and 256²; PERF.md
//   §6).  At 64² .. 8² 9-point float32 it takes 0.0034-0.0083 device ms a
//   sweep where the tile kernel takes 0.0044-0.0101 (PERF.md §6).
// - Streamed (`sweep_fused`, the tile design of tile2.cuh, shared with K11):
//   every other shape: tiles of q with a halo of one ring a phase in
//   shared memory, the stencil and b from device memory.
//
// Both regimes work out of place: q_in is left as it was.
//
// Batches of planes (3D plane relaxation's embedded point smoothers,
// ops/planes3.py; the Pallas sweep batched by `pallas_call`'s vmap rule
// under the JAX package's vmapped plane cycles, cedar_tpu/ops/pallas2.py
// `point_relax`): q, b and res (nb, nx, ny), the stencil (ndir, nb, nx,
// ny), one launch for every plane.  The plan is a plane's: the resident
// kernel takes one block a plane, the tile kernel blockIdx.z as the plane.
// Colours anchor to each plane's own origin, so every plane is swept as
// the unbatched sweep sweeps it, bit for bit.  Planes are never periodic.
//
// No point couples to a point of its own colour (red-black for 5-point,
// the (w%2, z%2) 4-colouring for 9-point), so a phase updates its colour
// from the others' values in any order.  Colours anchor at global indices
// (z + oz, w + ow).  Up-shifted couplings (to z+1 or w+1) read the
// neighbour's stored plane (W[z+1,w], S[z,w+1], NW[z+1,w], NW[z,w+1],
// SW[z+1,w+1]); a term whose neighbour lies outside the grid is exactly
// zero, which is what the zero-filled shifts of the reference give.
//
// Periodic mode (the Pallas sweep's `periodic`, cedar_tpu/ops/pallas2.py
// `_sweep_kernel`: lane rolls of the y couplings, wrapped x halo blocks, no
// high-edge mask under x-periodicity): on a periodic axis a neighbour at -1
// or n is the point n-1 or 0, and an up-shifted coupling at the last point
// reads the first one's plane (W[0,w] at z = nx-1; `shift2(..., periodic)`),
// so the zero rule above holds on non-periodic axes only, the residual
// included.  An odd extent along a periodic axis (a 400² grid coarsens to
// 25²) puts the last point and the first, neighbours, into one colour; the
// plain version then computes each point of a phase from the values before
// the phase.  The resident regime does so there (JAC): a phase computes
// its colour's points into registers, and writes them after a barrier;
// with even extents it updates in place, as without the wrap.  The
// streamed regime uses tile2.cuh's `sweep_wrap` (its Jacobi phases where
// an extent is odd).

#include "async.cuh"
#include "tile2.cuh"

namespace cedar {
namespace {

// threads of a resident block
constexpr int kResThreads = 1024;

// arrays a resident block holds, each nx rows of ny: the stencil planes,
// q, b
__host__ __device__ constexpr int resident_arrays(bool nine) {
  return (nine ? 5 : 3) + 2;
}

// a periodic resident phase's points a thread, in registers: a colour of a
// level that fits one block has at most this many points a thread
constexpr int kResPer = 8;

// K1, resident: one sweep of the level in shared memory, q_in read once
// and q_out written once, + res on request; vec: every array starts
// 16-byte aligned and holds a multiple of 16 bytes.  PER: the periodic
// mode, on the axes of wr; JAC: an odd extent along one of them (the
// header note).  Block p sweeps plane p of a batch of nb (the header
// note), the stencil planes of one plane nb*nx*ny words apart.
template <typename T, bool NINE, bool PER, bool JAC>
__global__ void __launch_bounds__(kResThreads)
sweep_resident(const T* __restrict__ so, const T* __restrict__ q_in,
               const T* __restrict__ b, T* __restrict__ q_out,
               T* __restrict__ res, int nx, int ny, int nb, int colors,
               int ncolors, int oz, int ow, int emit_res, int vec, Wrap wr) {
  using A = Arith<T>;
  constexpr int ND = resident_arrays(NINE) - 2, QA = ND, BA = ND + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  const int N = nx * ny;  // words an array
  const int tid = threadIdx.x, nth = blockDim.x;
  const long long pz = (long long)blockIdx.x * N, sd = (long long)nb * N;
  so += pz;
  q_in += pz;
  b += pz;
  q_out += pz;
  if (emit_res) res += pz;

  // every array, 16 bytes or one element a copy
  auto load = [&](int a, const T* src) {
    if (vec) {
      constexpr int V = 16 / sizeof(T);
      for (int e = tid * V; e < N; e += nth * V)
        copy_async16(sm + a * N + e, src + e);
    } else {
      for (int e = tid; e < N; e += nth)
        copy_async(sm + a * N + e, src + e, true);
    }
  };
#pragma unroll
  for (int d = 0; d < ND; ++d) load(d, so + d * sd);
  load(QA, q_in);
  load(BA, b);
  commit_async();
  wait_async<0>();
  __syncthreads();

  // Σ coupling · q at (z, w), offdiag_terms2's order, and b and the
  // diagonal there, all from shared memory (off-grid neighbours couple by
  // exactly zero and are not read)
  struct Pt {
    T off, b, diag;
    T* q;
  };
  auto point = [&](int z, int w) -> Pt {
    const int i = z * ny + w;
    T* q0 = sm + QA * N + i;
    T off;
    if constexpr (!PER) {
      const bool zl = z > 0, zh = z + 1 < nx, wl = w > 0, wh = w + 1 < ny;
      off = offdiag_terms2<T, NINE>([&](int dz, int dw, int d) -> T {
        const bool ok = (dz < 0 ? zl : dz > 0 ? zh : true) &&
                        (dw < 0 ? wl : dw > 0 ? wh : true);
        return ok ? A::mul(sm[d * N + i + (dz > 0 ? ny : 0) + (dw > 0 ? 1 : 0)],
                           q0[dz * ny + dw])
                  : T(0);
      });
    } else {
      // the neighbours' rows and columns, wrapped on the periodic axes
      const bool zl = wr.x || z > 0, zh = wr.x || z + 1 < nx;
      const bool wl = wr.y || w > 0, wh = wr.y || w + 1 < ny;
      const int zm = z == 0 ? nx - 1 : z - 1, zn = z + 1 == nx ? 0 : z + 1;
      const int wm = w == 0 ? ny - 1 : w - 1, wn = w + 1 == ny ? 0 : w + 1;
      off = offdiag_terms2<T, NINE>([&](int dz, int dw, int d) -> T {
        const bool ok = (dz < 0 ? zl : dz > 0 ? zh : true) &&
                        (dw < 0 ? wl : dw > 0 ? wh : true);
        const int zq = dz < 0 ? zm : dz > 0 ? zn : z;
        const int wq = dw < 0 ? wm : dw > 0 ? wn : w;
        return ok ? A::mul(sm[d * N + (dz > 0 ? zn : z) * ny +
                              (dw > 0 ? wn : w)],
                           sm[QA * N + zq * ny + wq])
                  : T(0);
      });
    }
    return Pt{off, sm[BA * N + i], sm[i], q0};
  };

  // the colour phases: q = (b + Σ coupling·q_nb) * (1/O) at the colour's
  // points; 5-point (z + oz + w + ow) % 2 == color, 9-point color = 2 cw +
  // cz, rows with (z + oz) % 2 == cz, columns with (w + ow) % 2 == cw
  const int hw = (ny + 1) / 2;  // a row's points of one column parity
  for (int k = 0; k < ncolors; ++k) {
    const int color = (colors >> (4 * k)) & 15;
    const int zf = NINE ? (((color & 1) - oz) & 1) : 0;
    const int nrows = NINE ? max(nx - zf + 1, 0) / 2 : nx;
    // the colour's point e: (z, w), or w >= ny for none
    auto at = [&](int e, int& z, int& w) {
      z = zf + (NINE ? 2 : 1) * (e / hw);
      const int cpar = NINE ? color >> 1 : color - (z + oz);
      w = 2 * (e % hw) + ((cpar - ow) & 1);
    };
    if constexpr (!JAC) {
      for (int e = tid; e < nrows * hw; e += nth) {
        int z, w;
        at(e, z, w);
        if (w >= ny) continue;
        const Pt t = point(z, w);
        *t.q = A::mul(A::add(t.b, t.off), A::div(T(1), t.diag));
      }
    } else {
      // every point from the values before the phase (the wrap may couple
      // points of one colour): compute, barrier, write
      T v[kResPer];
#pragma unroll
      for (int u = 0; u < kResPer; ++u) {
        const int e = tid + u * nth;
        int z, w;
        at(e, z, w);
        if (e >= nrows * hw || w >= ny) continue;
        const Pt t = point(z, w);
        v[u] = A::mul(A::add(t.b, t.off), A::div(T(1), t.diag));
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kResPer; ++u) {
        const int e = tid + u * nth;
        int z, w;
        at(e, z, w);
        if (e >= nrows * hw || w >= ny) continue;
        sm[QA * N + z * ny + w] = v[u];
      }
    }
    __syncthreads();
  }

  // q to q_out, and the residual b - A q to res
  for (int e = tid; e < N; e += nth) {
    q_out[e] = sm[QA * N + e];
    if (emit_res) {
      const Pt t = point(e / ny, e % ny);
      res[e] = A::sub(A::add(t.b, t.off), A::mul(t.diag, *t.q));
    }
  }
}

template <typename T, bool NINE, bool PER, bool JAC>
int launch_resident(const void* so, const void* q_in, const void* b,
                    void* q_out, void* res, int nx, int ny, int nb,
                    int colors, int ncolors, int oz, int ow, int emit_res,
                    long long smem, Wrap wr, cudaStream_t st) {
  // the plan must hold the level's arrays in one block
  if (smem != (long long)resident_arrays(NINE) * nx * ny * sizeof(T))
    return (int)cudaErrorInvalidValue;
  // a Jacobi phase holds its colour's points in registers
  const long long most = (long long)(NINE ? (nx + 1) / 2 : nx) * ((ny + 1) / 2);
  if (JAC && most > (long long)kResPer * kResThreads)
    return (int)cudaErrorInvalidValue;
  auto fn = sweep_resident<T, NINE, PER, JAC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  auto a16 = [](const void* p) { return ((size_t)p & 15) == 0; };
  const int vec = a16(so) && a16(q_in) && a16(b) &&
                  ((long long)nx * ny * sizeof(T)) % 16 == 0;
  fn<<<nb, kResThreads, smem, st>>>((const T*)so, (const T*)q_in,
                                    (const T*)b, (T*)q_out, (T*)res, nx, ny,
                                    nb, colors, ncolors, oz, ow, emit_res,
                                    vec, wr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* so, const void* q_in, const void* b, void* q_out,
           void* res, int nx, int ny, int nb, int nine, int colors,
           int ncolors, int oz, int ow, int emit_res, Wrap wr,
           long long smem, cudaStream_t st) {
  if (q_in == q_out) return (int)cudaErrorInvalidValue;
  const bool per = wr.x || wr.y;
  // batches of planes: never periodic (plane relaxation's planes)
  if (nb < 1 || nb > 65535 || (per && nb != 1))
    return (int)cudaErrorInvalidValue;
  if (smem == 0) {
    // streamed: the tile kernel, on static shared memory
    const int mode = emit_res ? kRes : kNone;
    if (per)
      return launch_sweep_wrap<T>(so, q_in, b, q_out, res, nx, ny, nine,
                                  colors, ncolors, oz, ow, mode, wr, st);
    return launch_sweep<T>(so, q_in, b, q_out, res, nullptr, nx, ny, nine,
                           colors, ncolors, oz, ow, mode, nb, st);
  }
  // the Jacobi phases where an extent along a periodic axis is odd
  const bool jac = (wr.x && (nx & 1)) || (wr.y && (ny & 1));
  auto fn = launch_resident<T, false, false, false>;
  if (nine)
    fn = !per ? launch_resident<T, true, false, false>
              : jac ? launch_resident<T, true, true, true>
                    : launch_resident<T, true, true, false>;
  else if (per)
    fn = jac ? launch_resident<T, false, true, true>
             : launch_resident<T, false, true, false>;
  return fn(so, q_in, b, q_out, res, nx, ny, nb, colors, ncolors, oz, ow,
            emit_res, smem, wr, st);
}

}  // namespace
}  // namespace cedar

extern "C" {

// The threads of a resident K1 block.
int cedar_sweep2_threads() { return cedar::kResThreads; }

// One whole sweep of q_in into q_out, another array (res = b - A q_out
// when emit_res), on each of nb planes (q, b, res (nb, nx, ny), the stencil
// (ndir, nb, nx, ny); nb = 1: one grid), periodic along x (px) and y (py)
// where they are 1 (one plane only), on the plan of ops/cuda2.py `plan`:
// the bytes of the one block that holds a plane (resident), or smem = 0
// (streamed).  Returns a CUDA error code (0 on success).
int cedar_sweep2(int dtype, const void* so, const void* q_in, const void* b,
                 void* q_out, void* res, int nx, int ny, int nb, int nine,
                 int colors, int ncolors, int oz, int ow, int emit_res,
                 int px, int py, long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cedar::Wrap wr;
  wr.x = px != 0;
  wr.y = py != 0;
  if (dtype == cedar::kFloat32)
    return cedar::launch<float>(so, q_in, b, q_out, res, nx, ny, nb, nine,
                                colors, ncolors, oz, ow, emit_res, wr, smem,
                                st);
  if (dtype == cedar::kFloat64)
    return cedar::launch<double>(so, q_in, b, q_out, res, nx, ny, nb, nine,
                                 colors, ncolors, oz, ow, emit_res, wr, smem,
                                 st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
