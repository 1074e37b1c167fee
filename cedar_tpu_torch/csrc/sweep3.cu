// K6: one 3D multicolour Gauss-Seidel sweep (+ the residual b - A q), out
// of place.
//
// Replaces the Pallas kernels cedar_tpu/ops/pallas3.py `_sweep_kernel`
// (called by `_point_relax_call` / `point_relax`) and `_sweep2d_kernel`
// (its (x, y)-tiled variant for wide rows, `_point_relax2d_call`), which
// run all colour phases of a sweep on a VMEM-resident slab and optionally
// emit the residual.  The same function is what the octant-split and
// wavefront sweeps (pallas3_split.py `_sweep_kernel3`, pallas3_stream.py
// `_stream_kernel3`) compute, and what K14 (fused3.cu) computes on the
// fused levels.  Its math is ops/relax3.py (masked phase update) and
// ops/stencil3.py (`offdiag_apply`, `residual`) of this package; the
// off-diagonal sum is stencil3.cuh's `offdiag_terms`, shared with K14-K16,
// so a sweep equals relax3.sweep3_torch bit for bit.
//
// What bounds it on the H100: bytes at the large levels, and below them
// the latency of a launch and of the dependent colour phases, whose 27-point
// terms add up in a fixed order (the plain version's).  A 7-point sweep
// reads 4 stencil planes, b and q and writes q (about 0.5 flop a byte), a
// 27-point one reads 14 planes.  The wrapper's plan (ops/cuda3.py `plan`)
// picks the regime measured fastest on the card at each shape (PERF.md §6):
//
// - Resident (`sweep_resident`, here): a 27-point level of at most 512
//   points a colour whose q and 13 off-diagonal stencil planes fit one
//   block's shared memory (float32 up to 16³, float64 up to 12³) is loaded
//   once by cp.async, each thread holding its point's b and diagonal of
//   each colour in registers; all 8 colour phases run there with one block
//   barrier between them, and q_out and, on request, the residual of the
//   swept iterate are written from there: one launch a sweep.  Where some
//   planes had to be read through L1/L2 (16³ with b in shared memory), and
//   for 7-point levels, whose phases are short, it lost to the per-colour
//   launches (PERF.md §6).
// - Per colour (`sweep_phase`, here, and `residual`): one launch a colour
//   phase (2 or 8), the first writing every point of q_out, then one for
//   the residual; every level between the others.
// - K14's launches (fused3.cu): a 7-point level of 200³ points or more on
//   the ring march with its residual epilogue, a 27-point float32 one of 96³
//   or more on the marches of two colours a launch, then `residual`.
//
// Every regime works out of place: q_in is left as it was.
//
// No point couples to a point of its own colour (red-black on x+y+z for
// 7-point, the (x%2, y%2, z%2) 8-colouring for 27-point), so a phase
// updates its colour from the others' values in any order.  Colours
// anchor at global indices (x + ox, y + oy, z + oz).
//
// Periodic mode (PER; the Pallas kernels' `periodic`, here its plain
// version ops/relax3.sweep3_torch with `periodic`): the couplings wrap
// around the periodic axes (stencil3.cuh `offdiag_wrap_terms`), a
// compile-time instantiation beside the unchanged non-periodic ones.  Along
// a periodic axis of odd extent the first and last points are neighbours of
// one colour, and the plain version updates a colour from the values
// before its phase: there the resident kernel computes a phase into
// registers and writes it after a barrier (JAC), and the per-colour launches
// go from one buffer to another (the wrapper's ping-pong, ops/cuda3.py)
// instead of in place.  The wrap costs integer work and no bytes.

#include "async.cuh"
#include "stencil3.cuh"

namespace cedar {
namespace {

// threads of a resident block, and so the most points an octant may hold
constexpr int kResThreads = 512;

// K6, resident (27-point): one sweep of the level on one block, q_in read
// once and q_out written once, + res on request.  A grid point's parities
// (x & 1, y & 1, z & 1) pick one of 8 octants of hx x hy x hz points (half
// the grid's extents, rounded up), and (x >> 1, y >> 1, z >> 1) its place
// there; a colour is one octant.  Thread t owns the t-th point of each
// octant: its b and diagonal stay in registers, one for each colour phase.
// Shared memory holds q and the 13 off-diagonal stencil planes in octant
// order, so that a phase's threads read consecutive words, and so do their
// neighbours' q and stencil values, a fixed number of words away: no bank
// conflicts (in the grid's own order a colour's points lie two words
// apart).
//
// PER wraps the couplings around the axes of wr (a neighbour's word from
// its wrapped grid index: across the wrap of an odd extent it lies in the
// same octant); JAC (odd periodic extents) writes each phase after a
// barrier, so that a phase reads only the values before it.
template <typename T, bool PER, bool JAC>
__global__ void __launch_bounds__(kResThreads)
sweep_resident(const T* __restrict__ so, const T* __restrict__ q_in,
               const T* __restrict__ b, T* __restrict__ q_out,
               T* __restrict__ res, int nx, int ny, int nz, int colors,
               int ox, int oy, int oz, int emit_res, Wrap3 wr) {
  using A = Arith<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hx = (nx + 1) >> 1, hy = (ny + 1) >> 1, hz = (nz + 1) >> 1;
  const int H = hx * hy * hz, m = 8 * H;  // words an octant, an array
  T* const sq = reinterpret_cast<T*>(smem);
  T* const ss = sq + m;  // planes 1-13 of the stencil
  const int sy = nz, sx = ny * nz, n = nx * sx;
  const int t = threadIdx.x, nth = blockDim.x;

  // the word of grid point (x, y, z) in an array
  auto word = [&](int x, int y, int z) {
    const int o = (x & 1) | (y & 1) << 1 | (z & 1) << 2;
    return ((o * hx + (x >> 1)) * hy + (y >> 1)) * hz + (z >> 1);
  };
  // q and the off-diagonal planes point by point, read in the grid's order
  for (int g = t; g < n; g += nth) {
    const int w = word(g / sx, (g / sy) % ny, g % nz);
    copy_async(sq + w, q_in + g, true);
#pragma unroll 2
    for (int d = 1; d < 14; ++d)
      copy_async(ss + (d - 1) * m + w, so + (long long)d * n + g, true);
  }
  commit_async();

  // the thread's point of colour phase k (own: it lies on the grid), and
  // its b and diagonal
  int px[8], py[8], pz[8], gx[8], gy[8], gz[8];
  bool own[8];
  T bv[8], dv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int color = (colors >> (4 * k)) & 15;
    px[k] = ((color & 1) - ox) & 1;
    py[k] = (((color >> 1) & 1) - oy) & 1;
    pz[k] = (((color >> 2) & 1) - oz) & 1;
    const int cy = (ny - py[k] + 1) >> 1, cz = (nz - pz[k] + 1) >> 1;
    own[k] = t < ((nx - px[k] + 1) >> 1) * cy * cz;
    gx[k] = 2 * (t / (cy * cz)) + px[k];
    gy[k] = 2 * ((t / cz) % cy) + py[k];
    gz[k] = 2 * (t % cz) + pz[k];
    const int g = own[k] ? (gx[k] * ny + gy[k]) * nz + gz[k] : 0;
    bv[k] = own[k] ? b[g] : T(0);
    dv[k] = own[k] ? so[g] : T(1);
  }
  wait_async<0>();
  __syncthreads();

  // Σ coupling · q at grid point (x, y, z) of octant (px, py, pz), word w,
  // in offdiag_terms' order (off-grid neighbours couple by exactly zero).
  // Every read is made whether or not the neighbour lies on the grid (from
  // the point itself where it does not), so that none waits on a branch
  // and a point's reads are in flight together.
  const int hyz = hy * hz;
  auto offd = [&](int x, int y, int z, int px, int py, int pz,
                  int w) -> T {
    if constexpr (PER) {
      return offdiag_wrap_terms<T, true>(
          x, y, z, nx, ny, nz, wr,
          [&](int xs, int ys, int zs, int P, int xn, int yn, int zn) -> T {
            return A::mul(ss[(P - 1) * m + word(xs, ys, zs)],
                          sq[word(xn, yn, zn)]);
          });
    }
    // the words between a point and its neighbour one step down or up
    // each axis: the other octant, and a half step where it crosses one
    const int fx = (1 - 2 * px) * H, fy = (1 - 2 * py) * 2 * H;
    const int fz = (1 - 2 * pz) * 4 * H;
    const int xm = fx + (px - 1) * hyz, xp = fx + px * hyz;
    const int ym = fy + (py - 1) * hz, yp = fy + py * hz;
    const int zm = fz + pz - 1, zp = fz + pz;
    auto at = [&](int dx, int dy, int dz) {
      return w + (dx < 0 ? xm : dx > 0 ? xp : 0) +
             (dy < 0 ? ym : dy > 0 ? yp : 0) + (dz < 0 ? zm : dz > 0 ? zp : 0);
    };
    const bool xl = x > 0, xh = x + 1 < nx, yl = y > 0, yh = y + 1 < ny;
    const bool zl = z > 0, zh = z + 1 < nz;
    return offdiag_terms<T, true>([&](int dx, int dy, int dz, int P) -> T {
      const bool ok = (dx < 0 ? xl : dx > 0 ? xh : true) &&
                      (dy < 0 ? yl : dy > 0 ? yh : true) &&
                      (dz < 0 ? zl : dz > 0 ? zh : true);
      const T sv = ss[(P - 1) * m + (ok ? at(dx > 0, dy > 0, dz > 0) : w)];
      const T qv = sq[ok ? at(dx, dy, dz) : w];
      return ok ? A::mul(sv, qv) : T(0);
    });
  };
  auto word_of = [&](int k) {
    return ((((px[k] | py[k] << 1 | pz[k] << 2) * hx + (gx[k] >> 1)) * hy +
             (gy[k] >> 1)) * hz) + (gz[k] >> 1);
  };

  // the colour phases: q = (b + Σ coupling·q_nb) * (1/P) at the colour's
  // points, gx % 2 == color & 1, gy % 2 == color >> 1 & 1, gz % 2 ==
  // color >> 2 & 1: one octant each, a point a thread
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if constexpr (JAC) {
      T v = T(0);
      const int w = word_of(k);
      if (own[k])
        v = A::mul(A::add(bv[k], offd(gx[k], gy[k], gz[k], px[k], py[k],
                                      pz[k], w)),
                   A::div(T(1), dv[k]));
      __syncthreads();
      if (own[k]) sq[w] = v;
    } else if (own[k]) {
      const int w = word_of(k);
      const T v = A::add(bv[k], offd(gx[k], gy[k], gz[k], px[k], py[k],
                                     pz[k], w));
      sq[w] = A::mul(v, A::div(T(1), dv[k]));
    }
    __syncthreads();
  }

  // q to q_out, and the residual of the swept iterate to res, the
  // thread's points
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!own[k]) continue;
    const int w = word_of(k);
    const int g = (gx[k] * ny + gy[k]) * nz + gz[k];
    const T qv = sq[w];
    q_out[g] = qv;
    if (emit_res)
      res[g] = A::sub(A::add(bv[k], offd(gx[k], gy[k], gz[k], px[k], py[k],
                                         pz[k], w)),
                      A::mul(dv[k], qv));
  }
}

// The extents along a periodic axis of wr include an odd one: the wrap
// couples points of one colour, and the phases run as Jacobi steps.
inline bool odd_wrap(int nx, int ny, int nz, Wrap3 wr) {
  return (wr.x && (nx & 1)) || (wr.y && (ny & 1)) || (wr.z && (nz & 1));
}

template <typename T>
int launch_resident(const void* so, const void* q_in, const void* b,
                    void* q_out, void* res, int nx, int ny, int nz,
                    int colors, int ox, int oy, int oz, int emit_res,
                    Wrap3 wr, long long smem, cudaStream_t st) {
  if (q_in == q_out) return (int)cudaErrorInvalidValue;
  // the plan must hold q and the 13 off-diagonal planes in one block, in
  // octants of half the grid's extents (rounded up) of a point a thread
  const long long h =
      (long long)((nx + 1) / 2) * ((ny + 1) / 2) * ((nz + 1) / 2);
  if (h > kResThreads || smem != 14 * 8 * h * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  const bool per = wr.x || wr.y || wr.z;
  auto fn = !per ? sweep_resident<T, false, false>
            : odd_wrap(nx, ny, nz, wr) ? sweep_resident<T, true, true>
                                       : sweep_resident<T, true, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<1, kResThreads, smem, st>>>((const T*)so, (const T*)q_in, (const T*)b,
                                   (T*)q_out, (T*)res, nx, ny, nz, colors, ox,
                                   oy, oz, emit_res, wr);
  return (int)cudaGetLastError();
}

// One colour phase of the per-colour regime: q_out = (b + Σ coupling·q_nb)
// * (1/P) at this colour's points, the neighbours read from q_in.  The
// first phase of a sweep (q_in another array) also copies q_in's other
// points to q_out, so that the sweep pays no copy pass; the later ones run
// in place on q_out (q_in == q_out), race-free because no point couples to
// its own colour.  Colours anchor at global indices (x + ox, y + oy,
// z + oz):
//   7-point:  (gx + gy + gz) % 2 == color
//   27-point: gx % 2 == color & 1, gy % 2 == color >> 1 & 1,
//             gz % 2 == color >> 2 & 1
// PER wraps the couplings around the axes of wr (stencil3.cuh
// offdiag_wrap: its steps across the wrap found once a thread; a branch to
// offdiag away from the wrap measured slower at 128³ 27-point, where every
// z row has a warp at the wrap); at an odd periodic extent every phase
// goes from one array to another (the wrapper's ping-pong).
template <typename T, bool TS, bool PER>
__global__ void sweep_phase(const T* __restrict__ so, const T* q_in,
                            T* q_out, const T* __restrict__ b, int nx,
                            int ny, int nz, int color, int ox, int oy,
                            int oz, Wrap3 wr) {
  using A = Arith<T>;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (y >= ny || z >= nz) return;
  const int gx = x + ox, gy = y + oy, gz = z + oz;
  const bool member =
      TS ? (((gx & 1) == (color & 1)) && ((gy & 1) == ((color >> 1) & 1)) &&
            ((gz & 1) == ((color >> 2) & 1)))
         : (((gx + gy + gz) & 1) == color);
  const long long i = ((long long)x * ny + y) * nz + z;
  if (!member) {
    if (q_in != q_out) q_out[i] = q_in[i];
    return;
  }
  const T rec = A::div(T(1), so[i]);  // plane P is plane 0
  if constexpr (PER)
    q_out[i] = A::mul(
        A::add(b[i], offdiag_wrap<T, TS>(so, q_in, x, y, z, nx, ny, nz, wr)),
        rec);
  else
    q_out[i] = A::mul(
        A::add(b[i], offdiag<T, TS>(so, q_in, x, y, z, nx, ny, nz)), rec);
}

// res = (b + Σ coupling·q_nb) - P·q (PER: the couplings wrap around wr)
template <typename T, bool TS, bool PER>
__global__ void residual(const T* __restrict__ so, const T* __restrict__ q,
                         const T* __restrict__ b, T* __restrict__ res,
                         int nx, int ny, int nz, Wrap3 wr) {
  using A = Arith<T>;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (y >= ny || z >= nz) return;
  const long long i = ((long long)x * ny + y) * nz + z;
  if constexpr (PER)
    res[i] = A::sub(
        A::add(b[i], offdiag_wrap<T, TS>(so, q, x, y, z, nx, ny, nz, wr)),
        A::mul(so[i], q[i]));
  else
    res[i] = A::sub(A::add(b[i], offdiag<T, TS>(so, q, x, y, z, nx, ny, nz)),
                    A::mul(so[i], q[i]));
}

template <typename T>
int launch_phase(const void* so, const void* q_in, void* q_out,
                 const void* b, int nx, int ny, int nz, int ts, int color,
                 int ox, int oy, int oz, Wrap3 wr, cudaStream_t st) {
  // an odd periodic extent runs its phases from one array to another
  if (q_in == q_out && odd_wrap(nx, ny, nz, wr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid3_for(nx, ny, nz), block(kBlockX, kBlockY);
  const bool per = wr.x || wr.y || wr.z;
  auto fn = ts ? (per ? sweep_phase<T, true, true> : sweep_phase<T, true, false>)
               : (per ? sweep_phase<T, false, true>
                      : sweep_phase<T, false, false>);
  fn<<<grid, block, 0, st>>>((const T*)so, (const T*)q_in, (T*)q_out,
                             (const T*)b, nx, ny, nz, color, ox, oy, oz, wr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_residual(const void* so, const void* q, const void* b, void* res,
                    int nx, int ny, int nz, int ts, Wrap3 wr,
                    cudaStream_t st) {
  const dim3 grid = grid3_for(nx, ny, nz), block(kBlockX, kBlockY);
  const bool per = wr.x || wr.y || wr.z;
  auto fn = ts ? (per ? residual<T, true, true> : residual<T, true, false>)
               : (per ? residual<T, false, true> : residual<T, false, false>);
  fn<<<grid, block, 0, st>>>((const T*)so, (const T*)q, (const T*)b, (T*)res,
                             nx, ny, nz, wr);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// The threads of a resident K6 block.
int cedar_sweep3_threads() { return cedar::kResThreads; }

// The most shared memory a resident K6 block may take on the current
// device: the opt-in limit of a block, less 1 KB (the rule of every plan of
// this package, ops/cuda_build.py BLOCK_SMEM); -1 on a CUDA error.
int cedar_sweep3_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin - 1024;
}

// One whole 27-point sweep of q_in into q_out, another array (res = b -
// A q_out when emit_res), in one block on the plan of ops/cuda3.py `plan`:
// smem the bytes of q and the 13 off-diagonal stencil planes in octant
// order.
// colors packs the 8 colour codes in order, 4 bits each; px, py, pz mark
// the periodic axes.  Returns a CUDA error code (0 on success).
int cedar_sweep3_resident(int dtype, const void* so, const void* q_in,
                          const void* b, void* q_out, void* res, int nx,
                          int ny, int nz, int colors, int ox, int oy, int oz,
                          int emit_res, int px, int py, int pz,
                          long long smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Wrap3 wr{px != 0, py != 0, pz != 0};
  if (dtype == cedar::kFloat32)
    return cedar::launch_resident<float>(so, q_in, b, q_out, res, nx, ny, nz,
                                         colors, ox, oy, oz, emit_res, wr,
                                         smem, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_resident<double>(so, q_in, b, q_out, res, nx, ny,
                                          nz, colors, ox, oy, oz, emit_res,
                                          wr, smem, st);
  return (int)cudaErrorInvalidValue;
}

// One colour phase of the per-colour regime from q_in into q_out: the
// sweep's first (q_in another array: q_out gets every point) or a later
// one (q_in == q_out, in place; refused at an odd periodic extent, whose
// phases go from one array to another).  px, py, pz mark the periodic
// axes.  Returns a CUDA error code.
int cedar_sweep3_phase(int dtype, const void* so, const void* q_in,
                       void* q_out, const void* b, int nx, int ny, int nz,
                       int ts, int color, int ox, int oy, int oz, int px,
                       int py, int pz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Wrap3 wr{px != 0, py != 0, pz != 0};
  if (dtype == cedar::kFloat32)
    return cedar::launch_phase<float>(so, q_in, q_out, b, nx, ny, nz, ts,
                                      color, ox, oy, oz, wr, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_phase<double>(so, q_in, q_out, b, nx, ny, nz, ts,
                                       color, ox, oy, oz, wr, st);
  return (int)cudaErrorInvalidValue;
}

// res = b - A q (the per-colour and the 27-point march regimes' residual),
// the couplings wrapping around the periodic axes px, py, pz.  Returns a
// CUDA error code.
int cedar_residual3(int dtype, const void* so, const void* q, const void* b,
                    void* res, int nx, int ny, int nz, int ts, int px,
                    int py, int pz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Wrap3 wr{px != 0, py != 0, pz != 0};
  if (dtype == cedar::kFloat32)
    return cedar::launch_residual<float>(so, q, b, res, nx, ny, nz, ts, wr,
                                         st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_residual<double>(so, q, b, res, nx, ny, nz, ts, wr,
                                          st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
