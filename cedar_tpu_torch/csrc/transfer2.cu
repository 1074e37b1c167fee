// K2 (restrict), K3 (interp-add) and K5 (interp): the 2D BoxMG grid
// transfers.
//
// K2 replaces the Pallas kernel cedar_tpu/ops/pallas_transfer2.py
// `_restrict_kernel` (called by `_restrict_call` / `restrict`): the coarse
// right-hand side cb = Pᵀ res, gathered through the 8 CI weight planes.
// K3 replaces `_interp_kernel` (called by `_interp_call` / `interp_add`):
// q += P qc, plus res / diag at fine-only points.  The math and the term
// order are ops/interp2.py `restrict` and `interp_add` of this package
// (reference: BMG2_SymStd_restrict.f90:76-92,
// BMG2_SymStd_interp_add.f90:101-137).
//
// What bounds K2 and K3 on the H100: bytes at the large grids, and on the
// small planes of plane relaxation a launch's fixed cost and its round
// trip to memory.  K2 must read the fine residual once and the 8 CI
// planes at coarse size and write cb; K3 reads q, res, the diagonal, the
// CI planes and qc and writes q: a handful of flops per byte.  The first
// design (a thread per output point, a (32, 8) block, grid z the plane)
// lost here: K3's lanes alternated between the 4 parity classes of
// `interp_at`, so every warp diverged, and the 4 fine points of a coarse
// cell each re-read its CI and qc values; on 8²-16² coarse planes a (32,
// 8) block left 3/4 of its lanes idle, in both kernels.
//
// This design works on row segments: `seg` consecutive lanes (a power of
// two up to a warp) over consecutive coarse columns of one row of one
// plane.  The rows of every plane of the batch are numbered one after the
// other and a block holds whole segments, so a block of small planes
// holds several whole planes, its lanes busy, and a launch of them covers
// the card in one wave.  The launch plan (ops/cuda_transfer2.plan: `seg`,
// the segments a row, threads a block, grid rows) is computed in Python
// and checked here.
// - K2: lane wc computes cb(zc, wc) from its 9 fine values and 8 weights,
//   loaded as scalars.  Of each fine row a warp's stride-2 load of the
//   even columns brings every sector of the row's span, and its loads of
//   the odd columns take them from L1: 4 bytes of registers hold 8 bytes
//   of sectors in flight, and a thread needs few registers.  A design of
//   vector loads of the fine pairs (2wc, 2wc+1) with the third column and
//   the CI at wc+1 shuffled from the neighbour lane (each value requested
//   once) was built bit-exact and measured slower at every shape, 4096²
//   and the small planes alike (PERF.md §6): it holds a register a
//   value in flight and 41 of them a thread, and its segment's edge lanes
//   load their outside neighbours themselves.
// - K3: lane m owns the coarse cell (k, m), k in [0, nxc]: its part of the
//   fine rows 2k-1 and 2k.  It loads the 8 weights CI(., k, m) and qc(k-1
//   | k, m) once, takes the weights and qc at m+1 from lane + 1 and qc at
//   m-1 from lane - 1 (the segment's last and first lane load them), and
//   in each of its fine rows updates the pair of columns at an even
//   address, (2m, 2m+1) or (2m-1, 2m) by the row's start (odd ny
//   alternates them), with q, res and the diagonal read and q written as
//   one vector each (8 bytes f32, 16 f64).  Every load is issued before
//   the first shuffle and store: one round trip to memory.  No warp
//   diverges on the parity classes, and each CI and qc value is read
//   once.
// Every output goes through the shared functors `restrict_value` and
// `interp_at` (transfer2.cuh), fed from device memory (K2) or registers
// and shuffles (K3), so the kernels round as their plain versions and
// K12/K13 do.  The Pallas versions work on a lane-parity-split residual
// and emit four parity parts that XLA merges afterwards, because Mosaic
// cannot reshape lanes in a kernel; here the kernels read the dense
// residual and K3 adds into q in place, so neither split nor merge pass
// exists.
//
// K5 replaces `_interp_kernel_split_nores` (called by
// `interp_split_nores`): x = P qc into a new fine tensor, the F-cycle's
// level entry, where the residual and the addend are exactly zero.  It
// reads only qc and the CI planes and writes x (about 0.22 GB at 4096²
// f32, against K3's q, res and diagonal streams besides); it shares K3's
// weights and parity classes (`interp_value`), one thread a fine point.
//
// The CI access, the restriction of one coarse point and the interpolated
// value of one fine point live in transfer2.cuh, shared with the fused
// kernels K12 and K13 (fused2.cu).
//
// K2 and K3 also take a batch of nb independent planes (plane relaxation's
// embedded 2D cycles, ops/planes3.py): grid arrays (nb, nx, ny), the
// stencil (ndir, nb, nx, ny) and CI (8, nb, nxc+1, nyc+1), the batch axis
// after the direction axis; nb = 1 is the unbatched launch.
//
// Periodic grids (template flag PER, the periodic axes in a Wrap; the JAX
// package runs these transfers in XLA there, cedar_tpu/ops/interp2.py
// `restrict` and `interp_add` with `periodic`): K2 reads a fine neighbour
// at -1 (or nx) on a periodic axis as nx-1 (or 0), the coarse-sample wrap;
// K3 and K5 read qc at coarse index nxc (nyc) as index 0, the padded qcp.
// CI's wrap entries come from setup (ops/interp2.setup_interp), so the
// weights need no special case, and restrict_value / interp_at read
// through the same functors as before.

#include <cstdint>

#include "transfer2.cuh"

namespace cedar {
namespace {

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// The element parity of an address: 0 where a pair starting there is one
// aligned vector.
template <typename T>
__device__ __forceinline__ int parity(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) & 1);
}

// row[a], row[a+1] of a row of n values, zero outside it; one vector load
// where both lie in the row and `vec` (row + a is aligned).
template <typename T>
__device__ __forceinline__ void load_pair(const T* __restrict__ row, int a,
                                          int n, bool vec, T& x, T& y) {
  if (vec && a >= 0 && a + 1 < n) {
    const auto v = *reinterpret_cast<const typename Pair<T>::type*>(row + a);
    x = v.x;
    y = v.y;
  } else {
    x = (a >= 0 && a < n) ? row[a] : T(0);
    y = (a + 1 >= 0 && a + 1 < n) ? row[a + 1] : T(0);
  }
}

// row[a] = x, row[a+1] = y where they lie in the row; one vector store
// where both do (row + a aligned).
template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ row, int a, int n,
                                           T x, T y) {
  if (a >= 0 && a + 1 < n) {
    *reinterpret_cast<typename Pair<T>::type*>(row + a) = {x, y};
  } else {
    if (a >= 0 && a < n) row[a] = x;
    if (a + 1 >= 0 && a + 1 < n) row[a + 1] = y;
  }
}

// lane + 1's v, lane - 1's v within a segment of `seg` lanes (a segment's
// last / first lane gets its own v back)
template <typename T>
__device__ __forceinline__ T from_next(T v, int seg) {
  return __shfl_down_sync(0xffffffffu, v, 1, seg);
}
template <typename T>
__device__ __forceinline__ T from_prev(T v, int seg) {
  return __shfl_up_sync(0xffffffffu, v, 1, seg);
}

template <typename T>
__device__ __forceinline__ T fine_at(const T* __restrict__ r, int z, int w,
                                     int nx, int ny) {
  return (z >= 0 && z < nx && w >= 0 && w < ny) ? r[(long long)z * ny + w]
                                                : T(0);
}

// cb[zc, wc] = res[2zc, 2wc] + Σ weight · res[2zc+du, 2wc+dv], in
// interp2.PW_TABLE order.  Block (seg, threads / seg): x the lane of a
// row segment (coarse column wc), y a row (plane p, coarse row zc: p * nxc
// + zc); grid x the segment of the row, y the block of rows.
template <typename T, bool PER>
__global__ void restrict_kernel(const T* __restrict__ ci_p,
                                const T* __restrict__ res,
                                T* __restrict__ cb, int nx, int ny, int nxc,
                                int nyc, int nb, Wrap wr) {
  const int wc = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= nb * nxc || wc >= nyc) return;
  const int p = r / nxc, zc = r - p * nxc;
  const CI<T> ci = ci_of(ci_p, p, nb, nxc, nyc);
  res += p * ((long long)nx * ny);
  T* const out = cb + p * ((long long)nxc * nyc) + (long long)zc * nyc + wc;
  if constexpr (!PER) {
    auto fine = [&](int z, int w) { return fine_at(res, z, w, nx, ny); };
    *out = restrict_value(ci, fine, zc, wc);
  } else {
    // the fine rows and columns 2zc - 1, 2zc + 1 (2wc -+ 1), wrapped on
    // the periodic axes once; restrict_value asks only for these
    const int z0 = 2 * zc, w0 = 2 * wc;
    const int zm = wr.x && z0 == 0 ? nx - 1 : z0 - 1;
    const int zp = wr.x && z0 + 1 == nx ? 0 : z0 + 1;
    const int wm = wr.y && w0 == 0 ? ny - 1 : w0 - 1;
    const int wp = wr.y && w0 + 1 == ny ? 0 : w0 + 1;
    auto fine = [&](int z, int w) {
      return fine_at(res, z < z0 ? zm : z > z0 ? zp : z0,
                     w < w0 ? wm : w > w0 ? wp : w0, nx, ny);
    };
    *out = restrict_value(ci, fine, zc, wc);
  }
}

// q[z, w] += P qc (+ res / diag off the coincident points), in place.
// Plane O of so (nb, nx, ny) comes first, so plane p's diagonal sits at the
// same offset as its q.  Block (seg, threads / seg): x the lane of a row
// segment, y a cell row (plane p, cell row k in [0, nxc]: p * (nxc + 1) +
// k); grid x the segment, y the block of rows.  Every load is issued
// before the first shuffle and the first store (one round trip to memory,
// the segment's edge lanes' own loads included), and no thread returns
// before the shuffles.
template <typename T, bool PER>
__global__ void interp_add_kernel(const T* __restrict__ ci_p,
                                  const T* __restrict__ so,
                                  const T* __restrict__ qc,
                                  const T* __restrict__ res,
                                  T* __restrict__ q, int nx, int ny, int nxc,
                                  int nyc, int nb, Wrap wr) {
  using A = Arith<T>;
  const int seg = blockDim.x, lane = threadIdx.x;
  const bool first = lane == 0, last = lane == seg - 1;
  const int m = blockIdx.x * seg + lane;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const bool live = r < nb * (nxc + 1);
  const int p = live ? r / (nxc + 1) : 0, k = live ? r - p * (nxc + 1) : 0;
  const CI<T> ci = ci_of(ci_p, p, nb, nxc, nyc);
  const T* __restrict__ qcp = qc + p * ((long long)nxc * nyc);
  auto qc_at = [&](bool in, int kk, int mm) -> T {
    if constexpr (PER) {  // coarse index nxc (nyc) is index 0
      if (wr.x && kk == nxc) kk = 0;
      if (wr.y && mm == nyc) mm = 0;
    }
    return (in && kk >= 0 && kk < nxc && mm >= 0 && mm < nyc)
               ? qcp[(long long)kk * nyc + mm]
               : T(0);
  };
  // the cell's 8 weights CI(., k, m) and qc(k-1 | k, m); the weights of
  // the y-line and centre points at m+1 and qc there from the next lane
  // (loaded in the last), qc at m-1 from the previous one (loaded in the
  // first); the x-line weights LR, LL are never asked for at m+1
  const bool here = live && m <= nyc, next = last && live && m < nyc;
  T w[8], wn[8] = {};
#pragma unroll
  for (int d = 0; d < 8; ++d) w[d] = here ? ci(d, k, m) : T(0);
#pragma unroll
  for (int d = LA; d < 8; ++d) wn[d] = next ? ci(d, k, m + 1) : T(0);
  const T lo = qc_at(live, k - 1, m), hi = qc_at(live, k, m);
  T lo_n = qc_at(next, k - 1, m + 1), hi_n = qc_at(next, k, m + 1);
  T lo_p = qc_at(live && first, k - 1, m - 1);
  T hi_p = qc_at(live && first, k, m - 1);
  // fine rows 2k-1, 2k: the aligned pair (a, a+1), a = 2m - odd, of q,
  // res and the diagonal
  const long long plane = (long long)nx * ny;
  const int par = parity(q);
  const bool vec_res = parity(res) == par, vec_so = parity(so) == par;
  T qv[2][2], rv[2][2], dv[2][2];
  long long off[2];
  int a[2];
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int z = 2 * k - 1 + h;
    in[h] = live && m < nyc && z >= 0 && z < nx;
    off[h] = p * plane + (long long)(in[h] ? z : 0) * ny;
    a[h] = 2 * m - (int)((par + off[h]) & 1);
    qv[h][0] = qv[h][1] = rv[h][0] = rv[h][1] = dv[h][0] = dv[h][1] = T(0);
    if (in[h]) {
      load_pair(q + off[h], a[h], ny, true, qv[h][0], qv[h][1]);
      load_pair(res + off[h], a[h], ny, vec_res, rv[h][0], rv[h][1]);
      load_pair(so + off[h], a[h], ny, vec_so, dv[h][0], dv[h][1]);
    }
  }
#pragma unroll
  for (int d = LA; d < 8; ++d) {
    const T s = from_next(w[d], seg);
    if (!last) wn[d] = s;
  }
  {
    const T ln = from_next(lo, seg), hn = from_next(hi, seg);
    const T lp = from_prev(lo, seg), hp = from_prev(hi, seg);
    if (!last) lo_n = ln, hi_n = hn;
    if (!first) lo_p = lp, hi_p = hp;
  }
  if (!live || m >= nyc) return;
  // interp_at asks for weights in row k at m or m+1, qc in rows k-1, k at
  // m-1, m or m+1
  auto weight = [&](int d, int, int mm) -> T {
    return mm == m ? w[d] : wn[d];
  };
  auto coarse = [&](int kk, int mm) -> T {
    const bool low = kk != k;
    return mm == m ? (low ? lo : hi)
                   : mm > m ? (low ? lo_n : hi_n) : (low ? lo_p : hi_p);
  };
  // q[z, w] + (P qc)[z, w] (+ res / diag)
  auto update = [&](int z, int col, T qz, T rz, T dz) -> T {
    T v = interp_at<T>(weight, coarse, z, col);
    if ((z | col) & 1) v = A::add(v, A::div(rz, dz));  // res / so[O]
    return A::add(qz, v);
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!in[h]) continue;
    const int z = 2 * k - 1 + h;
    if (a[h] >= 0) qv[h][0] = update(z, a[h], qv[h][0], rv[h][0], dv[h][0]);
    if (a[h] + 1 < ny)
      qv[h][1] = update(z, a[h] + 1, qv[h][1], rv[h][1], dv[h][1]);
    store_pair(q + off[h], a[h], ny, qv[h][0], qv[h][1]);
    // a row at an odd address: the last cell's column 2m+1 (even ny)
    const long long t = off[h] + a[h] + 2;
    if (a[h] + 2 < ny && m == nyc - 1 && ((par + off[h]) & 1))
      q[t] = update(z, a[h] + 2, q[t], res[t], so[t]);
  }
}

// K5: x[z, w] = (P qc)[z, w], a new fine tensor (the F-cycle's level
// entry: no residual, no addend), a thread a fine point.  blockIdx.z is the
// plane of a batch of nb (plane relaxation's embedded F-cycles; the JAX
// package's vmapped `interp_split_nores`): x (nb, nx, ny), qc (nb, nxc,
// nyc), CI (8, nb, nxc+1, nyc+1), each plane as alone.
template <typename T, bool PER>
__global__ void interp_kernel(const T* __restrict__ ci_p,
                              const T* __restrict__ qc, T* __restrict__ x,
                              int nx, int ny, int nxc, int nyc, int nb,
                              Wrap wr) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (z >= nx || w >= ny) return;
  const int p = blockIdx.z;
  const CI<T> ci = ci_of(ci_p, p, nb, nxc, nyc);
  qc += p * ((long long)nxc * nyc);
  x += p * ((long long)nx * ny);
  if constexpr (!PER) {
    x[(long long)z * ny + w] = interp_value(ci, qc, z, w, nxc, nyc);
  } else {  // coarse index nxc (nyc) is index 0
    x[(long long)z * ny + w] = interp_at<T>(ci, [&](int k, int m) -> T {
      if (wr.x && k == nxc) k = 0;
      if (wr.y && m == nyc) m = 0;
      return (k < nxc && m < nyc) ? qc[(long long)k * nyc + m] : T(0);
    }, z, w);
  }
}

// The launch of K2 or K3 (ops/cuda_transfer2.plan): segments of `seg`
// lanes, `nseg` a row, blocks of `threads`, `gy` blocks of rows.
struct TransferPlan {
  int seg, nseg, threads, gy;
};

// The plan must cover the `rows` rows and nyc columns once, in blocks of
// whole warps of whole segments.
inline bool plan_ok(const TransferPlan& p, int rows, int nyc) {
  const bool pow2 = p.seg > 0 && p.seg <= 32 && (p.seg & (p.seg - 1)) == 0;
  return pow2 && p.threads % 32 == 0 && p.threads <= 1024 && p.nseg >= 1 &&
         p.seg * p.nseg >= nyc && p.seg * (p.nseg - 1) < nyc &&
         p.gy >= 1 && p.gy <= 65535 &&
         (long long)p.gy * (p.threads / p.seg) >= rows &&
         (long long)(p.gy - 1) * (p.threads / p.seg) < rows;
}

template <typename T>
int launch_restrict(const void* ci, const void* res, void* cb, int nx, int ny,
                    int nxc, int nyc, int nb, Wrap wr, const TransferPlan& p,
                    cudaStream_t st) {
  if (!plan_ok(p, nb * nxc, nyc)) return (int)cudaErrorInvalidValue;
  auto fn = (wr.x || wr.y) ? restrict_kernel<T, true>
                           : restrict_kernel<T, false>;
  fn<<<dim3(p.nseg, p.gy), dim3(p.seg, p.threads / p.seg), 0, st>>>(
      (const T*)ci, (const T*)res, (T*)cb, nx, ny, nxc, nyc, nb, wr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp_add(const void* ci, const void* so, const void* qc,
                      const void* res, void* q, int nx, int ny, int nxc,
                      int nyc, int nb, Wrap wr, const TransferPlan& p,
                      cudaStream_t st) {
  if (!plan_ok(p, nb * (nxc + 1), nyc)) return (int)cudaErrorInvalidValue;
  auto fn = (wr.x || wr.y) ? interp_add_kernel<T, true>
                           : interp_add_kernel<T, false>;
  fn<<<dim3(p.nseg, p.gy), dim3(p.seg, p.threads / p.seg), 0, st>>>(
      (const T*)ci, (const T*)so, (const T*)qc, (const T*)res, (T*)q, nx, ny,
      nxc, nyc, nb, wr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp(const void* ci, const void* qc, void* x, int nx, int ny,
                  int nxc, int nyc, int nb, Wrap wr, cudaStream_t st) {
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  auto fn = (wr.x || wr.y) ? interp_kernel<T, true> : interp_kernel<T, false>;
  dim3 grid = grid_for(nx, ny);
  grid.z = nb;
  fn<<<grid, dim3(kBlockX, kBlockY), 0, st>>>(
      (const T*)ci, (const T*)qc, (T*)x, nx, ny, nxc, nyc, nb, wr);
  return (int)cudaGetLastError();
}

// The periodic axes as the C entry points take them.
inline Wrap wrap_of(int px, int py) {
  Wrap wr;
  wr.x = px != 0;
  wr.y = py != 0;
  return wr;
}

}  // namespace
}  // namespace cedar

extern "C" {

// cb (nb, nxc, nyc) = Pᵀ res (nb, nx, ny), plane by plane, periodic along
// x (px) and y (py) where they are 1, on the plan (seg, nseg, threads, gy)
// of ops/cuda_transfer2.plan.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a wrong plan.
int cedar_restrict2(int dtype, const void* ci, const void* res, void* cb,
                    int nx, int ny, int nxc, int nyc, int nb, int px, int py,
                    int seg, int nseg, int threads, int gy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::TransferPlan p{seg, nseg, threads, gy};
  const cedar::Wrap wr = cedar::wrap_of(px, py);
  if (dtype == cedar::kFloat32)
    return cedar::launch_restrict<float>(ci, res, cb, nx, ny, nxc, nyc, nb,
                                         wr, p, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_restrict<double>(ci, res, cb, nx, ny, nxc, nyc, nb,
                                          wr, p, st);
  return (int)cudaErrorInvalidValue;
}

// q (nb, nx, ny) += P qc (nb, nxc, nyc) + res / so[O], in place, plane by
// plane, periodic along x (px) and y (py) where they are 1, on the plan
// (seg, nseg, threads, gy) of ops/cuda_transfer2.plan.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a wrong plan.
int cedar_interp_add2(int dtype, const void* ci, const void* so,
                      const void* qc, const void* res, void* q, int nx,
                      int ny, int nxc, int nyc, int nb, int px, int py,
                      int seg, int nseg, int threads, int gy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::TransferPlan p{seg, nseg, threads, gy};
  const cedar::Wrap wr = cedar::wrap_of(px, py);
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp_add<float>(ci, so, qc, res, q, nx, ny, nxc,
                                           nyc, nb, wr, p, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp_add<double>(ci, so, qc, res, q, nx, ny, nxc,
                                            nyc, nb, wr, p, st);
  return (int)cudaErrorInvalidValue;
}

// x (nb, nx, ny) = P qc (nb, nxc, nyc), written in full, plane by plane,
// periodic along x (px) and y (py) where they are 1.  Returns
// cudaGetLastError().
int cedar_interp2(int dtype, const void* ci, const void* qc, void* x, int nx,
                  int ny, int nxc, int nyc, int nb, int px, int py,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Wrap wr = cedar::wrap_of(px, py);
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp<float>(ci, qc, x, nx, ny, nxc, nyc, nb, wr,
                                       st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp<double>(ci, qc, x, nx, ny, nxc, nyc, nb, wr,
                                        st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
