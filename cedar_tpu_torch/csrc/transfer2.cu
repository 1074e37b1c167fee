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
// What bounds them on the H100: bytes.  K2 reads the fine residual once
// (9 reads per coarse point, each fine value shared by up to 4 coarse
// points through L1/L2) and 8 CI planes at coarse size; K3 reads q, res,
// the diagonal and the CI planes and writes q: a handful of flops per
// byte.  Design: one thread per output point, consecutive threads on
// consecutive w, so the dominant fine-grid streams are coalesced (K2's
// stride-2 fine reads touch every sector of a row pair once).  The
// Pallas versions work on a lane-parity-split residual and emit four
// parity parts that XLA merges afterwards, because Mosaic cannot reshape
// lanes in a kernel; here the kernels read the dense residual and K3 adds
// into q in place, so neither split nor merge pass exists.
//
// K5 replaces `_interp_kernel_split_nores` (called by
// `interp_split_nores`): x = P qc into a new fine tensor, the F-cycle's
// level entry, where the residual and the addend are exactly zero.  It
// reads only qc and the CI planes and writes x (about 0.22 GB at 4096²
// f32, against K3's q, res and diagonal streams besides); it shares K3's
// weights and parity classes (`interp_value`).
//
// The CI access, the restriction of one coarse point and the interpolated
// value of one fine point live in transfer2.cuh, shared with the fused
// kernels K12 and K13 (fused2.cu).
//
// K2 and K3 also take a batch of nb independent planes (plane relaxation's
// embedded 2D cycles, ops/planes3.py): grid arrays (nb, nx, ny), the
// stencil (ndir, nb, nx, ny) and CI (8, nb, nxc+1, nyc+1), the batch axis
// after the direction axis.  Grid z is the plane; nb = 1 is the unbatched
// launch.

#include "transfer2.cuh"

namespace cedar {
namespace {

template <typename T>
__device__ __forceinline__ T fine_at(const T* __restrict__ r, int z, int w,
                                     int nx, int ny) {
  return (z >= 0 && z < nx && w >= 0 && w < ny) ? r[(long long)z * ny + w]
                                                : T(0);
}

// cb[zc, wc] = res[2zc, 2wc] + Σ weight · res[2zc+du, 2wc+dv], in
// interp2.PW_TABLE order.
template <typename T>
__global__ void restrict_kernel(const T* __restrict__ ci_p,
                                const T* __restrict__ res,
                                T* __restrict__ cb, int nx, int ny, int nxc,
                                int nyc, int nb) {
  const int wc = blockIdx.x * blockDim.x + threadIdx.x;
  const int zc = blockIdx.y * blockDim.y + threadIdx.y;
  const int p = blockIdx.z;
  if (zc >= nxc || wc >= nyc) return;
  const CI<T> ci = ci_of(ci_p, p, nb, nxc, nyc);
  res += p * ((long long)nx * ny);
  cb += p * ((long long)nxc * nyc);
  auto fine = [&](int z, int w) { return fine_at(res, z, w, nx, ny); };
  cb[(long long)zc * nyc + wc] = restrict_value(ci, fine, zc, wc);
}

// q[z, w] += P qc (+ res / diag off the coincident points), in place.
// Plane O of so (nb, nx, ny) comes first, so plane p's diagonal sits at the
// same offset as its q.
template <typename T>
__global__ void interp_add_kernel(const T* __restrict__ ci_p,
                                  const T* __restrict__ so,
                                  const T* __restrict__ qc,
                                  const T* __restrict__ res,
                                  T* __restrict__ q, int nx, int ny, int nxc,
                                  int nyc, int nb) {
  using A = Arith<T>;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  const int p = blockIdx.z;
  if (z >= nx || w >= ny) return;
  const CI<T> ci = ci_of(ci_p, p, nb, nxc, nyc);
  qc += p * ((long long)nxc * nyc);
  const long long i = p * ((long long)nx * ny) + (long long)z * ny + w;
  T v = interp_value(ci, qc, z, w, nxc, nyc);
  if ((z | w) & 1) v = A::add(v, A::div(res[i], so[i]));  // res / so[O]
  q[i] = A::add(q[i], v);
}

// K5: x[z, w] = (P qc)[z, w], a new fine tensor (the F-cycle's level
// entry: no residual, no addend).
template <typename T>
__global__ void interp_kernel(const T* __restrict__ ci_p,
                              const T* __restrict__ qc, T* __restrict__ x,
                              int nx, int ny, int nxc, int nyc) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (z >= nx || w >= ny) return;
  const CI<T> ci{ci_p, (long long)(nxc + 1) * (nyc + 1), nyc + 1};
  x[(long long)z * ny + w] = interp_value(ci, qc, z, w, nxc, nyc);
}

// grid_for over the plane, grid z over the batch
inline dim3 grid_batch(int nrows, int ncols, int nb) {
  dim3 g = grid_for(nrows, ncols);
  g.z = nb;
  return g;
}

template <typename T>
int launch_restrict(const void* ci, const void* res, void* cb, int nx, int ny,
                    int nxc, int nyc, int nb, cudaStream_t st) {
  restrict_kernel<T><<<grid_batch(nxc, nyc, nb), dim3(kBlockX, kBlockY), 0,
                       st>>>((const T*)ci, (const T*)res, (T*)cb, nx, ny, nxc,
                             nyc, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp_add(const void* ci, const void* so, const void* qc,
                      const void* res, void* q, int nx, int ny, int nxc,
                      int nyc, int nb, cudaStream_t st) {
  interp_add_kernel<T><<<grid_batch(nx, ny, nb), dim3(kBlockX, kBlockY), 0,
                         st>>>((const T*)ci, (const T*)so, (const T*)qc,
                               (const T*)res, (T*)q, nx, ny, nxc, nyc, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp(const void* ci, const void* qc, void* x, int nx, int ny,
                  int nxc, int nyc, cudaStream_t st) {
  interp_kernel<T><<<grid_for(nx, ny), dim3(kBlockX, kBlockY), 0, st>>>(
      (const T*)ci, (const T*)qc, (T*)x, nx, ny, nxc, nyc);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// cb (nb, nxc, nyc) = Pᵀ res (nb, nx, ny), plane by plane.
// Returns cudaGetLastError().
int cedar_restrict2(int dtype, const void* ci, const void* res, void* cb,
                    int nx, int ny, int nxc, int nyc, int nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_restrict<float>(ci, res, cb, nx, ny, nxc, nyc, nb,
                                         st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_restrict<double>(ci, res, cb, nx, ny, nxc, nyc, nb,
                                          st);
  return (int)cudaErrorInvalidValue;
}

// q (nb, nx, ny) += P qc (nb, nxc, nyc) + res / so[O], in place, plane by
// plane.  Returns cudaGetLastError().
int cedar_interp_add2(int dtype, const void* ci, const void* so,
                      const void* qc, const void* res, void* q, int nx,
                      int ny, int nxc, int nyc, int nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp_add<float>(ci, so, qc, res, q, nx, ny, nxc,
                                           nyc, nb, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp_add<double>(ci, so, qc, res, q, nx, ny, nxc,
                                            nyc, nb, st);
  return (int)cudaErrorInvalidValue;
}

// x (nx, ny) = P qc (nxc, nyc), written in full.
// Returns cudaGetLastError().
int cedar_interp2(int dtype, const void* ci, const void* qc, void* x, int nx,
                  int ny, int nxc, int nyc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp<float>(ci, qc, x, nx, ny, nxc, nyc, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp<double>(ci, qc, x, nx, ny, nxc, nyc, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
