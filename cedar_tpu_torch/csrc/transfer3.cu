// K7 (restrict3), K8 (interp_add3) and K9 (interp3): the 3D BoxMG grid
// transfers.
//
// K7 replaces the Pallas kernels cedar_tpu/ops/pallas_transfer3.py
// `_restrict_kernel` (called by `_restrict_call` / `restrict`) and
// pallas3_split.py `_restrict_kernel3` / `_restrict_kernel3_panel`
// (`_restrict_call3`, the F-cycle's b chain): cb = Pᵀ res over the
// 27-point footprint.  K8 replaces pallas3_split.py `_interp_kernel3` /
// `_interp_kernel3_panel` (`_interp_call3`): q += P qc, plus res / diag at
// fine-only points.  K9 replaces `_interp_kernel3_nores` (with its nested
// panel kernel, `interp_split_nores3`): x = P qc, the F-cycle's level
// entry, where residual and addend are exactly zero.  The math and the
// term order are ops/interp3.py `restrict_torch`, `interp_add_torch` and
// `interp_torch` of this package (reference: BMG3_SymStd_restrict.f90,
// BMG3_SymStd_interp_add.f90).
//
// What bounds them on the H100: bytes.  The 26 CI weight planes of the
// coarse grid (26/8 of a fine grid) dominate K7's and K9's streams; K8
// also reads q, res and the diagonal and writes q.  A few flops per byte.
// Design: one thread per output point (K7 a coarse point, K8/K9 a fine
// point), threadIdx.x along the contiguous z axis.  The Pallas versions
// read padded, per-coarse-point restacked weights (setup_pw3 / pw4) and a
// parity-split residual because Mosaic cannot reshape lanes in a kernel;
// here the kernels read the unpadded CI (26, nxc+1, nyc+1, nzc+1) and the
// dense fine arrays directly, and K8 adds into q in place, so no split,
// restack, padding or merge pass exists.
//
// The CI access, the restriction sum and `interp_value` live in
// transfer3.cuh, shared with the fused kernels K15/K16 (fused3.cu).

#include "transfer3.cuh"

namespace cedar {
namespace {

// cb = Pᵀ res, one coarse point a thread (transfer3.cuh `restrict_value`).
template <typename T>
__global__ void restrict_kernel(const T* __restrict__ ci_p,
                                const T* __restrict__ res,
                                T* __restrict__ cb, int nx, int ny, int nz,
                                int nxc, int nyc, int nzc) {
  const int zc = blockIdx.x * blockDim.x + threadIdx.x;
  const int yc = blockIdx.y * blockDim.y + threadIdx.y;
  const int xc = blockIdx.z;
  if (yc >= nyc || zc >= nzc) return;
  const CI3<T> ci = make_ci(ci_p, nxc, nyc, nzc);
  const int x = 2 * xc, y = 2 * yc, z = 2 * zc;
  auto fine = [&](int ox, int oy, int oz) -> T {
    const int fx = x + ox, fy = y + oy, fz = z + oz;
    return (fx >= 0 && fx < nx && fy >= 0 && fy < ny && fz >= 0 && fz < nz)
               ? res[((long long)fx * ny + fy) * nz + fz]
               : T(0);
  };
  cb[((long long)xc * nyc + yc) * nzc + zc] =
      restrict_value(ci, fine, xc, yc, zc);
}

// q += P qc (+ res / diag off the coincident points), in place.
template <typename T>
__global__ void interp_add_kernel(const T* __restrict__ ci_p,
                                  const T* __restrict__ so,
                                  const T* __restrict__ qc,
                                  const T* __restrict__ res,
                                  T* __restrict__ q, int nx, int ny, int nz,
                                  int nxc, int nyc, int nzc) {
  using A = Arith<T>;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (y >= ny || z >= nz) return;
  const CI3<T> ci = make_ci(ci_p, nxc, nyc, nzc);
  const long long i = ((long long)x * ny + y) * nz + z;
  const T init = ((x | y | z) & 1) ? A::div(res[i], so[i]) : T(0);  // so[P]
  q[i] = A::add(q[i], interp_value(ci, qc, x, y, z, nxc, nyc, nzc, init));
}

// x = P qc, a new fine tensor (no residual, no addend).
template <typename T>
__global__ void interp_kernel(const T* __restrict__ ci_p,
                              const T* __restrict__ qc, T* __restrict__ out,
                              int nx, int ny, int nz, int nxc, int nyc,
                              int nzc) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (y >= ny || z >= nz) return;
  const CI3<T> ci = make_ci(ci_p, nxc, nyc, nzc);
  out[((long long)x * ny + y) * nz + z] =
      interp_value(ci, qc, x, y, z, nxc, nyc, nzc, T(0));
}

template <typename T>
int launch_restrict(const void* ci, const void* res, void* cb, int nx, int ny,
                    int nz, int nxc, int nyc, int nzc, cudaStream_t st) {
  restrict_kernel<T><<<grid3_for(nxc, nyc, nzc), dim3(kBlockX, kBlockY), 0,
                       st>>>((const T*)ci, (const T*)res, (T*)cb, nx, ny, nz,
                             nxc, nyc, nzc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp_add(const void* ci, const void* so, const void* qc,
                      const void* res, void* q, int nx, int ny, int nz,
                      int nxc, int nyc, int nzc, cudaStream_t st) {
  interp_add_kernel<T><<<grid3_for(nx, ny, nz), dim3(kBlockX, kBlockY), 0,
                         st>>>((const T*)ci, (const T*)so, (const T*)qc,
                               (const T*)res, (T*)q, nx, ny, nz, nxc, nyc,
                               nzc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp(const void* ci, const void* qc, void* out, int nx, int ny,
                  int nz, int nxc, int nyc, int nzc, cudaStream_t st) {
  interp_kernel<T><<<grid3_for(nx, ny, nz), dim3(kBlockX, kBlockY), 0, st>>>(
      (const T*)ci, (const T*)qc, (T*)out, nx, ny, nz, nxc, nyc, nzc);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// cb (nxc, nyc, nzc) = Pᵀ res (nx, ny, nz).  Returns cudaGetLastError().
int cedar_restrict3(int dtype, const void* ci, const void* res, void* cb,
                    int nx, int ny, int nz, int nxc, int nyc, int nzc,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_restrict<float>(ci, res, cb, nx, ny, nz, nxc, nyc,
                                         nzc, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_restrict<double>(ci, res, cb, nx, ny, nz, nxc, nyc,
                                          nzc, st);
  return (int)cudaErrorInvalidValue;
}

// q (nx, ny, nz) += P qc (nxc, nyc, nzc) + res / so[P], in place.
// Returns cudaGetLastError().
int cedar_interp_add3(int dtype, const void* ci, const void* so,
                      const void* qc, const void* res, void* q, int nx,
                      int ny, int nz, int nxc, int nyc, int nzc,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp_add<float>(ci, so, qc, res, q, nx, ny, nz,
                                           nxc, nyc, nzc, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp_add<double>(ci, so, qc, res, q, nx, ny, nz,
                                            nxc, nyc, nzc, st);
  return (int)cudaErrorInvalidValue;
}

// x (nx, ny, nz) = P qc (nxc, nyc, nzc), written in full.
// Returns cudaGetLastError().
int cedar_interp3(int dtype, const void* ci, const void* qc, void* x, int nx,
                  int ny, int nz, int nxc, int nyc, int nzc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp<float>(ci, qc, x, nx, ny, nz, nxc, nyc, nzc,
                                       st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp<double>(ci, qc, x, nx, ny, nz, nxc, nyc, nzc,
                                        st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
