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
//
// Periodic mode (PER, a compile-time instantiation beside the unchanged
// non-periodic ones; the JAX package's XLA path, cedar_tpu/ops/interp3.py
// `restrict` and `interp_add` with `periodic`): K7's fine accessor wraps
// its indices around the periodic axes, K8 and K9 read the coarse values
// through QC3Wrap.  The sums keep their order, so each equals
// restrict_torch, interp_add_torch and interp_torch with `periodic` bit for
// bit.  K7's wrapped neighbours are found once a thread; in K8 and K9 only
// the points next to the wrap take QC3Wrap (a branch a thread), the others
// run the non-periodic code.  The wrap adds no bytes.

#include "transfer3.cuh"

namespace cedar {
namespace {

// cb = Pᵀ res, one coarse point a thread (transfer3.cuh `restrict_value`);
// PER wraps the fine indices around the axes of wr (2c - 1 = -1 reads n - 1,
// 2c + 1 = n reads 0).
template <typename T, bool PER>
__global__ void restrict_kernel(const T* __restrict__ ci_p,
                                const T* __restrict__ res,
                                T* __restrict__ cb, int nx, int ny, int nz,
                                int nxc, int nyc, int nzc, Wrap3 wr) {
  const int zc = blockIdx.x * blockDim.x + threadIdx.x;
  const int yc = blockIdx.y * blockDim.y + threadIdx.y;
  const int xc = blockIdx.z;
  if (yc >= nyc || zc >= nzc) return;
  const CI3<T> ci = make_ci(ci_p, nxc, nyc, nzc);
  const int x = 2 * xc, y = 2 * yc, z = 2 * zc;
  if constexpr (PER) {
    // the fine neighbours 2c - 1 and 2c + 1 along each axis, wrapped on
    // the periodic axes once (-1 or n off the grid on the others);
    // restrict_value asks only for these
    const int xm = x > 0 ? x - 1 : wr.x ? nx - 1 : -1;
    const int xp = x + 1 < nx ? x + 1 : wr.x ? 0 : nx;
    const int ym = y > 0 ? y - 1 : wr.y ? ny - 1 : -1;
    const int yp = y + 1 < ny ? y + 1 : wr.y ? 0 : ny;
    const int zm = z > 0 ? z - 1 : wr.z ? nz - 1 : -1;
    const int zp = z + 1 < nz ? z + 1 : wr.z ? 0 : nz;
    auto wrapped = [&](int ox, int oy, int oz) -> T {
      const int fx = ox < 0 ? xm : ox > 0 ? xp : x;
      const int fy = oy < 0 ? ym : oy > 0 ? yp : y;
      const int fz = oz < 0 ? zm : oz > 0 ? zp : z;
      return (fx >= 0 && fx < nx && fy >= 0 && fy < ny && fz >= 0 && fz < nz)
                 ? res[((long long)fx * ny + fy) * nz + fz]
                 : T(0);
    };
    cb[((long long)xc * nyc + yc) * nzc + zc] =
        restrict_value(ci, wrapped, xc, yc, zc);
  } else {
    auto fine = [&](int ox, int oy, int oz) -> T {
      const int fx = x + ox, fy = y + oy, fz = z + oz;
      return (fx >= 0 && fx < nx && fy >= 0 && fy < ny && fz >= 0 &&
              fz < nz)
                 ? res[((long long)fx * ny + fy) * nz + fz]
                 : T(0);
    };
    cb[((long long)xc * nyc + yc) * nzc + zc] =
        restrict_value(ci, fine, xc, yc, zc);
  }
}

// q += P qc (+ res / diag off the coincident points), in place; PER reads
// qc through QC3Wrap.
template <typename T, bool PER>
__global__ void interp_add_kernel(const T* __restrict__ ci_p,
                                  const T* __restrict__ so,
                                  const T* __restrict__ qc,
                                  const T* __restrict__ res,
                                  T* __restrict__ q, int nx, int ny, int nz,
                                  int nxc, int nyc, int nzc, Wrap3 wr) {
  using A = Arith<T>;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (y >= ny || z >= nz) return;
  const CI3<T> ci = make_ci(ci_p, nxc, nyc, nzc);
  const long long i = ((long long)x * ny + y) * nz + z;
  const T init = ((x | y | z) & 1) ? A::div(res[i], so[i]) : T(0);  // so[P]
  if constexpr (PER) {
    // the points that read coarse index nxc (nyc, nzc) read index 0; the
    // others as without the wrap
    if (reads_wrap(x, y, z, nxc, nyc, nzc, wr)) {
      q[i] = A::add(q[i], interp_with<T>(ci, QC3Wrap<T>{qc, nxc, nyc, nzc,
                                                        wr},
                                         x, y, z, [&] { return init; }));
      return;
    }
  }
  q[i] = A::add(q[i], interp_value(ci, qc, x, y, z, nxc, nyc, nzc, init));
}

// x = P qc, a new fine tensor (no residual, no addend); PER reads qc
// through QC3Wrap.
template <typename T, bool PER>
__global__ void interp_kernel(const T* __restrict__ ci_p,
                              const T* __restrict__ qc, T* __restrict__ out,
                              int nx, int ny, int nz, int nxc, int nyc,
                              int nzc, Wrap3 wr) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (y >= ny || z >= nz) return;
  const CI3<T> ci = make_ci(ci_p, nxc, nyc, nzc);
  if constexpr (PER) {
    if (reads_wrap(x, y, z, nxc, nyc, nzc, wr)) {
      out[((long long)x * ny + y) * nz + z] =
          interp_with<T>(ci, QC3Wrap<T>{qc, nxc, nyc, nzc, wr}, x, y, z,
                         [&] { return T(0); });
      return;
    }
  }
  out[((long long)x * ny + y) * nz + z] =
      interp_value(ci, qc, x, y, z, nxc, nyc, nzc, T(0));
}

inline bool any_wrap(Wrap3 wr) { return wr.x || wr.y || wr.z; }

template <typename T>
int launch_restrict(const void* ci, const void* res, void* cb, int nx, int ny,
                    int nz, int nxc, int nyc, int nzc, Wrap3 wr,
                    cudaStream_t st) {
  auto fn = any_wrap(wr) ? restrict_kernel<T, true> : restrict_kernel<T, false>;
  fn<<<grid3_for(nxc, nyc, nzc), dim3(kBlockX, kBlockY), 0, st>>>(
      (const T*)ci, (const T*)res, (T*)cb, nx, ny, nz, nxc, nyc, nzc, wr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp_add(const void* ci, const void* so, const void* qc,
                      const void* res, void* q, int nx, int ny, int nz,
                      int nxc, int nyc, int nzc, Wrap3 wr, cudaStream_t st) {
  auto fn = any_wrap(wr) ? interp_add_kernel<T, true>
                         : interp_add_kernel<T, false>;
  fn<<<grid3_for(nx, ny, nz), dim3(kBlockX, kBlockY), 0, st>>>(
      (const T*)ci, (const T*)so, (const T*)qc, (const T*)res, (T*)q, nx, ny,
      nz, nxc, nyc, nzc, wr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interp(const void* ci, const void* qc, void* out, int nx, int ny,
                  int nz, int nxc, int nyc, int nzc, Wrap3 wr,
                  cudaStream_t st) {
  auto fn = any_wrap(wr) ? interp_kernel<T, true> : interp_kernel<T, false>;
  fn<<<grid3_for(nx, ny, nz), dim3(kBlockX, kBlockY), 0, st>>>(
      (const T*)ci, (const T*)qc, (T*)out, nx, ny, nz, nxc, nyc, nzc, wr);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// cb (nxc, nyc, nzc) = Pᵀ res (nx, ny, nz), the fine indices wrapping
// around the periodic axes px, py, pz.  Returns cudaGetLastError().
int cedar_restrict3(int dtype, const void* ci, const void* res, void* cb,
                    int nx, int ny, int nz, int nxc, int nyc, int nzc,
                    int px, int py, int pz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Wrap3 wr{px != 0, py != 0, pz != 0};
  if (dtype == cedar::kFloat32)
    return cedar::launch_restrict<float>(ci, res, cb, nx, ny, nz, nxc, nyc,
                                         nzc, wr, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_restrict<double>(ci, res, cb, nx, ny, nz, nxc, nyc,
                                          nzc, wr, st);
  return (int)cudaErrorInvalidValue;
}

// q (nx, ny, nz) += P qc (nxc, nyc, nzc) + res / so[P], in place; coarse
// index nxc (nyc, nzc) is index 0 along the periodic axes px, py, pz.
// Returns cudaGetLastError().
int cedar_interp_add3(int dtype, const void* ci, const void* so,
                      const void* qc, const void* res, void* q, int nx,
                      int ny, int nz, int nxc, int nyc, int nzc, int px,
                      int py, int pz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Wrap3 wr{px != 0, py != 0, pz != 0};
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp_add<float>(ci, so, qc, res, q, nx, ny, nz,
                                           nxc, nyc, nzc, wr, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp_add<double>(ci, so, qc, res, q, nx, ny, nz,
                                            nxc, nyc, nzc, wr, st);
  return (int)cudaErrorInvalidValue;
}

// x (nx, ny, nz) = P qc (nxc, nyc, nzc), written in full; coarse index nxc
// (nyc, nzc) is index 0 along the periodic axes px, py, pz.
// Returns cudaGetLastError().
int cedar_interp3(int dtype, const void* ci, const void* qc, void* x, int nx,
                  int ny, int nz, int nxc, int nyc, int nzc, int px, int py,
                  int pz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cedar::Wrap3 wr{px != 0, py != 0, pz != 0};
  if (dtype == cedar::kFloat32)
    return cedar::launch_interp<float>(ci, qc, x, nx, ny, nz, nxc, nyc, nzc,
                                       wr, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_interp<double>(ci, qc, x, nx, ny, nz, nxc, nyc, nzc,
                                        wr, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
