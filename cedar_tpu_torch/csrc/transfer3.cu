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
// The guard entries of CI at index nxc / nyc / nzc hold the weights of
// fine points beyond the last coarse point; at even fine extents the
// weight toward the missing upper coarse point is zero by construction,
// and the coarse value there reads as zero.  Fine indices off the grid
// read as zero.

#include "common.cuh"

// The 26 CI planes in InterpDir3 order (core/types.py) with the fine ->
// coarse displacement δ each interpolates across (ops/interp3.DELTA):
// X(plane, δx, δy, δz).
#define CEDAR_DELTA3(X)                                                      \
  X(0, -1, 0, 0) X(1, 1, 0, 0) X(2, 0, 1, 0) X(3, 0, -1, 0) X(4, 0, 0, 1)    \
  X(5, 0, 0, -1) X(6, 1, 1, 0) X(7, 1, -1, 0) X(8, -1, -1, 0)                \
  X(9, -1, 1, 0) X(10, -1, 0, -1) X(11, -1, 0, 1) X(12, 1, 0, 1)             \
  X(13, 1, 0, -1) X(14, 0, 1, -1) X(15, 0, 1, 1) X(16, 0, -1, 1)             \
  X(17, 0, -1, -1) X(18, -1, -1, -1) X(19, -1, 1, -1) X(20, 1, 1, -1)        \
  X(21, 1, -1, -1) X(22, -1, -1, 1) X(23, -1, 1, 1) X(24, 1, 1, 1)           \
  X(25, 1, -1, 1)

namespace cedar {
namespace {

template <typename T>
struct CI3 {
  const T* __restrict__ p;
  long long plane;  // (nxc+1)*(nyc+1)*(nzc+1)
  int s1, s2;       // (nyc+1), (nzc+1)
  __device__ __forceinline__ T operator()(int d, int i, int j, int k) const {
    return p[d * plane + ((long long)i * s1 + j) * s2 + k];
  }
};

template <typename T>
__device__ __forceinline__ CI3<T> make_ci(const T* p, int nxc, int nyc,
                                          int nzc) {
  return CI3<T>{p, (long long)(nxc + 1) * (nyc + 1) * (nzc + 1), nyc + 1,
                nzc + 1};
}

// cb[c] = res[2c] + Σ weight · res[2c + off] over off = -δ in plane order
// (interp3.restrict_torch: [(0,0,0)] + PW3_TABLE); the weight toward
// 2c + off lies at CI index c + max(off, 0).
template <typename T>
__global__ void restrict_kernel(const T* __restrict__ ci_p,
                                const T* __restrict__ res,
                                T* __restrict__ cb, int nx, int ny, int nz,
                                int nxc, int nyc, int nzc) {
  using A = Arith<T>;
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
  T acc = fine(0, 0, 0);
#define CEDAR_R(P, DX, DY, DZ)                                               \
  acc = A::add(acc, A::mul(ci(P, xc + (-(DX) > 0), yc + (-(DY) > 0),         \
                              zc + (-(DZ) > 0)),                             \
                           fine(-(DX), -(DY), -(DZ))));
  CEDAR_DELTA3(CEDAR_R)
#undef CEDAR_R
  cb[((long long)xc * nyc + yc) * nzc + zc] = acc;
}

// init + Σ weight · qc over the planes of the point's parity class, in
// plane order (interp3._interp_parts); at coincident points the coarse
// value alone.  Shared by K8 (init = res / diag) and K9 (init = 0) so that
// the two cannot drift apart.
//
// Along each axis a fine index f has parity p = f & 1; its weight index is
// (f >> 1) + p and its coarse neighbour for δ is (f >> 1) + (δ > 0).
template <typename T>
__device__ __forceinline__ T interp_value(const CI3<T>& ci,
                                          const T* __restrict__ qc, int x,
                                          int y, int z, int nxc, int nyc,
                                          int nzc, T init) {
  using A = Arith<T>;
  const int hx = x >> 1, hy = y >> 1, hz = z >> 1;
  const int px = x & 1, py = y & 1, pz = z & 1;
  if (!(px | py | pz)) return qc[((long long)hx * nyc + hy) * nzc + hz];
  const int cat = px | (py << 1) | (pz << 2);
  // coarse value, zero at index nxc / nyc / nzc
  auto QC = [&](int i, int j, int k) -> T {
    return (i < nxc && j < nyc && k < nzc)
               ? qc[((long long)i * nyc + j) * nzc + k]
               : T(0);
  };
  T v = init;
#define CEDAR_I(P, DX, DY, DZ)                                               \
  if (cat == ((DX != 0) | ((DY != 0) << 1) | ((DZ != 0) << 2)))              \
    v = A::add(v, A::mul(ci(P, hx + px, hy + py, hz + pz),                   \
                         QC(hx + (DX > 0), hy + (DY > 0), hz + (DZ > 0))));
  CEDAR_DELTA3(CEDAR_I)
#undef CEDAR_I
  return v;
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
