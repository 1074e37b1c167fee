// K6: 3D multicolour Gauss-Seidel sweep, one colour phase per launch,
// plus the residual b - A q as one more launch.
//
// Replaces the Pallas kernels cedar_tpu/ops/pallas3.py `_sweep_kernel`
// (called by `_point_relax_call` / `point_relax`) and `_sweep2d_kernel`
// (its (x, y)-tiled variant for wide rows, `_point_relax2d_call`), which
// run all colour phases of a sweep on a VMEM-resident slab and optionally
// emit the residual.  The same function is what the octant-split and
// wavefront sweeps (pallas3_split.py `_sweep_kernel3`, pallas3_stream.py
// `_stream_kernel3`) compute.  Its math is ops/relax3.py (masked phase
// update) and ops/stencil3.py (`offdiag_apply`, `residual`) of this
// package.
//
// What bounds it on the H100: bytes.  A 7-point phase reads 4 stencil
// planes, b and q and writes one colour of q (about 0.5 flop per byte);
// a 27-point phase reads 14 planes.  Design: one thread per grid point
// with non-members returning at once; threadIdx.x runs along the
// contiguous z axis so loads and stores coalesce, and the neighbour reads
// along y and x hit L1/L2 sectors that neighbouring warps and blocks also
// read.  A colour phase is a grid-wide dependency (phase c+1 reads what
// phase c wrote), so phases are separate launches on one stream.  Keeping
// several phases on chip (temporal blocking, as the Pallas slab does in
// VMEM) is left to later work.
//
// In-place update is race-free only because no point couples to a point
// of its own colour: red-black on x+y+z for 7-point, the (x%2, y%2, z%2)
// 8-colouring for 27-point.  The wrapper (ops/cuda3.py) checks the kind.
//
// The off-diagonal sum is stencil3.cuh's `offdiag`, shared with the fused
// kernels K14-K16 (fused3.cu).

#include "stencil3.cuh"

namespace cedar {
namespace {

// One colour phase: q = (b + Σ coupling·q_nb) * (1/P) at this colour's
// points.  Colours anchor at global indices (x + ox, y + oy, z + oz):
//   7-point:  (gx + gy + gz) % 2 == color
//   27-point: gx % 2 == color & 1, gy % 2 == color >> 1 & 1,
//             gz % 2 == color >> 2 & 1
template <typename T, bool TS>
__global__ void sweep_phase(const T* __restrict__ so, T* q,
                            const T* __restrict__ b, int nx, int ny, int nz,
                            int color, int ox, int oy, int oz) {
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
  if (!member) return;
  const long long i = ((long long)x * ny + y) * nz + z;
  const T rec = A::div(T(1), so[i]);  // plane P is plane 0
  q[i] = A::mul(A::add(b[i], offdiag<T, TS>(so, q, x, y, z, nx, ny, nz)),
                rec);
}

// res = (b + Σ coupling·q_nb) - P·q
template <typename T, bool TS>
__global__ void residual(const T* __restrict__ so, const T* __restrict__ q,
                         const T* __restrict__ b, T* __restrict__ res,
                         int nx, int ny, int nz) {
  using A = Arith<T>;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (y >= ny || z >= nz) return;
  const long long i = ((long long)x * ny + y) * nz + z;
  res[i] = A::sub(A::add(b[i], offdiag<T, TS>(so, q, x, y, z, nx, ny, nz)),
                  A::mul(so[i], q[i]));
}

template <typename T>
int launch_phase(const void* so, void* q, const void* b, int nx, int ny,
                 int nz, int ts, int color, int ox, int oy, int oz,
                 cudaStream_t st) {
  const dim3 grid = grid3_for(nx, ny, nz), block(kBlockX, kBlockY);
  if (ts)
    sweep_phase<T, true><<<grid, block, 0, st>>>(
        (const T*)so, (T*)q, (const T*)b, nx, ny, nz, color, ox, oy, oz);
  else
    sweep_phase<T, false><<<grid, block, 0, st>>>(
        (const T*)so, (T*)q, (const T*)b, nx, ny, nz, color, ox, oy, oz);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_residual(const void* so, const void* q, const void* b, void* res,
                    int nx, int ny, int nz, int ts, cudaStream_t st) {
  const dim3 grid = grid3_for(nx, ny, nz), block(kBlockX, kBlockY);
  if (ts)
    residual<T, true><<<grid, block, 0, st>>>(
        (const T*)so, (const T*)q, (const T*)b, (T*)res, nx, ny, nz);
  else
    residual<T, false><<<grid, block, 0, st>>>(
        (const T*)so, (const T*)q, (const T*)b, (T*)res, nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// One colour phase of the sweep, in place on q.  Returns cudaGetLastError().
int cedar_sweep3_phase(int dtype, const void* so, void* q, const void* b,
                       int nx, int ny, int nz, int ts, int color, int ox,
                       int oy, int oz, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_phase<float>(so, q, b, nx, ny, nz, ts, color, ox, oy,
                                      oz, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_phase<double>(so, q, b, nx, ny, nz, ts, color, ox,
                                       oy, oz, st);
  return (int)cudaErrorInvalidValue;
}

// res = b - A q.  Returns cudaGetLastError().
int cedar_residual3(int dtype, const void* so, const void* q, const void* b,
                    void* res, int nx, int ny, int nz, int ts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_residual<float>(so, q, b, res, nx, ny, nz, ts, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_residual<double>(so, q, b, res, nx, ny, nz, ts, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
