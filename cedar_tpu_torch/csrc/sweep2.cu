// K1: 2D multicolour Gauss-Seidel sweep, one colour phase per launch,
// plus the residual b - A q as one more launch.
//
// Replaces the Pallas kernel cedar_tpu/ops/pallas2.py `_sweep_kernel`
// (called by `_point_relax_call` / `point_relax`), which runs all colour
// phases of a sweep on a VMEM-resident row slab and optionally emits the
// residual.  Its math is ops/relax2.py (masked phase update) and
// ops/stencil2.py (`offdiag_apply`, `residual`) of this package.
//
// What bounds it on the H100: bytes.  A phase reads the coupling planes
// (3 for 5-point, 5 for 9-point), b and the neighbouring q values and
// writes the phase's colour of q: about 1 flop per byte, far below the
// card's ~20 flop/byte f32 balance point.  Design: one thread per grid
// point with non-members returning at once, consecutive threads on
// consecutive w so every load and store is coalesced; neighbour reads of
// a warp fall in the same or adjacent 32-byte sectors, so L1/L2 serve the
// reuse.  A colour phase is a grid-wide dependency (phase c+1 reads what
// phase c wrote), so phases are separate launches on one stream rather
// than one kernel with a grid barrier.  Keeping several phases on chip
// (temporal blocking in shared memory, as the Pallas slab does in VMEM)
// is left to later work.
//
// In-place update is race-free only because no point couples to a point
// of its own colour: red-black for 5-point, the (w%2, z%2) 4-colouring
// for 9-point.  The Python wrapper (ops/cuda2.py) checks the stencil kind.
//
// Up-shifted couplings (to z+1 or w+1) read the neighbour's stored plane
// (W[z+1,w], S[z,w+1], NW[z+1,w], NW[z,w+1], SW[z+1,w+1]); a term whose
// neighbour lies outside the grid is exactly zero, which is what the
// zero-filled shifts of the reference give.

#include "stencil2.cuh"

namespace cedar {
namespace {

// offdiag (Σ coupling · q(neighbour), stencil2.offsets_for order) is in
// stencil2.cuh, shared with K10's residual.

// One colour phase: q = (b + Σ coupling·q_nb) * (1/O) at this colour's
// points.  Colours anchor at global indices (z + oz, w + ow):
//   5-point: (gz + gw) % 2 == color
//   9-point: gw % 2 == color / 2 and gz % 2 == color % 2
template <typename T, bool NINE>
__global__ void sweep_phase(const T* __restrict__ so, T* q,
                            const T* __restrict__ b, int nx, int ny,
                            int color, int oz, int ow) {
  using A = Arith<T>;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (z >= nx || w >= ny) return;
  const int gz = z + oz, gw = w + ow;
  const bool member = NINE
      ? (((gw & 1) == (color >> 1)) && ((gz & 1) == (color & 1)))
      : (((gz + gw) & 1) == color);
  if (!member) return;
  const long long i = (long long)z * ny + w;
  const T rec = A::div(T(1), so[i]);  // plane O is plane 0
  const long long P = (long long)nx * ny;
  q[i] = A::mul(A::add(b[i], offdiag<T, NINE>(so, q, P, z, w, nx, ny)), rec);
}

// res = (b + Σ coupling·q_nb) - O·q
template <typename T, bool NINE>
__global__ void residual(const T* __restrict__ so, const T* __restrict__ q,
                         const T* __restrict__ b, T* __restrict__ res,
                         int nx, int ny) {
  using A = Arith<T>;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (z >= nx || w >= ny) return;
  const long long i = (long long)z * ny + w;
  const long long P = (long long)nx * ny;
  res[i] = A::sub(A::add(b[i], offdiag<T, NINE>(so, q, P, z, w, nx, ny)),
                  A::mul(so[i], q[i]));
}

template <typename T>
int launch_phase(const void* so, void* q, const void* b, int nx, int ny,
                 int nine, int color, int oz, int ow, cudaStream_t st) {
  const dim3 grid = grid_for(nx, ny), block(kBlockX, kBlockY);
  if (nine)
    sweep_phase<T, true><<<grid, block, 0, st>>>(
        (const T*)so, (T*)q, (const T*)b, nx, ny, color, oz, ow);
  else
    sweep_phase<T, false><<<grid, block, 0, st>>>(
        (const T*)so, (T*)q, (const T*)b, nx, ny, color, oz, ow);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_residual(const void* so, const void* q, const void* b, void* res,
                    int nx, int ny, int nine, cudaStream_t st) {
  const dim3 grid = grid_for(nx, ny), block(kBlockX, kBlockY);
  if (nine)
    residual<T, true><<<grid, block, 0, st>>>(
        (const T*)so, (const T*)q, (const T*)b, (T*)res, nx, ny);
  else
    residual<T, false><<<grid, block, 0, st>>>(
        (const T*)so, (const T*)q, (const T*)b, (T*)res, nx, ny);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cedar

extern "C" {

// One colour phase of the sweep, in place on q.  Returns cudaGetLastError().
int cedar_sweep2_phase(int dtype, const void* so, void* q, const void* b,
                       int nx, int ny, int nine, int color, int oz, int ow,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_phase<float>(so, q, b, nx, ny, nine, color, oz, ow, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_phase<double>(so, q, b, nx, ny, nine, color, oz, ow, st);
  return (int)cudaErrorInvalidValue;
}

// res = b - A q.  Returns cudaGetLastError().
int cedar_residual2(int dtype, const void* so, const void* q, const void* b,
                    void* res, int nx, int ny, int nine, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == cedar::kFloat32)
    return cedar::launch_residual<float>(so, q, b, res, nx, ny, nine, st);
  if (dtype == cedar::kFloat64)
    return cedar::launch_residual<double>(so, q, b, res, nx, ny, nine, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
