// Shared helpers of the port's kernels.
//
// Arithmetic goes through the round-to-nearest intrinsics so that nvcc
// does not contract a*b + c into one FMA: each product and each sum rounds
// once, in the term order of the PyTorch reference functions
// (ops/stencil2.offdiag_apply, ops/interp2.restrict / interp_add and their
// 3D counterparts), so a kernel and its plain version agree to the last
// bit or within a few ulps.
#pragma once

#include <cuda_runtime.h>

namespace cedar {

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

// dtype codes of the C entry points (ops/cuda_build.DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kFloat64 = 1;

// The periodic axes of a 2D wrap-aware kernel: x (the first axis, z) and
// y (the second, w).
struct Wrap {
  bool x = false, y = false;
};

// The periodic axes of a 3D wrap-aware kernel: x, y and z (the first,
// second and third axis of a (nx, ny, nz) grid).
struct Wrap3 {
  bool x = false, y = false, z = false;
};

// z modulo n in [0, n), for any int z (a tile's halo can wrap more than
// once around a grid smaller than the tile).
__device__ __forceinline__ int wrap_index(int z, int n) {
  z %= n;
  return z < 0 ? z + n : z;
}

// 2D launch shape: x runs along the contiguous (w) axis, y along rows (z).
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

inline dim3 grid_for(int nrows, int ncols) {
  return dim3((ncols + kBlockX - 1) / kBlockX, (nrows + kBlockY - 1) / kBlockY);
}

// 3D launch shape over (n0, n1, n2), row-major with n2 contiguous: x runs
// along n2, y along n1, and grid z is the index along n0 (so n0 <= 65535).
inline dim3 grid3_for(int n0, int n1, int n2) {
  return dim3((n2 + kBlockX - 1) / kBlockX, (n1 + kBlockY - 1) / kBlockY, n0);
}

}  // namespace cedar
