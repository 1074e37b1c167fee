// 2D BoxMG transfer device code shared by K2/K3/K5 (transfer2.cu) and the
// fused kernels K12/K13 (fused2.cu), so that a fused kernel rounds as the
// separate transfers do: the CI weight access, the restriction of one
// coarse point and the interpolated value of one fine point.  The term
// orders are those of ops/interp2.py (`restrict_torch`, the PW_TABLE
// order, and `_interp_parts`) of this package.
//
// CI is unpadded, (8, nb, nxc+1, nyc+1): the high row nxc and column nyc
// hold the weights of fine points beyond the last coarse point
// (core/types.py InterpDir2).  Fine indices outside the grid and coarse
// indices nxc / nyc read as zero.
#pragma once

#include "common.cuh"

namespace cedar {

// InterpDir2 plane indices (core/types.py)
constexpr int LL = 0, LR = 1, LA = 2, LB = 3, LSW = 4, LNW = 5, LNE = 6, LSE = 7;

template <typename T>
struct CI {
  const T* __restrict__ p;
  long long plane;  // nb*(nxc+1)*(nyc+1): one weight plane of every batch
  int stride;       // nyc+1
  __device__ __forceinline__ T operator()(int d, int k, int m) const {
    return p[d * plane + (long long)k * stride + m];
  }
};

// The weights of batch plane p: CI (8, nb, nxc+1, nyc+1).
template <typename T>
__device__ __forceinline__ CI<T> ci_of(const T* __restrict__ ci_p, int p,
                                       int nb, int nxc, int nyc) {
  const long long cplane = (long long)(nxc + 1) * (nyc + 1);
  return CI<T>{ci_p + p * cplane, nb * cplane, nyc + 1};
}

// cb[zc, wc] = res(2zc, 2wc) + Σ weight · res(2zc+du, 2wc+dv), in
// interp2.PW_TABLE order; ci(d, k, m) is the weight and res(z, w) the fine
// value, zero outside the grid (functors, so that they can read device
// memory or K12's shared-memory rings).
template <typename Ci, typename Fine>
__device__ __forceinline__ auto restrict_value(const Ci& ci, const Fine& res,
                                               int zc, int wc)
    -> decltype(res(0, 0)) {
  using T = decltype(res(0, 0));
  using A = Arith<T>;
  const int z = 2 * zc, w = 2 * wc;
  T acc = res(z, w);
  acc = A::add(acc, A::mul(ci(LR, zc, wc), res(z - 1, w)));
  acc = A::add(acc, A::mul(ci(LL, zc + 1, wc), res(z + 1, w)));
  acc = A::add(acc, A::mul(ci(LA, zc, wc), res(z, w - 1)));
  acc = A::add(acc, A::mul(ci(LB, zc, wc + 1), res(z, w + 1)));
  acc = A::add(acc, A::mul(ci(LNE, zc, wc), res(z - 1, w - 1)));
  acc = A::add(acc, A::mul(ci(LNW, zc + 1, wc), res(z + 1, w - 1)));
  acc = A::add(acc, A::mul(ci(LSE, zc, wc + 1), res(z - 1, w + 1)));
  return A::add(acc, A::mul(ci(LSW, zc + 1, wc + 1), res(z + 1, w + 1)));
}

// (P qc)[z, w]: the coarse value at coincident points, else the weighted
// sum of the coarse neighbours of the point's parity class, from the
// weights ci(d, k, m) and the coarse values QC(k, m) (zero at k = nxc or m
// = nyc; k, m >= 0 on every path below): functors, so that they can read
// device memory (interp_value) or K13's shared-memory rings.  Shared by
// K3, K5 and K13 so that they cannot drift apart.
template <typename T, typename Ci, typename Qc>
__device__ __forceinline__ T interp_at(const Ci& ci, const Qc& QC, int z,
                                       int w) {
  using A = Arith<T>;
  const int pz = z & 1, pw = w & 1;
  if (!pz && !pw) return QC(z >> 1, w >> 1);
  if (pz && !pw) {  // x-line point (2k-1, 2m)
    const int k = (z + 1) >> 1, m = w >> 1;
    return A::add(A::mul(ci(LR, k, m), QC(k, m)),
                  A::mul(ci(LL, k, m), QC(k - 1, m)));
  }
  if (!pz && pw) {  // y-line point (2k, 2m-1)
    const int k = z >> 1, m = (w + 1) >> 1;
    return A::add(A::mul(ci(LA, k, m), QC(k, m)),
                  A::mul(ci(LB, k, m), QC(k, m - 1)));
  }
  // cell centre (2k-1, 2m-1)
  const int k = (z + 1) >> 1, m = (w + 1) >> 1;
  T s = A::mul(ci(LSW, k, m), QC(k - 1, m - 1));
  s = A::add(s, A::mul(ci(LNW, k, m), QC(k - 1, m)));
  s = A::add(s, A::mul(ci(LNE, k, m), QC(k, m)));
  return A::add(s, A::mul(ci(LSE, k, m), QC(k, m - 1)));
}

// interp_at with CI and qc (nxc, nyc) in device memory.
template <typename T>
__device__ __forceinline__ T interp_value(const CI<T>& ci,
                                          const T* __restrict__ qc, int z,
                                          int w, int nxc, int nyc) {
  return interp_at<T>(ci, [&](int k, int m) -> T {
    return (k < nxc && m < nyc) ? qc[(long long)k * nyc + m] : T(0);
  }, z, w);
}

}  // namespace cedar
