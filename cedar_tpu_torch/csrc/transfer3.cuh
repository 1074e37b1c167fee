// 3D BoxMG transfer device code shared by K7-K9 (transfer3.cu) and the
// fused kernels K15/K16 (fused3.cu, edge3.cu), so that a fused kernel
// rounds as the separate transfers do: the CI weight access, the
// restriction of one coarse point and the interpolated value of one fine
// point.  The weights and coarse values come through accessors (CI3, QC3
// on the grid; the 7-point K15 passes its own over shared-memory rings),
// so the term order is written
// once.  The term
// orders are those of ops/interp3.py (`restrict_torch`, the PW3_TABLE
// order, and `_interp_parts`) of this package (reference:
// BMG3_SymStd_restrict.f90, BMG3_SymStd_interp_add.f90).
//
// CI is unpadded, (26, nxc+1, nyc+1, nzc+1): the guard entries at index
// nxc / nyc / nzc hold the weights of fine points beyond the last coarse
// point; at even fine extents the weight toward the missing upper coarse
// point is zero by construction, and the coarse value there reads as
// zero.  Fine indices off the grid read as zero.
//
// On a periodic axis (K7-K9's periodic mode) the fine accessor wraps the
// fine index around (interp3.restrict_torch's coarse_sample with wrap) and
// QC3Wrap reads coarse index nxc (nyc, nzc) as index 0 (interp3's padded
// qc with qcp[n_c] = qcp[0]); the CI needs no change, its wrap entries at
// index 0 come from setup (interp3.setup_interp).
#pragma once

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

// The coarse values qc (nxc, nyc, nzc) on the grid, zero at index nxc /
// nyc / nzc.  K16 reads CI and qc through accessors of the same shape over
// its shared-memory rings.
template <typename T>
struct QC3 {
  const T* __restrict__ p;
  int nxc, nyc, nzc;
  __device__ __forceinline__ T operator()(int i, int j, int k) const {
    return (i < nxc && j < nyc && k < nzc)
               ? p[((long long)i * nyc + j) * nzc + k]
               : T(0);
  }
};

// QC3 on periodic axes: coarse index nxc (nyc, nzc) along an axis of wr
// is coarse index 0 (the only index past the grid that the interpolation
// asks for).
template <typename T>
struct QC3Wrap {
  const T* __restrict__ p;
  int nxc, nyc, nzc;
  Wrap3 wr;
  __device__ __forceinline__ T operator()(int i, int j, int k) const {
    if (wr.x && i == nxc) i = 0;
    if (wr.y && j == nyc) j = 0;
    if (wr.z && k == nzc) k = 0;
    return (i < nxc && j < nyc && k < nzc)
               ? p[((long long)i * nyc + j) * nzc + k]
               : T(0);
  }
};

// Whether fine point (x, y, z) reads coarse index nxc (nyc, nzc) along a
// periodic axis of wr: an odd index 2h + 1 whose upper coarse neighbour
// h + 1 lies past the grid.  Only there does QC3Wrap differ from QC3.
__device__ __forceinline__ bool reads_wrap(int x, int y, int z, int nxc,
                                           int nyc, int nzc, Wrap3 wr) {
  return (wr.x && (x & 1) && (x >> 1) + 1 == nxc) ||
         (wr.y && (y & 1) && (y >> 1) + 1 == nyc) ||
         (wr.z && (z & 1) && (z >> 1) + 1 == nzc);
}

// cb[c] = res[2c] + Σ weight · res[2c + off] over off = -δ in plane order
// (interp3.restrict_torch: [(0,0,0)] + PW3_TABLE); the weight toward
// 2c + off lies at CI index c + max(off, 0).  fine(ox, oy, oz) is the
// residual at 2c + (ox, oy, oz), zero off the grid, and ci(P, i, j, k)
// the weight (functors, so that they can read device memory or a
// shared-memory window).
template <typename CI, typename Fine>
__device__ __forceinline__ auto restrict_value(const CI& ci, const Fine& fine,
                                               int xc, int yc, int zc)
    -> decltype(fine(0, 0, 0)) {
  using T = decltype(fine(0, 0, 0));
  using A = Arith<T>;
  T acc = fine(0, 0, 0);
#define CEDAR_R(P, DX, DY, DZ)                                               \
  acc = A::add(acc, A::mul(ci(P, xc + (-(DX) > 0), yc + (-(DY) > 0),         \
                              zc + (-(DZ) > 0)),                             \
                           fine(-(DX), -(DY), -(DZ))));
  CEDAR_DELTA3(CEDAR_R)
#undef CEDAR_R
  return acc;
}

// init() + Σ weight · qc over the CI planes [P0, P1) of one parity class
// (the planes of a class are contiguous in InterpDir3 order), in plane
// order (interp3._interp_parts).  The loads come first, straight-line, so
// that they are in flight while init() computes (K16's recomputed
// residual).  ci(P, i, j, k) and qc(i, j, k) read the weights and the
// coarse values (CI3 and QC3 on the grid).
template <int P0, int P1, typename T, typename CI, typename QC,
          typename Init>
__device__ __forceinline__ T interp_class(const CI& ci, const QC& qc, int hx,
                                          int hy, int hz, int px, int py,
                                          int pz, const Init& init) {
  using A = Arith<T>;
  T w[P1 - P0], c[P1 - P0];
#define CEDAR_L(P, DX, DY, DZ)                                               \
  if constexpr (P >= P0 && P < P1) {                                         \
    w[P - P0] = ci(P, hx + px, hy + py, hz + pz);                            \
    c[P - P0] = qc(hx + (DX > 0), hy + (DY > 0), hz + (DZ > 0));             \
  }
  CEDAR_DELTA3(CEDAR_L)
#undef CEDAR_L
  T v = init();
#pragma unroll
  for (int k = 0; k < P1 - P0; ++k) v = A::add(v, A::mul(w[k], c[k]));
  return v;
}

// init() + Σ weight · qc over the planes of the point's parity class, in
// plane order; at coincident points the coarse value alone (init() is not
// called).  Shared by K8 (init = res / diag), K9 (init = 0) and K16 so
// that they cannot drift apart.
//
// Along each axis a fine index f has parity p = f & 1; its weight index is
// (f >> 1) + p and its coarse neighbour for δ is (f >> 1) + (δ > 0).
template <typename T, typename CI, typename QC, typename Init>
__device__ __forceinline__ T interp_with(const CI& ci, const QC& qc, int x,
                                         int y, int z, const Init& init) {
  const int hx = x >> 1, hy = y >> 1, hz = z >> 1;
  const int px = x & 1, py = y & 1, pz = z & 1;
#define CEDAR_C(P0, P1)                                                      \
  return interp_class<P0, P1, T>(ci, qc, hx, hy, hz, px, py, pz, init)
  switch (px | (py << 1) | (pz << 2)) {
    case 0: return qc(hx, hy, hz);
    case 1: CEDAR_C(0, 2);
    case 2: CEDAR_C(2, 4);
    case 4: CEDAR_C(4, 6);
    case 3: CEDAR_C(6, 10);
    case 5: CEDAR_C(10, 14);
    case 6: CEDAR_C(14, 18);
    default: CEDAR_C(18, 26);
  }
#undef CEDAR_C
}

// interp_with on the grid's CI and qc (K8, K9)
template <typename T, typename Init>
__device__ __forceinline__ T interp_with(const CI3<T>& ci,
                                         const T* __restrict__ qc, int x,
                                         int y, int z, int nxc, int nyc,
                                         int nzc, const Init& init) {
  return interp_with<T>(ci, QC3<T>{qc, nxc, nyc, nzc}, x, y, z, init);
}

template <typename T>
__device__ __forceinline__ T interp_value(const CI3<T>& ci,
                                          const T* __restrict__ qc, int x,
                                          int y, int z, int nxc, int nyc,
                                          int nzc, T init) {
  return interp_with(ci, qc, x, y, z, nxc, nyc, nzc, [&] { return init; });
}

}  // namespace cedar
