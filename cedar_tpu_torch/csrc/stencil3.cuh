// 3D stencil device code shared by K6 (sweep3.cu), K14-K16 (fused3.cu) and
// the edge kernel (edge3.cu), so that the kernels round alike: the
// off-diagonal sum of the sweep and the residual, in the term order of
// ops/stencil3.py (`offsets_for`, `offdiag_apply`) of this package.
// `offdiag_terms` holds the order; `offdiag_at` reads plain strided memory
// (K6), the marching kernels read their shared-memory rings through their
// own term.
//
// The stencil `so` is (ndir, nx, ny, nz), row-major with z contiguous;
// plane P = 0 is the diagonal.  Up-shifted couplings read the neighbour's
// stored plane (e.g. (1,1,1) reads BSW[x+1, y+1, z+1]); the plane shift is
// the positive part of the offset, so a term whose neighbour lies off the
// grid is exactly zero, which is what the zero-filled shifts of the plain
// versions give.  On a periodic axis (K6's periodic mode, `offdiag_wrap`,
// `offdiag_wrap_terms`) the neighbour and the up-shifted plane wrap around
// instead, as the plain versions' rolls do.
#pragma once

#include "common.cuh"

namespace cedar {

// Dir3 plane indices (core/types.py); plane P = 0 is indexed directly
constexpr int PW = 1, PS = 2, B = 3, PSW = 4, PNW = 5, BW = 6, BNW = 7,
              BN = 8, BNE = 9, BE = 10, BSE = 11, BS = 12, BSW = 13;

// Σ term(dx, dy, dz, P) over the neighbours of one point, in
// stencil3.offsets_for order: term returns the coupling of the (dx, dy, dz)
// neighbour, stored at plane P shifted by the positive part of the offset,
// times that neighbour's q (zero off the grid).  The term order lives here
// only, so that every reader of the stencil and q rounds alike.
template <typename T, bool TS, typename Term>
__device__ __forceinline__ T offdiag_terms(const Term& term) {
  using A = Arith<T>;
  T acc;
  if (!TS) {
    acc = term(-1, 0, 0, PW);
    acc = A::add(acc, term(1, 0, 0, PW));
    acc = A::add(acc, term(0, -1, 0, PS));
    acc = A::add(acc, term(0, 1, 0, PS));
    acc = A::add(acc, term(0, 0, -1, B));
    return A::add(acc, term(0, 0, 1, B));
  }
  // in-plane
  acc = term(-1, 0, 0, PW);
  acc = A::add(acc, term(1, 0, 0, PW));
  acc = A::add(acc, term(0, -1, 0, PS));
  acc = A::add(acc, term(0, 1, 0, PS));
  acc = A::add(acc, term(-1, -1, 0, PSW));
  acc = A::add(acc, term(1, -1, 0, PNW));
  acc = A::add(acc, term(-1, 1, 0, PNW));
  acc = A::add(acc, term(1, 1, 0, PSW));
  // plane below
  acc = A::add(acc, term(0, 0, -1, B));
  acc = A::add(acc, term(-1, 0, -1, BW));
  acc = A::add(acc, term(1, 0, -1, BE));
  acc = A::add(acc, term(0, -1, -1, BS));
  acc = A::add(acc, term(0, 1, -1, BN));
  acc = A::add(acc, term(-1, -1, -1, BSW));
  acc = A::add(acc, term(1, -1, -1, BSE));
  acc = A::add(acc, term(-1, 1, -1, BNW));
  acc = A::add(acc, term(1, 1, -1, BNE));
  // plane above
  acc = A::add(acc, term(0, 0, 1, B));
  acc = A::add(acc, term(1, 0, 1, BW));
  acc = A::add(acc, term(-1, 0, 1, BE));
  acc = A::add(acc, term(0, 1, 1, BS));
  acc = A::add(acc, term(0, -1, 1, BN));
  acc = A::add(acc, term(1, 1, 1, BSW));
  acc = A::add(acc, term(-1, 1, 1, BSE));
  acc = A::add(acc, term(1, -1, 1, BNW));
  return A::add(acc, term(-1, -1, 1, BNE));
}

// Σ coupling · q(neighbour) at one point (offdiag_terms).  The stencil is
// read through s0 and sp, the point's position in its own x plane and in
// the x+1 plane, with the stride N between stencil planes and the row (y)
// stride ss; q through qm, q0 and qp, the point's position in the planes
// x-1, x and x+1, with the row stride qs; z is contiguous (K6 reads the
// grid itself).  xl ..
// zh say whether the low / high neighbour along each axis lies on the
// grid.
template <typename T, bool TS>
__device__ __forceinline__ T offdiag_at(const T* s0, const T* sp,
                                        long long N, long long ss, bool xl,
                                        bool xh, bool yl, bool yh, bool zl,
                                        bool zh, const T* qm, const T* q0,
                                        const T* qp, long long qs) {
  using A = Arith<T>;
  return offdiag_terms<T, TS>([&](int dx, int dy, int dz, int p) -> T {
    const bool ok = (dx < 0 ? xl : dx > 0 ? xh : true) &&
                    (dy < 0 ? yl : dy > 0 ? yh : true) &&
                    (dz < 0 ? zl : dz > 0 ? zh : true);
    if (!ok) return T(0);
    const T* s = dx > 0 ? sp : s0;
    const T* qx = dx < 0 ? qm : dx > 0 ? qp : q0;
    return A::mul(s[p * N + (dy > 0 ? ss : 0) + (dz > 0 ? 1 : 0)],
                  qx[dy * qs + dz]);
  });
}

// The neighbours of index i one step down and up an axis of extent n:
// wrapped where the axis is periodic, -1 where they lie off the grid.
struct Steps {
  int m, p;
};

__device__ __forceinline__ Steps steps(int i, int n, bool wrap) {
  return Steps{i > 0 ? i - 1 : wrap ? n - 1 : -1,
               i + 1 < n ? i + 1 : wrap ? 0 : -1};
}

// offdiag_terms at (x, y, z) of a grid (nx, ny, nz) with the couplings
// wrapping around the axes of wr (shift3's roll: the neighbour at -1 is the
// last point, and an up-shifted coupling at the last point reads the first
// plane); a term whose neighbour lies off the grid on another axis is
// zero.  at(xs, ys, zs, p, xn, yn, zn) returns the coupling stored at plane
// p of point (xs, ys, zs) times q at (xn, yn, zn), each index on the grid.
// The resident K6 reads its octant-ordered shared memory through it
// (sweep3.cu); offdiag_wrap reads the grid with the same wrap.
template <typename T, bool TS, typename At>
__device__ __forceinline__ T offdiag_wrap_terms(int x, int y, int z, int nx,
                                                int ny, int nz, Wrap3 wr,
                                                const At& at) {
  const Steps sx = steps(x, nx, wr.x), sy = steps(y, ny, wr.y);
  const Steps sz = steps(z, nz, wr.z);
  return offdiag_terms<T, TS>([&](int dx, int dy, int dz, int p) -> T {
    const int xn = dx < 0 ? sx.m : dx > 0 ? sx.p : x;
    const int yn = dy < 0 ? sy.m : dy > 0 ? sy.p : y;
    const int zn = dz < 0 ? sz.m : dz > 0 ? sz.p : z;
    if (xn < 0 || yn < 0 || zn < 0) return T(0);
    return at(dx > 0 ? xn : x, dy > 0 ? yn : y, dz > 0 ? zn : z, p, xn, yn,
              zn);
  });
}

// Σ coupling · q(neighbour) at (x, y, z) of the grid q (nx, ny, nz), the
// couplings wrapping around the axes of wr, as offdiag_wrap_terms reads
// them.  The steps to the neighbours one point down and up each axis are
// computed once (across the wrap where the axis is periodic), so a term
// costs what offdiag's does but for an added step.
template <typename T, bool TS>
__device__ __forceinline__ T offdiag_wrap(const T* __restrict__ so,
                                          const T* q, int x, int y, int z,
                                          int nx, int ny, int nz, Wrap3 wr) {
  using A = Arith<T>;
  const long long N = (long long)nx * ny * nz;
  const long long sx = (long long)ny * nz;
  const int sy = nz;
  const long long i = (long long)x * sx + (long long)y * sy + z;
  const bool xl = wr.x || x > 0, xh = wr.x || x + 1 < nx;
  const bool yl = wr.y || y > 0, yh = wr.y || y + 1 < ny;
  const bool zl = wr.z || z > 0, zh = wr.z || z + 1 < nz;
  const long long xm = x > 0 ? -sx : (nx - 1) * sx;
  const long long xp = x + 1 < nx ? sx : -(nx - 1) * sx;
  const int ym = y > 0 ? -sy : (ny - 1) * sy;
  const int yp = y + 1 < ny ? sy : -(ny - 1) * sy;
  const int zm = z > 0 ? -1 : nz - 1, zp = z + 1 < nz ? 1 : 1 - nz;
  const T* s0 = so + i;
  const T* q0 = q + i;
  return offdiag_terms<T, TS>([&](int dx, int dy, int dz, int p) -> T {
    const bool ok = (dx < 0 ? xl : dx > 0 ? xh : true) &&
                    (dy < 0 ? yl : dy > 0 ? yh : true) &&
                    (dz < 0 ? zl : dz > 0 ? zh : true);
    const long long xs = dx > 0 ? xp : 0;
    const long long xq = dx < 0 ? xm : xs;
    const int ys = dy > 0 ? yp : 0, yq = dy < 0 ? ym : ys;
    const int zs = dz > 0 ? zp : 0, zq = dz < 0 ? zm : zs;
    return ok ? A::mul(s0[p * N + xs + ys + zs], q0[xq + yq + zq]) : T(0);
  });
}

// Σ coupling · q(neighbour) at (x, y, z) of the grid q (nx, ny, nz).
template <typename T, bool TS>
__device__ __forceinline__ T offdiag(const T* __restrict__ so, const T* q,
                                     int x, int y, int z, int nx, int ny,
                                     int nz) {
  const long long N = (long long)nx * ny * nz;
  const long long sx = (long long)ny * nz, sy = nz;
  const long long i = (long long)x * sx + (long long)y * sy + z;
  const T* q0 = q + i;
  return offdiag_at<T, TS>(so + i, so + i + sx, N, sy, x > 0, x + 1 < nx,
                           y > 0, y + 1 < ny, z > 0, z + 1 < nz, q0 - sx,
                           q0, q0 + sx, sy);
}

}  // namespace cedar
