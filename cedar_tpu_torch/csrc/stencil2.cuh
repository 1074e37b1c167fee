// 2D stencil device code shared by K1 (sweep2.cu), K4 (lines2.cu), K10
// (planes2.cu) and K11-K13 (fused2.cu), so that the kernels round alike:
// the off-diagonal sum of the residual, the off-line right-hand sides of
// the line solves and the line solve itself.  The term orders are those of
// ops/stencil2.py (`offdiag_apply`) and ops/lines2.py (`line_rhs_x`,
// `_factor`, `tridiag_solve`, `pcr_solve`) of this package.
//
// Each function reads one plane (nx, ny), row-major: `so` points at its
// plane O and stencil plane d sits at so + d * P, where P is the stride
// between stencil planes (nx * ny for one grid; nb * nx * ny for the
// batched stencil (ndir, nb, nx, ny) of plane relaxation).  q carries no
// __restrict__: K10 reads and writes it within one launch, across block
// barriers, so its loads must not go through the read-only cache.
// Couplings whose neighbour lies outside the grid read as exactly 0, as
// the zero-filled shifts of the plain versions give.  On a periodic axis
// there is no outside: the wrap-aware instantiations (template flag PER,
// with the periodic axes in a Wrap) read a neighbour at -1 as the last
// point and an up-shifted coupling at the last point from the first, as
// the wrapped shifts (core/shift.py `shift2(..., periodic)`) give.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace cedar {

// Dir2 plane indices (core/types.py); plane O = 0 is indexed directly
constexpr int W = 1, S = 2, SW = 3, NW = 4;

// Σ term(dz, dw, P) over the neighbours of one point, in
// stencil2.offsets_for order: term returns the coupling of the (dz, dw)
// neighbour, stored at plane P shifted by the positive part of the offset
// ((-1,0) W(z,w), (1,0) W(z+1,w), (0,-1) S(z,w), (0,1) S(z,w+1); 9-point
// (-1,-1) SW(z,w), (1,-1) NW(z+1,w), (-1,1) NW(z,w+1), (1,1) SW(z+1,w+1)),
// times that neighbour's q, or exactly zero for a neighbour off the grid.
// The term order lives here only, so that every reader of the stencil and
// q rounds alike.
template <typename T, bool NINE, typename Term>
__device__ __forceinline__ T offdiag_terms2(const Term& term) {
  using A = Arith<T>;
  T acc = term(-1, 0, W);
  acc = A::add(acc, term(1, 0, W));
  acc = A::add(acc, term(0, -1, S));
  acc = A::add(acc, term(0, 1, S));
  if (NINE) {
    acc = A::add(acc, term(-1, -1, SW));
    acc = A::add(acc, term(1, -1, NW));
    acc = A::add(acc, term(-1, 1, NW));
    acc = A::add(acc, term(1, 1, SW));
  }
  return acc;
}

// Σ coupling · q(neighbour) at (z, w) (offdiag_terms2), with q read
// through qp = &q(z, w) and the row stride qs of what qp points into: the
// grid itself (qs = ny), or a shared-memory tile of it in the fused
// kernels of fused2.cu.  With PER the couplings wrap around the axes of
// wr (qp's neighbours must then hold the wrapped values: a tile whose halo
// was loaded with wrap-around).
template <typename T, bool NINE, bool PER = false>
__device__ __forceinline__ T offdiag_at(const T* __restrict__ so, long long P,
                                        int z, int w, int nx, int ny,
                                        const T* qp, long long qs,
                                        Wrap wr = Wrap{}) {
  using A = Arith<T>;
  if constexpr (!PER) {
    const long long i = (long long)z * ny + w;
    const bool zl = z > 0, zh = z + 1 < nx, wl = w > 0, wh = w + 1 < ny;
    return offdiag_terms2<T, NINE>([&](int dz, int dw, int d) -> T {
      const bool ok = (dz < 0 ? zl : dz > 0 ? zh : true) &&
                      (dw < 0 ? wl : dw > 0 ? wh : true);
      return ok ? A::mul(so[d * P + i + (dz > 0 ? ny : 0) + (dw > 0 ? 1 : 0)],
                         qp[dz * qs + dw])
                : T(0);
    });
  } else {
    const bool zl = wr.x || z > 0, zh = wr.x || z + 1 < nx;
    const bool wl = wr.y || w > 0, wh = wr.y || w + 1 < ny;
    // the up-shifted planes' row and column: z + 1 and w + 1, wrapped
    const int zn = z + 1 == nx ? 0 : z + 1, wn = w + 1 == ny ? 0 : w + 1;
    return offdiag_terms2<T, NINE>([&](int dz, int dw, int d) -> T {
      const bool ok = (dz < 0 ? zl : dz > 0 ? zh : true) &&
                      (dw < 0 ? wl : dw > 0 ? wh : true);
      return ok ? A::mul(so[d * P + (long long)(dz > 0 ? zn : z) * ny +
                            (dw > 0 ? wn : w)],
                         qp[dz * qs + dw])
                : T(0);
    });
  }
}

// Σ coupling · q(neighbour) at (z, w) of the grid q.
template <typename T, bool NINE>
__device__ __forceinline__ T offdiag(const T* __restrict__ so, const T* q,
                                     long long P, int z, int w, int nx,
                                     int ny) {
  return offdiag_at<T, NINE>(so, P, z, w, nx, ny,
                             q + (long long)z * ny + w, ny);
}

// The rhs of point i on an x-line (line = column j): b + couplings to the
// columns j-1 and j+1, in lines2.line_rhs_x order.
template <typename T, bool NINE>
__device__ __forceinline__ T rhs_x(const T* __restrict__ so, const T* q,
                                   const T* __restrict__ b, long long P,
                                   long long i, int ny, bool zl, bool zh,
                                   bool jl, bool jh) {
  using A = Arith<T>;
  const T zero = T(0);
  T r = b[i];
  r = A::add(r, jl ? A::mul(so[S * P + i], q[i - 1]) : zero);
  r = A::add(r, jh ? A::mul(so[S * P + i + 1], q[i + 1]) : zero);
  if (NINE) {
    r = A::add(r, (zl && jl) ? A::mul(so[SW * P + i], q[i - ny - 1]) : zero);
    r = A::add(r, (zh && jl) ? A::mul(so[NW * P + i + ny], q[i + ny - 1]) : zero);
    r = A::add(r, (zl && jh) ? A::mul(so[NW * P + i + 1], q[i - ny + 1]) : zero);
    r = A::add(r, (zh && jh) ? A::mul(so[SW * P + i + ny + 1], q[i + ny + 1]) : zero);
  }
  return r;
}

// The rhs of point idx on a y-line (line = row i): the x rhs of the
// transposed stencil, b + couplings to the rows i-1 and i+1.
template <typename T, bool NINE>
__device__ __forceinline__ T rhs_y(const T* __restrict__ so, const T* q,
                                   const T* __restrict__ b, long long P,
                                   long long idx, int ny, bool il, bool ih,
                                   bool wl, bool wh) {
  using A = Arith<T>;
  const T zero = T(0);
  T r = b[idx];
  r = A::add(r, il ? A::mul(so[W * P + idx], q[idx - ny]) : zero);
  r = A::add(r, ih ? A::mul(so[W * P + idx + ny], q[idx + ny]) : zero);
  if (NINE) {
    r = A::add(r, (il && wl) ? A::mul(so[SW * P + idx], q[idx - ny - 1]) : zero);
    r = A::add(r, (il && wh) ? A::mul(so[NW * P + idx + 1], q[idx - ny + 1]) : zero);
    r = A::add(r, (ih && wl) ? A::mul(so[NW * P + idx + ny], q[idx + ny - 1]) : zero);
    r = A::add(r, (ih && wh) ? A::mul(so[SW * P + idx + ny + 1], q[idx + ny + 1]) : zero);
  }
  return r;
}

// rhs_x on a periodic grid (the axes of wr): b + couplings to the columns
// j-1 and j+1 of the point (z, j), the neighbours wrapped, in
// lines2.line_rhs_x order.
template <typename T, bool NINE>
__device__ __forceinline__ T rhs_x_wrap(const T* __restrict__ so, const T* q,
                                        const T* __restrict__ b, long long P,
                                        int z, int j, int nx, int ny,
                                        Wrap wr) {
  using A = Arith<T>;
  const T zero = T(0);
  const bool zl = wr.x || z > 0, zh = wr.x || z + 1 < nx;
  const bool jl = wr.y || j > 0, jh = wr.y || j + 1 < ny;
  const long long r0 = (long long)z * ny;
  const long long rm = (long long)(z == 0 ? nx - 1 : z - 1) * ny;
  const long long rn = (long long)(z + 1 == nx ? 0 : z + 1) * ny;
  const int jm = j == 0 ? ny - 1 : j - 1, jn = j + 1 == ny ? 0 : j + 1;
  T r = b[r0 + j];
  r = A::add(r, jl ? A::mul(so[S * P + r0 + j], q[r0 + jm]) : zero);
  r = A::add(r, jh ? A::mul(so[S * P + r0 + jn], q[r0 + jn]) : zero);
  if (NINE) {
    r = A::add(r, (zl && jl) ? A::mul(so[SW * P + r0 + j], q[rm + jm]) : zero);
    r = A::add(r, (zh && jl) ? A::mul(so[NW * P + rn + j], q[rn + jm]) : zero);
    r = A::add(r, (zl && jh) ? A::mul(so[NW * P + r0 + jn], q[rm + jn]) : zero);
    r = A::add(r, (zh && jh) ? A::mul(so[SW * P + rn + jn], q[rn + jn]) : zero);
  }
  return r;
}

// rhs_y on a periodic grid: b + couplings to the rows i-1 and i+1 of the
// point (i, w), the neighbours wrapped, in rhs_y's order.
template <typename T, bool NINE>
__device__ __forceinline__ T rhs_y_wrap(const T* __restrict__ so, const T* q,
                                        const T* __restrict__ b, long long P,
                                        int i, int w, int nx, int ny,
                                        Wrap wr) {
  using A = Arith<T>;
  const T zero = T(0);
  const bool il = wr.x || i > 0, ih = wr.x || i + 1 < nx;
  const bool wl = wr.y || w > 0, wh = wr.y || w + 1 < ny;
  const long long r0 = (long long)i * ny;
  const long long rm = (long long)(i == 0 ? nx - 1 : i - 1) * ny;
  const long long rn = (long long)(i + 1 == nx ? 0 : i + 1) * ny;
  const int wm = w == 0 ? ny - 1 : w - 1, wn = w + 1 == ny ? 0 : w + 1;
  T r = b[r0 + w];
  r = A::add(r, il ? A::mul(so[W * P + r0 + w], q[rm + w]) : zero);
  r = A::add(r, ih ? A::mul(so[W * P + rn + w], q[rn + w]) : zero);
  if (NINE) {
    r = A::add(r, (il && wl) ? A::mul(so[SW * P + r0 + w], q[rm + wm]) : zero);
    r = A::add(r, (il && wh) ? A::mul(so[NW * P + r0 + wn], q[rm + wn]) : zero);
    r = A::add(r, (ih && wl) ? A::mul(so[NW * P + rn + w], q[rn + wm]) : zero);
    r = A::add(r, (ih && wh) ? A::mul(so[SW * P + rn + wn], q[rn + wn]) : zero);
  }
  return r;
}

// ---- the line solve of K4 and K10 (ops/lines2.py `sweep_x_torch`) ------
//
// A block stages some lines of one zebra colour (`stage_lines`), solves
// them (`solve_lines`) and writes them back (`store_lines`), with a block
// barrier between the phases.  A line of n points is held as npad rows,
// each the coupling to the row before (lo), the diagonal (dg), the coupling
// to the row after (up) and the rhs (r), which the solution replaces.
// Lines of pcr_stride h > 0 (ops/lines2.pcr_stride) take log2 h PCR steps,
// then Thomas on the h interleaved systems; shorter lines (h = 0) take the
// LDLᵀ recurrence, one thread a line.  h is a launch argument, any power of
// two: under solver.ml-relax.enabled (pcr_stride's `full`) it is the power
// of two at or above n, so PCR runs to the end (cedar_tpu's full-length
// `_pcr_solve`), the line is padded to h rows and Thomas is one row a
// system, r / dg.  Nothing here bounds h by the block: a PCR step strides
// its rows by the block's threads, Thomas its systems.

// One row of a line's system, read and written as one vector.
template <typename T>
struct alignas(4 * sizeof(T)) Row {
  T lo, dg, up, r;
};

// The rows a line of n points is held in: a multiple of h for PCR (the pad
// rows are identity rows), n made odd for the LDLᵀ recurrence, so that the
// threads that run one line each read different shared-memory banks.
__host__ __device__ inline int line_pad(int n, int h) {
  return h ? (n + h - 1) / h * h : (n | 1);
}

// nl lines of one colour in two buffers of cap * npad rows, a and b (row i
// of line l at l * npad + i), in shared memory or, for a line too long for
// it, in device memory.  The PCR steps go from one buffer to the other.
template <typename T>
struct Lines {
  Row<T>* a;
  Row<T>* b;
  int nl, n, npad, h;
  __device__ Lines(Row<T>* base, int cap, int nl_, int n_, int h_)
      : a(base), nl(nl_), n(n_), npad(line_pad(n_, h_)), h(h_) {
    b = base + (long long)cap * npad;
  }
};

// Row i of the line `line` (x-lines, Y false: the column `line` along z;
// y-lines: the row `line` along w) of n points: lo = -W(i) (x) or -S(i)
// (y), 0 at i = 0; up = the same coupling at i + 1, 0 at the last point;
// dg = O; r = the rhs (rhs_x / rhs_y), as lines2.line_coeffs_x and
// line_rhs_x give them.  Pad rows (i >= n) are identity rows.
template <typename T, bool NINE, bool Y>
__device__ __forceinline__ Row<T> line_row(const T* __restrict__ so,
                                           const T* q,
                                           const T* __restrict__ b,
                                           long long P, int nx, int ny,
                                           int line, int i) {
  Row<T> v{T(0), T(1), T(0), T(0)};
  if (Y && i < ny) {
    const long long idx = (long long)line * ny + i;
    v.lo = i > 0 ? -so[S * P + idx] : T(0);
    v.up = i + 1 < ny ? -so[S * P + idx + 1] : T(0);
    v.dg = so[idx];
    v.r = rhs_y<T, NINE>(so, q, b, P, idx, ny, line > 0, line + 1 < nx,
                         i > 0, i + 1 < ny);
  } else if (!Y && i < nx) {
    const long long idx = (long long)i * ny + line;
    v.lo = i > 0 ? -so[W * P + idx] : T(0);
    v.up = i + 1 < nx ? -so[W * P + idx + ny] : T(0);
    v.dg = so[idx];
    v.r = rhs_x<T, NINE>(so, q, b, P, idx, ny, i > 0, i + 1 < nx,
                         line > 0, line + 1 < ny);
  }
  return v;
}

// line_row on a periodic grid (the axes of wr).  A line along a periodic
// axis is cyclic (lines2.cyclic_solve): its rows are those of the modified
// matrix A' (the corners dropped, d[0] -= γ and d[n-1] -= cl·cu/γ, with
// γ = -d[0] and cl = cu the wrap coupling of point 0, -W(0) or -S(0)),
// and it is staged twice: slot 0 with the rhs, slot 1 with the
// Sherman–Morrison vector u = (γ, 0, …, 0, cl) in r.  A line across a
// periodic axis reads its neighbour lines with wrap-around.
template <typename T, bool NINE, bool Y>
__device__ __forceinline__ Row<T> line_row_wrap(const T* __restrict__ so,
                                                const T* q,
                                                const T* __restrict__ b,
                                                long long P, int nx, int ny,
                                                int line, int i, Wrap wr,
                                                int slot) {
  using A = Arith<T>;
  Row<T> v{T(0), T(1), T(0), T(0)};
  const int n = Y ? ny : nx;
  if (i >= n) return v;
  const int step = Y ? 1 : ny;  // the index stride along the line
  const long long i0 = Y ? (long long)line * ny : line;  // point 0
  const long long idx = i0 + (long long)i * step;
  const int c = Y ? S : W;  // the coupling along the line
  v.lo = i > 0 ? -so[c * P + idx] : T(0);
  v.up = i + 1 < n ? -so[c * P + idx + step] : T(0);
  v.dg = so[idx];
  if (slot == 0)
    v.r = Y ? rhs_y_wrap<T, NINE>(so, q, b, P, line, i, nx, ny, wr)
            : rhs_x_wrap<T, NINE>(so, q, b, P, i, line, nx, ny, wr);
  if (Y ? wr.y : wr.x) {
    const T gamma = -so[i0], cl = -so[c * P + i0];
    if (i == 0) v.dg = A::sub(v.dg, gamma);
    if (i == n - 1) v.dg = A::sub(v.dg, A::div(A::mul(cl, cl), gamma));
    if (slot == 1) v.r = i == n - 1 ? cl : i == 0 ? gamma : T(0);
  }
  return v;
}

// The Sherman–Morrison factor of a cyclic line from its two solves (y:
// the rhs, z: u; lines2.cyclic_solve), kept in z's row 0, whose lo the
// store does not read:
//   t = cu/γ,  vy = y[0] + t y[n-1],  vz = z[0] + t z[n-1],
//   f = vy / (1 + vz);  then x = y - z f (cyclic_value)
template <typename T, bool Y>
__device__ __forceinline__ void cyclic_factor(const Row<T>* y, Row<T>* z,
                                              int n,
                                              const T* __restrict__ so,
                                              long long P, int ny, int line) {
  using A = Arith<T>;
  const long long i0 = Y ? (long long)line * ny : line;
  const T gamma = -so[i0], cu = -so[(Y ? S : W) * P + i0];
  const T t = A::div(cu, gamma);
  const T vy = A::add(y[0].r, A::mul(t, y[n - 1].r));
  const T vz = A::add(z[0].r, A::mul(t, z[n - 1].r));
  z[0].lo = A::div(vy, A::add(T(1), vz));
}

template <typename T>
__device__ __forceinline__ T cyclic_value(const Row<T>* y, const Row<T>* z,
                                          int i) {
  using A = Arith<T>;
  return A::sub(y[i].r, A::mul(z[i].r, z[0].lo));
}

// stage_lines on a periodic grid: L holds `slots` (2 for cyclic lines,
// else 1) systems a line, line l of the colour in L's lines l * slots ..
// l * slots + slots - 1 (line_row_wrap's slots).
template <typename T, bool NINE, bool Y>
__device__ void stage_lines_wrap(const Lines<T>& L, const T* __restrict__ so,
                                 const T* q, const T* __restrict__ b,
                                 long long P, int nx, int ny, int parity,
                                 int t0, Wrap wr, int slots) {
  const int total = L.nl * L.npad;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int l = Y ? k / L.npad : k % L.nl;
    const int i = Y ? k % L.npad : k / L.nl;
    L.a[Y ? k : l * L.npad + i] = line_row_wrap<T, NINE, Y>(
        so, q, b, P, nx, ny, 2 * (t0 + l / slots) + parity, i, wr,
        l % slots);
  }
}

// store_lines after stage_lines_wrap: a cyclic line's points combine its
// two solves (cyclic_factor, a thread a line, a barrier, cyclic_value).
template <typename T, bool Y>
__device__ void store_lines_wrap(const Lines<T>& L, Row<T>* rows, T* q,
                                 const T* __restrict__ so, long long P,
                                 int ny, int parity, int t0, int slots) {
  const int nl = L.nl / slots, total = nl * L.n;
  if (slots == 2) {
    for (int l = threadIdx.x; l < nl; l += blockDim.x) {
      Row<T>* y = rows + 2LL * l * L.npad;
      cyclic_factor<T, Y>(y, y + L.npad, L.n, so, P, ny,
                          2 * (t0 + l) + parity);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int l = Y ? k / L.n : k % nl;
    const int i = Y ? k % L.n : k / nl;
    const int line = 2 * (t0 + l) + parity;
    const Row<T>* y = rows + (long long)l * slots * L.npad;
    q[Y ? (long long)line * ny + i : (long long)i * ny + line] =
        slots == 1 ? y[i].r : cyclic_value(y, y + L.npad, i);
  }
}

// Stage the active lines t0 .. t0 + L.nl - 1 of the zebra colour `parity`
// into L.a: x-lines (Y false) are the columns 2t + parity, y-lines the
// rows 2t + parity (line_row).  Adjacent threads take adjacent lines of a
// row (x-lines: the row's run of columns) or adjacent points of a row (y).
// A thread forms kStage rows before it stores them, so that their loads
// are in flight together.
constexpr int kStage = 2;

template <typename T, bool NINE, bool Y>
__device__ void stage_lines(const Lines<T>& L, const T* __restrict__ so,
                            const T* q, const T* __restrict__ b, long long P,
                            int nx, int ny, int parity, int t0) {
  const int total = L.nl * L.npad, nt = blockDim.x;
  for (int k0 = threadIdx.x; k0 < total; k0 += kStage * nt) {
    Row<T> v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int k = k0 + u * nt;
      const int l = Y ? k / L.npad : k % L.nl;
      const int i = Y ? k % L.npad : k / L.nl;
      if (k < total)
        v[u] = line_row<T, NINE, Y>(so, q, b, P, nx, ny,
                                    2 * (t0 + l) + parity, i);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int k = k0 + u * nt;
      if (k < total)
        L.a[Y ? k : (k % L.nl) * L.npad + k / L.nl] = v[u];
    }
  }
}

// Write the solution (the r of `rows`, one of L's buffers) back into q,
// mapped as stage_lines maps the lines.
template <typename T, bool Y>
__device__ void store_lines(const Lines<T>& L, const Row<T>* rows, T* q,
                            int ny, int parity, int t0) {
  const int total = L.nl * L.n;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int l = Y ? k / L.n : k % L.nl;
    const int i = Y ? k % L.n : k / L.nl;
    const int line = 2 * (t0 + l) + parity;
    q[Y ? (long long)line * ny + i : (long long)i * ny + line] =
        rows[l * L.npad + i].r;
  }
}

// The LDLᵀ solve of one line (lines2._factor, then tridiag_solve), factored
// on the fly, in place on its rows: diagonal dg, off-diagonal lo (lo[s]
// couples s-1 and s), rhs r (replaced by the solution), the multipliers
// into up.
//   l_s = e_s / d_{s-1},  d_s = a_s - l_s e_s,  z_s = r_s - l_s z_{s-1},
//   w_s = z_s (1/d_s);  x_{n-1} = w_{n-1},  x_s = w_s - l_{s+1} x_{s+1}
template <typename T>
__device__ void ldlt_solve(Row<T>* v, int n) {
  using A = Arith<T>;
  T d = v[0].dg;
  T z = v[0].r;
  v[0].r = A::mul(z, A::div(T(1), d));
  for (int s = 1; s < n; ++s) {
    const T e = v[s].lo;
    const T li = A::div(e, d);
    d = A::sub(v[s].dg, A::mul(li, e));
    z = A::sub(v[s].r, A::mul(li, z));
    v[s].up = li;
    v[s].r = A::mul(z, A::div(T(1), d));
  }
  T x = v[n - 1].r;
  for (int s = n - 2; s >= 0; --s) {
    x = A::sub(v[s].r, A::mul(v[s + 1].up, x));
    v[s].r = x;
  }
}

// One PCR step of stride hh from the rows `src` to `dst` (rows rows, npad
// a line), in the term order of lines2.pcr_solve:
//   al = lo / dg[i-hh],  be = up / dg[i+hh],
//   dg = dg - al up[i-hh] - be lo[i+hh],  r = r - al r[i-hh] - be r[i+hh],
//   lo = -al lo[i-hh],  up = -be up[i+hh]
// with rows off the line read as identity rows.  The caller meets a block
// barrier before the next step reads dst.
template <typename T>
__device__ void pcr_step(const Row<T>* src, Row<T>* dst, int rows, int npad,
                         int hh) {
  using A = Arith<T>;
  const Row<T> id{T(0), T(1), T(0), T(0)};
  const int di = blockDim.x % npad;  // a thread's next row is nt rows on
  int i = threadIdx.x % npad;        // the row within its line
#pragma unroll 4
  for (int f = threadIdx.x; f < rows; f += blockDim.x) {
    const Row<T> c = src[f];
    const Row<T> m = i >= hh ? src[f - hh] : id;
    const Row<T> p = i + hh < npad ? src[f + hh] : id;
    const T al = A::div(c.lo, m.dg);
    const T be = A::div(c.up, p.dg);
    Row<T> o;
    o.lo = A::mul(-al, m.lo);
    o.dg = A::sub(A::sub(c.dg, A::mul(al, m.up)), A::mul(be, p.lo));
    o.up = A::mul(-be, p.up);
    o.r = A::sub(A::sub(c.r, A::mul(al, m.r)), A::mul(be, p.r));
    dst[f] = o;
    i += di;
    if (i >= npad) i -= npad;
  }
}

// Thomas on the h interleaved systems of each line (rows k, k+h, ...), one
// thread a system, in place on `rows` after the PCR steps (with the full
// stride a system is one row: x = r / dg); in the term order of
// lines2.pcr_solve:
//   l_t = lo_t / d_{t-1},  d_t = dg_t - l_t up_{t-1},
//   z_t = r_t - l_t z_{t-1};
//   x_{T-1} = z / d,  x_t = (z_t - up_t x_{t+1}) / d_t
// Adjacent threads run adjacent systems: their rows are adjacent.  A thread
// loads kChain rows before it runs their steps, so that the chain waits on
// its arithmetic only.
constexpr int kChain = 4;

template <typename T>
__device__ void thomas_interleaved(const Lines<T>& L, Row<T>* rows) {
  using A = Arith<T>;
  const int h = L.h, nt = L.npad / h;
  for (int m = threadIdx.x; m < L.nl * h; m += blockDim.x) {
    Row<T>* v = rows + (long long)(m / h) * L.npad + m % h;
    T d = v[0].dg, z = v[0].r, up = v[0].up;
    for (int t0 = 1; t0 < nt; t0 += kChain) {
      Row<T> c[kChain];
#pragma unroll
      for (int u = 0; u < kChain; ++u)
        if (t0 + u < nt) c[u] = v[(t0 + u) * h];
#pragma unroll
      for (int u = 0; u < kChain; ++u) {
        if (t0 + u < nt) {
          const T lt = A::div(c[u].lo, d);
          d = A::sub(c[u].dg, A::mul(lt, up));
          z = A::sub(c[u].r, A::mul(lt, z));
          up = c[u].up;
          v[(t0 + u) * h] = Row<T>{c[u].lo, d, up, z};
        }
      }
    }
    T x = A::div(z, d);
    v[(nt - 1) * h].r = x;
    for (int t0 = nt - 2; t0 >= 0; t0 -= kChain) {
      Row<T> c[kChain];
#pragma unroll
      for (int u = 0; u < kChain; ++u)
        if (t0 - u >= 0) c[u] = v[(t0 - u) * h];
#pragma unroll
      for (int u = 0; u < kChain; ++u) {
        if (t0 - u >= 0) {
          x = A::div(A::sub(c[u].r, A::mul(c[u].up, x)), c[u].dg);
          v[(t0 - u) * h].r = x;
        }
      }
    }
  }
}

// Solve the lines staged in L.a; returns the buffer whose r holds the
// solution.  Every thread of the block calls it; the caller meets a
// barrier before it reads the solution.
template <typename T>
__device__ const Row<T>* solve_lines(const Lines<T>& L) {
  if (L.h == 0) {
    for (int l = threadIdx.x; l < L.nl; l += blockDim.x)
      ldlt_solve(L.a + (long long)l * L.npad, L.n);
    return L.a;
  }
  Row<T>* src = L.a;
  Row<T>* dst = L.b;
  for (int hh = 1; hh < L.h; hh *= 2) {
    pcr_step(src, dst, L.nl * L.npad, L.npad, hh);
    __syncthreads();
    Row<T>* t = src;
    src = dst;
    dst = t;
  }
  thomas_interleaved(L, src);
  return src;
}

// Bytes of the two buffers of `lines` lines of npad rows.
template <typename T>
inline size_t lines_bytes(long long lines, int npad) {
  return 2 * sizeof(Row<T>) * lines * npad;
}

// Threads of a line kernel's block for `rows` rows a buffer: four rows a
// thread, a multiple of 32 in [128, 1024].
inline int line_threads(long long rows) {
  const long long t = (rows + 3) / 4;
  return (int)std::min<long long>(
      1024, std::max<long long>(128, (t + 31) / 32 * 32));
}

}  // namespace cedar
