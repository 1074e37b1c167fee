// 2D stencil device code shared by K1 (sweep2.cu), K4 (lines2.cu), K10
// (planes2.cu) and K11-K13 (fused2.cu), so that the kernels round alike:
// the off-diagonal sum of the residual, the off-line right-hand sides of
// the line solves and the LDLᵀ line solve.  The term orders are those of
// ops/stencil2.py
// (`offdiag_apply`) and ops/lines2.py (`line_rhs_x`, `_factor`,
// `tridiag_solve`) of this package.
//
// Each function reads one plane (nx, ny), row-major: `so` points at its
// plane O and stencil plane d sits at so + d * P, where P is the stride
// between stencil planes (nx * ny for one grid; nb * nx * ny for the
// batched stencil (ndir, nb, nx, ny) of plane relaxation).  q carries no
// __restrict__: K10 reads and writes it within one launch, across block
// barriers, so its loads must not go through the read-only cache.
// Couplings whose neighbour lies outside the grid read as exactly 0, as
// the zero-filled shifts of the plain versions give.
#pragma once

#include "common.cuh"

namespace cedar {

// Dir2 plane indices (core/types.py); plane O = 0 is indexed directly
constexpr int W = 1, S = 2, SW = 3, NW = 4;
constexpr int kChunk = 16;  // line-solve steps whose loads issue together

// Σ coupling · q(neighbour) at (z, w), in stencil2.offsets_for order, with
// q read through qp = &q(z, w) and the row stride qs of what qp points
// into: the grid itself (qs = ny), or a shared-memory tile of it in the
// fused kernels of fused2.cu.
template <typename T, bool NINE>
__device__ __forceinline__ T offdiag_at(const T* __restrict__ so, long long P,
                                        int z, int w, int nx, int ny,
                                        const T* qp, long long qs) {
  using A = Arith<T>;
  const long long i = (long long)z * ny + w;
  const bool zl = z > 0, zh = z + 1 < nx, wl = w > 0, wh = w + 1 < ny;
  const T zero = T(0);
  // (-1,0) W(z,w)      (1,0) W(z+1,w)
  T acc = zl ? A::mul(so[W * P + i], qp[-qs]) : zero;
  acc = A::add(acc, zh ? A::mul(so[W * P + i + ny], qp[qs]) : zero);
  // (0,-1) S(z,w)      (0,1) S(z,w+1)
  acc = A::add(acc, wl ? A::mul(so[S * P + i], qp[-1]) : zero);
  acc = A::add(acc, wh ? A::mul(so[S * P + i + 1], qp[1]) : zero);
  if (NINE) {
    // (-1,-1) SW(z,w)  (1,-1) NW(z+1,w)  (-1,1) NW(z,w+1)  (1,1) SW(z+1,w+1)
    acc = A::add(acc, (zl && wl) ? A::mul(so[SW * P + i], qp[-qs - 1]) : zero);
    acc = A::add(acc, (zh && wl) ? A::mul(so[NW * P + i + ny], qp[qs - 1]) : zero);
    acc = A::add(acc, (zl && wh) ? A::mul(so[NW * P + i + 1], qp[1 - qs]) : zero);
    acc = A::add(acc, (zh && wh) ? A::mul(so[SW * P + i + ny + 1], qp[qs + 1]) : zero);
  }
  return acc;
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

// The LDLᵀ solve of one line of n points: diagonal a[s*as], off-diagonal
// -c[s*as] (coupling s-1 and s), rhs r[s*rs] (overwritten by w), the
// multipliers to l[s*rs], the solution to q[s*qs].  The loads of kChunk
// steps are issued together before those steps run, so a chunk pays one
// memory latency instead of one per step.
template <typename T>
__device__ __forceinline__ void solve_line(const T* __restrict__ a,
                                           const T* __restrict__ c,
                                           T* __restrict__ r,
                                           T* __restrict__ l, T* q, int n,
                                           long long as, long long rs,
                                           long long qs) {
  using A = Arith<T>;
  T d = a[0];
  T z = r[0];
  r[0] = A::mul(z, A::div(T(1), d));
  for (int s0 = 1; s0 < n; s0 += kChunk) {
    T av[kChunk], cv[kChunk], rv[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int s = s0 + k;
      if (s < n) {
        av[k] = a[s * as];
        cv[k] = c[s * as];
        rv[k] = r[s * rs];
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int s = s0 + k;
      if (s < n) {
        const T e = -cv[k];
        const T li = A::div(e, d);
        d = A::sub(av[k], A::mul(li, e));
        z = A::sub(rv[k], A::mul(li, z));
        l[s * rs] = li;
        r[s * rs] = A::mul(z, A::div(T(1), d));
      }
    }
  }
  T x = r[(n - 1) * rs];
  q[(n - 1) * qs] = x;
  for (int s1 = n - 2; s1 >= 0; s1 -= kChunk) {
    T wv[kChunk], lv[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int s = s1 - k;
      if (s >= 0) {
        wv[k] = r[s * rs];
        lv[k] = l[(s + 1) * rs];
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int s = s1 - k;
      if (s >= 0) {
        x = A::sub(wv[k], A::mul(lv[k], x));
        q[s * qs] = x;
      }
    }
  }
}

}  // namespace cedar
