// One phase of the 4-color line-relaxation smoother, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU the JAX package runs this phase
// (emg3d_tpu/ops/smoothers.py:791-850, _line_relax_x_phase, with the
// block-Thomas solve of :936-970) as XLA code whose two lax.scan loops
// compile to one loop each.  Eager PyTorch has no such loop: its plain
// version launches some 16,000 small kernels per phase.  This kernel is one
// launch per phase.
//
// What it computes: exactly one call of gauss_seidel_line_phase(..., p1,
// p2, axis).  The lines run along the frame's x axis; the y- and z-lines
// are the x-lines of a permuted frame (axis 1: (y, x, z); axis 2:
// (z, y, x)).  The kernel reads the untransposed C-contiguous tensors
// through the strides of their permuted views, given at run time, so no
// transpose is copied.  For every line at the transverse frame node
// (iy, iz) = (1 + p1 + 2j, 1 + p2 + 2k) it
//   1. assembles, group by group along the line, the complex-symmetric
//      (transposed, never conjugated) 5x5 diagonal block M_g, the
//      sub-diagonal block L_g and the rhs r_g from zeta, eta, the widths,
//      the sources and the neighbouring edges (reference emg3d
//      core.py:680-766), with the last-group reduction (core.py:1467-1477);
//      unknowns per group g: [ex(g), ey-, ey+, ez-, ez+] at node g+1;
//   2. eliminates forward (block-Thomas, unpivoted as the reference's
//      banded LDL^T): C_0 = M_0, C_g = M_g - L_g C_{g-1}^{-1} L_g^T,
//      y_g = r_g - L_g C_{g-1}^{-1} y_{g-1}, with C_g^{-1} (5x5, by
//      Gauss-Jordan) and y_g carried in registers, and keeps for the
//      backward pass W_g = C_g^{-1} L_{g+1}^T and z_g = C_g^{-1} y_g (30
//      values per group) in a scratch tensor that the wrapper allocates;
//   3. substitutes backward, u_g = z_g - W_g u_{g+1}, and writes the five
//      unknowns of each group back in place.
//
// In place is safe: a line reads only its own sources and the edges of the
// transversely neighbouring lines, whose transverse node parity differs,
// so no line of a color reads what another line of the color writes.
//
// What bounds it on this card: memory traffic.  Per group a line reads
// about 60 operand values (8 zeta, 20 eta, 5 sources, 20 neighbouring
// edges, the widths) and writes 5 unknowns, for some 2,000 real flops; in
// complex64 that is under 10 flop/byte, below the card's ~20.  The scratch
// adds 30 values written and read back per group.  One thread per line,
// one warp per block (so that the few lines of a color spread over the
// SMs): at 128^3 a color has 4,096 lines, a few percent of the card's
// thread slots, so the kernel is latency- rather than bandwidth-limited;
// consecutive threads take the transverse frame axis with the smaller
// memory stride, so that they read neighbouring addresses.  A warp per
// line or a cyclic-reduction form is later work.
//
// Complex tensors are read in place, interleaved (re, im), through
// torch.view_as_real(...).data_ptr().  Shapes and strides are run-time
// arguments (no per-shape build), offsets 64-bit.  The kernel launches on
// the caller's stream, does not synchronise and allocates nothing; each C
// entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename R>
struct alignas(2 * sizeof(R)) Cx {
  R re, im;
};

// Value arithmetic: V is R (Laplace domain, real) or Cx<R> (frequency
// domain).  Coefficients are always real.
template <typename R> __device__ __forceinline__ R cx_add(R a, R b) { return a + b; }
template <typename R> __device__ __forceinline__ R cx_sub(R a, R b) { return a - b; }
template <typename R> __device__ __forceinline__ R cx_mul(R a, R b) { return a * b; }
template <typename R> __device__ __forceinline__ R cx_scale(R a, R s) { return a * s; }
template <typename R> __device__ __forceinline__ R cx_recip(R a) { return R(1) / a; }

template <typename R>
__device__ __forceinline__ Cx<R> cx_add(Cx<R> a, Cx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__device__ __forceinline__ Cx<R> cx_sub(Cx<R> a, Cx<R> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename R>
__device__ __forceinline__ Cx<R> cx_mul(Cx<R> a, Cx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename R>
__device__ __forceinline__ Cx<R> cx_scale(Cx<R> a, R s) {
  return {a.re * s, a.im * s};
}
template <typename R>
__device__ __forceinline__ Cx<R> cx_recip(Cx<R> a) {
  R d = R(1) / (a.re * a.re + a.im * a.im);
  return {a.re * d, -a.im * d};
}
template <typename R> __device__ __forceinline__ R cx_neg(R a) { return -a; }
template <typename R>
__device__ __forceinline__ Cx<R> cx_neg(Cx<R> a) {
  return {-a.re, -a.im};
}

template <typename V, typename R> struct Real;
template <typename R> struct Real<R, R> {
  __device__ static R make(R s) { return s; }
};
template <typename R> struct Real<Cx<R>, R> {
  __device__ static Cx<R> make(R s) { return {s, R(0)}; }
};

// acc + c * v, with a real coefficient c.
template <typename V, typename R>
__device__ __forceinline__ V axpy(V acc, R c, V v) {
  return cx_add(acc, cx_scale(v, c));
}

// Frame geometry: cells along the frame axes, and the element strides of
// the permuted views of the edge arrays of the x, y and z role and of the
// cell arrays.
struct Geo {
  int64_t nx, ny, nz;
  int64_t sx[3], sy[3], sz[3], sc[3];
};

template <typename V, typename R>
struct Line {
  V* ex; V* ey; V* ez;
  const V* srcx; const V* srcy; const V* srcz;
  const V* eta_x; const V* eta_y; const V* eta_z;
  const R* zeta; const R* hx; const R* hy; const R* hz;
  V* scratch;
  Geo g;

  __device__ __forceinline__ int64_t ox(int64_t a, int64_t b, int64_t c) const {
    return a * g.sx[0] + b * g.sx[1] + c * g.sx[2];
  }
  __device__ __forceinline__ int64_t oy(int64_t a, int64_t b, int64_t c) const {
    return a * g.sy[0] + b * g.sy[1] + c * g.sy[2];
  }
  __device__ __forceinline__ int64_t oz(int64_t a, int64_t b, int64_t c) const {
    return a * g.sz[0] + b * g.sz[1] + c * g.sz[2];
  }
  __device__ __forceinline__ int64_t oc(int64_t a, int64_t b, int64_t c) const {
    return a * g.sc[0] + b * g.sc[1] + c * g.sc[2];
  }

  // The sub-diagonal block L_a of group a (its 8 nonzero entries, all
  // real): l01 l02 l03 l04 in row 0, l11 l22 l33 l44 on the diagonal.
  // Zero rows 1-4 for the last group.
  __device__ __forceinline__ void left(int64_t a, int64_t iy, int64_t iz,
                                       R (&L)[8]) const {
    const R ihxa = R(1) / hx[a];
    const R kxa = R(0.5) * ihxa;
    const R kym = R(0.5) / hy[iy - 1], kyp = R(0.5) / hy[iy];
    const R kzm = R(0.5) / hz[iz - 1], kzp = R(0.5) / hz[iz];
    const R zamm = zeta[oc(a, iy - 1, iz - 1)], zamp = zeta[oc(a, iy - 1, iz)];
    const R zapm = zeta[oc(a, iy, iz - 1)], zapp = zeta[oc(a, iy, iz)];
    L[0] = kym * (zamp + zamm) * ihxa;     // zyLxm
    L[1] = -kyp * (zapp + zapm) * ihxa;    // -zyRxm
    L[2] = kzm * (zapm + zamm) * ihxa;     // yzLxm
    L[3] = -kzp * (zapp + zamp) * ihxa;    // -yzRxm
    const bool last = a == g.nx - 1;
    L[4] = last ? R(0) : -kxa * (zamp + zamm) * ihxa;   // -zxLym
    L[5] = last ? R(0) : -kxa * (zapp + zapm) * ihxa;   // -zxLyp
    L[6] = last ? R(0) : -kxa * (zapm + zamm) * ihxa;   // -yxLzm
    L[7] = last ? R(0) : -kxa * (zapp + zamp) * ihxa;   // -yxLzp
  }

  // The diagonal block M and the rhs r of group a, with the last-group
  // reduction (reference core.py:680-766, 1467-1477).
  __device__ __forceinline__ void block(int64_t a, int64_t iy, int64_t iz,
                                        V (&M)[5][5], V (&r)[5]) const {
    using RV = Real<V, R>;
    const int64_t b = a + 1 < g.nx ? a + 1 : g.nx - 1;
    const int64_t ym = iy - 1, yp = iy, zm = iz - 1, zp = iz;
    const R ihxa = R(1) / hx[a], ihxb = R(1) / hx[b];
    const R ihym = R(1) / hy[ym], ihyp = R(1) / hy[yp];
    const R ihzm = R(1) / hz[zm], ihzp = R(1) / hz[zp];
    const R kxa = R(0.5) * ihxa, kxb = R(0.5) * ihxb;
    const R kym = R(0.5) * ihym, kyp = R(0.5) * ihyp;
    const R kzm = R(0.5) * ihzm, kzp = R(0.5) * ihzp;

    // zeta at the 8 cells around the edge pair: z{x: a|b}{y: m|p}{z: m|p}.
    const R zamm = zeta[oc(a, ym, zm)], zamp = zeta[oc(a, ym, zp)];
    const R zapm = zeta[oc(a, yp, zm)], zapp = zeta[oc(a, yp, zp)];
    const R zbmm = zeta[oc(b, ym, zm)], zbmp = zeta[oc(b, ym, zp)];
    const R zbpm = zeta[oc(b, yp, zm)], zbpp = zeta[oc(b, yp, zp)];

    // The 24 averaged-zeta coefficients (reference core.py:350-374).
    const R zyLxm = kym * (zamp + zamm), zyRxm = kyp * (zapp + zapm);
    const R yzLxm = kzm * (zapm + zamm), yzRxm = kzp * (zapp + zamp);
    const R zxLym = kxa * (zamp + zamm), zxRym = kxb * (zbmp + zbmm);
    const R xzLym = kzm * (zbmm + zamm), xzRym = kzp * (zbmp + zamp);
    const R zxLyp = kxa * (zapp + zapm), zxRyp = kxb * (zbpp + zbpm);
    const R xzLyp = kzm * (zbpm + zapm), xzRyp = kzp * (zbpp + zapp);
    const R yxLzm = kxa * (zapm + zamm), yxRzm = kxb * (zbpm + zbmm);
    const R xyLzm = kym * (zbmm + zamm), xyRzm = kyp * (zbpm + zapm);
    const R yxLzp = kxa * (zapp + zamp), yxRzp = kxb * (zbpp + zbmp);
    const R xyLzp = kym * (zbmp + zamp), xyRzp = kyp * (zbpp + zapp);

    // Diagonal eta sums / 4 over the 4 cells around each edge.
    auto sum4 = [](V p, V q, V s, V t) {
      return cx_scale(cx_add(cx_add(p, q), cx_add(s, t)), R(0.25));
    };
    const V st0 = sum4(eta_x[oc(a, ym, zm)], eta_x[oc(a, yp, zm)],
                       eta_x[oc(a, ym, zp)], eta_x[oc(a, yp, zp)]);
    const V st2 = sum4(eta_y[oc(b, ym, zm)], eta_y[oc(b, ym, zp)],
                       eta_y[oc(a, ym, zm)], eta_y[oc(a, ym, zp)]);
    const V st3 = sum4(eta_y[oc(b, yp, zm)], eta_y[oc(b, yp, zp)],
                       eta_y[oc(a, yp, zm)], eta_y[oc(a, yp, zp)]);
    const V st4 = sum4(eta_z[oc(b, yp, zm)], eta_z[oc(b, ym, zm)],
                       eta_z[oc(a, yp, zm)], eta_z[oc(a, ym, zm)]);
    const V st5 = sum4(eta_z[oc(b, yp, zp)], eta_z[oc(b, ym, zp)],
                       eta_z[oc(a, yp, zp)], eta_z[oc(a, ym, zp)]);

    const V m00 = cx_sub(RV::make(zyRxm * ihyp + zyLxm * ihym
                                  + yzRxm * ihzp + yzLxm * ihzm), st0);
    r[0] = srcx[ox(a, iy, iz)];
    r[0] = axpy(r[0], zyRxm * ihyp, ex[ox(a, iy + 1, iz)]);
    r[0] = axpy(r[0], zyLxm * ihym, ex[ox(a, iy - 1, iz)]);
    r[0] = axpy(r[0], yzRxm * ihzp, ex[ox(a, iy, iz + 1)]);
    r[0] = axpy(r[0], yzLxm * ihzm, ex[ox(a, iy, iz - 1)]);

    if (a == g.nx - 1) {
      // Last group: only ex; identity rows for the four absent unknowns.
#pragma unroll
      for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 5; ++j) M[i][j] = RV::make(R(i == j && i > 0));
        if (i > 0) r[i] = RV::make(R(0));
      }
      M[0][0] = m00;
      return;
    }

    M[0][0] = m00;
    M[1][1] = cx_sub(RV::make(zxRym * ihxb + zxLym * ihxa
                              + xzRym * ihzp + xzLym * ihzm), st2);
    M[2][2] = cx_sub(RV::make(zxRyp * ihxb + zxLyp * ihxa
                              + xzRyp * ihzp + xzLyp * ihzm), st3);
    M[3][3] = cx_sub(RV::make(yxRzm * ihxb + yxLzm * ihxa
                              + xyRzm * ihyp + xyLzm * ihym), st4);
    M[4][4] = cx_sub(RV::make(yxRzp * ihxb + yxLzp * ihxa
                              + xyRzp * ihyp + xyLzp * ihym), st5);
    M[1][0] = M[0][1] = RV::make(-zyLxm * ihxa);
    M[2][0] = M[0][2] = RV::make(zyRxm * ihxa);
    M[3][0] = M[0][3] = RV::make(-yzLxm * ihxa);
    M[4][0] = M[0][4] = RV::make(yzRxm * ihxa);
    M[2][1] = M[1][2] = RV::make(R(0));
    M[3][1] = M[1][3] = RV::make(-xzLym * ihym);
    M[4][1] = M[1][4] = RV::make(xzRym * ihym);
    M[3][2] = M[2][3] = RV::make(xzLyp * ihyp);
    M[4][2] = M[2][4] = RV::make(-xzRyp * ihyp);
    M[4][3] = M[3][4] = RV::make(R(0));

    // Off-line couplings moved to the rhs (core.py:723-766).
    r[1] = srcy[oy(b, ym, iz)];
    r[1] = axpy(r[1], zxRym * ihym, ex[ox(b, iy - 1, iz)]);
    r[1] = axpy(r[1], -zxLym * ihym, ex[ox(a, iy - 1, iz)]);
    r[1] = axpy(r[1], xzRym * ihym, ez[oz(b, iy - 1, zp)]);
    r[1] = axpy(r[1], -xzLym * ihym, ez[oz(b, iy - 1, zm)]);
    r[1] = axpy(r[1], xzRym * ihzp, ey[oy(b, ym, iz + 1)]);
    r[1] = axpy(r[1], xzLym * ihzm, ey[oy(b, ym, iz - 1)]);

    r[2] = srcy[oy(b, yp, iz)];
    r[2] = axpy(r[2], zxLyp * ihyp, ex[ox(a, iy + 1, iz)]);
    r[2] = axpy(r[2], -zxRyp * ihyp, ex[ox(b, iy + 1, iz)]);
    r[2] = axpy(r[2], xzLyp * ihyp, ez[oz(b, iy + 1, zm)]);
    r[2] = axpy(r[2], -xzRyp * ihyp, ez[oz(b, iy + 1, zp)]);
    r[2] = axpy(r[2], xzRyp * ihzp, ey[oy(b, yp, iz + 1)]);
    r[2] = axpy(r[2], xzLyp * ihzm, ey[oy(b, yp, iz - 1)]);

    r[3] = srcz[oz(b, iy, zm)];
    r[3] = axpy(r[3], yxRzm * ihzm, ex[ox(b, iy, iz - 1)]);
    r[3] = axpy(r[3], -yxLzm * ihzm, ex[ox(a, iy, iz - 1)]);
    r[3] = axpy(r[3], xyRzm * ihzm, ey[oy(b, yp, iz - 1)]);
    r[3] = axpy(r[3], -xyLzm * ihzm, ey[oy(b, ym, iz - 1)]);
    r[3] = axpy(r[3], xyRzm * ihyp, ez[oz(b, iy + 1, zm)]);
    r[3] = axpy(r[3], xyLzm * ihym, ez[oz(b, iy - 1, zm)]);

    r[4] = srcz[oz(b, iy, zp)];
    r[4] = axpy(r[4], yxLzp * ihzp, ex[ox(a, iy, iz + 1)]);
    r[4] = axpy(r[4], -yxRzp * ihzp, ex[ox(b, iy, iz + 1)]);
    r[4] = axpy(r[4], xyLzp * ihzp, ey[oy(b, ym, iz + 1)]);
    r[4] = axpy(r[4], -xyRzp * ihzp, ey[oy(b, yp, iz + 1)]);
    r[4] = axpy(r[4], xyRzp * ihyp, ez[oz(b, iy + 1, zp)]);
    r[4] = axpy(r[4], xyLzp * ihym, ez[oz(b, iy - 1, zp)]);
  }
};

// In-place inverse of a 5x5 matrix by unpivoted Gauss-Jordan.
template <typename V>
__device__ __forceinline__ void invert5(V (&A)[5][5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const V piv = cx_recip(A[k][k]);
    A[k][k] = piv;
#pragma unroll
    for (int j = 0; j < 5; ++j)
      if (j != k) A[k][j] = cx_mul(A[k][j], piv);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (i == k) continue;
      const V f = A[i][k];
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if (j != k) A[i][j] = cx_sub(A[i][j], cx_mul(f, A[k][j]));
      A[i][k] = cx_neg(cx_mul(f, piv));
    }
  }
}

template <typename V, typename R>
__global__ void __launch_bounds__(32)
line_phase_kernel(Line<V, R> ln, int py, int pz, int64_t ncy, int64_t ncz,
                  int y_fastest) {
  const int64_t nlines = ncy * ncz;
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nlines) return;
  const int64_t j = y_fastest ? t % ncy : t / ncz;
  const int64_t k = y_fastest ? t / ncy : t % ncz;
  const int64_t iy = 1 + py + 2 * j, iz = 1 + pz + 2 * k;
  const int64_t nx = ln.g.nx;
  // Scratch value q of group a of this line; consecutive lines are
  // consecutive in memory.
  auto sidx = [&](int64_t a, int q) { return (a * 30 + q) * nlines + t; };

  V C[5][5], y[5], z[5];
  ln.block(0, iy, iz, C, y);
  invert5(C);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    z[i] = cx_mul(C[i][0], y[0]);
#pragma unroll
    for (int q = 1; q < 5; ++q) z[i] = cx_add(z[i], cx_mul(C[i][q], y[q]));
  }

  // Forward elimination.  Entering step a: C = C_{a-1}^{-1}, z = z_{a-1}.
  for (int64_t a = 1; a < nx; ++a) {
    R L[8];
    V M[5][5];
    ln.left(a, iy, iz, L);
    ln.block(a, iy, iz, M, y);
    // W = C_{a-1}^{-1} L_a^T: column 0 from row 0 of L_a, columns 1-4
    // from its diagonal.  M -= L_a W and y -= L_a z, row by row of W.
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      V w[5];
      w[0] = cx_scale(C[i][1], L[0]);
      w[0] = cx_add(w[0], cx_scale(C[i][2], L[1]));
      w[0] = cx_add(w[0], cx_scale(C[i][3], L[2]));
      w[0] = cx_add(w[0], cx_scale(C[i][4], L[3]));
#pragma unroll
      for (int q = 1; q < 5; ++q) w[q] = cx_scale(C[i][q], L[3 + q]);
#pragma unroll
      for (int q = 0; q < 5; ++q) ln.scratch[sidx(a - 1, 5 * i + q)] = w[q];
      ln.scratch[sidx(a - 1, 25 + i)] = z[i];
      // Row 0 of L_a: L[0..3] at columns 1..4; row i >= 1: L[3 + i] at i.
      const R l0i = i == 0 ? R(0) : L[i - 1];
#pragma unroll
      for (int q = 0; q < 5; ++q) M[0][q] = cx_sub(M[0][q], cx_scale(w[q], l0i));
      y[0] = cx_sub(y[0], cx_scale(z[i], l0i));
      if (i > 0) {
#pragma unroll
        for (int q = 0; q < 5; ++q) M[i][q] = cx_sub(M[i][q], cx_scale(w[q], L[3 + i]));
        y[i] = cx_sub(y[i], cx_scale(z[i], L[3 + i]));
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int q = 0; q < 5; ++q) C[i][q] = M[i][q];
    invert5(C);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      z[i] = cx_mul(C[i][0], y[0]);
#pragma unroll
      for (int q = 1; q < 5; ++q) z[i] = cx_add(z[i], cx_mul(C[i][q], y[q]));
    }
  }

  // Backward substitution: u_{nx-1} = z_{nx-1} (ex only), then
  // u_a = z_a - W_a u_{a+1}.
  V* const ex = ln.ex; V* const ey = ln.ey; V* const ez = ln.ez;
  ex[ln.ox(nx - 1, iy, iz)] = z[0];
  V u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) u[i] = z[i];
  for (int64_t a = nx - 2; a >= 0; --a) {
    V un[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      V acc = ln.scratch[sidx(a, 25 + i)];
#pragma unroll
      for (int q = 0; q < 5; ++q)
        acc = cx_sub(acc, cx_mul(ln.scratch[sidx(a, 5 * i + q)], u[q]));
      un[i] = acc;
    }
    ex[ln.ox(a, iy, iz)] = un[0];
    ey[ln.oy(a + 1, iy - 1, iz)] = un[1];
    ey[ln.oy(a + 1, iy, iz)] = un[2];
    ez[ln.oz(a + 1, iy, iz - 1)] = un[3];
    ez[ln.oz(a + 1, iy, iz)] = un[4];
#pragma unroll
    for (int i = 0; i < 5; ++i) u[i] = un[i];
  }
}

template <typename V, typename R>
int launch(void* ex, void* ey, void* ez, const void* sx, const void* sy,
           const void* sz, const void* eta_x, const void* eta_y,
           const void* eta_z, const void* zeta, const void* hx,
           const void* hy, const void* hz, void* scratch, const int64_t* geo,
           int py, int pz, void* stream) {
  Line<V, R> ln;
  ln.ex = static_cast<V*>(ex);
  ln.ey = static_cast<V*>(ey);
  ln.ez = static_cast<V*>(ez);
  ln.srcx = static_cast<const V*>(sx);
  ln.srcy = static_cast<const V*>(sy);
  ln.srcz = static_cast<const V*>(sz);
  ln.eta_x = static_cast<const V*>(eta_x);
  ln.eta_y = static_cast<const V*>(eta_y);
  ln.eta_z = static_cast<const V*>(eta_z);
  ln.zeta = static_cast<const R*>(zeta);
  ln.hx = static_cast<const R*>(hx);
  ln.hy = static_cast<const R*>(hy);
  ln.hz = static_cast<const R*>(hz);
  ln.scratch = static_cast<V*>(scratch);
  ln.g.nx = geo[0];
  ln.g.ny = geo[1];
  ln.g.nz = geo[2];
  for (int i = 0; i < 3; ++i) {
    ln.g.sx[i] = geo[3 + i];
    ln.g.sy[i] = geo[6 + i];
    ln.g.sz[i] = geo[9 + i];
    ln.g.sc[i] = geo[12 + i];
  }
  const int64_t ncy = (ln.g.ny - py) / 2, ncz = (ln.g.nz - pz) / 2;
  const int64_t nlines = ncy * ncz;
  if (nlines > 0) {
    // Consecutive threads along the transverse axis of smaller stride;
    // one warp per block spreads the few lines of a color over the SMs.
    const int y_fastest = ln.g.sc[1] < ln.g.sc[2];
    const int threads = 32;
    const int64_t blocks = (nlines + threads - 1) / threads;
    line_phase_kernel<V, R><<<dim3(unsigned(blocks)), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        ln, py, pz, ncy, ncz, y_fastest);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LINE_PHASE_ENTRY(NAME, V, R)                                         \
  extern "C" int NAME(void* ex, void* ey, void* ez, const void* sx,          \
                      const void* sy, const void* sz, const void* eta_x,     \
                      const void* eta_y, const void* eta_z,                  \
                      const void* zeta, const void* hx, const void* hy,      \
                      const void* hz, void* scratch, const int64_t* geo,     \
                      int py, int pz, void* stream) {                        \
    return launch<V, R>(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,   \
                        hx, hy, hz, scratch, geo, py, pz, stream);           \
  }

LINE_PHASE_ENTRY(line_phase_c64, Cx<float>, float)
LINE_PHASE_ENTRY(line_phase_c128, Cx<double>, double)
LINE_PHASE_ENTRY(line_phase_f32, float, float)
LINE_PHASE_ENTRY(line_phase_f64, double, double)
