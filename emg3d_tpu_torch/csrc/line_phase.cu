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
//      banded LDL^T), in the form of emg3d_tpu/ops/smoothers.py:942-951:
//      solve C_{g-1} X = [L_g^T | y_{g-1}] (5x6), then
//      C_g = M_g - L_g X[:, :5] and y_g = r_g - L_g X[:, 5]; X is kept for
//      the backward pass (W_{g-1} = X[:, :5], z_{g-1} = X[:, 5]: 30 values
//      per group) in a scratch tensor that the wrapper allocates;
//   3. substitutes backward, u_g = z_g - W_g u_{g+1}, and writes the five
//      unknowns of each group back in place.
//
// In place is safe: a line reads only its own sources and the edges of the
// transversely neighbouring lines, whose transverse node parity differs,
// so no line of a color reads what another line of the color writes.
//
// What bounds it on this card: neither the bytes it must move (about 60
// operand values read and 5 written per group; 0.038 ms at 128^3
// complex64) nor its arithmetic, but the length of one line's dependent
// chain: the groups of a line follow one another, and a color has few
// lines (4,096 at 128^3, 1,024 at 64^3).  Measured on an H100 (PERF.md):
// a warp alone on its scheduler takes about 1.0 us per group (some 840
// instructions at 2.4 cycles each), whatever the number of lines, up to
// one warp per scheduler (2,112 lines); at 128^3 two warps share a
// scheduler and the scratch no longer fits the L2 cache, and a group takes
// 2.0-2.2 us.
// What the design does about it: a TEAM of 8 lanes shares one line, 4
// lines per warp, one warp per block (so that the few lines of a color
// spread over the SMs).
//   - Lane q < 5 owns column q of the step's right-hand side [L_g^T |
//     y_{g-1}] and lanes 5-7 the y column (6 and 7 repeat 5, so that every
//     lane runs the same instructions).  Each lane factors the symmetric
//     C_{g-1} redundantly (unpivoted LDL^T, the products fused into
//     multiply-adds, the pivots inverted by IEEE division) and solves only
//     its own column.  Column q of C_g = M_g -
//     L_g X is then local to lane q, and y_g to lane 5; the lanes exchange
//     the 15 distinct entries of C_g by shuffles of width 8.
//   - The assembly is shared out: all lanes of a team read the zeta of the
//     line at the same addresses and compute the real coefficients
//     redundantly; lane q loads only the 4 eta of its own diagonal entry,
//     its own source and its own 4-6 neighbouring edges, through per-lane
//     pointers set up once per line, so that no branch diverges.  The
//     loads of group g+1 are started before the algebra of group g.
//   - The scratch stays in device memory: lane q stores its column of X
//     (lane 5: z), laid out by rows, 6 values per row, so that in the
//     backward pass lane i reads row i of [W_g | z_g] as 6 consecutive
//     values, computes its own unknown and writes it itself.
//   - Consecutive teams take the transverse frame axis with the smaller
//     memory stride.
// Tried on the card and not kept (PERF.md): 20 scratch values per group
// (the symmetric C_g^{-1} and z_g, with L rebuilt in the backward pass),
// teams of 6 lanes with 5 lines per warp, reading the scratch 8 groups
// ahead, 2, 4 or 8 warps per block, and the approximate reciprocal in
// float.
//
// Complex tensors are read in place, interleaved (re, im), through
// torch.view_as_real(...).data_ptr().  Shapes and strides are run-time
// arguments (no per-shape build), offsets 64-bit.  The kernel launches on
// the caller's stream, does not synchronise and allocates nothing; each C
// entry point returns cudaGetLastError().
//
// A task index (the batch engine, emg3d_tpu/parallel/batch.py:99-103):
// blockIdx.y is the task, with one task stride per edge role (fields and
// sources are (ntask, ...)), one for eta (stacked: cells; shared: 0) and
// one for the scratch (each task has its own).  A shared eta may carry one
// scale per task that multiplies every eta value on load (solver._scaled).
// zeta and the widths are shared.  The design per line is unchanged; one
// task, stride 0 and no scale is the unbatched kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TEAM = 8;             // lanes that share one line
constexpr int WARP = 32;            // threads per block: 4 teams
constexpr unsigned FULL = 0xffffffffu;

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
// 1 / a, by IEEE division in float too: the approximate reciprocal was
// timed (7 % faster at 128^3, 13-15 % below) and not kept.
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
  R d = cx_recip(a.re * a.re + a.im * a.im);
  return {a.re * d, -a.im * d};
}
// s - a * b, fused: 4 fused multiply-adds, 2 deep, for a complex value.
template <typename R> __device__ __forceinline__ R cx_msub(R s, R a, R b) {
  return fma(-a, b, s);
}
template <typename R>
__device__ __forceinline__ Cx<R> cx_msub(Cx<R> s, Cx<R> a, Cx<R> b) {
  return {fma(a.im, b.im, fma(-a.re, b.re, s.re)),
          fma(-a.im, b.re, fma(-a.re, b.im, s.im))};
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

// The value that lane ``src`` of the caller's team holds in ``v``.
template <typename R>
__device__ __forceinline__ R team_get(R v, int src) {
  return __shfl_sync(FULL, v, src, TEAM);
}
template <typename R>
__device__ __forceinline__ Cx<R> team_get(Cx<R> v, int src) {
  return {__shfl_sync(FULL, v.re, src, TEAM),
          __shfl_sync(FULL, v.im, src, TEAM)};
}

// One of five values by the lane's role (0-4), without a branch.
template <typename T>
__device__ __forceinline__ T sel5(int role, T a0, T a1, T a2, T a3, T a4) {
  return role == 0 ? a0 : role == 1 ? a1 : role == 2 ? a2
                                    : role == 3 ? a3 : a4;
}

// Frame geometry: cells along the frame axes, and the element strides of
// the permuted views of the edge arrays of the x, y and z role and of the
// cell arrays; then the task strides of the edge arrays of each role, of
// eta and of the scratch.
struct Geo {
  int64_t nx, ny, nz;
  int64_t sx[3], sy[3], sz[3], sc[3];
  int64_t tx, ty, tz, teta, tscr;
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
};

// What one lane reads of one group: its source, its 6 neighbouring edges
// (4 for role 0), the 4 eta of its diagonal entry, and for the whole team
// the 4 zeta and the width of the cells at x = min(g + 1, nx - 1).
template <typename V, typename R>
struct Raw {
  V src, nb[6], eta[4];
  R zb[4], hb;
};

// Unpivoted LDL^T of the symmetric 5x5 C, of which only the lower
// triangle is read; C is overwritten.  l holds the strict lower triangle
// of the unit factor, row by row, dinv the inverses of the pivots.
template <typename V>
struct Ldl {
  V l[10], dinv[5];

  __device__ __forceinline__ V& at(int i, int j) { return l[i * (i - 1) / 2 + j]; }

  __device__ __forceinline__ void factor(V (&C)[5][5]) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      // C[i][j] <- u_ij = l_ij d_j = c_ij - sum_{k<j} u_ik l_jk.
#pragma unroll
      for (int i = j; i < 5; ++i) {
        V s = C[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = cx_msub(s, C[i][k], at(j, k));
        C[i][j] = s;
      }
      dinv[j] = cx_recip(C[j][j]);
#pragma unroll
      for (int i = j + 1; i < 5; ++i) at(i, j) = cx_mul(C[i][j], dinv[j]);
    }
  }

  // x <- C^{-1} x.
  __device__ __forceinline__ void solve(V (&x)[5]) {
#pragma unroll
    for (int i = 1; i < 5; ++i)
#pragma unroll
      for (int k = 0; k < i; ++k) x[i] = cx_msub(x[i], at(i, k), x[k]);
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = cx_mul(x[i], dinv[i]);
#pragma unroll
    for (int i = 3; i >= 0; --i)
#pragma unroll
      for (int k = i + 1; k < 5; ++k) x[i] = cx_msub(x[i], at(k, i), x[k]);
  }
};

template <typename V, typename R, bool SCALED>
__global__ void __launch_bounds__(WARP)
line_phase_kernel(Line<V, R> ln, int py, int pz, int64_t ncy, int64_t ncz,
                  int y_fastest, const V* __restrict__ scale) {
  using RV = Real<V, R>;
  // This block's task: its slices of the fields, sources, eta and scratch.
  const int64_t task = blockIdx.y;
  V* const ex = ln.ex + task * ln.g.tx;
  V* const ey = ln.ey + task * ln.g.ty;
  V* const ez = ln.ez + task * ln.g.tz;
  const V* const srcx = ln.srcx + task * ln.g.tx;
  const V* const srcy = ln.srcy + task * ln.g.ty;
  const V* const srcz = ln.srcz + task * ln.g.tz;
  const V* const etax = ln.eta_x + task * ln.g.teta;
  const V* const etay = ln.eta_y + task * ln.g.teta;
  const V* const etaz = ln.eta_z + task * ln.g.teta;
  V sc;
  if constexpr (SCALED) sc = scale[task];
  const int64_t nlines = ncy * ncz;
  const int q = threadIdx.x % TEAM;
  int64_t t = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / TEAM;
  // A team past the last line repeats it and stores nothing: the shuffles
  // need every lane of the warp.
  const bool active = t < nlines;
  if (!active) t = nlines - 1;
  // Lanes 0-4 assemble row `role` and own column `role`; lanes 5-7 own the
  // y column and repeat the assembly of row 4.
  const int role = q < 5 ? q : 4;
  const bool is_y = q >= 5;
  const bool role0 = role == 0;
  const int64_t j = y_fastest ? t % ncy : t / ncz;
  const int64_t k = y_fastest ? t / ncy : t % ncz;
  const int64_t iy = 1 + py + 2 * j, iz = 1 + pz + 2 * k;
  const int64_t ym = iy - 1, yp = iy, zm = iz - 1, zp = iz;
  const int64_t nx = ln.g.nx;
  const int64_t sx0 = ln.g.sx[0], sy0 = ln.g.sy[0], sz0 = ln.g.sz[0];
  const int64_t sc0 = ln.g.sc[0];

  // Transverse widths: the same for every group of the line.
  const R ihym = cx_recip(ln.hy[ym]), ihyp = cx_recip(ln.hy[yp]);
  const R ihzm = cx_recip(ln.hz[zm]), ihzp = cx_recip(ln.hz[zp]);
  const R kym = R(0.5) * ihym, kyp = R(0.5) * ihyp;
  const R kzm = R(0.5) * ihzm, kzp = R(0.5) * ihzp;

  // zeta of the 4 cells around the line, at x = 0: mm, mp, pm, pp.
  const int64_t tmm = ln.oc(0, ym, zm), tmp = ln.oc(0, ym, zp);
  const int64_t tpm = ln.oc(0, yp, zm), tpp = ln.oc(0, yp, zp);

  // The 4 eta cells of the lane's diagonal entry (reference
  // core.py:390): role 0 takes the 4 cells at x = a; roles 1-4 take two
  // transverse cells at x = b (pair 0) and at x = a (pair 1).
  const V* const eta_p = role0 ? etax : role <= 2 ? etay : etaz;
  const int64_t eo0 = sel5(role, tmm, tmm, tpm, tpm, tpp);
  const int64_t eo1 = sel5(role, tpm, tmp, tpp, tmm, tmp);
  const int64_t eo2 = role0 ? tmp : eo0;
  const int64_t eo3 = role0 ? tpp : eo1;

  // The lane's source and neighbouring edges, at x = 0 (the off-line
  // couplings of its row, reference core.py:723-766, in the order of the
  // sums there).  Terms 0 and 1 are ex edges; 2, 3 and 4, 5 are two pairs
  // of the other components.  Roles 1-4 read term 0 or term 1 at x = b.
  const V* const ps = sel5<const V*>(role, srcx + ln.ox(0, iy, iz),
                           srcy + ln.oy(0, ym, iz),
                           srcy + ln.oy(0, yp, iz),
                           srcz + ln.oz(0, iy, zm),
                           srcz + ln.oz(0, iy, zp));
  const int64_t ssrc = role0 ? sx0 : role <= 2 ? sy0 : sz0;
  const V* const p0 = ex + sel5(role, ln.ox(0, iy + 1, iz),
                                ln.ox(0, iy - 1, iz), ln.ox(0, iy + 1, iz),
                                ln.ox(0, iy, iz - 1), ln.ox(0, iy, iz + 1));
  const V* const p1 = role0 ? ex + ln.ox(0, iy - 1, iz) : p0;
  const bool b0 = role == 1 || role == 3, b1 = role == 2 || role == 4;
  const V* const p2 = sel5<const V*>(role, ex + ln.ox(0, iy, iz + 1),
                           ez + ln.oz(0, iy - 1, zp),
                           ez + ln.oz(0, iy + 1, zm),
                           ey + ln.oy(0, yp, iz - 1),
                           ey + ln.oy(0, ym, iz + 1));
  const V* const p3 = sel5<const V*>(role, ex + ln.ox(0, iy, iz - 1),
                           ez + ln.oz(0, iy - 1, zm),
                           ez + ln.oz(0, iy + 1, zp),
                           ey + ln.oy(0, ym, iz - 1),
                           ey + ln.oy(0, yp, iz + 1));
  const int64_t s23 = role0 ? sx0 : role <= 2 ? sz0 : sy0;
  // Role 0 has no terms 4 and 5: it reads term 0 again and drops it.
  const V* const p4 = sel5<const V*>(role, p0,
                           ey + ln.oy(0, ym, iz + 1),
                           ey + ln.oy(0, yp, iz + 1),
                           ez + ln.oz(0, iy + 1, zm),
                           ez + ln.oz(0, iy + 1, zp));
  const V* const p5 = sel5<const V*>(role, p0,
                           ey + ln.oy(0, ym, iz - 1),
                           ey + ln.oy(0, yp, iz - 1),
                           ez + ln.oz(0, iy - 1, zm),
                           ez + ln.oz(0, iy - 1, zp));
  const int64_t s45 = role0 ? sx0 : role <= 2 ? sy0 : sz0;
  // The constant factor of each of the lane's 6 rhs coefficients.
  const R w0 = sel5(role, ihyp, ihym, ihyp, ihzm, ihzp);
  const R w1 = sel5(role, ihym, -ihym, -ihyp, -ihzm, -ihzp);
  const R w2 = sel5(role, ihzp, ihym, ihyp, ihzm, ihzp);
  const R w3 = sel5(role, ihzm, -ihym, -ihyp, -ihzm, -ihzp);
  const R w4 = sel5(role, R(0), ihzp, ihzp, ihyp, ihyp);
  const R w5 = sel5(role, R(0), ihzm, ihzm, ihym, ihym);

  // Everything the lane reads of group a.  b = min(a + 1, nx - 1): in the
  // last group the x = b operands are read (in bounds) and dropped.
  auto load = [&](int64_t a) {
    Raw<V, R> w;
    const int64_t b = a + 1 < nx ? a + 1 : nx - 1;
    const int64_t xr = role0 ? a : b;
    w.src = ps[xr * ssrc];
    w.nb[0] = p0[(b0 ? b : a) * sx0];
    w.nb[1] = p1[(b1 ? b : a) * sx0];
    w.nb[2] = p2[xr * s23];
    w.nb[3] = p3[xr * s23];
    w.nb[4] = p4[xr * s45];
    w.nb[5] = p5[xr * s45];
    w.eta[0] = eta_p[xr * sc0 + eo0];
    w.eta[1] = eta_p[xr * sc0 + eo1];
    w.eta[2] = eta_p[a * sc0 + eo2];
    w.eta[3] = eta_p[a * sc0 + eo3];
    if constexpr (SCALED) {
#pragma unroll
      for (int i = 0; i < 4; ++i) w.eta[i] = cx_mul(sc, w.eta[i]);
    }
    w.zb[0] = ln.zeta[b * sc0 + tmm];
    w.zb[1] = ln.zeta[b * sc0 + tmp];
    w.zb[2] = ln.zeta[b * sc0 + tpm];
    w.zb[3] = ln.zeta[b * sc0 + tpp];
    w.hb = ln.hx[b];
    return w;
  };

  // Scratch value (row i, column c) of group a of this line: 5 rows of
  // [W_a[i, 0..4], z_a[i]].
  V* const scr = ln.scratch + task * ln.g.tscr;
  auto sidx = [&](int64_t a, int i, int c) {
    return (a * nlines + t) * 30 + (i * 6 + c);
  };

  V C[5][5], col[5];
  Ldl<V> f;
  R za[4] = {ln.zeta[tmm], ln.zeta[tmp], ln.zeta[tpm], ln.zeta[tpp]};
  R ihxa = cx_recip(ln.hx[0]);
  Raw<V, R> nxt = load(0);

  // Forward elimination.  Entering step a > 0: every lane holds the lower
  // triangle of C_{a-1} in C, and the y lanes hold y_{a-1} in col.
  for (int64_t a = 0; a < nx; ++a) {
    const Raw<V, R> cur = nxt;
    if (a + 1 < nx) nxt = load(a + 1);
    const bool last = a == nx - 1;

    // The averaged-zeta coefficients (reference core.py:350-374); z{x: a|b}
    // {y: m|p}{z: m|p} are the 8 cells around the edge pair.
    const R ihxb = cx_recip(cur.hb);
    const R kxa = R(0.5) * ihxa, kxb = R(0.5) * ihxb;
    const R zamm = za[0], zamp = za[1], zapm = za[2], zapp = za[3];
    const R zbmm = cur.zb[0], zbmp = cur.zb[1];
    const R zbpm = cur.zb[2], zbpp = cur.zb[3];
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

    // The sub-diagonal block L_a (8 real nonzeros): row 0 = (0, l0[1..4]),
    // rows 1-4 diagonal ld[1..4], zero in the last group.
    R l0[5], ld[5];
    l0[0] = ld[0] = R(0);
    l0[1] = zyLxm * ihxa;
    l0[2] = -zyRxm * ihxa;
    l0[3] = yzLxm * ihxa;
    l0[4] = -yzRxm * ihxa;
    ld[1] = last ? R(0) : -zxLym * ihxa;
    ld[2] = last ? R(0) : -zxLyp * ihxa;
    ld[3] = last ? R(0) : -yxLzm * ihxa;
    ld[4] = last ? R(0) : -yxLzp * ihxa;

    // The lane's row of the rhs r_a: coefficient k is the averaged zeta
    // sk times the lane's constant inverse width wk (sign included).
    const R s0 = sel5(role, zyRxm, zxRym, zxLyp, yxRzm, yxLzp);
    const R s1 = sel5(role, zyLxm, zxLym, zxRyp, yxLzm, yxRzp);
    const R s2 = sel5(role, yzRxm, xzRym, xzLyp, xyRzm, xyLzp);
    const R s3 = sel5(role, yzLxm, xzLym, xzRyp, xyLzm, xyRzp);
    const R s4 = sel5(role, R(0), xzRym, xzRyp, xyRzm, xyRzp);
    const R s5 = sel5(role, R(0), xzLym, xzLyp, xyLzm, xyLzp);
    const R c0 = s0 * w0, c1 = s1 * w1, c2 = s2 * w2, c3 = s3 * w3;
    const R c4 = s4 * w4, c5 = s5 * w5;
    V rq = cur.src;
    rq = axpy(rq, c0, cur.nb[0]);
    rq = axpy(rq, c1, cur.nb[1]);
    rq = axpy(rq, c2, cur.nb[2]);
    rq = axpy(rq, c3, cur.nb[3]);
    if (!role0) {
      rq = axpy(rq, c4, cur.nb[4]);
      rq = axpy(rq, c5, cur.nb[5]);
    }
    // Last group: only ex; identity rows for the four absent unknowns.
    if (last && !role0) rq = RV::make(R(0));

    // The lane's column of the diagonal block M_a (= its row: M_a is
    // symmetric), real parts first.
    // Role 0: the sum of its 4 rhs coefficients.  Roles 1-4: the two ex
    // couplings over the x widths (the one read at x = b over hx[b]) plus
    // the rhs coefficients 4 and 5.
    const R dre = role0 ? c0 + c1 + c2 + c3
                        : s0 * (b0 ? ihxb : ihxa) + s1 * (b1 ? ihxb : ihxa)
                              + c4 + c5;
    const V st = cx_scale(cx_add(cx_add(cur.eta[0], cur.eta[1]),
                                 cx_add(cur.eta[2], cur.eta[3])), R(0.25));
    V diag = cx_sub(RV::make(dre), st);
    if (last && !role0) diag = RV::make(R(1));
    const R m10 = -l0[1], m20 = -l0[2], m30 = -l0[3], m40 = -l0[4];
    const R m31 = -xzLym * ihym, m41 = xzRym * ihym;
    const R m32 = xzLyp * ihyp, m42 = -xzRyp * ihyp;
    const R zero = R(0);
    R mc[5];
    mc[0] = sel5(role, zero, m10, m20, m30, m40);
    mc[1] = sel5(role, m10, zero, zero, m31, m41);
    mc[2] = sel5(role, m20, zero, zero, m32, m42);
    mc[3] = sel5(role, m30, m31, m32, zero, zero);
    mc[4] = sel5(role, m40, m41, m42, zero, zero);
    V base[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const V off = RV::make(last ? zero : mc[i]);
      const V ri = team_get(rq, i);          // r_a[i], from the lane of row i
      base[i] = is_y ? ri : (i == role ? diag : off);
    }

    if (a > 0) {
      // The lane's column of [L_a^T | y_{a-1}]: row q of L_a, or y.
      V x[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const R bl = q == 0 ? l0[i] : (q == i ? ld[i] : zero);
        x[i] = is_y ? col[i] : RV::make(bl);
      }
      f.factor(C);
      f.solve(x);
      if (active && q < 6) {
#pragma unroll
        for (int i = 0; i < 5; ++i) scr[sidx(a - 1, i, q)] = x[i];
      }
      // base - L_a x: row 0 of L_a is l0, rows 1-4 are diagonal.
      V lx = cx_scale(x[1], l0[1]);
#pragma unroll
      for (int i = 2; i < 5; ++i) lx = axpy(lx, l0[i], x[i]);
      col[0] = cx_sub(base[0], lx);
#pragma unroll
      for (int i = 1; i < 5; ++i) col[i] = cx_sub(base[i], cx_scale(x[i], ld[i]));
    } else {
#pragma unroll
      for (int i = 0; i < 5; ++i) col[i] = base[i];
    }

    // Every lane gathers the lower triangle of C_a from the column lanes.
#pragma unroll
    for (int jj = 0; jj < 5; ++jj)
#pragma unroll
      for (int i = jj; i < 5; ++i) C[i][jj] = team_get(col[i], jj);

#pragma unroll
    for (int i = 0; i < 4; ++i) za[i] = cur.zb[i];
    ihxa = ihxb;
  }

  // z_{nx-1} = C_{nx-1}^{-1} y_{nx-1} in the y lanes; u_{nx-1} = z_{nx-1}.
  f.factor(C);
  f.solve(col);
  V u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) u[i] = team_get(col[i], 5);

  // Backward substitution, u_a = z_a - W_a u_{a+1}: lane i < 5 computes
  // and writes unknown i (ex at cell a; the others at node a + 1).
  V* const out = sel5<V*>(role, ex + ln.ox(0, iy, iz),
                          ey + ln.oy(1, iy - 1, iz), ey + ln.oy(1, iy, iz),
                          ez + ln.oz(1, iy, iz - 1), ez + ln.oz(1, iy, iz));
  const int64_t sout = role0 ? sx0 : role <= 2 ? sy0 : sz0;
  const bool writes = active && q < 5;
  if (writes && role0) out[(nx - 1) * sout] = u[0];
  V row[6];
  if (nx >= 2) {
#pragma unroll
    for (int c = 0; c < 6; ++c) row[c] = scr[sidx(nx - 2, role, c)];
  }
  for (int64_t a = nx - 2; a >= 0; --a) {
    V cur[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) cur[c] = row[c];
    if (a > 0) {
#pragma unroll
      for (int c = 0; c < 6; ++c) row[c] = scr[sidx(a - 1, role, c)];
    }
    V un = cur[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) un = cx_msub(un, cur[c], u[c]);
    if (writes) out[a * sout] = un;
#pragma unroll
    for (int i = 0; i < 5; ++i) u[i] = team_get(un, i);
  }
}

template <typename V, typename R>
int launch(void* ex, void* ey, void* ez, const void* sx, const void* sy,
           const void* sz, const void* eta_x, const void* eta_y,
           const void* eta_z, const void* zeta, const void* hx,
           const void* hy, const void* hz, void* scratch, const int64_t* geo,
           int py, int pz, int64_t ntask, const void* scale, void* stream) {
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
  ln.g.tx = geo[15];
  ln.g.ty = geo[16];
  ln.g.tz = geo[17];
  ln.g.teta = geo[18];
  ln.g.tscr = geo[19];
  const int64_t ncy = (ln.g.ny - py) / 2, ncz = (ln.g.nz - pz) / 2;
  const int64_t nlines = ncy * ncz;
  if (nlines > 0 && ntask > 0) {
    // Consecutive teams along the transverse axis of smaller stride; one
    // warp (4 lines) per block spreads the lines of a color over the SMs.
    const int y_fastest = ln.g.sc[1] < ln.g.sc[2];
    const int64_t blocks = (nlines * TEAM + WARP - 1) / WARP;
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>(ntask));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const V* sc = static_cast<const V*>(scale);
    if (sc != nullptr)
      line_phase_kernel<V, R, true><<<grid, WARP, 0, st>>>(
          ln, py, pz, ncy, ncz, y_fastest, sc);
    else
      line_phase_kernel<V, R, false><<<grid, WARP, 0, st>>>(
          ln, py, pz, ncy, ncz, y_fastest, sc);
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
                      int py, int pz, int64_t ntask, const void* scale,      \
                      void* stream) {                                        \
    return launch<V, R>(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,   \
                        hx, hy, hz, scratch, geo, py, pz, ntask, scale,      \
                        stream);                                             \
  }

LINE_PHASE_ENTRY(line_phase_c64, Cx<float>, float)
LINE_PHASE_ENTRY(line_phase_c128, Cx<double>, double)
LINE_PHASE_ENTRY(line_phase_f32, float, float)
LINE_PHASE_ENTRY(line_phase_f64, double, double)
