// One phase of the 8-color point Gauss-Seidel smoother, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of emg3d_tpu/ops/pallas_gs.py, which
// compute the same function:
//   - gauss_seidel_phase_pallas        (whole phase, VMEM-resident operands;
//                                       coarse and mid levels), and
//   - gauss_seidel_phase_pallas_tiled  (the same phase, (x, y)-tiled with
//                                       double-buffered HBM->VMEM DMA; fine
//                                       levels that do not fit VMEM).
// No on-chip memory limit splits the work on this card, so one kernel
// serves every level size.
//
// What it computes: for every interior node (ix, iy, iz) of the parity
// class (ix-1, iy-1, iz-1) = (px, py, pz) mod 2, assemble the
// complex-symmetric (NOT Hermitian: nothing is conjugated) 6x6 system of
// the node's six edges (reference emg3d core.py:392-492), solve it by
// unpivoted Gaussian elimination in registers, and write the six edges
// back.  The off-diagonal couplings are real (averaged zeta times inverse
// widths); only the diagonal carries the complex -eta/4 term.
//
// In place is safe: a phase never reads an edge that it writes (the
// 8-color decoupling; docs/pallas-smoother.md:40-41), and each node's six
// edges belong to that node alone within its color.
//
// What bounds it on this card: memory traffic.  Per node it reads about
// 19 operand streams (24 neighbour edges, 6 source edges, 24 eta and 8
// zeta cells, most shared with neighbouring nodes) for a few hundred
// flops, far below the H100's flop:byte balance.  This first version is
// one thread per phase node, with the node index linearised z fastest so
// that neighbouring threads read neighbouring addresses, and it relies on
// L1/L2 for the stencil reuse between nodes.  A shared-memory/TMA tiled
// form (the Hopper counterpart of the tiled Pallas kernel) is later work.
//
// Complex tensors are read in place, interleaved (re, im), through
// torch.view_as_real(...).data_ptr(): no split/merge copies.  Shapes are
// run-time arguments (no per-shape build).  The kernel launches on the
// caller's stream, does not synchronise and allocates nothing; each C
// entry point returns cudaGetLastError().
//
// A task index (the batch engine, emg3d_tpu/parallel/batch.py:99-103,
// which vmaps this phase over a leading task axis): blockIdx.y is the
// task.  Fields and sources are (ntask, ...) C-contiguous, so a task's
// component starts one component size after the last one's.  eta is
// either stacked (task stride = cells) or shared (task stride 0), and a
// shared eta may carry one scale per task that multiplies every eta value
// on load (the counterpart of solver._scaled: task k's eta is scale[k]
// times the shared one, so B copies of eta never exist).  zeta and the
// widths are shared.  One task, stride 0 and no scale is the unbatched
// kernel: the unscaled instantiation does the same arithmetic.

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

template <typename V, typename R> struct Real;
template <typename R> struct Real<R, R> {
  __device__ static R make(R s) { return s; }
};
template <typename R> struct Real<Cx<R>, R> {
  __device__ static Cx<R> make(R s) { return {s, R(0)}; }
};

template <typename V, typename R, bool SCALED>
__global__ void __launch_bounds__(256)
gs_phase_kernel(V* __restrict__ ex, V* __restrict__ ey, V* __restrict__ ez,
                const V* __restrict__ sx, const V* __restrict__ sy,
                const V* __restrict__ sz, const V* __restrict__ eta_x,
                const V* __restrict__ eta_y, const V* __restrict__ eta_z,
                const R* __restrict__ zeta, const R* __restrict__ hx,
                const R* __restrict__ hy, const R* __restrict__ hz,
                int64_t nx, int64_t ny, int64_t nz, int px, int py, int pz,
                int64_t ncx, int64_t ncy, int64_t ncz, int64_t eta_tstride,
                const V* __restrict__ scale) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= ncx * ncy * ncz) return;
  // This block's task: move every per-task pointer to its slice.
  const int64_t task = blockIdx.y;
  const int64_t nex = nx * (ny + 1) * (nz + 1);
  const int64_t ney = (nx + 1) * ny * (nz + 1);
  const int64_t nez = (nx + 1) * (ny + 1) * nz;
  ex += task * nex;
  sx += task * nex;
  ey += task * ney;
  sy += task * ney;
  ez += task * nez;
  sz += task * nez;
  eta_x += task * eta_tstride;
  eta_y += task * eta_tstride;
  eta_z += task * eta_tstride;
  V sc;
  if constexpr (SCALED) sc = scale[task];
  // An eta value of this task (scaled on load where eta is shared).
  auto ld = [&](const V* eta, int64_t o) {
    if constexpr (SCALED) return cx_mul(sc, eta[o]);
    else return eta[o];
  };
  const int64_t k = t % ncz;
  const int64_t j = (t / ncz) % ncy;
  const int64_t i = t / (ncz * ncy);
  // The node and its minus/plus cells along each axis.
  const int64_t ix = 1 + px + 2 * i, iy = 1 + py + 2 * j, iz = 1 + pz + 2 * k;

  // Offsets.  ex: (nx, ny+1, nz+1); ey: (nx+1, ny, nz+1);
  // ez: (nx+1, ny+1, nz); cells: (nx, ny, nz); all C-contiguous.
  auto oex = [=](int64_t a, int64_t b, int64_t c) {
    return (a * (ny + 1) + b) * (nz + 1) + c;
  };
  auto oey = [=](int64_t a, int64_t b, int64_t c) {
    return (a * ny + b) * (nz + 1) + c;
  };
  auto oez = [=](int64_t a, int64_t b, int64_t c) {
    return (a * (ny + 1) + b) * nz + c;
  };
  auto oc = [=](int64_t a, int64_t b, int64_t c) {
    return (a * ny + b) * nz + c;
  };

  // Gathers in the plain version's convention: a cell offset o in {0, 1}
  // is cell (i - 1 + o); a node offset d in {-1, 0, 1} is node (i + d).
  auto gex = [&](const V* f, int o, int dy, int dz) {
    return f[oex(ix - 1 + o, iy + dy, iz + dz)];
  };
  auto gey = [&](const V* f, int dx, int o, int dz) {
    return f[oey(ix + dx, iy - 1 + o, iz + dz)];
  };
  auto gez = [&](const V* f, int dx, int dy, int o) {
    return f[oez(ix + dx, iy + dy, iz - 1 + o)];
  };

  // Width coefficients: k = 0.5 / h, ih = 1 / h, at the minus (a/m) and
  // plus (b/p) cells.
  const R hxa = hx[ix - 1], hxb = hx[ix];
  const R hym = hy[iy - 1], hyp = hy[iy];
  const R hzm = hz[iz - 1], hzp = hz[iz];
  const R kxa = R(0.5) / hxa, kxb = R(0.5) / hxb;
  const R kym = R(0.5) / hym, kyp = R(0.5) / hyp;
  const R kzm = R(0.5) / hzm, kzp = R(0.5) / hzp;
  const R ihxa = R(1) / hxa, ihxb = R(1) / hxb;
  const R ihym = R(1) / hym, ihyp = R(1) / hyp;
  const R ihzm = R(1) / hzm, ihzp = R(1) / hzp;

  // zeta at the 8 cells around the node: z{x: a|b}{y: m|p}{z: m|p}.
  const R zamm = zeta[oc(ix - 1, iy - 1, iz - 1)];
  const R zamp = zeta[oc(ix - 1, iy - 1, iz)];
  const R zapm = zeta[oc(ix - 1, iy, iz - 1)];
  const R zapp = zeta[oc(ix - 1, iy, iz)];
  const R zbmm = zeta[oc(ix, iy - 1, iz - 1)];
  const R zbmp = zeta[oc(ix, iy - 1, iz)];
  const R zbpm = zeta[oc(ix, iy, iz - 1)];
  const R zbpp = zeta[oc(ix, iy, iz)];

  // The 24 averaged-zeta coefficients (reference core.py:350-374).
  const R zyLxm = kym * (zamp + zamm), zyRxm = kyp * (zapp + zapm);
  const R yzLxm = kzm * (zapm + zamm), yzRxm = kzp * (zapp + zamp);
  const R zyLxp = kym * (zbmp + zbmm), zyRxp = kyp * (zbpp + zbpm);
  const R yzLxp = kzm * (zbpm + zbmm), yzRxp = kzp * (zbpp + zbmp);
  const R zxLym = kxa * (zamp + zamm), zxRym = kxb * (zbmp + zbmm);
  const R xzLym = kzm * (zbmm + zamm), xzRym = kzp * (zbmp + zamp);
  const R zxLyp = kxa * (zapp + zapm), zxRyp = kxb * (zbpp + zbpm);
  const R xzLyp = kzm * (zbpm + zapm), xzRyp = kzp * (zbpp + zapp);
  const R yxLzm = kxa * (zapm + zamm), yxRzm = kxb * (zbpm + zbmm);
  const R xyLzm = kym * (zbmm + zamm), xyRzm = kyp * (zbpm + zapm);
  const R yxLzp = kxa * (zapp + zamp), yxRzp = kxb * (zbpp + zbmp);
  const R xyLzp = kym * (zbmp + zamp), xyRzp = kyp * (zbpp + zapp);

  // Diagonal eta sums / 4 over the 4 cells around each edge.
  auto st4 = [&](const V* eta, int64_t a0, int64_t a1, int64_t b0,
                 int64_t b1, int64_t c0, int64_t c1) {
    V s = cx_add(cx_add(ld(eta, oc(a0, b0, c0)), ld(eta, oc(a0, b0, c1))),
                 cx_add(ld(eta, oc(a1, b1, c0)), ld(eta, oc(a1, b1, c1))));
    return cx_scale(s, R(0.25));
  };
  // eta_x at x-cell xa|xb, summed over y in {iy-1, iy}, z in {iz-1, iz}.
  const V st0 = st4(eta_x, ix - 1, ix - 1, iy - 1, iy, iz - 1, iz);
  const V st1 = st4(eta_x, ix, ix, iy - 1, iy, iz - 1, iz);
  // eta_y at y-cell ym|yp, summed over x and z.
  const V st2 = st4(eta_y, ix - 1, ix, iy - 1, iy - 1, iz - 1, iz);
  const V st3 = st4(eta_y, ix - 1, ix, iy, iy, iz - 1, iz);
  // eta_z at z-cell zm|zp, summed over x and y.
  const V st4_ = cx_scale(
      cx_add(cx_add(ld(eta_z, oc(ix - 1, iy - 1, iz - 1)), ld(eta_z, oc(ix - 1, iy, iz - 1))),
             cx_add(ld(eta_z, oc(ix, iy - 1, iz - 1)), ld(eta_z, oc(ix, iy, iz - 1)))),
      R(0.25));
  const V st5 = cx_scale(
      cx_add(cx_add(ld(eta_z, oc(ix - 1, iy - 1, iz)), ld(eta_z, oc(ix - 1, iy, iz))),
             cx_add(ld(eta_z, oc(ix, iy - 1, iz)), ld(eta_z, oc(ix, iy, iz)))),
      R(0.25));

  using RV = Real<V, R>;
  // The symmetric 6x6 matrix; unknowns [ex-, ex+, ey-, ey+, ez-, ez+].
  V A[6][6];
  A[0][0] = cx_sub(RV::make(zyRxm * ihyp + zyLxm * ihym + yzRxm * ihzp + yzLxm * ihzm), st0);
  A[1][1] = cx_sub(RV::make(zyRxp * ihyp + zyLxp * ihym + yzRxp * ihzp + yzLxp * ihzm), st1);
  A[2][2] = cx_sub(RV::make(zxRym * ihxb + zxLym * ihxa + xzRym * ihzp + xzLym * ihzm), st2);
  A[3][3] = cx_sub(RV::make(zxRyp * ihxb + zxLyp * ihxa + xzRyp * ihzp + xzLyp * ihzm), st3);
  A[4][4] = cx_sub(RV::make(yxRzm * ihxb + yxLzm * ihxa + xyRzm * ihyp + xyLzm * ihym), st4_);
  A[5][5] = cx_sub(RV::make(yxRzp * ihxb + yxLzp * ihxa + xyRzp * ihyp + xyLzp * ihym), st5);
  A[1][0] = A[0][1] = RV::make(R(0));
  A[2][0] = A[0][2] = RV::make(-zyLxm * ihxa);
  A[3][0] = A[0][3] = RV::make(zyRxm * ihxa);
  A[4][0] = A[0][4] = RV::make(-yzLxm * ihxa);
  A[5][0] = A[0][5] = RV::make(yzRxm * ihxa);
  A[2][1] = A[1][2] = RV::make(zyLxp * ihxb);
  A[3][1] = A[1][3] = RV::make(-zyRxp * ihxb);
  A[4][1] = A[1][4] = RV::make(yzLxp * ihxb);
  A[5][1] = A[1][5] = RV::make(-yzRxp * ihxb);
  A[3][2] = A[2][3] = RV::make(R(0));
  A[4][2] = A[2][4] = RV::make(-xzLym * ihym);
  A[5][2] = A[2][5] = RV::make(xzRym * ihym);
  A[4][3] = A[3][4] = RV::make(xzLyp * ihyp);
  A[5][3] = A[3][5] = RV::make(-xzRyp * ihyp);
  A[5][4] = A[4][5] = RV::make(R(0));

  // rhs = source + couplings to the 24 neighbouring edges
  // (reference core.py:432-492): real coefficients times field values.
  auto lin2 = [&](R c, V a, R ca, V b, R cb) {
    return cx_scale(cx_add(cx_scale(a, ca), cx_scale(b, cb)), c);
  };
  V b[6];
  b[0] = cx_add(cx_add(cx_add(cx_add(gex(sx, 0, 0, 0),
      lin2(zyRxm, gey(ey, -1, 1, 0), ihxa, gex(ex, 0, 1, 0), ihyp)),
      lin2(zyLxm, gey(ey, -1, 0, 0), -ihxa, gex(ex, 0, -1, 0), ihym)),
      lin2(yzRxm, gez(ez, -1, 0, 1), ihxa, gex(ex, 0, 0, 1), ihzp)),
      lin2(yzLxm, gez(ez, -1, 0, 0), -ihxa, gex(ex, 0, 0, -1), ihzm));
  b[1] = cx_add(cx_add(cx_add(cx_add(gex(sx, 1, 0, 0),
      lin2(zyRxp, gey(ey, 1, 1, 0), -ihxb, gex(ex, 1, 1, 0), ihyp)),
      lin2(zyLxp, gey(ey, 1, 0, 0), ihxb, gex(ex, 1, -1, 0), ihym)),
      lin2(yzRxp, gez(ez, 1, 0, 1), -ihxb, gex(ex, 1, 0, 1), ihzp)),
      lin2(yzLxp, gez(ez, 1, 0, 0), ihxb, gex(ex, 1, 0, -1), ihzm));
  b[2] = cx_add(cx_add(cx_add(cx_add(gey(sy, 0, 0, 0),
      lin2(zxRym, gey(ey, 1, 0, 0), ihxb, gex(ex, 1, -1, 0), ihym)),
      lin2(zxLym, gey(ey, -1, 0, 0), ihxa, gex(ex, 0, -1, 0), -ihym)),
      lin2(xzRym, gez(ez, 0, -1, 1), ihym, gey(ey, 0, 0, 1), ihzp)),
      lin2(xzLym, gez(ez, 0, -1, 0), -ihym, gey(ey, 0, 0, -1), ihzm));
  b[3] = cx_add(cx_add(cx_add(cx_add(gey(sy, 0, 1, 0),
      lin2(zxRyp, gey(ey, 1, 1, 0), ihxb, gex(ex, 1, 1, 0), -ihyp)),
      lin2(zxLyp, gey(ey, -1, 1, 0), ihxa, gex(ex, 0, 1, 0), ihyp)),
      lin2(xzRyp, gez(ez, 0, 1, 1), -ihyp, gey(ey, 0, 1, 1), ihzp)),
      lin2(xzLyp, gez(ez, 0, 1, 0), ihyp, gey(ey, 0, 1, -1), ihzm));
  b[4] = cx_add(cx_add(cx_add(cx_add(gez(sz, 0, 0, 0),
      lin2(yxRzm, gez(ez, 1, 0, 0), ihxb, gex(ex, 1, 0, -1), ihzm)),
      lin2(yxLzm, gez(ez, -1, 0, 0), ihxa, gex(ex, 0, 0, -1), -ihzm)),
      lin2(xyRzm, gez(ez, 0, 1, 0), ihyp, gey(ey, 0, 1, -1), ihzm)),
      lin2(xyLzm, gez(ez, 0, -1, 0), ihym, gey(ey, 0, 0, -1), -ihzm));
  b[5] = cx_add(cx_add(cx_add(cx_add(gez(sz, 0, 0, 1),
      lin2(yxRzp, gez(ez, 1, 0, 1), ihxb, gex(ex, 1, 0, 1), -ihzp)),
      lin2(yxLzp, gez(ez, -1, 0, 1), ihxa, gex(ex, 0, 0, 1), ihzp)),
      lin2(xyRzp, gez(ez, 0, 1, 1), ihyp, gey(ey, 0, 1, 1), -ihzp)),
      lin2(xyLzp, gez(ez, 0, -1, 1), ihym, gey(ey, 0, 0, 1), ihzp));

  // Unpivoted Gaussian elimination, fully unrolled into registers.
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const V inv = cx_recip(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const V f = cx_mul(A[r][c], inv);
#pragma unroll
      for (int q = c + 1; q < 6; ++q) A[r][q] = cx_sub(A[r][q], cx_mul(f, A[c][q]));
      b[r] = cx_sub(b[r], cx_mul(f, b[c]));
    }
  }
  V x[6];
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    V acc = b[r];
#pragma unroll
    for (int q = r + 1; q < 6; ++q) acc = cx_sub(acc, cx_mul(A[r][q], x[q]));
    x[r] = cx_mul(acc, cx_recip(A[r][r]));
  }

  ex[oex(ix - 1, iy, iz)] = x[0];
  ex[oex(ix, iy, iz)] = x[1];
  ey[oey(ix, iy - 1, iz)] = x[2];
  ey[oey(ix, iy, iz)] = x[3];
  ez[oez(ix, iy, iz - 1)] = x[4];
  ez[oez(ix, iy, iz)] = x[5];
}

template <typename V, typename R>
int launch(void* ex, void* ey, void* ez, const void* sx, const void* sy,
           const void* sz, const void* eta_x, const void* eta_y,
           const void* eta_z, const void* zeta, const void* hx,
           const void* hy, const void* hz, int64_t nx, int64_t ny,
           int64_t nz, int px, int py, int pz, int64_t ntask,
           int64_t eta_tstride, const void* scale, void* stream) {
  const int64_t ncx = (nx - 1 - px + 1) / 2;  // len(range(px, nx-1, 2))
  const int64_t ncy = (ny - 1 - py + 1) / 2;
  const int64_t ncz = (nz - 1 - pz + 1) / 2;
  const int64_t total = ncx * ncy * ncz;
  if (total > 0 && ntask > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>(ntask));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GS_PHASE_ARGS                                                        \
  static_cast<V*>(ex), static_cast<V*>(ey), static_cast<V*>(ez),             \
      static_cast<const V*>(sx), static_cast<const V*>(sy),                  \
      static_cast<const V*>(sz), static_cast<const V*>(eta_x),               \
      static_cast<const V*>(eta_y), static_cast<const V*>(eta_z),            \
      static_cast<const R*>(zeta), static_cast<const R*>(hx),                \
      static_cast<const R*>(hy), static_cast<const R*>(hz), nx, ny, nz, px,  \
      py, pz, ncx, ncy, ncz, eta_tstride, static_cast<const V*>(scale)
    if (scale != nullptr)
      gs_phase_kernel<V, R, true><<<grid, threads, 0, st>>>(GS_PHASE_ARGS);
    else
      gs_phase_kernel<V, R, false><<<grid, threads, 0, st>>>(GS_PHASE_ARGS);
#undef GS_PHASE_ARGS
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GS_PHASE_ENTRY(NAME, V, R)                                           \
  extern "C" int NAME(void* ex, void* ey, void* ez, const void* sx,          \
                      const void* sy, const void* sz, const void* eta_x,     \
                      const void* eta_y, const void* eta_z,                  \
                      const void* zeta, const void* hx, const void* hy,      \
                      const void* hz, int64_t nx, int64_t ny, int64_t nz,    \
                      int px, int py, int pz, int64_t ntask,                 \
                      int64_t eta_tstride, const void* scale,                \
                      void* stream) {                                        \
    return launch<V, R>(ex, ey, ez, sx, sy, sz, eta_x, eta_y, eta_z, zeta,   \
                        hx, hy, hz, nx, ny, nz, px, py, pz, ntask,           \
                        eta_tstride, scale, stream);                         \
  }

GS_PHASE_ENTRY(gs_phase_c64, Cx<float>, float)
GS_PHASE_ENTRY(gs_phase_c128, Cx<double>, double)
GS_PHASE_ENTRY(gs_phase_f32, float, float)
GS_PHASE_ENTRY(gs_phase_f64, double, double)
