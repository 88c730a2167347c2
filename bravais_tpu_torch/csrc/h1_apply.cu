// Fused Bloch H1 stiffness and mass element apply, complex64.
//
// Replaces bravais_tpu/operators/pallas/h1_apply.py::helmholtz_block_apply
// (the Pallas TPU kernel). Per element and block row, from the gathered
// element dofs u ((l, ..., l), d = 2 or 3 axes) it computes
//
//   y = (grad + ik)^H alpha (grad + ik) u: the value uq and the reference
//       gradient g_r by sum-factorised contractions, w_r = (Jinv^T g)_r +
//       i k_r uq, f = alpha.w . w, then y = contract_t(-i k.f, B..B)
//       + sum_r contract_t((Jinv f)_r, tables with D on axis r);
//   m = contract_t(beta.w . uq, B..B).
//
// `want` selects y (bit 0), m (bit 1) or both. At k = 0 (the QPLaplace
// apply of the field engine's Chebyshev gradient projector) the ik terms
// vanish and their contractions are skipped. The Bloch phases of a
// quasi-periodic space live in the gather and scatter outside the kernel.
//
// Layout (element-major): element-row b = row * nelem + element reads its
// l^d complex values contiguously from u[b]; alpha.w, beta.w are
// (nelem, q^d) float32 with the quadrature weights folded in. The tables
// B, D, the metric Jinv^T, Jinv and a table of up to kMaxK k-points are
// kernel parameters: rows come in groups of rows_per_k, one k each (a
// k-batched solve), so element-row b uses k[(b / nelem) / rows_per_k].
// The ik contractions are skipped only when every k of the table is 0.
//
// What bounds it on an H100: at config-3 shapes (d = 3, p = 3: l = 4,
// q = 5) a 16-row k = 0 "A" call reads and writes 1.8 MB each (about 1 us
// at 3.35 TB/s) and does about 0.13 GFLOP of f32 (about 2 us at
// 67 TFLOP/s): each element-row is tiny (64 values in, 125 quadrature
// points), so the limit in practice is the latency of its dependent
// stages and the shared memory they pass through. The design:
//
// * One warp per (row, element), several element-rows per block, no block
//   barrier: the stages of an element-row run inside its warp, separated
//   by __syncwarp, with the intermediates in the warp's own shared slab.
// * A plan fixed at compile time. Forward, the gradients share stages:
//   stage 0 gives B.u and D.u once, stage 1 BB, BD and DB, the last stage
//   the value BBB and the gradients (DBB, BDB, BBD). Transposed, the terms
//   that share their remaining tables are summed before the next stage:
//   (h_0, h_1, h_2 + s) -> (B^T h_0, D^T h_1 + B^T (h_2 + ...)) -> y.
// * A lane owns a fiber (the values along the contracted axis) and emits
//   every output of it for one or two tables: the fiber is read from
//   shared memory once, the tables sit in registers.
// * Extents from a template on (d, l, q): the repository's shapes are
//   instantiated (div/mod by constants, loops unrolled); any other shape
//   runs the same template with runtime extents.
// * The element-row is staged with 16-byte loads (32 lanes, 512 B at
//   config 3).

#include <cuda_runtime.h>

#include "sumfact.cuh"

namespace {

using bt::fwd;
using bt::kMaxL;
using bt::kMaxQ;
using bt::trn;

constexpr int kMaxWarps = 4;
// k-points of one launch (768 bytes of kernel parameters, no copy to the
// device per launch); the wrapper splits a larger batch into launches.
constexpr int kMaxK = 64;

// KT: the k-table's length, 1 (one k: the parameters and code of a
// single-k apply) or kMaxK.
template <int KT>
struct H1Params {
  float B[kMaxQ * kMaxL], D[kMaxQ * kMaxL];  // (q, l) row-major, zero-padded
  float JinvT[9], Jinv[9];                   // row-major, leading d x d of 3 x 3
  float k[KT][3];                            // one k per group of rows_per_k rows
  int q, l, nelem, nblocks, want, kz, rows_per_k;
  int xsize, ysize;  // float2 slots of the warp's two buffers
};

// DIM = 2 or 3; LL, QQ the extents, or 0 for runtime extents.
template <int DIM, int LL, int QQ, int KT>
__global__ void __launch_bounds__(32 * kMaxWarps)
h1_apply_kernel(const float2* __restrict__ u, const float* __restrict__ aw,
                const float* __restrict__ bw, float2* __restrict__ y,
                float2* __restrict__ m, const H1Params<KT> P) {
  constexpr int LM = LL ? LL : kMaxL, QM = QQ ? QQ : kMaxQ;
  const int l = LL ? LL : P.l, q = QQ ? QQ : P.q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = blockIdx.x * (blockDim.x >> 5) + warp;
  if (blk >= P.nblocks) return;  // no block barrier below
  const int e = blk % P.nelem;

  float tB[QM * LM], tD[QM * LM];
#pragma unroll
  for (int i = 0; i < QM * LM; ++i) {
    tB[i] = P.B[i];
    tD[i] = P.D[i];
  }
  const bool wantA = P.want & 1, wantM = P.want & 2, kz = P.kz;
  const bool need_uq = wantM || (wantA && !kz);
  const int ld = DIM == 3 ? l * l * l : l * l;  // element-row values
  const int qd = DIM == 3 ? q * q * q : q * q;  // quadrature points

  extern __shared__ __align__(16) float2 smem[];
  float2* X = smem + (size_t)warp * (P.xsize + P.ysize);  // holds the quadrature planes
  float2* Y = X + P.xsize;
  // The forward chain ends in X: stage the element-row in X for even d,
  // in Y for odd d.
  float2* U = DIM % 2 ? Y : X;
  const float2* ub = u + (size_t)blk * ld;
  if (ld % 2 == 0 && (reinterpret_cast<size_t>(ub) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(ub);
    float4* d4 = reinterpret_cast<float4*>(U);
    for (int i = lane; i < ld / 2; i += 32) d4[i] = s4[i];
  } else {
    for (int i = lane; i < ld; i += 32) U[i] = ub[i];
  }
  __syncwarp();

  // Planes of X after the forward chain: g_0..g_{d-1} (A), then the S
  // plane (A, k != 0), then the M plane (M); uq sits in the first of the
  // last two that exists.
  const int pS = wantA ? DIM : 0;
  const int pM = pS + (wantA && !kz ? 1 : 0);
  const int pU = pS;
  float2* const g0 = X;

  if (DIM == 3) {
    const int l2 = l * l, sq = q * l * l, s1 = q * q * l;
    // Stage 0: B.u, D.u (q, l, l) into X.
    fwd<LM, QM>(U, 1, l2, l, q, tB, X, tD, wantA ? X + sq : nullptr, lane);
    __syncwarp();
    // Stage 1: BB, BD from B.u; DB from D.u (q, q, l) into Y.
    fwd<LM, QM>(X, q, l, l, q, tB, Y, tD, wantA ? Y + s1 : nullptr, lane);
    if (wantA) fwd<LM, QM>(X + sq, q, l, l, q, tB, Y + 2 * s1, tB, nullptr, lane);
    __syncwarp();
    // Stage 2: uq = BBB, g_2 = BBD, g_1 = BDB, g_0 = DBB (q, q, q) into X.
    if (need_uq)
      fwd<LM, QM>(Y, q * q, 1, l, q, tB, X + pU * qd, tD, wantA ? g0 + 2 * qd : nullptr,
                  lane);
    else
      fwd<LM, QM>(Y, q * q, 1, l, q, tD, g0 + 2 * qd, tB, nullptr, lane);
    if (wantA) {
      fwd<LM, QM>(Y + s1, q * q, 1, l, q, tB, g0 + qd, tB, nullptr, lane);
      fwd<LM, QM>(Y + 2 * s1, q * q, 1, l, q, tB, g0, tB, nullptr, lane);
    }
  } else {
    // Stage 0: B.u, D.u (q, l) into Y.
    fwd<LM, QM>(U, 1, l, l, q, tB, Y, tD, wantA ? Y + q * l : nullptr, lane);
    __syncwarp();
    // Stage 1: uq = BB, g_1 = BD from B.u; g_0 = DB from D.u (q, q) into X.
    if (need_uq)
      fwd<LM, QM>(Y, q, 1, l, q, tB, X + pU * qd, tD, wantA ? g0 + qd : nullptr, lane);
    else
      fwd<LM, QM>(Y, q, 1, l, q, tD, g0 + qd, tB, nullptr, lane);
    if (wantA) fwd<LM, QM>(Y + q * l, q, 1, l, q, tB, g0, tB, nullptr, lane);
  }
  __syncwarp();

  // Pointwise, in place: h_r = (Jinv f)_r into g_r, s = -i k.f into the S
  // plane, beta.w uq into the M plane; k of this element-row's group.
  const int ik = KT == 1 ? 0 : (blk / P.nelem) / P.rows_per_k;
  const float kv[3] = {P.k[ik][0], P.k[ik][1], P.k[ik][2]};
  for (int x = lane; x < qd; x += 32) {
    const float2 uq = need_uq ? X[pU * qd + x] : make_float2(0.0f, 0.0f);
    if (wantA) {
      const float a = aw[(size_t)e * qd + x];
      float2 gv[DIM], f[DIM];
#pragma unroll
      for (int s = 0; s < DIM; ++s) gv[s] = g0[s * qd + x];
      float sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int r = 0; r < DIM; ++r) {  // w_r = (Jinv^T g)_r + i k_r uq; f = a w
        float gr = 0.0f, gi = 0.0f;
#pragma unroll
        for (int s = 0; s < DIM; ++s) {
          gr = fmaf(P.JinvT[r * 3 + s], gv[s].x, gr);
          gi = fmaf(P.JinvT[r * 3 + s], gv[s].y, gi);
        }
        f[r] = make_float2(a * (gr - kv[r] * uq.y), a * (gi + kv[r] * uq.x));
        sr = fmaf(kv[r], f[r].y, sr);
        si = fmaf(-kv[r], f[r].x, si);
      }
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        float hr = 0.0f, hi = 0.0f;
#pragma unroll
        for (int s = 0; s < DIM; ++s) {
          hr = fmaf(P.Jinv[r * 3 + s], f[s].x, hr);
          hi = fmaf(P.Jinv[r * 3 + s], f[s].y, hi);
        }
        g0[r * qd + x] = make_float2(hr, hi);
      }
      if (!kz) X[pS * qd + x] = make_float2(sr, si);
    }
    if (wantM) {
      const float b = bw[(size_t)e * qd + x];
      X[pM * qd + x] = make_float2(b * uq.x, b * uq.y);
    }
  }
  __syncwarp();

  float2* yb = wantA ? y + (size_t)blk * ld : nullptr;
  float2* mb = wantM ? m + (size_t)blk * ld : nullptr;
  const float2* S = wantA && !kz ? X + pS * qd : nullptr;
  if (DIM == 3) {
    const int sa = q * q * l, sb = q * l * l;
    // T0, axis 2 (q, q, l) into Y: A0 = B^T h0, A1 = B^T h1,
    // A2 = D^T h2 + B^T s, Am = B^T hm.
    float2* Am = Y + (wantA ? 3 * sa : 0);
    if (wantA) {
      trn<LM, QM>(g0, tB, nullptr, tB, Y, q * q, 1, l, q, lane);
      trn<LM, QM>(g0 + qd, tB, nullptr, tB, Y + sa, q * q, 1, l, q, lane);
      trn<LM, QM>(g0 + 2 * qd, tD, S, tB, Y + 2 * sa, q * q, 1, l, q, lane);
    }
    if (wantM) trn<LM, QM>(X + pM * qd, tB, nullptr, tB, Am, q * q, 1, l, q, lane);
    __syncwarp();
    // T1, axis 1 (q, l, l) into X: YD = B^T A0, YB = D^T A1 + B^T A2,
    // Mm = B^T Am.
    if (wantA) {
      trn<LM, QM>(Y, tB, nullptr, tB, X, q, l, l, q, lane);
      trn<LM, QM>(Y + sa, tD, Y + 2 * sa, tB, X + sb, q, l, l, q, lane);
    }
    float2* Mm = X + (wantA ? 2 * sb : 0);
    if (wantM) trn<LM, QM>(Am, tB, nullptr, tB, Mm, q, l, l, q, lane);
    __syncwarp();
    // T2, axis 0 (l, l, l) to device memory: y = D^T YD + B^T YB, m = B^T Mm.
    if (wantA) trn<LM, QM>(X, tD, X + sb, tB, yb, 1, l * l, l, q, lane);
    if (wantM) trn<LM, QM>(Mm, tB, nullptr, tB, mb, 1, l * l, l, q, lane);
  } else {
    const int sa = q * l;
    // T0, axis 1 (q, l) into Y: A0 = B^T h0, A1 = D^T h1 + B^T s, Am = B^T hm.
    float2* Am = Y + (wantA ? 2 * sa : 0);
    if (wantA) {
      trn<LM, QM>(g0, tB, nullptr, tB, Y, q, 1, l, q, lane);
      trn<LM, QM>(g0 + qd, tD, S, tB, Y + sa, q, 1, l, q, lane);
    }
    if (wantM) trn<LM, QM>(X + pM * qd, tB, nullptr, tB, Am, q, 1, l, q, lane);
    __syncwarp();
    // T1, axis 0 (l, l) to device memory: y = D^T A0 + B^T A1, m = B^T Am.
    if (wantA) trn<LM, QM>(Y, tD, Y + sa, tB, yb, 1, l, l, q, lane);
    if (wantM) trn<LM, QM>(Am, tB, nullptr, tB, mb, 1, l, l, q, lane);
  }
}

// float2 slots of the warp's two buffers (X: the quadrature planes, and
// the stages that land in it; Y: the other stages), each rounded up to
// an even count so that both stay 16-byte aligned.
void buffer_sizes(int d, int l, int q, bool wantA, bool wantM, bool kz, int* xs,
                  int* ys) {
  int ld = 1, qd = 1;
  for (int i = 0; i < d; ++i) {
    ld *= l;
    qd *= q;
  }
  const int nA = wantA ? 1 : 0, nM = wantM ? 1 : 0;
  const int planes = nA * d + (wantA && !kz ? 1 : 0) + nM;
  int x = planes * qd, yv = 0;
  if (d == 3) {
    x = x > (1 + nA) * q * l * l ? x : (1 + nA) * q * l * l;       // stage 0, T1
    x = x > (2 * nA + nM) * q * l * l ? x : (2 * nA + nM) * q * l * l;
    yv = ld;                                                        // staged u
    yv = yv > (1 + 2 * nA) * q * q * l ? yv : (1 + 2 * nA) * q * q * l;  // stage 1
    yv = yv > (3 * nA + nM) * q * q * l ? yv : (3 * nA + nM) * q * q * l;  // T0
  } else {
    x = x > ld ? x : ld;                                            // staged u
    yv = (1 + nA) * q * l;                                          // stage 0
    yv = yv > (2 * nA + nM) * q * l ? yv : (2 * nA + nM) * q * l;    // T0
  }
  *xs = (x + 1) & ~1;
  *ys = (yv + 1) & ~1;
}

template <int DIM, int LL, int QQ, int KT>
cudaError_t launch(const float2* u, const float* aw, const float* bw, float2* y,
                   float2* m, const H1Params<KT>& P, int warps, cudaStream_t stream) {
  const size_t smem = (size_t)warps * (P.xsize + P.ysize) * sizeof(float2);
  const int grid = (P.nblocks + warps - 1) / warps;
  h1_apply_kernel<DIM, LL, QQ, KT><<<grid, 32 * warps, smem, stream>>>(u, aw, bw, y, m, P);
  return cudaGetLastError();
}

template <int KT>
int run(const void* u, const void* aw, const void* bw, void* y, void* m,
        const float* tabs, const float* metric, const float* ktab, int nk, int q,
        int l, int d, int nelem, int nblocks, int want, void* stream) {
  H1Params<KT> P = {};
  for (int i = 0; i < q * l; ++i) {
    P.B[i] = tabs[i];
    P.D[i] = tabs[q * l + i];
  }
  for (int i = 0; i < 9; ++i) {
    P.JinvT[i] = metric[i];
    P.Jinv[i] = metric[9 + i];
  }
  P.kz = 1;
  for (int j = 0; j < nk; ++j)
    for (int i = 0; i < 3; ++i) {
      P.k[j][i] = ktab[3 * j + i];
      P.kz = P.kz && P.k[j][i] == 0.0f;
    }
  P.q = q;
  P.l = l;
  P.nelem = nelem;
  P.nblocks = nblocks;
  P.want = want;
  P.rows_per_k = nblocks / nelem / nk;
  buffer_sizes(d, l, q, want & 1, want & 2, P.kz, &P.xsize, &P.ysize);
  // Element-rows per block: up to kMaxWarps within the 48 KB a block
  // gets without an opt-in.
  const int per_warp = (P.xsize + P.ysize) * (int)sizeof(float2);
  int warps = (48 * 1024) / per_warp;
  warps = warps > kMaxWarps ? kMaxWarps : warps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const float2* uu = (const float2*)u;
  const float *a = (const float*)aw, *b = (const float*)bw;
  float2 *yy = (float2*)y, *mm = (float2*)m;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  // The repository's shapes: config 3 and QPLaplace at p = 3 (3, 4, 5),
  // the FCC field engine and config 5 at p = 4 (3, 5, 6), the 2D rods at
  // p = 3 (2, 4, 5), the 2D scalar headline at p = 4 (2, 5, 6), the 2D
  // multigrid's p = 1 levels (2, 2, 3), the 3D field engine at p = 2
  // (3, 3, 4: the certification's CUB n = 4, FCC n = 3) and the 3D
  // multigrid's p = 1 levels (3, 2, 3).
  if (d == 3 && l == 4 && q == 5)
    err = launch<3, 4, 5, KT>(uu, a, b, yy, mm, P, warps, s);
  else if (d == 3 && l == 5 && q == 6)
    err = launch<3, 5, 6, KT>(uu, a, b, yy, mm, P, warps, s);
  else if (d == 2 && l == 4 && q == 5)
    err = launch<2, 4, 5, KT>(uu, a, b, yy, mm, P, warps, s);
  else if (d == 2 && l == 5 && q == 6)
    err = launch<2, 5, 6, KT>(uu, a, b, yy, mm, P, warps, s);
  else if (d == 2 && l == 2 && q == 3)
    err = launch<2, 2, 3, KT>(uu, a, b, yy, mm, P, warps, s);
  else if (d == 3 && l == 3 && q == 4)
    err = launch<3, 3, 4, KT>(uu, a, b, yy, mm, P, warps, s);
  else if (d == 3 && l == 2 && q == 3)
    err = launch<3, 2, 3, KT>(uu, a, b, yy, mm, P, warps, s);
  else if (d == 3)
    err = launch<3, 0, 0, KT>(uu, a, b, yy, mm, P, warps, s);
  else
    err = launch<2, 0, 0, KT>(uu, a, b, yy, mm, P, warps, s);
  return (int)err;
}

}  // namespace

// u, y, m: (nblocks, l^d) complex64; aw, bw: (nelem, q^d) float32 (alpha,
// beta times the quadrature weights); nblocks = nk * rows_per_k * nelem.
// tabs: host (2, q, l) float32 (B, D); metric: host JinvT (9), Jinv (9),
// the d x d blocks leading; ktab: host (nk, 3) float32, 1 <= nk <= kMaxK,
// the k of each group of rows_per_k rows (one k: the single-k kernel).
// want: 1 = y, 2 = m, 3 = both (y or m may be null when not wanted).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int h1_apply_launch(const void* u, const void* aw, const void* bw,
                               void* y, void* m, const float* tabs,
                               const float* metric, const float* ktab, int nk,
                               int q, int l, int d, int nelem, int nblocks,
                               int want, void* stream) {
  if (q < 1 || q > kMaxQ || l < 1 || l > kMaxL || d < 2 || d > 3 ||
      nelem < 1 || nblocks < 1 || nblocks % nelem != 0 || want < 1 ||
      want > 3 || ((want & 1) && y == nullptr) || ((want & 2) && m == nullptr) ||
      nk < 1 || nk > kMaxK || (nblocks / nelem) % nk != 0)
    return (int)cudaErrorInvalidValue;
  return nk == 1 ? run<1>(u, aw, bw, y, m, tabs, metric, ktab, nk, q, l, d, nelem,
                          nblocks, want, stream)
                 : run<kMaxK>(u, aw, bw, y, m, tabs, metric, ktab, nk, q, l, d,
                              nelem, nblocks, want, stream);
}
