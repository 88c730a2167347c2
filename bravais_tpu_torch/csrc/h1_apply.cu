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
// Layout (element-major): block b = row * nelem + element reads its l^d
// complex values contiguously from u[b]; alpha.w, beta.w are
// (nelem, q^d) float32 with the quadrature weights folded in. The tables
// B, D, the metric Jinv^T, Jinv and k are scalar arguments.
//
// What bounds it on an H100: at config-3 shapes (d = 3, p = 3: l = 4,
// q = 5) a 16-row k = 0 call reads 1.8 MB and writes 1.8 MB (about 1 us at
// 3.35 TB/s) and does about 0.12 GFLOP of f32 (6 contractions of 1,220
// multiply-adds on complex values; about 1.8 us at 67 TFLOP/s), a few
// microseconds either way. As in nd_apply.cu: one thread block per
// (row, element), every intermediate in shared memory, the contractions
// of a stage batched behind one barrier.

#include <cuda_runtime.h>

#include "contract_stage.cuh"

namespace {

using bt::kMaxJobs;
using bt::kMaxL;
using bt::kMaxQ;

constexpr int kThreads = 128;

struct H1Params {
  float tab[2 * kMaxQ * kMaxL];  // B, D, each (q, l) row-major
  float JinvT[9], Jinv[9];       // row-major, leading d x d of a 3 x 3
  float k[3];
  int q, l, d, nelem, want;
};

__global__ void __launch_bounds__(kThreads)
h1_apply_kernel(const float2* __restrict__ u, const float* __restrict__ aw,
                const float* __restrict__ bw, float2* __restrict__ y,
                float2* __restrict__ m, const H1Params P) {
  extern __shared__ float2 smem[];
  __shared__ float sT[2 * kMaxQ * kMaxL];
  __shared__ int fslot[kMaxJobs], ftab[3 * kMaxJobs];
  __shared__ int tslot[kMaxJobs], ttab[3 * kMaxJobs], ident[kMaxJobs];
  __shared__ int tout[kMaxJobs];
  __shared__ int nfwd, ntr;

  const int q = P.q, l = P.l, d = P.d;
  int ld = 1, qd = 1, ms = 1;
  const int mx = q > l ? q : l;
  for (int i = 0; i < d; ++i) {
    ld *= l;
    qd *= q;
    ms *= mx;
  }
  const bool wantA = P.want & 1, wantM = P.want & 2;
  const bool kz = P.k[0] == 0.0f && P.k[1] == 0.0f && P.k[2] == 0.0f;
  const bool need_uq = wantM || (wantA && !kz);
  float2* sU = smem;                  // l^d
  float2* R0 = sU + ld;               // kMaxJobs * ms
  float2* R1 = R0 + kMaxJobs * ms;    // kMaxJobs * ms
  float2* sP = R1 + kMaxJobs * ms;    // (d + 2) q^d: Jinv f, s, beta.w uq
  const size_t blk = blockIdx.x;
  const int e = (int)(blk % (size_t)P.nelem);

  for (int i = threadIdx.x; i < ld; i += blockDim.x) sU[i] = u[blk * ld + i];
  for (int i = threadIdx.x; i < 2 * q * l; i += blockDim.x) sT[i] = P.tab[i];
  if (threadIdx.x == 0) {
    // Forward jobs: the value (job 0 when needed), then d gradients.
    int j = 0;
    if (need_uq) {
      fslot[j] = 0;
      for (int i = 0; i < 3; ++i) ftab[i * kMaxJobs + j] = 0;
      ++j;
    }
    if (wantA)
      for (int r = 0; r < d; ++r, ++j) {
        fslot[j] = 0;
        for (int i = 0; i < 3; ++i) ftab[i * kMaxJobs + j] = i == r ? 1 : 0;
      }
    nfwd = j;
    // Transposed jobs read sP: slot r < d the term (Jinv f)_r with D on
    // axis r, slot d the ik term s, slot d + 1 the mass term; tout 0 = y,
    // 1 = m.
    j = 0;
    if (wantA) {
      for (int r = 0; r < d; ++r, ++j) {
        tslot[j] = r;
        tout[j] = 0;
        for (int i = 0; i < 3; ++i) ttab[i * kMaxJobs + j] = i == r ? 1 : 0;
      }
      if (!kz) {
        tslot[j] = d;
        tout[j] = 0;
        for (int i = 0; i < 3; ++i) ttab[i * kMaxJobs + j] = 0;
        ++j;
      }
    }
    if (wantM) {
      tslot[j] = d + 1;
      tout[j] = 1;
      for (int i = 0; i < 3; ++i) ttab[i * kMaxJobs + j] = 0;
      ++j;
    }
    ntr = j;
    for (int i = 0; i < kMaxJobs; ++i) ident[i] = i;
  }
  __syncthreads();

  const float2* F = bt::contract_all(sU, 0, fslot, ident, R0, R1, ms, sT,
                                     ftab, nullptr, nfwd, d, q, l,
                                     false);
  const int g0 = need_uq ? 1 : 0;  // first gradient job

  for (int x = threadIdx.x; x < qd; x += blockDim.x) {
    const float2 uq = need_uq ? F[x] : make_float2(0.0f, 0.0f);
    if (wantA) {
      const float a = aw[(size_t)e * qd + x];
      float2 f[3];
      float sr = 0.0f, si = 0.0f;
      for (int r = 0; r < d; ++r) {  // w_r = (Jinv^T g)_r + i k_r uq; f = a w
        float gr = 0.0f, gi = 0.0f;
        for (int s = 0; s < d; ++s) {
          const float2 g = F[(g0 + s) * ms + x];
          gr = fmaf(P.JinvT[r * 3 + s], g.x, gr);
          gi = fmaf(P.JinvT[r * 3 + s], g.y, gi);
        }
        f[r] = make_float2(a * (gr - P.k[r] * uq.y), a * (gi + P.k[r] * uq.x));
        sr = fmaf(P.k[r], f[r].y, sr);  // s = -i k.f
        si = fmaf(-P.k[r], f[r].x, si);
      }
      for (int r = 0; r < d; ++r) {
        float hr = 0.0f, hi = 0.0f;
        for (int s = 0; s < d; ++s) {
          hr = fmaf(P.Jinv[r * 3 + s], f[s].x, hr);
          hi = fmaf(P.Jinv[r * 3 + s], f[s].y, hi);
        }
        sP[r * qd + x] = make_float2(hr, hi);
      }
      sP[d * qd + x] = make_float2(sr, si);
    }
    if (wantM) {
      const float b = bw[(size_t)e * qd + x];
      sP[(d + 1) * qd + x] = make_float2(b * uq.x, b * uq.y);
    }
  }
  __syncthreads();

  const float2* T = bt::contract_all(sP, qd, tslot, ident, R0, R1, ms, sT,
                                     ttab, nullptr, ntr, d, q, l,
                                     true);

  for (int i = threadIdx.x; i < ld; i += blockDim.x) {
    float2 yv = make_float2(0.0f, 0.0f), mv = make_float2(0.0f, 0.0f);
    for (int j = 0; j < ntr; ++j) {
      const float2 v = T[j * ms + i];
      if (tout[j] == 1) {
        mv = v;
      } else {
        yv.x += v.x;
        yv.y += v.y;
      }
    }
    if (wantA) y[blk * ld + i] = yv;
    if (wantM) m[blk * ld + i] = mv;
  }
}

}  // namespace

// u, y, m: (nblocks, l^d) complex64; aw, bw: (nelem, q^d) float32 (alpha,
// beta times the quadrature weights); nblocks = rows * nelem. tabs: host
// (2, q, l) float32 (B, D); metric: host JinvT (9), Jinv (9), k (3), the
// d x d blocks leading. want: 1 = y, 2 = m, 3 = both (y or m may be null
// when not wanted). Returns the cudaError_t of the launch (0 on success).
extern "C" int h1_apply_launch(const void* u, const void* aw, const void* bw,
                               void* y, void* m, const float* tabs,
                               const float* metric, int q, int l, int d,
                               int nelem, int nblocks, int want, void* stream) {
  if (q < 1 || q > kMaxQ || l < 1 || l > kMaxL || d < 1 || d > 3 ||
      nelem < 1 || nblocks < 1 || nblocks % nelem != 0 || want < 1 ||
      want > 3 || ((want & 1) && y == nullptr) || ((want & 2) && m == nullptr))
    return (int)cudaErrorInvalidValue;
  H1Params P;
  for (int i = 0; i < 2 * q * l; ++i) P.tab[i] = tabs[i];
  for (int i = 0; i < 9; ++i) {
    P.JinvT[i] = metric[i];
    P.Jinv[i] = metric[9 + i];
  }
  for (int i = 0; i < 3; ++i) P.k[i] = metric[18 + i];
  P.q = q;
  P.l = l;
  P.d = d;
  P.nelem = nelem;
  P.want = want;
  size_t ld = 1, qd = 1, ms = 1;
  const int mx = q > l ? q : l;
  for (int i = 0; i < d; ++i) {
    ld *= l;
    qd *= q;
    ms *= mx;
  }
  const size_t smem = (ld + 2 * kMaxJobs * ms + (d + 2) * qd) * sizeof(float2);
  // Dynamic plus static shared memory must stay under the 48 KB a block
  // gets without an opt-in (static: tables and job lists, under 1 KB).
  if (smem > 47 * 1024) return (int)cudaErrorInvalidValue;
  h1_apply_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)u, (const float*)aw, (const float*)bw, (float2*)y,
      (float2*)m, P);
  return (int)cudaGetLastError();
}
