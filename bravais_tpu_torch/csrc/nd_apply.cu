// Fused Nedelec curl-curl and eps-mass element apply, complex64.
//
// Replaces bravais_tpu/operators/pallas/nd_apply.py::nedelec_block_apply
// (the Pallas TPU kernel). Per element and block row, from the gathered
// element dofs u (3 components; component c has p values on its open
// axis c and l = p + 1 on the two closed axes) it computes
//
//   m = M_e u: 3 value contractions, then eps.w . Ginv mixing at the
//              quadrature points, then 3 transposed contractions;
//   y = A_e u: 6 derivative contractions d_s u_t form the reference curl,
//              then J/detJ . (mu^-1.w) . J^T/detJ mixing, then 6 transposed
//              derivative contractions.
//
// `want` selects A (bit 0), M (bit 1) or both; a call that needs one
// output skips the other half. The Bloch phases live in the gather and
// scatter outside the kernel (torch), so the kernel does not depend on k.
//
// Layout (element-major): block b = row * nelem + element reads its
// 3 p l^2 complex values contiguously (coalesced) from u[b] and writes
// y[b], m[b], component after component, each row-major over its own
// extents (p on axis c). The coefficient planes muw, epsw are
// (nelem, q^3) float32 with the quadrature weights folded in. The tables
// (Bc, Dc, Bo, Do; the open ones (q, p) padded to (q, l) by a zero
// column), J, Ginv and 1/detJ are scalar arguments: the grid is affine.
//
// What bounds it on an H100: at config-3 shapes (p = 3: l = 4, q = 5) a
// 16-row fused call reads 4.0 MB and writes 8.0 MB (about 3.6 us at
// 3.35 TB/s) and does about 0.30 GFLOP of f32 (9 forward and 9
// transposed contractions, about 1,030 complex-by-real multiply-adds
// each; about 4.5 us at 67 TFLOP/s without tensor cores), so both bounds
// are a few microseconds. The design keeps every intermediate in shared
// memory: one thread block per (row, element), u (padded there with a
// zero slot on each open axis so that every component is (l, l, l)) and
// the per-stage intermediates (about 24 KB at l = 4, q = 5) in shared
// memory, threads over the output index of each contraction stage, all
// contractions of a stage batched so that a stage costs one barrier.
// Forward stages stop before the open tables' zero column; transposed
// stages still compute the pad slot, which is never written out.

#include <cuda_runtime.h>

#include "contract_stage.cuh"

namespace {

using bt::kMaxJobs;
using bt::kMaxL;
using bt::kMaxQ;

constexpr int kThreads = 256;

struct NdParams {
  float tab[4 * kMaxQ * kMaxL];  // Bc, Dc, Bo, Do, each (q, l) row-major
  float J[9], Ginv[9];           // row-major 3 x 3
  float inv_det;
  int q, l, nelem, want;
};

__global__ void __launch_bounds__(kThreads)
nd_apply_kernel(const float2* __restrict__ u, const float* __restrict__ muw,
                const float* __restrict__ epsw, float2* __restrict__ y,
                float2* __restrict__ m, const NdParams P) {
  extern __shared__ float2 smem[];
  __shared__ float sT[4 * kMaxQ * kMaxL];
  __shared__ int fslot[kMaxJobs], ftab[3 * kMaxJobs];
  __shared__ int tslot[kMaxJobs], ttab[3 * kMaxJobs], ident[kMaxJobs];
  __shared__ int jval[3], jder[9], tout[kMaxJobs], tlen[4];
  __shared__ float tsgn[kMaxJobs];
  __shared__ int nfwd, ntr;

  const int q = P.q, l = P.l, p = l - 1, l3 = l * l * l, q3 = q * q * q;
  const int nc = p * l * l;           // values of one component
  const int mx = q > l ? q : l, ms = mx * mx * mx;
  const bool wantA = P.want & 1, wantM = P.want & 2;
  float2* sU = smem;                  // 3 l^3
  float2* R0 = sU + 3 * l3;           // kMaxJobs * ms
  float2* R1 = R0 + kMaxJobs * ms;    // kMaxJobs * ms
  float2* sP = R1 + kMaxJobs * ms;    // 6 q^3: g (mass), cf (curl)
  const size_t blk = blockIdx.x;
  const int e = (int)(blk % (size_t)P.nelem);

  // Padded index (c, i0, i1, i2) of sU <- compact index of u[blk]
  // (component c's extents are l with p on axis c); pad slots are zero.
  for (int i = threadIdx.x; i < 3 * l3; i += blockDim.x) {
    const int c = i / l3, a = i - c * l3;
    const int i0 = a / (l * l), i1 = (a / l) % l, i2 = a % l;
    float2 v = make_float2(0.0f, 0.0f);
    if ((c == 0 ? i0 : c == 1 ? i1 : i2) < p) {
      const int e1 = c == 1 ? p : l, e2 = c == 2 ? p : l;
      v = u[blk * 3 * nc + c * nc + (i0 * e1 + i1) * e2 + i2];
    }
    sU[i] = v;
  }
  for (int i = threadIdx.x; i < 4 * q * l; i += blockDim.x) sT[i] = P.tab[i];
  if (threadIdx.x == 0) {
    for (int t = 0; t < 4; ++t) tlen[t] = t < 2 ? l : p;
    // Table id on axis i for component c and derivative axis s (-1: value):
    // open (i == c) picks Bo/Do, derivative (i == s) picks D.
    int j = 0;
    if (wantM)
      for (int c = 0; c < 3; ++c, ++j) {
        jval[c] = j;
        fslot[j] = c;
        for (int i = 0; i < 3; ++i) ftab[i * kMaxJobs + j] = i == c ? 2 : 0;
      }
    if (wantA)
      for (int t = 0; t < 3; ++t)
        for (int s = 0; s < 3; ++s) {
          if (s == t) continue;
          jder[s * 3 + t] = j;  // d_s u_t
          fslot[j] = t;
          for (int i = 0; i < 3; ++i)
            ftab[i * kMaxJobs + j] = (i == t ? 2 : 0) + (i == s ? 1 : 0);
          ++j;
        }
    nfwd = j;
    // Transposed jobs read sP: slots 0..2 the mass terms g_c, 3..5 the
    // curl terms cf_r. y_c = sum_{s != c} sign * contract_t(cf_r, der(c, s))
    // with r the third index, + when (r, s, c) is cyclic.
    j = 0;
    if (wantM)
      for (int c = 0; c < 3; ++c, ++j) {
        tslot[j] = c;
        tout[j] = c;
        tsgn[j] = 1.0f;
        for (int i = 0; i < 3; ++i) ttab[i * kMaxJobs + j] = i == c ? 2 : 0;
      }
    if (wantA)
      for (int c = 0; c < 3; ++c)
        for (int s = 0; s < 3; ++s) {
          if (s == c) continue;
          const int r = 3 - s - c;
          tslot[j] = 3 + r;
          tout[j] = 3 + c;
          tsgn[j] = (r + 1) % 3 == s ? 1.0f : -1.0f;
          for (int i = 0; i < 3; ++i)
            ttab[i * kMaxJobs + j] = (i == c ? 2 : 0) + (i == s ? 1 : 0);
          ++j;
        }
    ntr = j;
    for (int i = 0; i < kMaxJobs; ++i) ident[i] = i;
  }
  __syncthreads();

  const float2* F = bt::contract_all(sU, l3, fslot, ident, R0, R1, ms, sT,
                                     ftab, tlen, nfwd, 3, q, l, false);

  for (int x = threadIdx.x; x < q3; x += blockDim.x) {
    if (wantM) {
      float2 uh[3];
      for (int s = 0; s < 3; ++s) uh[s] = F[jval[s] * ms + x];
      const float w = epsw[(size_t)e * q3 + x];
      for (int r = 0; r < 3; ++r) {
        float gr = 0.0f, gi = 0.0f;
        for (int s = 0; s < 3; ++s) {
          gr = fmaf(P.Ginv[r * 3 + s], uh[s].x, gr);
          gi = fmaf(P.Ginv[r * 3 + s], uh[s].y, gi);
        }
        sP[r * q3 + x] = make_float2(w * gr, w * gi);
      }
    }
    if (wantA) {
      float2 ch[3], f[3];
      for (int r = 0; r < 3; ++r) {  // chat_r = d_s u_t - d_t u_s, (r, s, t) cyclic
        const int s = (r + 1) % 3, t = (r + 2) % 3;
        const float2 a = F[jder[s * 3 + t] * ms + x];
        const float2 b = F[jder[t * 3 + s] * ms + x];
        ch[r] = make_float2(a.x - b.x, a.y - b.y);
      }
      const float w = muw[(size_t)e * q3 + x] * P.inv_det;
      for (int r = 0; r < 3; ++r) {  // f = mu^-1 w J chat / detJ
        float fr = 0.0f, fi = 0.0f;
        for (int s = 0; s < 3; ++s) {
          fr = fmaf(P.J[r * 3 + s], ch[s].x, fr);
          fi = fmaf(P.J[r * 3 + s], ch[s].y, fi);
        }
        f[r] = make_float2(w * fr, w * fi);
      }
      for (int r = 0; r < 3; ++r) {  // cf = J^T f / detJ
        float cr = 0.0f, ci = 0.0f;
        for (int s = 0; s < 3; ++s) {
          cr = fmaf(P.J[s * 3 + r], f[s].x, cr);
          ci = fmaf(P.J[s * 3 + r], f[s].y, ci);
        }
        sP[(3 + r) * q3 + x] = make_float2(cr * P.inv_det, ci * P.inv_det);
      }
    }
  }
  __syncthreads();

  const float2* T = bt::contract_all(sP, q3, tslot, ident, R0, R1, ms, sT,
                                     ttab, nullptr, ntr, 3, q, l, true);

  // Compact output index i -> padded index a of the transposed results.
  for (int i = threadIdx.x; i < 3 * nc; i += blockDim.x) {
    const int c = i / nc, r = i - c * nc;
    const int e1 = c == 1 ? p : l, e2 = c == 2 ? p : l;
    const int i2 = r % e2, i1 = (r / e2) % e1, i0 = r / (e1 * e2);
    const int a = (i0 * l + i1) * l + i2;
    float2 yv = make_float2(0.0f, 0.0f), mv = make_float2(0.0f, 0.0f);
    for (int j = 0; j < ntr; ++j) {
      const float2 v = T[j * ms + a];
      if (tout[j] == c) {
        mv = v;
      } else if (tout[j] == 3 + c) {
        yv.x = fmaf(tsgn[j], v.x, yv.x);
        yv.y = fmaf(tsgn[j], v.y, yv.y);
      }
    }
    if (wantA) y[blk * 3 * nc + i] = yv;
    if (wantM) m[blk * 3 * nc + i] = mv;
  }
}

}  // namespace

// u, y, m: (nblocks, 3 p l^2) complex64, p = l - 1; muw, epsw:
// (nelem, q^3) float32; nblocks = rows * nelem. tabs: host (4, q, l)
// float32 (the open tables with their zero last column);
// metric: host J (9), Ginv (9), 1/detJ. want: 1 = A, 2 = M, 3 = both
// (y or m may be null when not wanted). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int nd_apply_launch(const void* u, const void* muw, const void* epsw,
                               void* y, void* m, const float* tabs,
                               const float* metric, int q, int l, int nelem,
                               int nblocks, int want, void* stream) {
  if (q < 1 || q > kMaxQ || l < 2 || l > kMaxL || nelem < 1 || nblocks < 1 ||
      nblocks % nelem != 0 || want < 1 || want > 3 ||
      ((want & 1) && y == nullptr) || ((want & 2) && m == nullptr))
    return (int)cudaErrorInvalidValue;
  NdParams P;
  for (int i = 0; i < 4 * q * l; ++i) P.tab[i] = tabs[i];
  for (int i = 0; i < 9; ++i) {
    P.J[i] = metric[i];
    P.Ginv[i] = metric[9 + i];
  }
  P.inv_det = metric[18];
  P.q = q;
  P.l = l;
  P.nelem = nelem;
  P.want = want;
  const int mx = q > l ? q : l;
  const size_t smem =
      (3 * (size_t)l * l * l + 2 * (size_t)kMaxJobs * mx * mx * mx +
       6 * (size_t)q * q * q) * sizeof(float2);
  // Dynamic plus static shared memory must stay under the 48 KB a block
  // gets without an opt-in (static: tables and job lists, under 1 KB).
  if (smem > 47 * 1024) return (int)cudaErrorInvalidValue;
  nd_apply_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)u, (const float*)muw, (const float*)epsw, (float2*)y,
      (float2*)m, P);
  return (int)cudaGetLastError();
}
