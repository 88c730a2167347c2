// Sum-factorised contractions along one axis, run by one warp, for the
// element kernels (h1_apply.cu, nd_apply.cu).
//
// A lane owns a fiber (the values along the contracted axis), reads it
// from shared memory once and emits every output of it for one or two
// tables, which the caller keeps in registers (with compile-time extents
// their indices are constants). Complex values are float2, tables real
// (q, l) row-major, so each multiply-add is two FMAs. The caller
// separates dependent stages with __syncwarp.

#pragma once

#include <cuda_runtime.h>

namespace bt {

constexpr int kMaxQ = 6;  // quadrature points per axis
constexpr int kMaxL = 5;  // local dofs per axis (p + 1)

// Forward along one axis, one source, one or two tables:
//   oa[a][n][b] = sum_o Ta[n][o] in[a][o][b]  (in: (pre, l, post), out: (pre, q, post)).
template <int LM, int QM>
__device__ __forceinline__ void fwd(const float2* in, int pre, int post, int l, int q,
                                    const float (&Ta)[QM * LM], float2* oa,
                                    const float (&Tb)[QM * LM], float2* ob, int lane) {
  for (int f = lane; f < pre * post; f += 32) {
    const int a = f / post, b = f - a * post;
    const float2* x = in + a * l * post + b;
    float2 v[LM];
#pragma unroll
    for (int o = 0; o < LM; ++o)
      if (o < l) v[o] = x[o * post];
#pragma unroll
    for (int n = 0; n < QM; ++n) {
      if (n >= q) break;
      float ar = 0.0f, ai = 0.0f, br = 0.0f, bi = 0.0f;
#pragma unroll
      for (int o = 0; o < LM; ++o) {
        if (o >= l) break;
        ar = fmaf(Ta[n * l + o], v[o].x, ar);
        ai = fmaf(Ta[n * l + o], v[o].y, ai);
        if (ob) {
          br = fmaf(Tb[n * l + o], v[o].x, br);
          bi = fmaf(Tb[n * l + o], v[o].y, bi);
        }
      }
      const int out = (a * q + n) * post + b;
      oa[out] = make_float2(ar, ai);
      if (ob) ob[out] = make_float2(br, bi);
    }
  }
}

// Transposed along one axis, one or two (source, table) terms summed:
//   out[a][n][b] = sum_o Ta[o][n] ia[a][o][b] + sum_o Tb[o][n] ib[a][o][b]
//   (in: (pre, q, post), out: (pre, l, post)).
template <int LM, int QM>
__device__ __forceinline__ void trn(const float2* ia, const float (&Ta)[QM * LM],
                                    const float2* ib, const float (&Tb)[QM * LM],
                                    float2* out, int pre, int post, int l, int q,
                                    int lane) {
  for (int f = lane; f < pre * post; f += 32) {
    const int a = f / post, b = f - a * post;
    const int at = a * q * post + b;
    float2 va[QM], vb[QM];
#pragma unroll
    for (int o = 0; o < QM; ++o)
      if (o < q) {
        va[o] = ia[at + o * post];
        if (ib) vb[o] = ib[at + o * post];
      }
#pragma unroll
    for (int n = 0; n < LM; ++n) {
      if (n >= l) break;
      float r = 0.0f, i = 0.0f;
#pragma unroll
      for (int o = 0; o < QM; ++o) {
        if (o >= q) break;
        r = fmaf(Ta[o * l + n], va[o].x, r);
        i = fmaf(Ta[o * l + n], va[o].y, i);
        if (ib) {
          r = fmaf(Tb[o * l + n], vb[o].x, r);
          i = fmaf(Tb[o * l + n], vb[o].y, i);
        }
      }
      out[(a * l + n) * post + b] = make_float2(r, i);
    }
  }
}

}  // namespace bt
