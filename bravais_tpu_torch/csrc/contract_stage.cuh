// Sum-factorised tensor-product contractions inside one thread block,
// for the Nedelec element-apply kernel (nd_apply.cu).
//
// A contraction maps one element's local values (l, ..., l) (d axes) to
// its quadrature values (q, ..., q) with a 1D table T (q x l) per axis,
// one axis per stage: stage i turns (q^i, l, l^(d-1-i)) into
// (q^(i+1), l^(d-1-i)). The transposed contraction maps (q, ..., q) back
// to (l, ..., l) with T^T. Complex values are float2 and tables are real,
// so each multiply-add is two FMAs.
//
// Every stage runs a batch of "jobs" (independent contractions of one
// element that share the stage's shape), all threads of the block over
// the flat (job, output) index, then the block synchronises.
//
// A table may end in zero columns (the Nedelec open axis: p values padded
// to l): `len`, when given, holds each table id's number of leading
// columns that are not padding, and a forward stage stops there.

#pragma once

#include <cuda_runtime.h>

namespace bt {

constexpr int kMaxQ = 6;     // quadrature points per axis
constexpr int kMaxL = 5;     // local dofs per axis (p + 1)
constexpr int kMaxJobs = 9;  // contractions in one batch

// One stage for a batch of `njobs` jobs:
//   forward   (nold = l, nnew = q): out_j[a][n][b] = sum_o T_j[n][o] in_j[a][o][b]
//   transpose (nold = q, nnew = l): out_j[a][n][b] = sum_o T_j[o][n] in_j[a][o][b]
// Job j reads in + slot[j] * in_stride, writes out + j * out_stride and
// uses the table tabs + tab[j] * q * l ((q, l) row-major).
__device__ __forceinline__ void contract_stage(
    const float2* in, int in_stride, const int* slot, float2* out,
    int out_stride, const float* tabs, const int* tab, const int* len,
    int njobs, int pre, int nold, int nnew, int post, int q, int l,
    bool transpose) {
  const int per = pre * nnew * post;
  for (int idx = threadIdx.x; idx < njobs * per; idx += blockDim.x) {
    const int j = idx / per, r = idx - j * per;
    const int a = r / (nnew * post), rem = r - a * (nnew * post);
    const int n = rem / post, b = rem - n * post;
    const float2* x = in + slot[j] * in_stride + a * nold * post + b;
    const float* T = tabs + tab[j] * q * l;
    const int nsum = transpose || len == nullptr ? nold : len[tab[j]];
    float re = 0.0f, im = 0.0f;
    for (int o = 0; o < nsum; ++o) {
      const float t = transpose ? T[o * l + n] : T[n * l + o];
      const float2 v = x[o * post];
      re = fmaf(t, v.x, re);
      im = fmaf(t, v.y, im);
    }
    out[j * out_stride + r] = make_float2(re, im);
  }
}

// All d stages of a batch (tab holds kMaxJobs table ids per axis; len as
// in contract_stage, or nullptr). Stage 0 reads `in` through `slot`;
// later stages read the previous stage's output through `ident`. Outputs
// alternate between buf0 and buf1 (stride ms per job); returns the buffer
// with the result.
__device__ __forceinline__ float2* contract_all(
    const float2* in, int in_stride, const int* slot, const int* ident,
    float2* buf0, float2* buf1, int ms, const float* tabs, const int* tab,
    const int* len, int njobs, int d, int q, int l, bool transpose) {
  const int nold = transpose ? q : l, nnew = transpose ? l : q;
  int post = 1;
  for (int i = 1; i < d; ++i) post *= nold;
  const float2* src = in;
  const int* sslot = slot;
  int sstride = in_stride, pre = 1;
  float2* dst = buf0;
  for (int i = 0; i < d; ++i) {
    contract_stage(src, sstride, sslot, dst, ms, tabs, tab + i * kMaxJobs,
                   len, njobs, pre, nold, nnew, post, q, l, transpose);
    __syncthreads();
    src = dst;
    sstride = ms;
    sslot = ident;
    dst = dst == buf0 ? buf1 : buf0;
    pre *= nnew;
    post /= nold;
  }
  return const_cast<float2*>(src);
}

}  // namespace bt
