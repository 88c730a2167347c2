// Fused Nedelec curl-curl and eps-mass element apply, complex64.
//
// Replaces bravais_tpu/operators/pallas/nd_apply.py::nedelec_block_apply
// (the Pallas TPU kernel). Per element and block row, from the gathered
// element dofs u (3 components; component c has p values on its open
// axis c and l = p + 1 on the two closed axes) it computes
//
//   m = M_e u: per component the value (Bo on its open axis, Bc on the
//              closed ones), eps.w . Ginv mixing at the quadrature points,
//              the transposed contractions;
//   y = A_e u: per component the two derivatives d_s u_t (Dc on axis s),
//              the curl, mu^-1.w . J^T J / detJ^2 mixing, per output
//              component two transposed derivative terms.
//
// `want` selects A (bit 0), M (bit 1) or both; a call that needs one
// output skips the other half. The Bloch phases live in the gather and
// scatter outside the kernel (torch), so the kernel does not depend on k.
//
// Layout (element-major): element-row b = row * nelem + element reads its
// 3 p l^2 complex values contiguously from u[b] and writes y[b], m[b],
// component after component, each row-major over its own extents (p on
// axis c). The coefficient planes muw, epsw are (nelem, q^3) float32 with
// the quadrature weights folded in. The tables Bc, Dc (q, l) and Bo
// (q, p), and the metric are kernel parameters: the grid is affine.
//
// What bounds it on an H100: at config-3 shapes (p = 3: l = 4, q = 5) a
// 16-row fused call reads 4.0 MB and writes 8.0 MB (about 3.6 us at
// 3.35 TB/s) and does about 0.26 GFLOP of f32 (about 3.9 us at
// 67 TFLOP/s), so both bounds are a few microseconds. Each element-row
// is small (144 values in, 9 planes of 125 quadrature points) and its
// stages depend on one another, so what limits it in practice is the
// latency of that chain and the shared memory its stages pass through.
// No tensor cores: TF32 keeps about three digits and would break the
// 2e-5 agreement with the plain version, and the f32 FMA bound is far
// below the kernel's time anyway. The design:
//
// * Three warps per element-row, one per component: the forward and the
//   transposed contractions of the components are independent, and only
//   the pointwise mixing couples them, between two named barriers over
//   those 96 threads (bar.sync id, 96). No block-wide barrier follows the
//   staging of the coefficients.
// * A plan fixed at compile time (no setup code in the kernel). Forward,
//   component t contracts its two closed axes r1 < r2 first and its open
//   axis last: B.u and D.u (r1), then BB, BD and DB (r2), then the value
//   and both derivatives (t, p -> q, the three sources in one pass).
//   Transposed, component c contracts its open axis first (q -> p: only
//   p outputs), then a2, then a1 (its closed axes, a1 < a2): the two curl
//   terms of y_c, +-(Bc^T_a1 Dc^T_a2 Bo^T_c cf_a1 - Dc^T_a1 Bc^T_a2 Bo^T_c
//   cf_a2), are summed in their last stage. The open axis sits where its
//   short extent p saves the most (last forward, first transposed).
// * A lane owns a fiber of a stage (csrc/sumfact.cuh, shared with h1);
//   the tables sit in registers, extents come from a template on (l, q)
//   (the repository's shapes are instantiated; any other runs the same
//   template with runtime extents) and on `want`.
// * One block holds up to kMaxRows rows of one element: it stages that
//   element's coefficient planes in shared memory once. A warp stages its
//   component of the element-row with 16-byte loads. Four rows a block
//   (56 registers a thread, 14.4 KB of shared memory an element-row at
//   config 3: 12 element-rows an SM) ran faster on the H100 than two
//   rows, and than one or two under a register cap that lets an SM hold
//   more rows (ptxas then spills).
// * A warp's region holds its forward planes, then in place the mixed
//   planes (cf_t, g_t), then its second transposed stage; its scratch
//   the staged dofs, the second forward and the first transposed stage.
// * What is left: a stage has 12-25 fibers a component for 32 lanes, so
//   lanes idle; the mixing runs 125 points on 96 threads.

#include <cuda_runtime.h>

#include "sumfact.cuh"

namespace {

using bt::fwd;
using bt::kMaxL;
using bt::kMaxQ;
using bt::trn;

constexpr int kMaxRows = 4;  // element-rows per block
constexpr int kRowThreads = 96;

struct NdParams {
  float Bc[kMaxQ * kMaxL], Dc[kMaxQ * kMaxL];  // (q, l) row-major
  float Bo[kMaxQ * kMaxL];                     // (q, p) row-major
  float K[9];                                  // J^T J / detJ^2
  float Ginv[9];
  int q, l, nelem, rows, rpb;
  int rsize, ssize;  // float2 slots of a warp's region and scratch
};

// The closed axes of component T, ascending.
template <int T>
struct Closed {
  static constexpr int a = T == 0 ? 1 : 0, b = T == 2 ? 1 : 2;
};

// pre and post of axis `ax` for extents e (products of the extents before
// and after it).
__device__ __forceinline__ void split(const int (&e)[3], int ax, int& pre, int& post) {
  pre = ax == 0 ? 1 : ax == 1 ? e[0] : e[0] * e[1];
  post = ax == 0 ? e[1] * e[2] : ax == 1 ? e[2] : 1;
}

// The named barrier of an element-row's 96 threads. The ids are
// immediates so that ptxas reserves only the barriers a block uses (with
// a register id it reserves all 16, and an SM then holds 4 blocks).
template <int ID>
__device__ __forceinline__ void bar_row() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(kRowThreads) : "memory");
}
__device__ __forceinline__ void bar_row(int slot) {
  static_assert(kMaxRows <= 4, "one case per element-row of a block");
  switch (slot) {
    case 0: bar_row<1>(); break;
    case 1: bar_row<2>(); break;
    case 2: bar_row<3>(); break;
    default: bar_row<4>();
  }
}

template <int LM, int QM>
struct Tabs {
  float Bc[QM * LM], Dc[QM * LM], Bo[QM * LM], nBc[QM * LM], nDc[QM * LM];
};

// Component T's forward chain: u_T (global) -> its planes in R, in the
// order [value (M)][d_r2 u_T, d_r1 u_T (A)].
template <int T, int LM, int QM, bool A, bool M>
__device__ __forceinline__ void forward(const float2* ub, float2* R, float2* S, int l, int q,
                                        const Tabs<LM, QM>& tb, int lane) {
  constexpr int r1 = Closed<T>::a, r2 = Closed<T>::b;
  const int p = l - 1, nc = p * l * l;
  if ((reinterpret_cast<size_t>(ub) & 15) == 0) {  // nc is even
    const float4* s4 = reinterpret_cast<const float4*>(ub);
    float4* d4 = reinterpret_cast<float4*>(S);
    for (int i = lane; i < nc / 2; i += 32) d4[i] = s4[i];
  } else {
    for (int i = lane; i < nc; i += 32) S[i] = ub[i];
  }
  __syncwarp();
  int e[3] = {l, l, l};
  e[T] = p;
  int pre, post;
  // Axis r1 into R: B.u, D.u (A).
  split(e, r1, pre, post);
  const int s1 = q * l * p;
  fwd<LM, QM>(S, pre, post, l, q, tb.Bc, R, tb.Dc, A ? R + s1 : nullptr, lane);
  __syncwarp();
  // Axis r2 into S: [BB (M)][BD, DB (A)].
  e[r1] = q;
  split(e, r2, pre, post);
  const int s2 = q * q * p;
  float2* BD = S + (M ? s2 : 0);
  if (M)
    fwd<LM, QM>(R, pre, post, l, q, tb.Bc, S, tb.Dc, A ? BD : nullptr, lane);
  else
    fwd<LM, QM>(R, pre, post, l, q, tb.Dc, BD, tb.Dc, nullptr, lane);
  if (A) fwd<LM, QM>(R + s1, pre, post, l, q, tb.Bc, BD + s2, tb.Bc, nullptr, lane);
  __syncwarp();
  // Open axis T (p -> q) into R, the sources stacked as an outer axis.
  e[r2] = q;
  split(e, T, pre, post);
  fwd<LM, QM>(S, (M + 2 * A) * pre, post, p, q, tb.Bo, R, tb.Bo, nullptr, lane);
}

// The slot of d_s u_t among component t's derivative planes: 0 for s =
// r2(t), 1 for s = r1(t) (the order of the forward chain's last stage).
__device__ __forceinline__ constexpr int dslot(int t, int s) {
  return s == (t == 2 ? 1 : 2) ? 0 : 1;
}

// At each quadrature point x of the element-row (96 threads): g_r = eps.w
// (Ginv uh)_r and cf = mu^-1.w K chat, chat_r = d_s u_t - d_t u_s ((r, s,
// t) cyclic), in place: region t becomes [cf_t (A)][g_t (M)].
template <bool A, bool M>
__device__ __forceinline__ void mix(float2* const (&R)[3], const float* cmu, const float* ceps,
                                    const float (&K)[9], const float (&Gi)[9], int q3,
                                    int tid) {
  for (int x = tid; x < q3; x += kRowThreads) {
    float2 g[3], cf[3];
    if (M) {
      float2 uh[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) uh[s] = R[s][x];
      const float w = ceps[x];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float gr = 0.0f, gi = 0.0f;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          gr = fmaf(Gi[r * 3 + s], uh[s].x, gr);
          gi = fmaf(Gi[r * 3 + s], uh[s].y, gi);
        }
        g[r] = make_float2(w * gr, w * gi);
      }
    }
    if (A) {
      float2 ch[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int s = (r + 1) % 3, t = (r + 2) % 3;
        const float2 a = R[t][(M + dslot(t, s)) * q3 + x];  // d_s u_t
        const float2 b = R[s][(M + dslot(s, t)) * q3 + x];  // d_t u_s
        ch[r] = make_float2(a.x - b.x, a.y - b.y);
      }
      const float w = cmu[x];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float cr = 0.0f, ci = 0.0f;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          cr = fmaf(K[r * 3 + s], ch[s].x, cr);
          ci = fmaf(K[r * 3 + s], ch[s].y, ci);
        }
        cf[r] = make_float2(w * cr, w * ci);
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (A) R[r][x] = cf[r];
      if (M) R[r][(A ? q3 : 0) + x] = g[r];
    }
  }
}

// Component C's transposed chain: the mixed planes -> y_C, m_C (global).
template <int C, int LM, int QM, bool A, bool M>
__device__ __forceinline__ void transposed(float2* const (&R)[3], float2* S, float2* yb,
                                           float2* mb, int l, int q, const Tabs<LM, QM>& tb,
                                           int lane) {
  constexpr int a1 = Closed<C>::a, a2 = Closed<C>::b;
  const int p = l - 1, q3 = q * q * q;
  int e[3] = {q, q, q};
  int pre, post;
  // Open axis C (q -> p) into S: [Bo^T cf_a2, Bo^T cf_a1 (A)][Bo^T g_C (M)].
  split(e, C, pre, post);
  const int s1 = q * q * p;
  if (A) {
    trn<LM, QM>(R[a2], tb.Bo, nullptr, tb.Bo, S, pre, post, p, q, lane);
    trn<LM, QM>(R[a1], tb.Bo, nullptr, tb.Bo, S + s1, pre, post, p, q, lane);
  }
  if (M) trn<LM, QM>(R[C] + (A ? q3 : 0), tb.Bo, nullptr, tb.Bo, S + 2 * A * s1, pre, post, p, q, lane);
  __syncwarp();
  // Axis a2 into region C after its cf plane (other warps read only that
  // plane; g_C is consumed): [Y1 = Bc^T .., Y2 = Dc^T .. (A)][Ym (M)].
  e[C] = p;
  split(e, a2, pre, post);
  const int s2 = q * l * p;
  float2* Y = R[C] + (A ? q3 : 0);
  if (A) {
    trn<LM, QM>(S, tb.Bc, nullptr, tb.Bc, Y, pre, post, l, q, lane);
    trn<LM, QM>(S + s1, tb.Dc, nullptr, tb.Dc, Y + s2, pre, post, l, q, lane);
  }
  if (M) trn<LM, QM>(S + 2 * A * s1, tb.Bc, nullptr, tb.Bc, Y + 2 * A * s2, pre, post, l, q, lane);
  __syncwarp();
  // Axis a1 to device memory: y_C = sign (Bc^T Y2 - Dc^T Y1), sign = -1
  // for C = 1; m_C = Bc^T Ym.
  e[a2] = l;
  split(e, a1, pre, post);
  if (A) {
    if (C == 1)
      trn<LM, QM>(Y + s2, tb.nBc, Y, tb.Dc, yb, pre, post, l, q, lane);
    else
      trn<LM, QM>(Y + s2, tb.Bc, Y, tb.nDc, yb, pre, post, l, q, lane);
  }
  if (M) trn<LM, QM>(Y + 2 * A * s2, tb.Bc, nullptr, tb.Bc, mb, pre, post, l, q, lane);
}

// LL, QQ the extents, or 0 for runtime extents; WANT: 1 = A, 2 = M, 3 = both.
template <int LL, int QQ, int WANT>
__global__ void __launch_bounds__(kRowThreads * kMaxRows)
nd_apply_kernel(const float2* __restrict__ u, const float* __restrict__ muw,
                const float* __restrict__ epsw, float2* __restrict__ y,
                float2* __restrict__ m, const NdParams P) {
  constexpr bool A = WANT & 1, M = WANT & 2;
  constexpr int LM = LL ? LL : kMaxL, QM = QQ ? QQ : kMaxQ;
  const int l = LL ? LL : P.l, q = QQ ? QQ : P.q, p = l - 1;
  const int q3 = q * q * q, nc = p * l * l;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / 3, comp = warp - 3 * slot;
  const int e = blockIdx.x % P.nelem;
  const int row = blockIdx.x / P.nelem * P.rpb + slot;

  // The element's coefficient planes, once per block: [mu^-1.w (A)][eps.w (M)].
  extern __shared__ __align__(16) float2 smem[];
  float* cmu = reinterpret_cast<float*>(smem);
  float* ceps = cmu + (A ? q3 : 0);
  for (int i = threadIdx.x; i < q3; i += blockDim.x) {
    if (A) cmu[i] = muw[(size_t)e * q3 + i];
    if (M) ceps[i] = epsw[(size_t)e * q3 + i];
  }
  __syncthreads();  // the only block-wide barrier
  if (row >= P.rows) return;  // the element-row's three warps leave together

  Tabs<LM, QM> tb;
#pragma unroll
  for (int i = 0; i < QM * LM; ++i) {
    tb.Bc[i] = P.Bc[i];
    tb.Dc[i] = P.Dc[i];
    tb.Bo[i] = P.Bo[i];
    tb.nBc[i] = -P.Bc[i];
    tb.nDc[i] = -P.Dc[i];
  }
  const int per = P.rsize + P.ssize;
  const int ncoef = ((A + M) * q3 + 3) & ~3;  // floats, 16-byte multiple
  float2* base = smem + ncoef / 2 + (size_t)slot * 3 * per;
  float2* const R[3] = {base, base + per, base + 2 * per};
  float2* S = R[comp] + P.rsize;
  const size_t b = (size_t)row * P.nelem + e;
  const size_t off = b * 3 * nc + (size_t)comp * nc;

  if (comp == 0)
    forward<0, LM, QM, A, M>(u + off, R[0], S, l, q, tb, lane);
  else if (comp == 1)
    forward<1, LM, QM, A, M>(u + off, R[1], S, l, q, tb, lane);
  else
    forward<2, LM, QM, A, M>(u + off, R[2], S, l, q, tb, lane);
  bar_row(slot);

  float K[9], Gi[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    K[i] = P.K[i];
    Gi[i] = P.Ginv[i];
  }
  mix<A, M>(R, cmu, ceps, K, Gi, q3, threadIdx.x - kRowThreads * slot);
  bar_row(slot);

  float2* yb = A ? y + off : nullptr;
  float2* mb = M ? m + off : nullptr;
  if (comp == 0)
    transposed<0, LM, QM, A, M>(R, S, yb, mb, l, q, tb, lane);
  else if (comp == 1)
    transposed<1, LM, QM, A, M>(R, S, yb, mb, l, q, tb, lane);
  else
    transposed<2, LM, QM, A, M>(R, S, yb, mb, l, q, tb, lane);
}

using Kernel = void (*)(const float2*, const float*, const float*, float2*, float2*,
                        const NdParams);

template <int LL, int QQ>
Kernel pick_want(int want) {
  return want == 1 ? nd_apply_kernel<LL, QQ, 1>
                   : want == 2 ? nd_apply_kernel<LL, QQ, 2> : nd_apply_kernel<LL, QQ, 3>;
}

// The repository's shapes: config 3 (p = 3: l = 4, q = 5), the FCC field
// path of config 4 (p = 4: l = 5, q = 6) and the tests' p = 2 (l = 3,
// q = 4); any other shape runs with runtime extents.
constexpr int kShapes = 4;  // the three instantiations and the runtime one
int shape_id(int l, int q) {
  return l == 4 && q == 5 ? 0 : l == 5 && q == 6 ? 1 : l == 3 && q == 4 ? 2 : 3;
}

Kernel pick(int l, int q, int want) {
  switch (shape_id(l, q)) {
    case 0: return pick_want<4, 5>(want);
    case 1: return pick_want<5, 6>(want);
    case 2: return pick_want<3, 4>(want);
    default: return pick_want<0, 0>(want);
  }
}

struct Config {
  Kernel fn;
  int rpb, rsize, ssize, threads, grid;
  size_t smem;
};

constexpr size_t kMaxSmem = 227 * 1024;

// The launch of `rows` rows of nelem elements; returns 0 or a cudaError_t.
// Regions and scratch are rounded to an even count of float2 so that
// every warp's buffers stay 16-byte aligned.
int configure(int q, int l, int want, int nelem, int rows, Config* c) {
  const int p = l - 1, q3 = q * q * q, nA = want & 1, nM = (want >> 1) & 1;
  int r = (nM + 2 * nA) * q3;                          // forward planes
  r = r > (1 + nA) * q * l * p ? r : (1 + nA) * q * l * p;  // axis r1
  const int t2 = nA * q3 + (2 * nA + nM) * q * l * p;  // transposed axis a2
  r = r > t2 ? r : t2;
  int s = p * l * l;                                   // staged dofs
  s = s > (nM + 2 * nA) * q * q * p ? s : (nM + 2 * nA) * q * q * p;
  c->rsize = (r + 1) & ~1;
  c->ssize = (s + 1) & ~1;
  const size_t coef = (((nA + nM) * q3 + 3) & ~3) * sizeof(float);
  const size_t row = 3 * (size_t)(c->rsize + c->ssize) * sizeof(float2);
  c->rpb = rows < kMaxRows ? rows : kMaxRows;
  while (c->rpb > 1 && coef + c->rpb * row > kMaxSmem) --c->rpb;
  c->smem = coef + c->rpb * row;
  if (c->smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  c->threads = kRowThreads * c->rpb;
  c->grid = nelem * ((rows + c->rpb - 1) / c->rpb);
  c->fn = pick(l, q, want);
  // Above 48 KB a block's dynamic shared memory needs an opt-in, once per
  // kernel and device (the largest size asked so far).
  if (c->smem > 48 * 1024) {
    static int opted[kShapes][3][32] = {};  // [shape][want - 1][device]
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int* have = dev < 32 ? &opted[shape_id(l, q)][want - 1][dev] : nullptr;
    if (have == nullptr || *have < (int)c->smem) {
      err = cudaFuncSetAttribute(c->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)c->smem);
      if (err != cudaSuccess) return (int)err;
      if (have) *have = (int)c->smem;
    }
  }
  return 0;
}

bool valid(int q, int l, int nelem, int nblocks, int want) {
  return q >= 1 && q <= kMaxQ && l >= 2 && l <= kMaxL && nelem >= 1 && nblocks >= 1 &&
         nblocks % nelem == 0 && want >= 1 && want <= 3;
}

}  // namespace

// u, y, m: (nblocks, 3 p l^2) complex64, p = l - 1; muw, epsw:
// (nelem, q^3) float32; nblocks = rows * nelem. tabs: host (4, q, l)
// float32 (Bc, Dc, Bo, Do; the open ones with their zero last column; Do
// is not used: no derivative runs along a component's open axis);
// metric: host J (9), Ginv (9), 1/detJ. want: 1 = A, 2 = M, 3 = both
// (y or m may be null when not wanted). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int nd_apply_launch(const void* u, const void* muw, const void* epsw,
                               void* y, void* m, const float* tabs,
                               const float* metric, int q, int l, int nelem,
                               int nblocks, int want, void* stream) {
  if (!valid(q, l, nelem, nblocks, want) || ((want & 1) && y == nullptr) ||
      ((want & 2) && m == nullptr))
    return (int)cudaErrorInvalidValue;
  Config c;
  const int err = configure(q, l, want, nelem, nblocks / nelem, &c);
  if (err) return err;
  NdParams P = {};
  const int p = l - 1;
  for (int n = 0; n < q; ++n) {
    for (int o = 0; o < l; ++o) {
      P.Bc[n * l + o] = tabs[n * l + o];
      P.Dc[n * l + o] = tabs[q * l + n * l + o];
    }
    for (int o = 0; o < p; ++o) P.Bo[n * p + o] = tabs[2 * q * l + n * l + o];
  }
  const float* J = metric;
  const float inv_det = metric[18];
  for (int r = 0; r < 3; ++r)
    for (int s = 0; s < 3; ++s) {
      double k = 0.0;
      for (int i = 0; i < 3; ++i) k += (double)J[i * 3 + r] * J[i * 3 + s];
      P.K[r * 3 + s] = (float)(k * inv_det * inv_det);
      P.Ginv[r * 3 + s] = metric[9 + r * 3 + s];
    }
  P.q = q;
  P.l = l;
  P.nelem = nelem;
  P.rows = nblocks / nelem;
  P.rpb = c.rpb;
  P.rsize = c.rsize;
  P.ssize = c.ssize;
  c.fn<<<c.grid, c.threads, c.smem, (cudaStream_t)stream>>>(
      (const float2*)u, (const float*)muw, (const float*)epsw, (float2*)y, (float2*)m, P);
  return (int)cudaGetLastError();
}

// The launch shape of a call and its residency on the current device:
// out = {element-rows per block, threads per block, dynamic shared bytes
// per block, resident blocks per SM}. Returns a cudaError_t (0 on
// success).
extern "C" int nd_apply_occupancy(int q, int l, int nelem, int nblocks, int want, int* out) {
  if (!valid(q, l, nelem, nblocks, want) || out == nullptr) return (int)cudaErrorInvalidValue;
  Config c;
  int err = configure(q, l, want, nelem, nblocks / nelem, &c);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.fn, c.threads, c.smem);
  if (err) return err;
  out[0] = c.rpb;
  out[1] = c.threads;
  out[2] = (int)c.smem;
  out[3] = blocks;
  return 0;
}
