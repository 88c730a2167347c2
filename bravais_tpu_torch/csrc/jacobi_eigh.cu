// Batched Hermitian eigensolver by cyclic (round-robin) Jacobi, complex64.
//
// Replaces bravais_tpu/eigen/pallas_jacobi.py::jacobi_eigh_pallas (the
// fused-sweep Pallas TPU kernel) and carries the contract of
// bravais_tpu/eigen/jacobi_eigh.py::jacobi_eigh: a Rutishauser stop
// (max |H_ij|^2 / |H_ii H_jj| <= rel_tol^2, tested before every sweep)
// under a cap of `max_sweeps` sweeps; rel_tol = 0 runs every sweep, as the
// TPU kernel's fixed 12-sweep schedule did.
//
// What bounds it: latency, not bytes or flops. One matrix is a chain of
// dependent rounds (n-1 per sweep, about 47 at the n = 48 Rayleigh-Ritz
// size), each a few block-wide barriers apart; the arithmetic per round is
// ~n^2 complex multiply-adds. So one thread block owns one matrix, the grid
// runs over the batch, and H and V live in shared memory for the whole
// solve (2 n^2 x 8 bytes: 36 KB at n = 48, 64 KB at n = 64) so that no
// round touches device memory. The round-robin pairs are computed in the
// kernel from the round index (circle method) instead of the permutation
// matmuls the TPU kernel used to feed its matrix unit.
//
// Per round: n/2 threads compute the rotation (c, s) of their pair; all
// threads rotate rows p, q of H (H <- G^H H); then columns p, q of H and V
// (H <- H G, V <- V G); then H is re-hermitized. G has G[p,p] = G[q,q] = c,
// G[p,q] = s, G[q,p] = -conj(s).
//
// Outputs: w (batch, n) the unsorted diagonal of the rotated H, V
// (batch, n, n) row-major with columns the eigenvectors, and the number
// of sweeps each matrix ran. The Python wrapper sorts and strips padding.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 cscale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float cabs2(float2 a) { return a.x * a.x + a.y * a.y; }

// Block-wide max of a non-negative value; every thread gets the result.
__device__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? scratch[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  v = scratch[0];
  __syncthreads();
  return v;
}

__global__ void jacobi_eigh_kernel(const float2* __restrict__ Hin,
                                   float* __restrict__ w_out,
                                   float2* __restrict__ V_out,
                                   int* __restrict__ sweeps_out, int n,
                                   int max_sweeps, float eps2) {
  extern __shared__ float2 smem[];
  float2* H = smem;          // n x n, row-major
  float2* V = smem + n * n;  // n x n, row-major
  __shared__ float rc[kMaxN / 2];
  __shared__ float2 rs[kMaxN / 2];
  __shared__ int rp[kMaxN / 2], rq[kMaxN / 2];
  __shared__ float scratch[32];

  const int tid = threadIdx.x, nt = blockDim.x, h = n / 2, nn = n * n;
  const float tiny = 1.17549435e-38f * 100.0f;  // FLT_MIN * 100
  const float dd_floor = 1.17549435e-38f * 1e6f;
  const float2* Hb = Hin + (size_t)blockIdx.x * nn;

  for (int i = tid; i < nn; i += nt) {
    H[i] = Hb[i];
    V[i] = make_float2((i / n == i % n) ? 1.0f : 0.0f, 0.0f);
  }
  __syncthreads();

  int sweep = 0;
  for (;; ++sweep) {
    // Rutishauser test over the off-diagonal entries.
    float worst = 0.0f;
    for (int i = tid; i < nn; i += nt) {
      const int r = i / n, c = i % n;
      if (r != c) {
        const float dr = sqrtf(cabs2(H[r * n + r]));
        const float dc = sqrtf(cabs2(H[c * n + c]));
        worst = fmaxf(worst, cabs2(H[i]) / fmaxf(dr * dc, dd_floor));
      }
    }
    worst = block_max(worst, scratch);
    if (sweep >= max_sweeps || !(worst > eps2)) break;

    for (int round = 0; round < n - 1; ++round) {
      if (tid < h) {
        // Circle method: lst = [0, others rotated by `round`], pair j is
        // (lst[j], lst[n-1-j]) with others = 1..n-1.
        const int a = tid == 0 ? 0 : 1 + (tid - 1 + round) % (n - 1);
        const int b = 1 + (n - 2 - tid + round) % (n - 1);
        const int p = min(a, b), q = max(a, b);
        const float app = H[p * n + p].x, aqq = H[q * n + q].x;
        const float2 apq = H[p * n + q];
        const float absa = sqrtf(cabs2(apq));
        float t = 0.0f;
        float2 phase = make_float2(1.0f, 0.0f);
        if (absa > tiny) {
          phase = cscale(1.0f / absa, apq);
          const float tau = (aqq - app) / (2.0f * absa);
          const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
          t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        }
        const float c = rsqrtf(1.0f + t * t);
        rc[tid] = c;
        rs[tid] = cscale(t * c, phase);
        rp[tid] = p;
        rq[tid] = q;
      }
      __syncthreads();
      // Rows: H[p,:] <- c H[p,:] - s H[q,:];  H[q,:] <- conj(s) H[p,:] + c H[q,:]
      for (int i = tid; i < h * n; i += nt) {
        const int j = i / n, k = i % n;
        const int p = rp[j], q = rq[j];
        const float c = rc[j];
        const float2 s = rs[j];
        const float2 hp = H[p * n + k], hq = H[q * n + k];
        H[p * n + k] = csub(cscale(c, hp), cmul(s, hq));
        H[q * n + k] = cadd(cmul(cconj(s), hp), cscale(c, hq));
      }
      __syncthreads();
      // Columns of H and V: X[:,p] <- c X[:,p] - conj(s) X[:,q];
      //                     X[:,q] <- s X[:,p] + c X[:,q]
      for (int i = tid; i < h * n; i += nt) {
        const int k = i / h, j = i % h;
        const int p = rp[j], q = rq[j];
        const float c = rc[j];
        const float2 s = rs[j], sc = cconj(s);
        float2 xp = H[k * n + p], xq = H[k * n + q];
        H[k * n + p] = csub(cscale(c, xp), cmul(sc, xq));
        H[k * n + q] = cadd(cmul(s, xp), cscale(c, xq));
        xp = V[k * n + p];
        xq = V[k * n + q];
        V[k * n + p] = csub(cscale(c, xp), cmul(sc, xq));
        V[k * n + q] = cadd(cmul(s, xp), cscale(c, xq));
      }
      __syncthreads();
      // Re-hermitize: H <- (H + H^H) / 2.
      for (int i = tid; i < nn; i += nt) {
        const int r = i / n, c = i % n;
        if (r < c) {
          const float2 a = H[i], b = H[c * n + r];
          const float2 m = cscale(0.5f, cadd(a, cconj(b)));
          H[i] = m;
          H[c * n + r] = cconj(m);
        } else if (r == c) {
          H[i].y = 0.0f;
        }
      }
      __syncthreads();
    }
  }

  float* wb = w_out + (size_t)blockIdx.x * n;
  float2* Vb = V_out + (size_t)blockIdx.x * nn;
  for (int i = tid; i < nn; i += nt) Vb[i] = V[i];
  for (int i = tid; i < n; i += nt) wb[i] = H[i * n + i].x;
  if (tid == 0) sweeps_out[blockIdx.x] = sweep;
}

}  // namespace

// Opts the kernel in to the shared memory of the largest n (64 KB at
// n = 64) on the current device. Call once per device before the first
// launch there. Returns the cudaError_t (0 on success).
extern "C" int jacobi_eigh_init() {
  return (int)cudaFuncSetAttribute(jacobi_eigh_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)(2 * kMaxN * kMaxN * sizeof(float2)));
}

// H: (batch, n, n) complex64, row-major, contiguous, n even, 2 <= n <= 64.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int jacobi_eigh_launch(const void* H, void* w, void* V, void* sweeps,
                                  int batch, int n, int max_sweeps, float rel_tol,
                                  void* stream) {
  if (n < 2 || n > kMaxN || (n & 1) || batch < 1 || max_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)n * n * sizeof(float2);
  int threads = (n / 2) * n;
  threads = threads > 1024 ? 1024 : ((threads + 31) / 32) * 32;
  jacobi_eigh_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      (const float2*)H, (float*)w, (float2*)V, (int*)sweeps, n, max_sweeps,
      rel_tol * rel_tol);
  return (int)cudaGetLastError();
}
