// Batched Hermitian eigensolver by cyclic (round-robin) Jacobi, complex64.
//
// Replaces bravais_tpu/eigen/pallas_jacobi.py::jacobi_eigh_pallas (the
// fused-sweep Pallas TPU kernel) and carries the contract of
// bravais_tpu/eigen/jacobi_eigh.py::jacobi_eigh: a Rutishauser stop
// (max |H_ij|^2 / |H_ii H_jj| <= rel_tol^2, tested before every sweep)
// under a cap of `max_sweeps` sweeps; rel_tol = 0 runs every sweep, as the
// TPU kernel's fixed 12-sweep schedule did. The circle-method pair order
// and the rotation formulas are those of the plain torch version
// (eigen/jacobi_eigh.py::jacobi_eigh_plain), which stays its model; the
// kernel evaluates them with reciprocals (__frcp_rn, __fdividef) where the
// plain version divides, so the two agree to rounding, not to the bit.
//
// What bounds it: latency, not bytes or flops. One matrix is a chain of
// dependent rounds (n-1 per sweep, about 330 at the n = 48 Rayleigh-Ritz
// size); the arithmetic of a round is ~n^2 complex multiply-adds. Tensor
// cores do not apply: a round is a rank-2 update per pair of rows, not a
// product worth wgmma. So the design cuts what each round waits on:
//
// * One barrier per round. The n/2 rotations of a round are disjoint, so
//   H <- G^H H G splits into independent 2x2 blocks, (pair i, pair j) ->
//   G_i^H H_ij G_j. One item thread owns block (i, j), i < j, reads it
//   from the current H and writes it and its conjugate mirror into the
//   other of two H buffers (ping-pong). H stays exactly Hermitian with a
//   real diagonal, so no re-hermitize pass is needed. The V updates (row
//   k, pair j) run in the same phase, in place (a round's columns are
//   disjoint).
// * The rotations off the critical path. A group's first warp is its
//   rotation warp, one lane per pair: during round r it writes round r's
//   diagonal blocks and computes round r+1's table. That needs only the
//   current H and round r's rotations: the 2x2 block of a round-(r+1)
//   pair after round r is one entry of a round-r block, which the lane
//   recomputes with the item thread's formulas in the item thread's
//   orientation, and two diagonal entries from round r's table. The two
//   copies are compiled apart and nvcc may contract them into FMAs
//   differently, so the lane's H_pq agrees with the stored one to
//   rounding (an ulp), which perturbs the next rotation no more than f32
//   rounding of H already does. So the item threads never
//   wait for a rotation, and the round's one barrier publishes both the
//   new H and the next table.
// * No div/mod in a round. Each thread's blocks and V rows are fixed at
//   kernel start (at most kMaxItems, one packed int each in shared
//   memory); the pairs of a round come from the rotation table, whose
//   lanes track the circle method's members, which advance by one each
//   round.
// * Matrices sized to the SM. A matrix gets a group of G threads (the
//   rotation warp and item threads with about two items each, 64 to 512
//   in all), several groups share a block when a group is under 256
//   threads, and a group synchronises only itself, with a named barrier
//   (bar.sync id, G). So 16x16 matrices never wait on a block barrier and
//   216 27x27 matrices are resident at once.
// * The Rutishauser test rides on the round that ends a sweep: each
//   thread takes the max ratio over the entries it writes (the new
//   diagonal comes from the rotation table), a warp-shuffle max, one
//   shared slot per warp read after the round's barrier.
// * Odd n runs the circle method on n + 1 with a "bye": the pair that
//   holds the virtual index n gets the identity rotation, which leaves V
//   and the zero virtual row and column of H as they are: exactly the
//   decoupled pad of the plain version.
// * The eigenpairs leave in ascending, stable order (rank = #{w_j < w_i}
//   + #{j < i : w_j = w_i}, NaN last: torch.sort(stable=True)), so the
//   wrapper launches this kernel and nothing else.
//
// Outputs: w (batch, n) ascending, V (batch, n, n) row-major with columns
// the eigenvectors, and the number of sweeps each matrix ran.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxItems = 8;  // blocks or V rows per thread

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

// G^H from the left on rows (p, q): x_p = c h_p - s h_q, x_q = conj(s) h_p + c h_q.
__device__ __forceinline__ void rot_rows(float c, float2 s, float2 hp, float2 hq,
                                         float2& xp, float2& xq) {
  xp = csub(cscale(c, hp), cmul(s, hq));
  xq = cadd(cmul(cconj(s), hp), cscale(c, hq));
}
// G from the right on columns (p, q): y_p = c x_p - conj(s) x_q, y_q = s x_p + c x_q.
__device__ __forceinline__ void rot_cols(float c, float2 s, float2 xp, float2 xq,
                                         float2& yp, float2& yq) {
  yp = csub(cscale(c, xp), cmul(cconj(s), xq));
  yq = cadd(cmul(s, xp), cscale(c, xq));
}

__device__ __forceinline__ float ratio(float2 h, float d1, float d2) {
  const float dd_floor = 1.17549435e-38f * 1e6f;  // FLT_MIN * 1e6
  return cabs2(h) * __frcp_rn(fmaxf(fabsf(d1) * fabsf(d2), dd_floor));
}

// A circle-method member in the next round: 1..ne-1 advance by one with
// wrap-around, 0 stays.
__device__ __forceinline__ int advance(int a, int ne) {
  return a == 0 ? 0 : (a == ne - 1 ? 1 : a + 1);
}

__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// A round's off-diagonal 2x2 H blocks owned by one thread (slots [0, nbs)
// of its item codes): read from Hc, written with their mirrors to Hn. With
// LAST, returns the max Rutishauser ratio of the entries written. The
// restrict qualifiers and the branch-free body let the compiler start the
// next block's loads before this one's stores (Hc, Hn, rot and codes never
// overlap).
template <bool LAST>
__device__ __forceinline__ float round_blocks(const int* __restrict__ codes, int nbs,
                                              int G, int gt,
                                              const float4* __restrict__ rot,
                                              const float2* __restrict__ Hc,
                                              float2* __restrict__ Hn, int ldh) {
  float wmax = 0.0f;
#pragma unroll 2
  for (int s = 0; s < nbs; ++s) {
    const int code = codes[s * G + gt], i = code & 255, j = (code >> 8) & 255;
    const float4 Ri = rot[2 * i], Rj = rot[2 * j];
    const int pqi = __float_as_int(Ri.w), pqj = __float_as_int(Rj.w);
    const int p = pqi & 255, q = pqi >> 8, r = pqj & 255, t = pqj >> 8;
    const float2 s_i = make_float2(Ri.y, Ri.z), s_j = make_float2(Rj.y, Rj.z);
    float2 xpr, xpt, xqr, xqt, ypr, ypt, yqr, yqt;
    rot_rows(Ri.x, s_i, Hc[p * ldh + r], Hc[q * ldh + r], xpr, xqr);
    rot_rows(Ri.x, s_i, Hc[p * ldh + t], Hc[q * ldh + t], xpt, xqt);
    rot_cols(Rj.x, s_j, xpr, xpt, ypr, ypt);
    rot_cols(Rj.x, s_j, xqr, xqt, yqr, yqt);
    Hn[p * ldh + r] = ypr;
    Hn[p * ldh + t] = ypt;
    Hn[q * ldh + r] = yqr;
    Hn[q * ldh + t] = yqt;
    Hn[r * ldh + p] = cconj(ypr);
    Hn[t * ldh + p] = cconj(ypt);
    Hn[r * ldh + q] = cconj(yqr);
    Hn[t * ldh + q] = cconj(yqt);
    if (LAST) {
      const float4 Di = rot[2 * i + 1], Dj = rot[2 * j + 1];
      wmax = fmaxf(wmax, fmaxf(fmaxf(ratio(ypr, Di.x, Dj.x), ratio(ypt, Di.x, Dj.y)),
                               fmaxf(ratio(yqr, Di.y, Dj.x), ratio(yqt, Di.y, Dj.y))));
    }
  }
  return wmax;
}

// A round's V rows owned by one thread (slots [s0, s1)), updated in place:
// V <- V G on the row's two columns of the pair (the bye pair of odd n has
// the identity rotation and a zero virtual column, so it needs no test).
// Vin and Vout are the same array, passed apart so that the compiler may
// load the next row before storing this one: the rows of a round never
// share an entry.
__device__ __forceinline__ void round_vrows(const int* __restrict__ codes, int s0, int s1,
                                            int G, int gt,
                                            const float4* __restrict__ rot,
                                            const float2* __restrict__ Vin,
                                            float2* __restrict__ Vout, int ldv) {
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {
    const int code = codes[s * G + gt], j = (code >> 8) & 255, k = code >> 16;
    const float4 R = rot[2 * j];
    const int pq = __float_as_int(R.w), p = pq & 255, q = pq >> 8;
    float2 yp, yq;
    rot_cols(R.x, make_float2(R.y, R.z), Vin[p * ldv + k], Vin[q * ldv + k], yp, yq);
    Vout[p * ldv + k] = yp;
    Vout[q * ldv + k] = yq;
  }
}

__host__ __device__ inline int padded(int n) { return n + (n & 1); }
// Odd strides, so that a row and a column of H (and V's columns) spread
// over the shared-memory banks.
__host__ __device__ inline int hstride(int n) { return padded(n) + 1; }
__host__ __device__ inline int vstride(int n) { return n | 1; }

// Shared bytes of one matrix's group: two H buffers (row-major), V
// (column-major), two rotation tables (this round's, the next one's), the
// test slots, ranks, the rotation warp's two member-to-pair maps (this
// round's, the next one's), the item threads' codes.
__host__ __device__ inline size_t group_bytes(int n, int G) {
  const int ne = padded(n), nw = G / 32;
  size_t b = (2 * (size_t)ne * hstride(n) + (size_t)ne * vstride(n)) * 8;
  b = (b + 15) & ~(size_t)15;
  b += 2 * (size_t)(ne / 2) * 32;
  b += 2 * nw * 4 + (size_t)n * 4 + 2 * (size_t)ne * 4 + (size_t)kMaxItems * (G - 32) * 4;
  return (b + 15) & ~(size_t)15;
}

// The rotation of one pair from its 2x2 block (H_pp, H_qq real, H_pq) into
// a table entry: (c, s, p | q << 8) and the block after it (H_pp, H_qq,
// H_pq), the formulas of the plain version with a reciprocal in place of
// its divisions by |H_pq| and the fast division for t. `skip` (the bye of odd n)
// gives the identity.
__device__ __forceinline__ void rotate_pair(float app, float aqq, float2 apq, int p,
                                            int q, bool skip, float4* entry) {
  const float tiny = 1.17549435e-38f * 100.0f;  // FLT_MIN * 100
  const float absa = sqrtf(cabs2(apq));
  float t = 0.0f;
  float2 phase = make_float2(1.0f, 0.0f);
  if (absa > tiny && !skip) {
    const float inv = __frcp_rn(absa);
    phase = cscale(inv, apq);
    const float tau = (aqq - app) * (0.5f * inv);
    const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
    const float den = fabsf(tau) + sqrtf(1.0f + tau * tau);
    t = den < 1e30f ? __fdividef(sgn, den) : 0.0f;  // |t| < 1e-30: no rotation
  }
  // c correctly rounded: with |phase| = 1 to the ulp the rotation stays
  // unitary to the ulp, which V's orthogonality accumulates over sweeps.
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float2 s = cscale(t * c, phase);
  float2 rpp, rpq, rqp, rqq, npp, npq, nqp, nqq;
  rot_rows(c, s, make_float2(app, 0.0f), cconj(apq), rpp, rqp);
  rot_rows(c, s, apq, make_float2(aqq, 0.0f), rpq, rqq);
  rot_cols(c, s, rpp, rpq, npp, npq);
  rot_cols(c, s, rqp, rqq, nqp, nqq);
  const float2 off = cscale(0.5f, cadd(npq, cconj(nqp)));
  entry[0] = make_float4(c, s.x, s.y, __int_as_float(p | q << 8));
  entry[1] = make_float4(npp.x, nqq.x, off.x, off.y);
}

__global__ void __launch_bounds__(512)
jacobi_eigh_kernel(const float2* __restrict__ Hin, float* __restrict__ w_out,
                   float2* __restrict__ V_out, int* __restrict__ sweeps_out,
                   int batch, int n, int G, int max_sweeps, float eps2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ne = padded(n), P = ne / 2, ldh = hstride(n), ldv = vstride(n);
  const int nw = G / 32;
  const int bye = (n & 1) ? n : -1;  // the virtual index of odd n
  const int grp = threadIdx.x / G, gt = threadIdx.x - grp * G;
  const int lane = threadIdx.x & 31, wg = gt >> 5;
  const int bid = (int)blockIdx.x * (blockDim.x / G) + grp;
  if (bid >= batch) return;  // the whole group leaves together
  const int bar = 1 + grp;   // named barrier 0 is __syncthreads

  unsigned char* base = smem + (size_t)grp * group_bytes(n, G);
  float2* Hc = (float2*)base;
  float2* Hn = Hc + ne * ldh;
  float2* Vt = Hn + ne * ldh;
  float4* tab = (float4*)(base + ((((2 * (size_t)ne * ldh + (size_t)ne * ldv) * 8) + 15) & ~(size_t)15));
  float* red = (float*)(tab + 4 * P);
  int* rank = (int*)(red + 2 * nw);
  int* pair_of = rank + n;  // two maps member -> its pair (| 256: second)
  int* codes = pair_of + 2 * ne;  // item codes, slot s of item thread it at s * Gi + it
  const int Gi = G - 32, it0 = gt - 32;  // the item threads: warps 1..

  // Load H hermitized (as the plain version's first round leaves it),
  // zero the virtual row and column of odd n; V = I.
  const float2* Hb = Hin + (size_t)bid * n * n;
  for (int idx = gt; idx < ne * ne; idx += G) {
    const int i = idx / ne, j = idx - i * ne;
    float2 h = make_float2(0.0f, 0.0f);
    if (i < n && j < n) {
      const float2 a = Hb[i * n + j];
      if (i == j) {
        h = make_float2(a.x, 0.0f);
      } else {
        const float2 b = Hb[j * n + i];
        h = cscale(0.5f, cadd(a, cconj(b)));
      }
    }
    Hc[i * ldh + j] = h;
  }
  for (int idx = gt; idx < ne * ldv; idx += G) {
    const int c = idx / ldv, k = idx - c * ldv;
    Vt[idx] = make_float2(c == k ? 1.0f : 0.0f, 0.0f);
  }

  // The item threads' items: slot s of item thread it0 is item
  // it0 + s * Gi. The off-diagonal blocks (i < j) come first, so slots
  // [0, nbs) are H blocks and [nbs, ns) V rows (pair j, row k, k fastest);
  // each is packed as i | j << 8 | k << 16. The loops over slots are real
  // loops: unrolled, every kind's code would issue for every slot under
  // predicates.
  const int nblk = P * (P - 1) / 2, nitems = nblk + n * P;
  int nbs = 0, ns = 0;
  if (wg > 0) {
    for (int it = it0; it < nitems; it += Gi, ++ns) {
      int i = 0, j = 0, k = 0;
      if (it < nblk) {
        int rem = it;
        for (; rem >= P - 1 - i; ++i) rem -= P - 1 - i;
        j = i + 1 + rem;
        ++nbs;
      } else {
        j = (it - nblk) / n;
        k = it - nblk - j * n;
      }
      codes[ns * Gi + it0] = i | j << 8 | k << 16;
    }
  }
  // The rotation warp's lane tracks one pair slot: members (ra, rb),
  // (lane, ne - 1 - lane) in round 0.
  int ra = lane, rb = ne - 1 - lane;
  group_sync(bar, G);

  // The test before sweep 0 (round 0: slot i pairs (i, ne - 1 - i)), and
  // round 0's rotations.
  int cur = 0;
  float wmax = 0.0f;
  if (wg == 0) {
    if (lane < P) {
      const int p = lane, q = ne - 1 - lane;
      const float app = Hc[p * ldh + p].x, aqq = Hc[q * ldh + q].x;
      const float2 apq = Hc[p * ldh + q];
      wmax = ratio(apq, app, aqq);
      rotate_pair(app, aqq, apq, p, q, q == bye, tab + 2 * lane);
      pair_of[p] = lane;
      pair_of[q] = lane | 256;
    }
  } else {
    for (int s = 0; s < nbs; ++s) {
      const int code = codes[s * Gi + it0], i = code & 255, j = (code >> 8) & 255;
      const int p = i, q = ne - 1 - i, r = j, t = ne - 1 - j;
      const float dp = Hc[p * ldh + p].x, dq = Hc[q * ldh + q].x;
      const float dr = Hc[r * ldh + r].x, dt = Hc[t * ldh + t].x;
      wmax = fmaxf(wmax, fmaxf(fmaxf(ratio(Hc[p * ldh + r], dp, dr),
                                     ratio(Hc[p * ldh + t], dp, dt)),
                               fmaxf(ratio(Hc[q * ldh + r], dq, dr),
                                     ratio(Hc[q * ldh + t], dq, dt))));
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  if (lane == 0) red[wg] = wmax;
  group_sync(bar, G);
  float worst = 0.0f;
  for (int w = 0; w < nw; ++w) worst = fmaxf(worst, red[w]);

  // A round: the item threads rotate H's off-diagonal blocks and V's rows
  // with this round's table while the rotation warp writes the diagonal
  // blocks and computes the next round's table (from the current H and
  // this round's rotations: the next pair's 2x2 block is known before the
  // barrier). One barrier publishes Hn and the next table.
  int sweep = 0;
  for (; sweep < max_sweeps && worst > eps2; ++sweep) {
    float* slot = red + ((sweep + 1) & 1) * nw;
    for (int round = 0; round < ne - 1; ++round) {
      const bool last = round == ne - 2;
      const float4* T = tab + cur * 2 * P;
      float4* Tn = tab + (cur ^ 1) * 2 * P;
      wmax = 0.0f;
      if (wg == 0) {
        const int* map = pair_of + cur * ne;  // this round's map
        if (lane < P) {
          // This round's diagonal block of the lane's pair.
          const float4 A = T[2 * lane], B = T[2 * lane + 1];
          const int pq = __float_as_int(A.w), p = pq & 255, q = pq >> 8;
          const float2 off = make_float2(B.z, B.w);
          Hn[p * ldh + p] = make_float2(B.x, 0.0f);
          Hn[q * ldh + q] = make_float2(B.y, 0.0f);
          Hn[p * ldh + q] = off;
          Hn[q * ldh + p] = cconj(off);
          if (last) wmax = ratio(off, B.x, B.y);
          // The next round's pair (p2, q2) and its 2x2 block after this
          // round: the diagonal from this round's table, H_p2q2 from the
          // block of this round's pairs that holds it, oriented as the item
          // thread that writes it computes it (so the two agree to rounding).
          ra = advance(ra, ne);
          rb = advance(rb, ne);
          const int p2 = min(ra, rb), q2 = max(ra, rb);
          const int sp = map[p2], sq = map[q2];
          const int i = sp & 255, j = sq & 255;
          const float4 Bi = T[2 * i + 1], Bj = T[2 * j + 1];
          const float app = sp & 256 ? Bi.y : Bi.x, aqq = sq & 256 ? Bj.y : Bj.x;
          float2 apq;
          if (i == j) {  // ne = 2: the same pair again
            apq = make_float2(Bi.z, Bi.w);
          } else {
            const int lo = min(i, j), hi = max(i, j);
            const float4 Rl = T[2 * lo], Rh = T[2 * hi];
            const int pql = __float_as_int(Rl.w), pqh = __float_as_int(Rh.w);
            const int pl = pql & 255, ql = pql >> 8, ph = pqh & 255, qh = pqh >> 8;
            const float2 s_l = make_float2(Rl.y, Rl.z), s_h = make_float2(Rh.y, Rh.z);
            float2 xpr, xpt, xqr, xqt, ypr, ypt, yqr, yqt;
            rot_rows(Rl.x, s_l, Hc[pl * ldh + ph], Hc[ql * ldh + ph], xpr, xqr);
            rot_rows(Rl.x, s_l, Hc[pl * ldh + qh], Hc[ql * ldh + qh], xpt, xqt);
            rot_cols(Rh.x, s_h, xpr, xpt, ypr, ypt);
            rot_cols(Rh.x, s_h, xqr, xqt, yqr, yqt);
            // Row member of the (lo, hi) block: p2's if p2 is in pair lo.
            const bool rq = (i == lo ? sp : sq) & 256, cq = (i == lo ? sq : sp) & 256;
            const float2 v = rq ? (cq ? yqt : yqr) : (cq ? ypt : ypr);
            apq = i == lo ? v : cconj(v);
          }
          rotate_pair(app, aqq, apq, p2, q2, q2 == bye, Tn + 2 * lane);
          pair_of[(cur ^ 1) * ne + p2] = lane;  // the next round's map
          pair_of[(cur ^ 1) * ne + q2] = lane | 256;
        }
      } else {
        if (last)
          wmax = round_blocks<true>(codes, nbs, Gi, it0, T, Hc, Hn, ldh);
        else
          round_blocks<false>(codes, nbs, Gi, it0, T, Hc, Hn, ldh);
        round_vrows(codes, nbs, ns, Gi, it0, T, Vt, Vt, ldv);
      }
      if (last) {
        for (int o = 16; o > 0; o >>= 1)
          wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
        if (lane == 0) slot[wg] = wmax;
      }
      group_sync(bar, G);
      float2* tmp = Hc;
      Hc = Hn;
      Hn = tmp;
      cur ^= 1;
      if (last) {
        worst = 0.0f;
        for (int w = 0; w < nw; ++w) worst = fmaxf(worst, slot[w]);
      }
    }
  }

  // Ascending, stable order of the eigenpairs, NaN last.
  float* wb = w_out + (size_t)bid * n;
  for (int i = gt; i < n; i += G) {
    const float wi = Hc[i * ldh + i].x;
    const bool ni = isnan(wi);
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const float wj = Hc[j * ldh + j].x;
      const bool nj = isnan(wj);
      const bool less = !nj && (ni || wj < wi);
      const bool tie = nj ? ni : wj == wi;
      r += less || (tie && j < i);
    }
    rank[i] = r;
    wb[r] = wi;
  }
  group_sync(bar, G);
  float2* Vb = V_out + (size_t)bid * n * n;
  for (int idx = gt; idx < n * n; idx += G) {
    const int k = idx / n, c = idx - k * n;
    Vb[k * n + rank[c]] = Vt[c * ldv + k];
  }
  if (gt == 0) sweeps_out[bid] = sweep;
}

}  // namespace

// Opts the kernel in to the device's largest dynamic shared memory per
// block. Call once per device before the first launch there. Returns the
// cudaError_t (0 on success).
extern "C" int jacobi_eigh_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(jacobi_eigh_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return (int)err;
}

// H: (batch, n, n) complex64, row-major, contiguous, 1 <= n <= 64. G: the
// threads of one matrix (a multiple of 32, at least 64: the rotation warp
// and item threads enough for kMaxItems each); per_block: matrices per
// block (G * per_block <= 512).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int jacobi_eigh_launch(const void* H, void* w, void* V, void* sweeps,
                                  int batch, int n, int G, int per_block,
                                  int max_sweeps, float rel_tol, void* stream) {
  const int ne = padded(n), P = ne / 2, nitems = P * (P - 1) / 2 + n * P;
  if (n < 1 || n > kMaxN || batch < 1 || max_sweeps < 0 || G < 64 ||
      G % 32 || per_block < 1 || per_block > 15 || G * per_block > 512 ||
      (long)(G - 32) * kMaxItems < nitems)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)per_block * group_bytes(n, G);
  const int blocks = (batch + per_block - 1) / per_block;
  jacobi_eigh_kernel<<<blocks, G * per_block, smem, (cudaStream_t)stream>>>(
      (const float2*)H, (float*)w, (float2*)V, (int*)sweeps, batch, n, G,
      max_sweeps, rel_tol * rel_tol);
  return (int)cudaGetLastError();
}
