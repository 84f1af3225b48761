// tournament: the optimizer's repack tournament after k (kernel C).
//
// Replaces the reference's jitted XLA program
// karpenter_tpu/optimizer/tournament.py::_tournament_impl (:140, from :179
// on) with karpenter_tpu/optimizer/relax.py::relax_residuals (:40-77) and
// replacement_lower_bound (relax.py:80-91). For subset s (victim mask row
// m = masks[s, :]) over N nodes and G groups:
//
//   need[g]    = sum_n m[n] counts[n, g]
//   supply[g]  = sum_n k[n, g] - sum_n m[n] k[n, g]
//   feasible   = all_g (need <= supply + EPS) or need == 0
//   savings    = sum_n m[n] price[n]
//   cap[n, g]  = (1 - m[n]) k[n, g];  x = cap * need / (sum_n cap + REPS)
//   iters x:   capacity pass  x[n, :] *= clip(min_r head+[n,r] / load[n,r])
//              demand pass    x += slack * deficit / (sum_n slack + REPS)
//   then one more capacity pass; residual[g] = max(need - sum_n x, 0)
//   out[s] = {feasible, savings, sum_g residual, sum_g residual * pslot}
//
// Bound: operations. The inputs are read once (k and counts [N, G], masks
// [S, N]: ~0.6 MB at the operator loop's first search, S=232, N=382,
// G~90). The function needs, per (subset, node, group) cell, 3 operations
// for the seed (cap, its sum over nodes, cap * q), 2*Rk+7 an iteration
// (the load over resources, x * scale, the sum of x, the slack and its
// sum, the update) and 2*Rk+2 for the last projection and the residual's
// sum, plus colsum(k) once: 75 a cell at Rk=2 and iters=6, ~0.6 GFLOP
// there, ~9 us at 67 TFLOP/s fp32. The kernel does 2*Rk+11 an iteration
// (a demand pass forms the slack twice, once for its sum and once for the
// update, rather than keeping a second [S, N, G] scratch).
//
// Design: a prologue kernel sums k over nodes once per launch (col [G]);
// then one block per subset, NT threads. Warp 0 compacts the mask row
// into the victims in ascending node order (ballots), so need, the
// supply's victim term and savings are gathers over a handful of nodes;
// the block keeps each node's survival 1 - m[n] in a [S, N] scratch, so
// a cell's cap is one product. x [N, G] sits in a global scratch slice of
// [S, N, G] (the wrapper allocates it; 32 MB at the relaxation budget,
// inside the 50 MB L2); need sits in a [S, G] scratch. A capacity pass
// gives each thread a node (load over g in registers, RMAX columns), a
// demand pass each thread a group (sums over n in node order);
// __syncthreads() separates the passes, which also makes the block's
// global writes visible to its other threads. Shared memory or a cluster
// for x, and wgmma for the load, are later work.
//
// Numerics: f32, built with -fmad=false; every product, sum and quotient
// is an explicit round-to-nearest intrinsic, as the reference's f32
// expressions round. Sums over nodes run in node order, savings over the
// victims in ascending node order (the reference's XLA dot on the CPU
// below 32 nodes), the final sums over groups in group order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define T_EPS 1.0e-4f  // binpack EPS == np.float32(1e-4): feasibility slack
#define R_EPS 1.0e-6f  // relax _EPS == np.float32(1e-6)
#define R_BIG 1.0e9f   // relax _BIG
#define NT 256         // threads per block
#define RMAX 16        // resource columns carried in registers

struct TournamentArgs {
  const float* head;    // [N, Rk] raw headroom (clamped at 0 here)
  const float* req;     // [G, Rk], rows req_stride floats apart
  const float* k;       // [N, G]
  const float* counts;  // [N, G], rows counts_stride floats apart
  const float* masks;   // [S, N], rows masks_stride floats apart
  const float* prices;  // [N]
  const float* pslot;   // [G]
  const float* col;     // [G] colsum(k), from tournament_colsum_kernel
  float* x;             // scratch [S, N, G]
  float* surv;          // scratch [S, N]: 1 - masks
  float* need;          // scratch [S, G]
  int* vic;             // scratch [S, N]
  float* out;           // [S, 4]
  int req_stride, counts_stride, masks_stride;
  int S, N, G, Rk, iters;
};

// x[n, :] *= clip(min_r max(head[n, r], 0) / load[n, r], 0, 1) for the
// block's nodes (the relaxation's capacity projection)
__device__ void capacity_pass(const TournamentArgs& a, float* x) {
  for (int n = threadIdx.x; n < a.N; n += NT) {
    float* xr = x + (size_t)n * a.G;
    float load[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) load[r] = 0.0f;
    for (int g = 0; g < a.G; ++g) {
      const float xv = xr[g];
      const float* q = a.req + (size_t)g * a.req_stride;
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < a.Rk) load[r] = __fadd_rn(load[r], __fmul_rn(xv, __ldg(q + r)));
    }
    float mn = INFINITY;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < a.Rk) {
        const float h = fmaxf(__ldg(a.head + (size_t)n * a.Rk + r), 0.0f);
        const float ratio =
            load[r] > R_EPS ? __fdiv_rn(h, fmaxf(load[r], R_EPS)) : R_BIG;
        mn = fminf(mn, ratio);
      }
    }
    const float sc = fminf(fmaxf(mn, 0.0f), 1.0f);
    for (int g = 0; g < a.G; ++g) xr[g] = __fmul_rn(xr[g], sc);
  }
}

// col[g] = sum_n k[n, g] in node order: the supply's first term, the same
// for every subset, so it is summed once per launch
__global__ void tournament_colsum_kernel(const float* k, float* col, int N,
                                         int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  float c = 0.0f;
  for (int n = 0; n < N; ++n) c = __fadd_rn(c, __ldg(k + (size_t)n * G + g));
  col[g] = c;
}

__global__ void __launch_bounds__(NT) tournament_kernel(TournamentArgs a) {
  const int s = blockIdx.x;
  const int N = a.N, G = a.G;
  const float* m = a.masks + (size_t)s * a.masks_stride;
  float* x = a.x + (size_t)s * N * G;
  float* need = a.need + (size_t)s * G;
  float* surv = a.surv + (size_t)s * N;
  int* vic = a.vic + (size_t)s * N;
  __shared__ int s_nv;
  __shared__ float s_savings;

  // 1. each node's survival; the victims, ascending (warp 0), and savings
  // in that order
  for (int n = threadIdx.x; n < N; n += NT) surv[n] = __fsub_rn(1.0f, m[n]);
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    int base = 0;
    for (int n0 = 0; n0 < N; n0 += 32) {
      const int n = n0 + (int)lane;
      const bool hit = n < N && m[n] != 0.0f;
      const unsigned b = __ballot_sync(0xffffffffu, hit);
      if (hit) vic[base + __popc(b & ((1u << lane) - 1u))] = n;
      base += __popc(b);
    }
    __syncwarp();
    if (lane == 0) {
      float sv = 0.0f;
      for (int j = 0; j < base; ++j) {
        const int n = vic[j];
        sv = __fadd_rn(sv, __fmul_rn(m[n], __ldg(a.prices + n)));
      }
      s_nv = base;
      s_savings = sv;
    }
  }
  __syncthreads();
  const int nv = s_nv;

  // 2. need, supply, feasibility, and the proportional seed of x: x = cap
  // while its sum runs, then x *= need / (sum + EPS)
  int ok = 1;
  for (int g = threadIdx.x; g < G; g += NT) {
    float nd = 0.0f, sub = 0.0f;
    for (int j = 0; j < nv; ++j) {
      const int n = vic[j];
      const float mv = m[n];
      nd = __fadd_rn(nd, __fmul_rn(mv, __ldg(a.counts + (size_t)n * a.counts_stride + g)));
      sub = __fadd_rn(sub, __fmul_rn(mv, __ldg(a.k + (size_t)n * G + g)));
    }
    float den = 0.0f;
    for (int n = 0; n < N; ++n) {
      const size_t i = (size_t)n * G + g;
      const float cap = __fmul_rn(surv[n], __ldg(a.k + i));
      den = __fadd_rn(den, cap);
      x[i] = cap;
    }
    const float supply = __fsub_rn(__ldg(a.col + g), sub);
    if (!(nd <= __fadd_rn(supply, T_EPS) || nd == 0.0f)) ok = 0;
    need[g] = nd;
    const float q = __fdiv_rn(nd, __fadd_rn(den, R_EPS));
    for (int n = 0; n < N; ++n) {
      const size_t i = (size_t)n * G + g;
      x[i] = __fmul_rn(x[i], q);
    }
  }
  const int feasible = __syncthreads_and(ok);

  // 3. iters x (capacity pass, demand pass), then a last capacity pass
  for (int it = 0; it < a.iters; ++it) {
    capacity_pass(a, x);
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += NT) {
      float xs = 0.0f, sd = 0.0f;
      for (int n = 0; n < N; ++n) {
        const size_t i = (size_t)n * G + g;
        const float xv = x[i];
        const float cap = __fmul_rn(surv[n], __ldg(a.k + i));
        xs = __fadd_rn(xs, xv);
        sd = __fadd_rn(sd, fmaxf(__fsub_rn(cap, xv), 0.0f));
      }
      const float def = fmaxf(__fsub_rn(need[g], xs), 0.0f);
      const float q = __fdiv_rn(def, __fadd_rn(sd, R_EPS));
      for (int n = 0; n < N; ++n) {
        const size_t i = (size_t)n * G + g;
        const float xv = x[i];
        const float sl =
            fmaxf(__fsub_rn(__fmul_rn(surv[n], __ldg(a.k + i)), xv), 0.0f);
        x[i] = __fadd_rn(xv, __fmul_rn(sl, q));
      }
    }
    __syncthreads();
  }
  capacity_pass(a, x);
  __syncthreads();

  // 4. residual per group (written over need), then the sums over groups
  for (int g = threadIdx.x; g < G; g += NT) {
    float xs = 0.0f;
    for (int n = 0; n < N; ++n) xs = __fadd_rn(xs, x[(size_t)n * G + g]);
    need[g] = fmaxf(__fsub_rn(need[g], xs), 0.0f);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float rs = 0.0f, rl = 0.0f;
    for (int g = 0; g < G; ++g) {
      rs = __fadd_rn(rs, need[g]);
      rl = __fadd_rn(rl, __fmul_rn(need[g], __ldg(a.pslot + g)));
    }
    float* o = a.out + (size_t)s * 4;
    o[0] = feasible ? 1.0f : 0.0f;
    o[1] = s_savings;
    o[2] = rs;
    o[3] = rl;
  }
}

// C interface (bound with ctypes). Pointers are device pointers; req,
// counts and masks rows are *_stride floats apart, everything else is
// contiguous. col, x, surv, need and vic are scratch of G, S*N*G, S*N,
// S*G and S*N elements. Both kernels run on `stream`, in order, and
// nothing synchronises. Returns the cudaError_t of the launches (0 =
// launched), -1 for arguments it refuses.
extern "C" int tournament_launch(const float* head, const float* req,
                                 int req_stride, const float* k,
                                 const float* counts, int counts_stride,
                                 const float* masks, int masks_stride,
                                 const float* prices, const float* pslot,
                                 float* col, float* x, float* surv,
                                 float* need, int* vic, float* out, int S,
                                 int N, int G, int Rk, int iters,
                                 void* stream) {
  if (S <= 0) return 0;
  if (N < 0 || G < 0 || Rk < 1 || Rk > RMAX || iters < 0) return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (G > 0) {
    tournament_colsum_kernel<<<(G + 127) / 128, 128, 0, st>>>(k, col, N, G);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  TournamentArgs a;
  a.head = head;
  a.req = req;
  a.k = k;
  a.counts = counts;
  a.masks = masks;
  a.prices = prices;
  a.pslot = pslot;
  a.col = col;
  a.x = x;
  a.surv = surv;
  a.need = need;
  a.vic = vic;
  a.out = out;
  a.req_stride = req_stride;
  a.counts_stride = counts_stride;
  a.masks_stride = masks_stride;
  a.S = S;
  a.N = N;
  a.G = G;
  a.Rk = Rk;
  a.iters = iters;
  tournament_kernel<<<S, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}
