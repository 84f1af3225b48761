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
// Resource columns: each instantiation carries RKB = 2, 4, 8, 16 or 32
// columns of a node's load in registers (rk_bucket). Past 32 the 32-column
// instantiation walks the columns in tiles of 32 (a runtime loop, no
// instantiation of its own): each tile's loads over groups in group order,
// exactly as a narrower Rk's, and the node's scale the minimum over every
// tile's ratios (a minimum is exact in any grouping). req's shared row
// holds RKW = Rk rounded up to 32 floats there (req_width).
//
// Bound: operations. The inputs are read once (k and counts [N, G], masks
// [S, N]: ~0.6 MB at the operator loop's first search, S=232, N=382,
// G=90). The function needs 75 operations a (subset, node, group) cell at
// Rk=2 and 6 iterations (optimizer/tournament_k.ops_needed), ~0.6 GFLOP
// there, ~9 us at 67 TFLOP/s fp32. What limits the kernel is latency, not
// that count: every sum over nodes runs in node order (a tie in the plan's
// ranking breaks on the last bit, so the kernel, its plain version and the
// tests share one order), so each of the 8 passes over a subset (the seed,
// 6 iterations, the last projection) is a chain of N dependent adds a
// group, and a block (one subset, or a cluster's slice of one) runs its
// chains, its node pass and its cell passes one after another. A block
// takes as long with 8 subsets on the card as with 232 (PERF.md).
//
// Design: four tiers, chosen from (S, N, G, Rk) alone
// (optimizer/tournament_k.tournament_layout):
//   block    one block a subset, its x [N, XS] in shared memory (several
//            subsets a block where N is small and S fills the card);
//   cluster  one thread-block cluster of CL = 2..16 blocks a subset, rank r
//            owning the node slice [r*SL, (r+1)*SL) of x in its shared
//            memory: the smallest cluster that holds the slices of x and
//            k, else of x alone;
//   global   CL = 16 with the slices in a global scratch, past 16 blocks'
//            shared memory;
//   stream   CL = 16, the slices in global scratch, where not even the
//            global tier's group rows fit (a few thousand groups): nothing
//            of a group stays resident. The per-group rows (running sums,
//            quotient, need) live in one global row a subset, which the
//            cluster's ranks add into in turn; req streams through two
//            shared buffers of GC groups (cp.async, zero-filled past Rk and
//            G) in the node pass; the chains and the update read k's rows
//            from global memory (L2).
// Beside x, a subset's region holds each node's survival 1 - m, m and
// capacity scale, and per group the running sums, the pass's quotient and
// need. x rows are XS floats (G rounded up to 4, to an odd number of
// 16-byte pieces, zero past G), so every pass moves four groups a 16-byte
// access without bank conflicts. k (in L2, shared by every subset) is
// copied once into shared memory where the slice's rows fit beside x
// (ksmem); else it streams through a ring of NBUF chunks of CH node rows,
// each pass anew. Both are TMA bulk copies, issued and awaited (mbarrier)
// by one thread, the others held at the block barrier. A pass is one of:
//   the node pass   one thread a node forms its load over groups in group
//                   order (req in shared memory), then its capacity scale;
//   cell passes     every thread on (node, 4-group) cells: x * scale, the
//                   seed's cap * q, the demand update (k from the ring);
//   chains          one thread a chain of 4 groups (x's sum) or 2 (the
//                   slack's, whose step weighs twice), each chain kind on
//                   whole warps, adds the block's slice in node order, 16
//                   nodes (8 in the seed) loaded before they are added. In
//                   a cluster, rank r starts from rank r-1's running sums,
//                   read through distributed shared memory once rank r-1
//                   hands them on
//                   (a remote mbarrier arrive, release/acquire at cluster
//                   scope); the last rank turns the totals into the pass's
//                   quotient and hands it to every rank the same way.
// The seed's chains also carry colsum(k) (k holds integers, but BIG = 1e9
// for a group with no request column, so its sums pass 2^24 and keep node
// order), need and the supply's victim term (victims only: the other terms
// are exact zeros; the mask phase lists each slice's victims by ballots)
// and savings. With k resident and one subset a block, the seed turns the
// resident rows into cap = (1 - m) k (the same bits as forming it in each
// pass) and writes x = cap * q itself. The slack is formed in the chain
// and again in the update: x, k and a slack array do not fit one block's
// shared memory at the first search.
//
// Numerics: f32, built with -fmad=false; every product, sum and quotient
// is an explicit round-to-nearest intrinsic, as the reference's f32
// expressions round. Sums over nodes run in node order, savings over the
// victims in ascending node order (the reference's XLA dot on the CPU
// below 32 nodes), the final sums over groups in group order. The zero
// pads past G add exact zeros.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define T_EPS 1.0e-4f  // binpack EPS == np.float32(1e-4): feasibility slack
#define R_EPS 1.0e-6f  // relax _EPS == np.float32(1e-6)
#define R_BIG 1.0e9f   // relax _BIG
#define NT 384         // threads per block (168 registers a thread)
#define NWARP (NT / 32)
#define RMAX 32        // resource columns carried in registers (RKB <= 32;
                       // past 32, tiles of 32)
#define CL_MAX 16      // the largest (non-portable) cluster on Hopper
#define SPB_MAX 32     // subsets one block may hold
#define MAX_DEVICES 64  // devices a per-device memo keeps (others: no memo)

#define NBUF 4         // ring buffers of k chunks (see slice_pass)
#define ISSUER (NT - 32)  // the thread that issues and waits on the ring

// Built with -DTOURNAMENT_PROFILE, thread 0 of block 0 stamps clock64()
// at each phase boundary into tournament_stamps (read back through
// tournament_profile), to split the kernel's time by phase.
#ifdef TOURNAMENT_PROFILE
__device__ long long tournament_stamps[128];
#define STAMP(i)                                                  \
  do {                                                            \
    const int i_ = (i);                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0 && i_ < 128)          \
      tournament_stamps[i_] = clock64();                          \
  } while (0)
#else
#define STAMP(i) \
  do {           \
  } while (0)
#endif

struct TournamentArgs {
  const float* head;    // [N, Rk] raw headroom (clamped at 0 here)
  const float* req;     // [G, Rk], rows req_stride floats apart
  const float* k;       // [N, G4], zero past G
  const float* counts;  // [N, G], rows counts_stride floats apart
  const float* masks;   // [S, N], rows masks_stride floats apart
  const float* prices;  // [N]
  const float* pslot;   // [G]
  float* xg;            // global, stream tiers: x scratch [S, CL*SL, XS]
  float* rows_g;        // stream tier: group rows [S, 6 G4 + 4]; else null
  float* out;           // [S, 4]
  int req_stride, counts_stride, masks_stride;
  int S, N, G, Rk, iters;
  int SL, SPB, XS, CH;
  int GC;            // stream tier: groups of a req chunk (else 0)
  int RKW;           // floats of a req row in shared memory (req_width)
  int ksmem;         // the slice's k rows resident in shared memory
  int G4;            // G rounded up to a multiple of 4
  int SL4;           // SL rounded up to a multiple of 4
  int block_floats;  // req [G4, RKW] and the ring [NBUF, CH, G4]; stream
                     // tier: two req chunks [2, GC, RKB]
  int lane_floats;   // one subset's region
};

__host__ __device__ inline int round4(int f) { return (f + 3) & ~3; }

// Where a subset's x and group rows live: x in shared memory (block and
// cluster tiers), x in global scratch (global tier), or x and the group
// rows in global memory (stream tier).
enum { T_SHARED = 0, T_GLOBAL = 1, T_STREAM = 2 };

// Row stride of x: G rounded up to a multiple of 4 whose quarter is odd, so
// that 8 threads reading 16-byte pieces of 8 node rows hit distinct banks.
__host__ __device__ inline int x_stride(int G) {
  const int g4 = round4(G);
  return (g4 / 4) % 2 == 1 ? g4 : g4 + 4;
}

// Floats of the block's shared rows: req [G4, RKW] (RKW = req_width(Rk),
// zero past Rk and G) and the ring of k chunks [NBUF, CH, G4] (rows zero
// past G), or with ksmem the slice's k rows [CH = SL, G4].
__host__ __device__ inline int block_floats(int G, int RKW, int CH,
                                            bool ksmem) {
  return round4(G) * RKW + (ksmem ? 1 : NBUF) * CH * round4(G);
}

// Floats of one subset's shared region: x [SL, XS] (shared tiers); surv, m
// and scale [SL4] each; running sums [4 G4 + 4]; quotient and need [G4]
// (the group rows: in global memory on the stream tier).
__host__ __device__ inline int lane_floats(int SL, int XS, int G, bool xs,
                                           bool stream) {
  return (xs ? SL * XS : 0) + 3 * round4(SL) +
         (stream ? 0 : 6 * round4(G) + 4);
}

struct Lane {  // one subset's pieces of shared (and global) memory
  float *x, *surv, *m, *sc, *run, *q, *need;
};

template <int TIER>
__device__ __forceinline__ Lane lane_at(const TournamentArgs& a, float* smem,
                                        int j, int s, int CL, int n0) {
  constexpr bool XSMEM = TIER == T_SHARED;
  Lane L;
  float* b = smem + a.block_floats + (size_t)j * a.lane_floats;
  const size_t xsz = XSMEM ? (size_t)a.SL * a.XS : 0;
  L.x = XSMEM ? b : a.xg + ((size_t)s * CL * a.SL + n0) * a.XS;
  L.surv = b + xsz;
  L.m = L.surv + a.SL4;
  L.sc = L.m + a.SL4;
  // the stream tier's group rows: one global row a subset, shared by the
  // ranks of its cluster
  L.run = TIER == T_STREAM ? a.rows_g + (size_t)s * (6 * a.G4 + 4)
                           : L.sc + a.SL4;
  L.q = L.run + 4 * a.G4 + 4;
  L.need = L.q + a.G4;
  return L;
}

// Reads of the group rows (run, q, need). On the stream tier other blocks
// of the cluster wrote them in global memory: read at L2 (ld.global.cg),
// never from an L1 line this SM cached before.
template <int TIER>
__device__ __forceinline__ float gr1(const float* p) {
  if constexpr (TIER == T_STREAM) return __ldcg(p);
  return *p;
}
template <int TIER>
__device__ __forceinline__ float4 gr4(const float* p) {
  if constexpr (TIER == T_STREAM)
    return __ldcg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}
template <int TIER>
__device__ __forceinline__ float2 gr2(const float* p) {
  if constexpr (TIER == T_STREAM)
    return __ldcg(reinterpret_cast<const float2*>(p));
  return *reinterpret_cast<const float2*>(p);
}

// Item t of a pass over SPB subsets of `per` items each: (subset, item).
__device__ __forceinline__ int lane_of(int t, int per, int SPB) {
  return SPB == 1 ? 0 : t / per;
}

__device__ __forceinline__ void csync(cg::cluster_group& cluster, int CL) {
  if (CL > 1)
    cluster.sync();
  else
    __syncthreads();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}
// max(s k - x, 0): the slack of a (node, group) cell
__device__ __forceinline__ float slk(float s, float k, float x) {
  return fmaxf(__fsub_rn(__fmul_rn(s, k), x), 0.0f);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
// max(cap - x, 0) from cap itself: the same bits as slk(s, k, x) with
// cap = s k rounded
__device__ __forceinline__ float slkc(float cap, float x) {
  return fmaxf(__fsub_rn(cap, x), 0.0f);
}
__device__ __forceinline__ float2 slack2c(float2 c, float2 x) {
  return make_float2(slkc(c.x, x.x), slkc(c.y, x.y));
}
__device__ __forceinline__ float4 slack4c(float4 c, float4 x) {
  return make_float4(slkc(c.x, x.x), slkc(c.y, x.y), slkc(c.z, x.z),
                     slkc(c.w, x.w));
}
__device__ __forceinline__ float2 slack2(float s, float2 k, float2 x) {
  return make_float2(slk(s, k.x, x.x), slk(s, k.y, x.y));
}
__device__ __forceinline__ float4 slack4(float s, float4 k, float4 x) {
  return make_float4(slk(s, k.x, x.x), slk(s, k.y, x.y), slk(s, k.z, x.z),
                     slk(s, k.w, x.w));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The ring's chunks arrive by TMA bulk copies (cp.async.bulk), one a chunk,
// each completing the transaction bytes of its buffer's mbarrier. Every
// thread tracks the buffers' phases in `ph` (bit b = buffer b's parity).
struct Ring {
  float* buf;               // [NBUF, CH, G4]
  unsigned long long* bar;  // [NBUF] mbarriers
  unsigned ph;              // the phase bit each buffer waits on next
};

// The issuing thread (the last warp's first, so that the chain warps, the
// first, do not wait on it): chunk c of the slice's k rows (rows of G4
// floats, zero past G, so a chunk is one contiguous span) into buffer
// c % NBUF. The caller has made every thread's reads of that buffer happen
// before (a block barrier).
__device__ __forceinline__ void ring_issue(Ring& R, const float* kc, int c,
                                           int nch, int CH, int G4,
                                           int nloc) {
  if (threadIdx.x != ISSUER || c >= nch) return;
  const int b = c % NBUF;
  const unsigned bytes = (unsigned)(min(CH, nloc - c * CH) * G4 * 4);
  const unsigned bar = smem_u32(R.bar + b);
  const float* src = kc + (size_t)c * CH * G4;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(R.buf + (size_t)b * CH * G4)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The issuing thread waits until chunk c has landed in its buffer (every
// thread tracks the phase); the block barrier that follows every call hands
// the landed bytes to the other threads, which wait there without spinning
// on the shared memory pipe.
__device__ __forceinline__ void ring_wait(Ring& R, int c) {
  const int b = c % NBUF;
  const unsigned bar = smem_u32(R.bar + b);
  const unsigned parity = (R.ph >> b) & 1u;
  R.ph ^= 1u << b;
  if (threadIdx.x != ISSUER) return;
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// An elementwise pass's cells: thread t takes the quad u = t % Q of rows
// t / Q, t / Q + NT / Q, ... (one division a pass); where Q > NT, a warp a
// row instead.
struct Cells {
  int r0, rstep, u0, ustep;
};
__device__ __forceinline__ Cells cells(int Q, int tid, int nthreads) {
  Cells c;
  if (Q <= nthreads) {
    c.rstep = nthreads / Q;
    c.r0 = tid < c.rstep * Q ? tid / Q : 1 << 30;  // the rest sit out
    c.u0 = tid - (tid / Q) * Q;
    c.ustep = Q;  // one quad a thread
  } else {
    c.r0 = tid >> 5;
    c.u0 = tid & 31;
    c.rstep = nthreads >> 5;
    c.ustep = 32;
  }
  return c;
}

// The minimum of mn and the capacity ratios max(head, 0) / load of the
// columns [r0, r0 + RKB) below Rk (BIG for an unloaded column); load
// holds those columns' loads.
template <int RKB>
__device__ __forceinline__ float node_min(const TournamentArgs& a,
                                          const float* load, int n, int r0,
                                          float mn) {
  const float* hr = a.head + (size_t)n * a.Rk + r0;
#pragma unroll
  for (int r = 0; r < RKB; ++r) {
    if (r0 + r < a.Rk) {
      const float h = fmaxf(__ldg(hr + r), 0.0f);
      const float ratio =
          load[r] > R_EPS ? __fdiv_rn(h, fmaxf(load[r], R_EPS)) : R_BIG;
      mn = fminf(mn, ratio);
    }
  }
  return mn;
}

// A node's capacity scale from its minimum ratio: clip(mn, 0, 1).
__device__ __forceinline__ float clip01(float mn) {
  return fminf(fmaxf(mn, 0.0f), 1.0f);
}

// Tiles of RKB columns an instantiation walks: one, but past RMAX columns
// (the 32-column instantiation) ceil(Rk / 32).
template <int RKB>
__device__ __forceinline__ int col_end(const TournamentArgs& a) {
  return RKB == RMAX ? a.Rk : 1;
}

// The stream tier's req chunk c (groups [c GC, (c + 1) GC)) of the columns
// [r0, r0 + RKB) into shared buffer c & 1 as [GC, RKB]: one 4-byte
// cp.async an element, zero-filled past Rk and G; every thread issues its
// share and commits one group.
template <int RKB>
__device__ __forceinline__ void req_chunk_issue(const TournamentArgs& a,
                                                float* smem, int c, int r0) {
  float* dst = smem + (size_t)(c & 1) * a.GC * RKB;
  const int g0 = c * a.GC;
  for (int i = threadIdx.x; i < a.GC * RKB; i += NT) {
    const int g = g0 + i / RKB, r = r0 + i % RKB;
    const bool in = g < a.G && r < a.Rk;
    const float* src = in ? a.req + (size_t)g * a.req_stride + r : a.req;
    asm volatile(
        "cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
            smem_u32(dst + i)),
        "l"(src), "r"(in ? 4 : 0)
        : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The stream tier's node pass: one thread a node keeps its load over groups
// in registers while req streams through two shared buffers of GC groups,
// chunk c + 1 landing while the block works on chunk c (groups in group
// order, as on the other tiers); past RMAX columns, once a tile of
// columns. Every thread takes part in every chunk's copies and barriers,
// so the nodes go in rounds of NT.
template <int RKB>
__device__ void stream_scales(const TournamentArgs& a, float* smem, int s0,
                              int CL, int n0, int nloc) {
  const Lane L = lane_at<T_STREAM>(a, smem, 0, s0, CL, n0);
  const int nchunk = (a.G + a.GC - 1) / a.GC;
  for (int nb = 0; nb < nloc; nb += NT) {
    const int n = nb + threadIdx.x;
    const bool act = n < nloc;
    float mn = INFINITY;
    for (int r0 = 0; r0 < col_end<RKB>(a); r0 += RKB) {
      if (r0 > 0) __syncthreads();  // the last tile's chunks read out
      float load[RKB];
#pragma unroll
      for (int r = 0; r < RKB; ++r) load[r] = 0.0f;
      if (nchunk > 0) req_chunk_issue<RKB>(a, smem, 0, r0);
      for (int c = 0; c < nchunk; ++c) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();  // chunk c landed; chunk c - 1's buffer read out
        if (c + 1 < nchunk) req_chunk_issue<RKB>(a, smem, c + 1, r0);
        if (!act) continue;
        const int g0 = c * a.GC, g1 = min(g0 + a.GC, a.G4);
        const float* xp = L.x + (size_t)n * a.XS + g0;
        const float* qp = smem + (size_t)(c & 1) * a.GC * RKB;
        for (int g = g0; g < g1; g += 4, xp += 4, qp += 4 * RKB) {
          const float4 x4 = ld4(xp);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int r = 0; r < RKB; ++r)
              load[r] = __fadd_rn(load[r], __fmul_rn(xv[b], qp[b * RKB + r]));
        }
      }
      if (act) mn = node_min<RKB>(a, load, n0 + n, r0, mn);
    }
    if (act) L.sc[n] = clip01(mn);
    __syncthreads();  // the last chunk read out before the next round's
  }
}

// The capacity projection over the block's nodes: (a) one thread a node
// forms load[r] = sum_g x[n, g] req[g, r] in group order (x four groups a
// load; req from shared memory, zero past Rk and G, as x is past G; past
// RMAX columns a tile of 32 at a time) and the scale clip(min_r max(head,
// 0) / load, 0, 1); (b) every thread scales (node, 4-group) cells.
template <int TIER, int RKB>
__device__ void capacity_pass(const TournamentArgs& a, float* smem, int s0,
                              int CL, int n0, int nloc) {
  const int SL = a.SL, XS = a.XS, SPB = a.SPB, rows = SPB * SL;
  const int Q = a.G4 / 4;
  if constexpr (TIER == T_STREAM) {
    stream_scales<RKB>(a, smem, s0, CL, n0, nloc);
  } else {
    const float* sreq = smem;
    // req's row: RKB floats, or RKW (tiles of RKB) past RMAX columns
    const int RKW = RKB == RMAX ? a.RKW : RKB;
    for (int t = threadIdx.x; t < rows; t += NT) {
      const int j = lane_of(t, SL, SPB), n = t - j * SL;
      if (s0 + j >= a.S || n >= nloc) continue;
      const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
      float mn = INFINITY;
      for (int r0 = 0; r0 < col_end<RKB>(a); r0 += RKB) {
        const float* xp = L.x + (size_t)n * XS;
        const float* qp = sreq + r0;
        float load[RKB];
#pragma unroll
        for (int r = 0; r < RKB; ++r) load[r] = 0.0f;
        for (int u = 0; u < Q; ++u, xp += 4, qp += 4 * RKW) {
          const float4 x4 = ld4(xp);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int r = 0; r < RKB; ++r)
              load[r] = __fadd_rn(load[r], __fmul_rn(xv[b], qp[b * RKW + r]));
        }
        mn = node_min<RKB>(a, load, n0 + n, r0, mn);
      }
      L.sc[n] = clip01(mn);
    }
  }
  __syncthreads();
  const Cells e = cells(Q, threadIdx.x, NT);
  for (int row = e.r0; row < rows; row += e.rstep) {
    const int j = lane_of(row, SL, SPB), n = row - j * SL;
    if (s0 + j >= a.S || n >= nloc) continue;
    const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
    float* xr = L.x + (size_t)n * XS;
    const float sc = L.sc[n];
    for (int u = e.u0; u < Q; u += e.ustep)
      st4(xr + 4 * u, mul4(ld4(xr + 4 * u), sc));
  }
  __syncthreads();
}

// Passes over the rank's node slice in chunks of CH node rows, k's rows
// streaming through a ring of NBUF buffers (TMA bulk copies), or in one
// chunk with k resident (on the stream tier: in one chunk, k's rows read
// from global memory):
//   K_SEED   chains: cap's sum (and x = cap, with k streamed), colsum(k)
//            (four groups a thread),
//            need and the victims' k (a group a thread, over the victim
//            list, beside chunk 0), savings;
//   K_ITER   chains: sum x (four groups a thread), sum of the slack
//            max(cap - x, 0) (two groups a thread);
//   K_LAST   chains: sum x (no k, one chunk);
//   K_UPDATE elementwise: x += max(cap - x, 0) * q, four groups a thread.
// A chain adds the slice in node order into its slot of `run`, which starts
// from rank-1's running sums (0 on rank 0) and ends as this rank's (on the
// stream tier the ranks add into one global row in turn); it loads NB
// nodes before it adds them. Chunk c's step: the issuing thread
// waits for chunk c+1, one block barrier, it issues chunk c+3 into the
// buffer chunk c-1 left, and the block works on chunk c.
enum { K_SEED = 0, K_ITER = 1, K_LAST = 2, K_UPDATE = 3 };

template <int TIER, int KIND>
__device__ void slice_pass(const TournamentArgs& a, float* smem, Ring& R,
                           int s0, int CL, int rank, int n0, int nloc,
                           cg::cluster_group& cluster, const int* nvic) {
  constexpr bool STREAM = TIER == T_STREAM;
  // nodes a chain loads before it adds: enough in flight to cover the
  // shared memory's latency
  constexpr int NB = KIND == K_SEED ? 8 : 16;
  const int G = a.G, G4 = a.G4, Q = G4 / 4, XS = a.XS, SPB = a.SPB;
  const int CH = KIND == K_LAST || a.ksmem || STREAM ? max(nloc, 1) : a.CH;
  // items a subset, each chain kind on whole warps (QP = Q rounded up to
  // 32, HP = 2Q rounded up, the items past Q or 2Q idle) so that no warp
  // runs two kinds: K_SEED 2 QP + G + 1 (x = cap and its sum, colsum(k),
  // need and sub a group, savings), K_ITER QP + HP (x four groups a thread,
  // the slack two: its step per node weighs twice x's), K_LAST QP
  const int QP = (Q + 31) & ~31, HP = (2 * Q + 31) & ~31;
  const int per = KIND == K_SEED   ? 2 * QP + G + 1
                  : KIND == K_ITER ? QP + HP
                                   : QP;
  const int items = KIND == K_UPDATE ? 0 : SPB * per;
  const float* kc = a.k + (size_t)n0 * G4;
  const int tid = threadIdx.x;
  // else k is resident, or (stream tier) read from global memory
  const bool RING = !STREAM && KIND != K_LAST && !a.ksmem;
  // past the seed, a resident k of the block's one subset holds cap
  const bool capres = KIND != K_SEED && a.ksmem && SPB == 1;

  // running sums from rank-1's (each thread keeps to its own slots); on
  // the stream tier rank 0 starts the subset's one row from 0 and the
  // other ranks go on from where rank-1 left it
  for (int t = tid; t < (STREAM && rank > 0 ? 0 : items); t += NT) {
    const int j = lane_of(t, per, SPB), u = t - j * per;
    if (s0 + j >= a.S) continue;
    const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
    const float* prev = !STREAM && rank > 0
                            ? cluster.map_shared_rank(L.run, rank - 1)
                            : nullptr;
    if (KIND == K_ITER && u >= QP) {  // a pair of the slack's row
      const int pi = u - QP;
      if (pi >= 2 * Q) continue;
      const int o = G4 + 2 * pi;
      st2(L.run + o, prev ? ld2(prev + o) : make_float2(0.f, 0.f));
    } else if (u < 2 * QP) {  // a quad of the first two rows of run
      const int qi = u < QP ? u : u - QP;
      if (qi >= Q) continue;
      const int o = (u < QP ? 0 : G4) + 4 * qi;
      st4(L.run + o, prev ? ld4(prev + o) : make_float4(0.f, 0.f, 0.f, 0.f));
    } else if (u < 2 * QP + G) {  // need and sub of one group
      const int g = u - 2 * QP;
      L.run[2 * G4 + g] = prev ? prev[2 * G4 + g] : 0.0f;
      L.run[3 * G4 + g] = prev ? prev[3 * G4 + g] : 0.0f;
    } else {
      L.run[4 * G4] = prev ? prev[4 * G4] : 0.0f;
    }
  }
  const Cells ue = cells(Q, tid, NT);

  const int nch = (nloc + CH - 1) / CH;
  if (RING) {
    ring_issue(R, kc, 0, nch, CH, G4, nloc);
    ring_issue(R, kc, 1, nch, CH, G4, nloc);
    ring_issue(R, kc, 2, nch, CH, G4, nloc);
    if (nch > 0) ring_wait(R, 0);
  }
  for (int c = 0; c < nch; ++c) {
    const int nb = c * CH, cn = min(CH, nloc - nb);
    if (RING) {
      if (c + 1 < nch) ring_wait(R, c + 1);
      __syncthreads();  // chunk c+1 landed, chunk c-1 done with
    }
    if (RING) ring_issue(R, kc, c + 3, nch, CH, G4, nloc);
    const float* rk =
        STREAM ? kc + (size_t)nb * G4 : R.buf + (size_t)(c % NBUF) * CH * G4;
    if (KIND == K_UPDATE) {
      for (int row = ue.r0; row < SPB * cn; row += ue.rstep) {
        const int j = lane_of(row, cn, SPB), i = row - j * cn;
        if (s0 + j >= a.S) continue;
        const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
        float* xr = L.x + (size_t)(nb + i) * XS;
        const float sv = L.surv[nb + i];
        const float* kr = rk + (size_t)i * G4;
        for (int u = ue.u0; u < Q; u += ue.ustep) {
          const float4 x4 = ld4(xr + 4 * u), k4 = ld4(kr + 4 * u);
          const float4 sl = capres ? slack4c(k4, x4) : slack4(sv, k4, x4);
          st4(xr + 4 * u, add4(x4, mul4(sl, gr4<TIER>(L.q + 4 * u))));
        }
      }
      continue;
    }
    for (int t = tid; t < items; t += NT) {
      const int j = lane_of(t, per, SPB), u = t - j * per;
      if (s0 + j >= a.S) continue;
      const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
      if (KIND == K_SEED && u >= 2 * QP) {  // need and victims' k; savings
        // over the slice's victims, ascending (csrc: the mask phase lists
        // them in the subset's scale row), once, beside chunk 0's chains
        if (c > 0) continue;
        const bool sav = u == 2 * QP + G;
        const int g = sav ? 0 : u - 2 * QP;
        float v0 = gr1<TIER>(L.run + (sav ? 4 * G4 : 2 * G4 + g));
        float v1 = sav ? 0.0f : gr1<TIER>(L.run + 3 * G4 + g);
        const int* vic = reinterpret_cast<const int*>(L.sc);
        for (int v = 0; v < nvic[j]; ++v) {
          const int n = n0 + vic[v];
          const float mv = L.m[vic[v]];
          if (sav) {
            v0 = __fadd_rn(v0, __fmul_rn(mv, __ldg(a.prices + n)));
          } else {
            const float cv = __ldg(a.counts + (size_t)n * a.counts_stride + g);
            v0 = __fadd_rn(v0, __fmul_rn(mv, cv));
            v1 = __fadd_rn(v1, __fmul_rn(mv, __ldg(a.k + (size_t)n * G4 + g)));
          }
        }
        if (sav) {
          L.run[4 * G4] = v0;
        } else {
          L.run[2 * G4 + g] = v0;
          L.run[3 * G4 + g] = v1;
        }
        continue;
      }
      if (KIND == K_ITER && u >= QP) {  // the slack's sum, two groups
        const int pi = u - QP;
        if (pi >= 2 * Q) continue;
        const float* xp = L.x + (size_t)nb * XS + 2 * pi;
        const float* kp = rk + 2 * pi;
        const float* sp = L.surv + nb;
        float* rp = L.run + G4 + 2 * pi;
        float2 acc = gr2<TIER>(rp);
        int i = 0;
        if (capres) {  // the resident rows hold cap itself
          for (; i + NB <= cn; i += NB, xp += NB * XS, kp += NB * G4) {
            float2 sl[NB];
#pragma unroll
            for (int b = 0; b < NB; ++b)
              sl[b] = slack2c(ld2(kp + b * G4), ld2(xp + b * XS));
#pragma unroll
            for (int b = 0; b < NB; ++b) acc = add2(acc, sl[b]);
          }
          for (; i < cn; ++i, xp += XS, kp += G4)
            acc = add2(acc, slack2c(ld2(kp), ld2(xp)));
        } else {
          for (; i + NB <= cn; i += NB, xp += NB * XS, kp += NB * G4, sp += NB) {
            float2 sl[NB];
#pragma unroll
            for (int b = 0; b < NB; ++b)
              sl[b] = slack2(sp[b], ld2(kp + b * G4), ld2(xp + b * XS));
#pragma unroll
            for (int b = 0; b < NB; ++b) acc = add2(acc, sl[b]);
          }
          for (; i < cn; ++i, xp += XS, kp += G4, ++sp)
            acc = add2(acc, slack2(*sp, ld2(kp), ld2(xp)));
        }
        st2(rp, acc);
        continue;
      }
      // a quad of groups: x, k and survival walked by pointer
      const bool second = u >= QP;  // the second chain of the quad
      const int qi = second ? u - QP : u;
      if (qi >= Q) continue;
      const int o = 4 * qi;
      float* xp = L.x + (size_t)nb * XS + o;
      const float* kp = rk + o;
      const float* sp = L.surv + nb;
      float* rp = L.run + (second ? G4 : 0) + o;
      float4 acc = gr4<TIER>(rp);
      int i = 0;
      if (KIND == K_SEED && !second && a.ksmem) {  // cap's sum (x later)
        for (; i + NB <= cn; i += NB, kp += NB * G4, sp += NB) {
          float4 cap[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) cap[b] = mul4(ld4(kp + b * G4), sp[b]);
#pragma unroll
          for (int b = 0; b < NB; ++b) acc = add4(acc, cap[b]);
        }
        for (; i < cn; ++i, kp += G4, ++sp) acc = add4(acc, mul4(ld4(kp), *sp));
      } else if (KIND == K_SEED && !second) {  // x = cap and its sum
        for (; i + NB <= cn; i += NB, xp += NB * XS, kp += NB * G4, sp += NB) {
          float4 cap[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) cap[b] = mul4(ld4(kp + b * G4), sp[b]);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            acc = add4(acc, cap[b]);
            st4(xp + b * XS, cap[b]);
          }
        }
        for (; i < cn; ++i, xp += XS, kp += G4, ++sp) {
          const float4 cap = mul4(ld4(kp), *sp);
          acc = add4(acc, cap);
          st4(xp, cap);
        }
      } else if (KIND == K_SEED) {  // colsum(k)
        for (; i + NB <= cn; i += NB, kp += NB * G4) {
          float4 kv[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) kv[b] = ld4(kp + b * G4);
#pragma unroll
          for (int b = 0; b < NB; ++b) acc = add4(acc, kv[b]);
        }
        for (; i < cn; ++i, kp += G4) acc = add4(acc, ld4(kp));
      } else {  // x's sum
        for (; i + NB <= cn; i += NB, xp += NB * XS) {
          float4 xv[NB];
#pragma unroll
          for (int b = 0; b < NB; ++b) xv[b] = ld4(xp + b * XS);
#pragma unroll
          for (int b = 0; b < NB; ++b) acc = add4(acc, xv[b]);
        }
        for (; i < cn; ++i, xp += XS) acc = add4(acc, ld4(xp));
      }
      st4(rp, acc);
    }
  }
  __syncthreads();  // the ring and this pass's results free for the next
}

// The cluster's hand-offs, point to point: each block's mbarrier hand[0]
// completes when rank-1's running sums are in place, hand[1] when the last
// rank's quotient is; one thread waits (acquire, cluster scope) and the
// block barrier hands on. `ph` holds the parity each waits on next.
struct Hand {
  unsigned long long* bar;  // [2]
  unsigned ph;
};

// The shared::cluster address of rank r's copy of a shared variable.
__device__ __forceinline__ unsigned mapa(unsigned addr, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(r));
  return out;
}

// Thread 0, after a block barrier: arrive on rank r's hand[i] (release,
// cluster scope: the block's writes before it are seen by rank r's waiter).
__device__ __forceinline__ void hand_give(Hand& H, int i, int r) {
  const unsigned bar = mapa(smem_u32(H.bar + i), r);
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}

// Every thread: wait until this block's hand[i] completes.
__device__ __forceinline__ void hand_take(Hand& H, int i) {
  const unsigned bar = smem_u32(H.bar + i);
  const unsigned parity = (H.ph >> i) & 1u;
  H.ph ^= 1u << i;
  if (threadIdx.x == 0) {
    unsigned done = 0;
    while (!done)  // test_wait: no suspension between polls
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
  }
  __syncthreads();
}

// A pass's chains over the cluster: rank r takes its turn once rank r-1
// hands it its running sums, and hands them on.
template <int TIER, int KIND>
__device__ void chains(const TournamentArgs& a, float* smem, Ring& R, int s0,
                       int CL, int rank, int n0, int nloc,
                       cg::cluster_group& cluster, const int* nvic, Hand& H) {
  if (rank > 0) hand_take(H, 0);
  slice_pass<TIER, KIND>(a, smem, R, s0, CL, rank, n0, nloc, cluster, nvic);
  if (rank + 1 < CL && threadIdx.x == 0) hand_give(H, 0, rank + 1);
}

// The last rank, its quotient in place: hand it to every other rank, which
// copies it (on the stream tier reads it from the subset's global row).
template <int TIER>
__device__ void share_q(const TournamentArgs& a, float* smem, int s0, int CL,
                        int rank, int n0, cg::cluster_group& cluster,
                        Hand& H) {
  __syncthreads();
  if (CL == 1) return;
  if (rank == CL - 1) {
    if (threadIdx.x == 0)
      for (int r = 0; r + 1 < CL; ++r) hand_give(H, 1, r);
    return;
  }
  hand_take(H, 1);
  if constexpr (TIER == T_STREAM) return;
  const int Q = a.G4 / 4;
  for (int t = threadIdx.x; t < a.SPB * Q; t += NT) {
    const int j = lane_of(t, Q, a.SPB), u = t - j * Q;
    if (s0 + j >= a.S) continue;
    const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
    st4(L.q + 4 * u, ld4(cluster.map_shared_rank(L.q, CL - 1) + 4 * u));
  }
  __syncthreads();
}

template <int TIER, int RKB>
__global__ void __launch_bounds__(NT, 1) tournament_kernel(TournamentArgs a) {
  constexpr bool XSMEM = TIER == T_SHARED;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_ok[SPB_MAX];
  __shared__ int s_nv[SPB_MAX];  // victims in each subset's slice
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int G = a.G, G4 = a.G4, Q = G4 / 4, SL = a.SL, XS = a.XS;
  const int SPB = a.SPB;
  const int s0 = (int)(blockIdx.x / CL) * SPB;
  const int n0 = rank * SL;
  const int nloc = max(0, min(SL, a.N - n0));
  const bool last = rank == CL - 1;
  __shared__ __align__(8) unsigned long long s_bar[NBUF];
  __shared__ __align__(8) unsigned long long s_hand[2];
  Hand H;
  H.bar = s_hand;
  H.ph = 0;
  Ring R;
  R.buf = smem + (size_t)G4 * a.RKW;
  R.bar = s_bar;
  R.ph = 0;
  if (threadIdx.x == 0) {
    for (int b = 0; b < NBUF; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_u32(s_bar + b)));
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_u32(s_hand + b)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int stamp = 0;
  STAMP(stamp++);

  // 1. shared memory zeroed (the pads of req, the ring, x and the group
  // rows stay zero), then req (zero past Rk; the stream tier streams it in
  // each node pass), survival and mask
  if (threadIdx.x < SPB_MAX) s_ok[threadIdx.x] = 1;
  {
    const int total = a.block_floats + SPB * a.lane_floats;
    for (int i = 4 * threadIdx.x; i < total; i += 4 * NT)
      st4(smem + i, make_float4(0.f, 0.f, 0.f, 0.f));
    // the ring's zeros before the bulk copies that overwrite them (the ring
    // is written by those copies alone from here on)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (TIER == T_STREAM ? 0 : G * a.RKW);
       i += NT) {
    const int g = i / a.RKW, r = i - g * a.RKW;
    if (r < a.Rk) smem[i] = __ldg(a.req + (size_t)g * a.req_stride + r);
  }
  if (!XSMEM) {  // the global slices' pads
    for (int t = threadIdx.x; t < nloc * (XS - G); t += NT) {
      const int n = t / (XS - G), g = G + t - n * (XS - G);
      lane_at<TIER>(a, smem, 0, s0, CL, n0).x[(size_t)n * XS + g] = 0.0f;
    }
  }
  for (int t = threadIdx.x; t < SPB * SL; t += NT) {
    const int j = lane_of(t, SL, SPB), n = t - j * SL;
    if (s0 + j >= a.S || n >= nloc) continue;
    const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
    const float mv = a.masks[(size_t)(s0 + j) * a.masks_stride + n0 + n];
    L.m[n] = mv;
    L.surv[n] = __fsub_rn(1.0f, mv);
  }
  // each subset's victims in its slice, ascending, into its scale row
  // (free until the first capacity pass): a warp a subset, by ballots
  __syncthreads();
  for (int j = threadIdx.x >> 5; j < SPB; j += NWARP) {
    if (s0 + j >= a.S) continue;
    const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
    int* vic = reinterpret_cast<int*>(L.sc);
    const unsigned lanebit = threadIdx.x & 31;
    int base = 0;
    for (int nb = 0; nb < nloc; nb += 32) {
      const int n = nb + (int)lanebit;
      const bool hit = n < nloc && L.m[n] != 0.0f;
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if (hit) vic[base + __popc(bits & ((1u << lanebit) - 1u))] = n;
      base += __popc(bits);
    }
    if (lanebit == 0) s_nv[j] = base;
  }
  if (a.ksmem) {  // the slice's k rows, once
    ring_issue(R, a.k + (size_t)n0 * G4, 0, nloc > 0 ? 1 : 0, SL, G4, nloc);
    if (nloc > 0) ring_wait(R, 0);
  }
  csync(cluster, CL);  // every block started before its peers read it
  STAMP(stamp++);

  // 2. the seed's chains; on the last rank need, supply, feasibility and
  // the seed's quotient q = need / (sum cap + EPS); then x = cap * q
  chains<TIER, K_SEED>(a, smem, R, s0, CL, rank, n0, nloc, cluster, s_nv,
                        H);
  STAMP(stamp++);
  if (last) {
    for (int t = threadIdx.x; t < SPB * G; t += NT) {
      const int j = lane_of(t, G, SPB), g = t - j * G;
      if (s0 + j >= a.S) continue;
      const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
      const float nd = gr1<TIER>(L.run + 2 * G4 + g);
      const float supply = __fsub_rn(gr1<TIER>(L.run + G4 + g),
                                     gr1<TIER>(L.run + 3 * G4 + g));
      if (!(nd <= __fadd_rn(supply, T_EPS) || nd == 0.0f)) s_ok[j] = 0;
      L.need[g] = nd;
      L.q[g] = __fdiv_rn(nd, __fadd_rn(gr1<TIER>(L.run + g), R_EPS));
    }
  }
  share_q<TIER>(a, smem, s0, CL, rank, n0, cluster, H);
  {
    const Cells e = cells(Q, threadIdx.x, NT);
    for (int row = e.r0; row < SPB * SL; row += e.rstep) {
      const int j = lane_of(row, SL, SPB), n = row - j * SL;
      if (s0 + j >= a.S || n >= nloc) continue;
      const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
      float* xr = L.x + (size_t)n * XS;
      if (!a.ksmem) {  // x holds cap since the seed's chains
        for (int u = e.u0; u < Q; u += e.ustep)
          st4(xr + 4 * u, mul4(ld4(xr + 4 * u), gr4<TIER>(L.q + 4 * u)));
        continue;
      }
      // cap from the resident k; with one subset a block the resident
      // rows keep it for the passes to come
      float* kr = R.buf + (size_t)n * G4;
      const float sv = L.surv[n];
      for (int u = e.u0; u < Q; u += e.ustep) {
        const float4 cap = mul4(ld4(kr + 4 * u), sv);
        if (SPB == 1) st4(kr + 4 * u, cap);
        st4(xr + 4 * u, mul4(cap, ld4(L.q + 4 * u)));
      }
    }
  }
  __syncthreads();
  STAMP(stamp++);

  // 3. iters x (capacity pass, demand pass)
  for (int it = 0; it < a.iters; ++it) {
    capacity_pass<TIER, RKB>(a, smem, s0, CL, n0, nloc);
    STAMP(stamp++);
    chains<TIER, K_ITER>(a, smem, R, s0, CL, rank, n0, nloc, cluster, s_nv,
                        H);
    STAMP(stamp++);
    if (last) {
      for (int t = threadIdx.x; t < SPB * G; t += NT) {
        const int j = lane_of(t, G, SPB), g = t - j * G;
        if (s0 + j >= a.S) continue;
        const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
        const float def = fmaxf(
            __fsub_rn(gr1<TIER>(L.need + g), gr1<TIER>(L.run + g)), 0.0f);
        L.q[g] = __fdiv_rn(def, __fadd_rn(gr1<TIER>(L.run + G4 + g), R_EPS));
      }
    }
    share_q<TIER>(a, smem, s0, CL, rank, n0, cluster, H);
    STAMP(stamp++);
    slice_pass<TIER, K_UPDATE>(a, smem, R, s0, CL, rank, n0, nloc, cluster,
                                s_nv);
    STAMP(stamp++);
  }

  // 4. the last capacity pass and sum of x; the residual and its sums over
  // groups (last rank)
  capacity_pass<TIER, RKB>(a, smem, s0, CL, n0, nloc);
  STAMP(stamp++);
  chains<TIER, K_LAST>(a, smem, R, s0, CL, rank, n0, nloc, cluster, s_nv,
                        H);
  STAMP(stamp++);
  if (last) {
    for (int t = threadIdx.x; t < SPB * G; t += NT) {
      const int j = lane_of(t, G, SPB), g = t - j * G;
      if (s0 + j >= a.S) continue;
      const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
      L.need[g] = fmaxf(
          __fsub_rn(gr1<TIER>(L.need + g), gr1<TIER>(L.run + g)), 0.0f);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < SPB; j += NT) {
      if (s0 + j >= a.S) continue;
      const Lane L = lane_at<TIER>(a, smem, j, s0 + j, CL, n0);
      float rs = 0.0f, rl = 0.0f;
      if constexpr (TIER == T_STREAM) {
        // the residual from global memory: 16 groups loaded before they
        // are added, in group order
        for (int g0 = 0; g0 < G; g0 += 16) {
          float nv[16], pv[16];
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            nv[b] = g0 + b < G ? gr1<TIER>(L.need + g0 + b) : 0.0f;
            pv[b] = g0 + b < G ? __ldg(a.pslot + g0 + b) : 0.0f;
          }
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            if (g0 + b < G) {
              rs = __fadd_rn(rs, nv[b]);
              rl = __fadd_rn(rl, __fmul_rn(nv[b], pv[b]));
            }
          }
        }
      } else {
        for (int g = 0; g < G; ++g) {
          rs = __fadd_rn(rs, L.need[g]);
          rl = __fadd_rn(rl, __fmul_rn(L.need[g], __ldg(a.pslot + g)));
        }
      }
      float* o = a.out + (size_t)(s0 + j) * 4;
      o[0] = s_ok[j] ? 1.0f : 0.0f;
      o[1] = gr1<TIER>(L.run + 4 * G4);
      o[2] = rs;
      o[3] = rl;
    }
  }
  STAMP(stamp++);
  (void)stamp;
  csync(cluster, CL);  // no block leaves while a peer may still read it
}

static cudaLaunchConfig_t cluster_cfg(int blocks, int CL, int smem_bytes,
                                      void* stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of CL blocks the card co-schedules at smem_bytes a block (0 if
// none), or a negative cudaError_t. The kernel's attributes are set, and
// the answer kept, for the last (CL, smem_bytes) asked.
struct ClusterMemo {
  int set_smem = -1, cl = 0, smem = -1, n = 0;
  bool nonportable = false;
};

template <int TIER, int RKB>
static int active_clusters(int CL, int smem_bytes) {
  // a function attribute belongs to one device, so the memo is per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  static ClusterMemo memos[MAX_DEVICES];
  ClusterMemo unmemoed;
  ClusterMemo& m = dev < MAX_DEVICES ? memos[dev] : unmemoed;
  if (CL == m.cl && smem_bytes == m.smem) return m.n;
  if (smem_bytes != m.set_smem) {
    e = cudaFuncSetAttribute(tournament_kernel<TIER, RKB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return -(int)e;
    m.set_smem = smem_bytes;
  }
  if (CL > 8 && !m.nonportable) {
    e = cudaFuncSetAttribute(tournament_kernel<TIER, RKB>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return -(int)e;
    m.nonportable = true;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(CL, CL, smem_bytes, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(
      &n, (const void*)tournament_kernel<TIER, RKB>, &cfg);
  if (e != cudaSuccess) return -(int)e;
  m.cl = CL;
  m.smem = smem_bytes;
  m.n = n;
  return n;
}

template <int TIER, int RKB>
static int launch(const TournamentArgs& a, int blocks, int CL, int smem_bytes,
                  void* stream) {
  const int n = active_clusters<TIER, RKB>(CL, smem_bytes);
  if (n < 0) return -n;
  if (n < 1) return -2;  // refused here, never run partly
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_cfg(blocks, CL, smem_bytes, stream, attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, tournament_kernel<TIER, RKB>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The instantiation carrying Rk columns in registers: Rk rounded up to a
// power of two, 2 to 32 (17 and more take the 32-column one, past 32 in
// tiles of 32).
__host__ __device__ inline int rk_bucket(int Rk) {
  return Rk <= 2 ? 2 : Rk <= 4 ? 4 : Rk <= 8 ? 8 : Rk <= 16 ? 16 : 32;
}

// Floats of req's row in shared memory: the instantiation's columns, or
// Rk rounded up to a whole tile of 32 past RMAX.
__host__ __device__ inline int req_width(int Rk) {
  return Rk <= RMAX ? rk_bucket(Rk) : (Rk + RMAX - 1) / RMAX * RMAX;
}

template <int TIER>
static int launch_rk(const TournamentArgs& a, int blocks, int CL,
                     int smem_bytes, void* stream) {
  if (a.Rk <= 2) return launch<TIER, 2>(a, blocks, CL, smem_bytes, stream);
  if (a.Rk <= 4) return launch<TIER, 4>(a, blocks, CL, smem_bytes, stream);
  if (a.Rk <= 8) return launch<TIER, 8>(a, blocks, CL, smem_bytes, stream);
  if (a.Rk <= 16) return launch<TIER, 16>(a, blocks, CL, smem_bytes, stream);
  return launch<TIER, 32>(a, blocks, CL, smem_bytes, stream);
}

// C interface (bound with ctypes). The source builds two libraries
// (ops/_build.BUILDS), compiled in parallel: as it is, with the block,
// cluster and global tiers, and with -DTOURNAMENT_STREAM_TIER, with the
// stream tier alone; each refuses (-1) a layout of the other's tiers.
// Pointers are device pointers; req,
// counts and masks rows are *_stride floats apart, k is [N, G4] (G rounded
// up to 4, zero past G, 16-byte aligned), everything else is contiguous.
// The layout (CL, SL, SPB, XS, CH, GC, x_smem, k_smem, smem_bytes) comes
// from optimizer/tournament_k.tournament_layout; xg is the x scratch of
// S*CL*SL*XS floats of the global and stream tiers (null on the shared
// tiers); GC > 0 selects the stream tier, whose group rows rows_g (S * (6
// G4 + 4) floats, zero past G) the caller allocates. One launch on
// `stream`; nothing synchronises. Returns the cudaError_t of the launch (0
// = launched), -1 for arguments it refuses, -2 when the card cannot
// co-schedule the cluster.
extern "C" int tournament_launch(const float* head, const float* req,
                                 int req_stride, const float* k,
                                 const float* counts, int counts_stride,
                                 const float* masks, int masks_stride,
                                 const float* prices, const float* pslot,
                                 float* xg, float* rows_g, float* out, int S,
                                 int N, int G, int Rk, int iters, int CL,
                                 int SL, int SPB, int XS, int CH, int GC,
                                 int x_smem, int k_smem, int smem_bytes,
                                 void* stream) {
  if (S <= 0) return 0;
  const bool stream_tier = GC > 0;
  if (N < 0 || G < 0 || Rk < 1 || iters < 0 || CL < 1 ||
      CL > CL_MAX || SL < 1 || (long long)CL * SL < N || SPB < 1 ||
      SPB > SPB_MAX || (SPB > 1 && CL > 1) || XS < G || CH < 1 || GC < 0 ||
      (x_smem != 0) != (xg == nullptr) || stream_tier != (rows_g != nullptr))
    return -1;
  if (stream_tier && (x_smem || k_smem || SPB != 1 || GC % 4 != 0))
    return -1;
  const int RKB = rk_bucket(Rk), RKW = req_width(Rk);
  if (k_smem && CH != SL) return -1;
  const int bf =
      stream_tier ? 2 * GC * RKB : block_floats(G, RKW, CH, k_smem != 0);
  const int lf = lane_floats(SL, XS, G, x_smem != 0, stream_tier);
  if (XS != x_stride(G) || 4LL * (bf + (long long)SPB * lf) > smem_bytes)
    return -1;
  TournamentArgs a;
  a.head = head;
  a.req = req;
  a.k = k;
  a.counts = counts;
  a.masks = masks;
  a.prices = prices;
  a.pslot = pslot;
  a.xg = xg;
  a.rows_g = rows_g;
  a.out = out;
  a.req_stride = req_stride;
  a.counts_stride = counts_stride;
  a.masks_stride = masks_stride;
  a.S = S;
  a.N = N;
  a.G = G;
  a.Rk = Rk;
  a.iters = iters;
  a.SL = SL;
  a.SPB = SPB;
  a.XS = XS;
  a.CH = CH;
  a.GC = GC;
  a.RKW = RKW;
  a.ksmem = k_smem;
  a.G4 = round4(G);
  a.SL4 = round4(SL);
  a.block_floats = bf;
  a.lane_floats = lf;
  const int blocks = (S + SPB - 1) / SPB * CL;
#ifdef TOURNAMENT_STREAM_TIER
  if (!stream_tier) return -1;
  return launch_rk<T_STREAM>(a, blocks, CL, smem_bytes, stream);
#else
  if (stream_tier) return -1;
  if (x_smem) return launch_rk<T_SHARED>(a, blocks, CL, smem_bytes, stream);
  return launch_rk<T_GLOBAL>(a, blocks, CL, smem_bytes, stream);
#endif
}

// The largest cluster (a power of two <= 16) of kernel C the card can
// co-schedule at smem_bytes of dynamic shared memory a block, on `tier`
// (T_SHARED, T_GLOBAL or T_STREAM); 0 if none, -1 for a tier this
// library does not hold.
extern "C" int tournament_max_cluster(int smem_bytes, int tier) {
#ifdef TOURNAMENT_STREAM_TIER
  if (tier != T_STREAM) return -1;
#else
  if (tier != T_SHARED && tier != T_GLOBAL) return -1;
#endif
  int best = 0;
  for (int cl = 1; cl <= CL_MAX; cl *= 2) {
#ifdef TOURNAMENT_STREAM_TIER
    const int n = active_clusters<T_STREAM, 2>(cl, smem_bytes);
#else
    const int n = tier == T_SHARED
                      ? active_clusters<T_SHARED, 2>(cl, smem_bytes)
                      : active_clusters<T_GLOBAL, 2>(cl, smem_bytes);
#endif
    if (n >= 1) best = cl;
  }
  return best;
}

#ifdef TOURNAMENT_PROFILE
// Copies the stamps of the last launch (synchronising) into host[128].
extern "C" int tournament_profile(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, tournament_stamps,
                                   sizeof(long long) * 128);
}
#endif
