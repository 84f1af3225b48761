// mesh_scan: kernel M, the node-sharded group scan.
//
// Replaces the XLA programs karpenter_tpu/parallel/mesh.py::sharded_solve_fn
// (:66) and karpenter_tpu/ops/solver.py::_mesh_packed_fn (:1162): the
// reference's `lax.scan` over pod groups (solver.py:347-483) with the node
// axis split over a mesh, whose per-step prefix GSPMD turns into
// collectives. Shard s owns the contiguous node range [lo, lo + Ns),
// lo = s * Ns, and that range's node state: type, open flag, zone and
// captype bits (NB words a node, the bit strings of csrc/scan_common.cuh),
// cum [Ns, Rk], hosted-group words [Ns, W]. The catalog
// rows, the per-group records of kernel B0 (csrc/solve_scan.cu, run once on
// every shard) and nused are replicated. Each shard's blocks own
// contiguous pieces of its range, in node order: block j of the whole mesh
// (shard * blocks a shard + b) holds the nodes before block j + 1's.
//
// Every step g = 0..Gp - 1 has two halves, the same code in both kernels:
//   count: kf = min(k, count) for each node (k from headroom, eligibility,
//     max_per_node - prior, as kernel B), one block scan (64-bit) for the
//     in-block exclusive prefix and the block total, which is saturated at
//     count and exchanged between the blocks of every shard;
//   apply: the carry of block j is the saturated sum of the totals of the
//     blocks below j, `placed` the saturated sum of all of them. A node's
//     take is min(kf, count - min(carry + prefix, count)), clamped at 0.
//     Then the new nodes [nused, nused + n_new) that fall in the block's
//     range open at B0's t_star.
// All terms are non-negative, so min(sum min(x_i, c), c) = min(sum x_i, c):
// a take depends only on the count of pods that fit on the nodes before it,
// not on how the node axis is cut into shards and blocks
// (tests/test_torch_parallel.py holds the plain version, cut into 1 to 24
// shards, equal to the reference's _solve_kernel).
//
// Two routes, one per layout of the mesh (ops/mesh_scan.mesh_route):
//
// * Shards that share one card: mesh_persistent_kernel, ONE cooperative
//   launch a solve for all shards and all steps. The grid is S * nbp blocks
//   (nbp a shard), sized by the occupancy of the kernel so that every block
//   is co-resident; each thread owns a run of npt consecutive nodes of its
//   block's piece. A block keeps its nodes' type, open flag, bits, cum and
//   kf in shared memory for the whole scan (one read before step 0, one
//   write after the last); where a block's piece would pass the card's
//   shared memory (ops/mesh_scan.persistent_layout: past ~200k nodes a
//   mesh at Rk=32), the instantiation with NSMEM false works on the shards'
//   own arrays in global memory instead, with kf in a per-shard scratch,
//   still one launch and one barrier a step. The block totals of step g go
//   to the parity slot tot[g & 1]; one grid barrier (cooperative_groups
//   grid sync) stands between a step's count and its apply. A block
//   writing slot g & 1 at step g + 2 has passed step g + 1's barrier, which
//   every block reaches only after reading step g's totals, so one barrier
//   a step is enough. nused is computed by every block from the replicated
//   records, so no block waits on another for it. Where S shards outnumber
//   the blocks the card holds at once, the mesh takes the per-step route
//   below (ops/mesh_scan.card_route, from sizes, before any launch).
//
// * Shards on distinct cards: mesh_step_kernel, one launch a shard a step.
//   Each launch applies step g - 1 with the block totals of every shard,
//   which the host all-gathers between the launches (parallel/collectives),
//   then counts step g. The node state lives in the shard's global memory
//   between launches; nused lives in hdr[parity] (the launch reads slot
//   (g - 1) & 1 and block 0 writes slot g & 1). This is the one form that
//   crosses cards without a barrier in peer memory.
//
// Bound: bytes. The whole scan must read its inputs once and write its
// takes once, far under a millisecond at HBM rate. What the per-step route
// pays is (Gp + 1) x S launches and Gp gathers; the persistent route pays
// one launch and Gp grid barriers, plus the per-step node work of its
// busiest thread.
//
// Numerics are kernel B's (must match the reference's f32 expressions bit
// for bit): __fdiv_rn / __fsub_rn, the EPS add as its own rounded add,
// cum + take * req as __fadd_rn(cum, __fmul_rn(take, req)), -fmad=false;
// the prefix is integer and saturating where the reference's is f32 (exact
// below 2^24, and moot once it passes count).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

namespace cg = cooperative_groups;

#define NTM 256        // threads a block
#define NWM (NTM / 32)
// shared bytes a node of the persistent kernel: cum, type, bits, kf, open
#define NODE_SMEM(Rk, NB) (4 * (Rk) + 4 * (NB) + 9)

#include "scan_common.cuh"  // B0's record, the bit strings, kernel B's f32

// One shard's arguments. The per-step route passes it by value; the
// persistent route reads shard s's from a device array of S of them.
struct MeshArgs {
  const float* alloc;                   // [T, Rk]
  const unsigned long long* availbits;  // [T, AW] (B0)
  const float* zovh;                    // [T, Z, Rk] or null
  const int* recs;                      // [Gp, RW] (B0)
  const int* prior;                     // [Gp, Ns] when prior_sharded
  const uint8_t* banned;                // [Gp, Ns] when banned_sharded
  int* type;                            // [Ns] node type (closed: kept)
  uint8_t* open;                        // [Ns]
  unsigned* bits;                       // [Ns, NB] zone and captype bits
  float* cum;                           // [Ns, Rk]
  unsigned* host;                       // [Ns, W] hosted-group words
  int* kf;                              // [Ns] this step's kf (per-step)
  int* pre;                             // [Ns] in-block prefix (per-step)
  int* tot;                             // [nb] block totals (per-step)
  int* takes;                           // [Gp, Ns]
  int* unsched;                         // [Gp]
  int* hdr;                             // [4]: nused[2] by parity, overflow
  int RW, prior_sharded, banned_sharded;
  int T, Z, C, Rk, W, Gp, Ns, lo, n_max, shard, nshards, nb, track;
  int NB, AW, HW;  // bit words a node, availability words a type, the
                   // record's req offset
};

// --- the two halves of a step, shared by both kernels ----------------------

// kf = min(k, count) of shard row i at step g (kernel B's count), 0 when the
// node is closed or not eligible. t, open, bits (NB words), cp: the node's
// state.
__device__ __forceinline__ int node_kf(const MeshArgs& a, const int* rec,
                                       int g, int i, int t, bool open,
                                       const unsigned* bits, const float* cp) {
  const int count = rec[REC_COUNT];
  if (!open || count <= 0) return 0;
  const int Z = a.Z, C = a.C, Rk = a.Rk, W = a.W;
  const int CW = (a.T + 31) / 32;
  const unsigned* gb = (const unsigned*)(rec + REC_HDR);  // [NB]
  const float* req = (const float*)(rec + a.HW);
  const unsigned* ccompat = (const unsigned*)(rec + a.HW + Rk);
  const unsigned* conf = ccompat + CW;
  if (!((ccompat[t >> 5] >> (t & 31)) & 1u)) return 0;
  if (!offer_in((const unsigned*)(a.availbits + (size_t)t * a.AW), bits, gb,
                Z, C))
    return 0;
  if (a.banned_sharded ? a.banned[(size_t)g * a.Ns + i] != 0
                       : rec[REC_BANNED] != 0)
    return 0;
  if (a.track)
    for (int w = 0; w < W; ++w)
      if (a.host[(size_t)i * W + w] & conf[w]) return 0;
  float kc = BIG_F;
  for (int r = 0; r < Rk; ++r) {
    float ta = a.alloc[(size_t)t * Rk + r];
    if (a.zovh != nullptr)
      ta = __fsub_rn(ta, zone_reserve(a.zovh, t, r, Z, Rk, [&](int w) {
                       return bits[w] & gb[w];
                     }));
    kc = fminf(kc, fit_ratio(__fsub_rn(ta, cp[r]), req[r]));
  }
  const int k_cap = (int)fmaxf(kc, 0.0f);  // kc <= BIG_F < 2^31
  const int pn = a.prior_sharded ? a.prior[(size_t)g * a.Ns + i]
                                 : rec[REC_PRIOR];
  const int cap_per = rec[REC_CAP];
  const int cap_eff = cap_per - pn > 0 ? cap_per - pn : 0;
  return min(min(k_cap, cap_eff), count);
}

// Block-wide exclusive scan of one 64-bit term a thread (terms < 2^31, at
// most NTM * 2^31 in all: no wrap). Returns the thread's exclusive prefix,
// the block's total in *btot. Contains one __syncthreads.
__device__ __forceinline__ long long block_scan(long long v0, int lane,
                                                int wid, long long* s_warp,
                                                long long* btot) {
  long long v = v0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long x = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += x;
  }
  if (lane == 31) s_warp[wid] = v;
  __syncthreads();
  long long woff = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NWM; ++w) {
    woff += w < wid ? s_warp[w] : 0;
    all += s_warp[w];
  }
  *btot = all;
  return woff + v - v0;
}

// Warp 0: the saturated sums of one step's ntot block totals: those of the
// blocks below block j (its carry) and all of them (placed), each capped
// at cnt. The totals were written by other blocks (or launches): read past
// L1.
__device__ __forceinline__ void saturated_sums(const int* tot, int ntot,
                                               int j, unsigned cnt, int lane,
                                               unsigned* carry,
                                               unsigned* placed) {
  unsigned long long below = 0, all = 0;  // < 2^31 terms: no wrap
  for (int e = lane; e < ntot; e += 32) {
    const unsigned long long v = (unsigned)__ldcg(tot + e);
    all += v;
    below += e < j ? v : 0ull;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    below += __shfl_xor_sync(0xffffffffu, below, o);
    all += __shfl_xor_sync(0xffffffffu, all, o);
  }
  if (lane == 0) {
    *carry = below < cnt ? (unsigned)below : cnt;
    *placed = all < cnt ? (unsigned)all : cnt;
  }
}

// What step g does with `placed` pods placed on open nodes: the pods left
// (rem), whether the offer can take them, the nodes it wants and opens.
struct StepPlan {
  unsigned rem, s, want, n_new;
  bool sched;
};

__device__ __forceinline__ StepPlan plan_step(const int* rec,
                                              unsigned placed, int nused,
                                              int n_max) {
  StepPlan p;
  p.rem = (unsigned)rec[REC_COUNT] - placed;
  p.sched = rec[REC_OK] != 0 && p.rem > 0;
  p.s = (unsigned)rec[REC_S];  // >= 1
  p.want = p.sched ? (p.rem + p.s - 1u) / p.s : 0u;
  const unsigned room = n_max > nused ? (unsigned)(n_max - nused) : 0u;
  p.n_new = p.want < room ? p.want : room;
  return p;
}

__device__ __forceinline__ int plan_unsched(const StepPlan& p) {
  const unsigned long long put = (unsigned long long)p.n_new * p.s;
  return (int)(p.sched ? (put < p.rem ? p.rem - put : 0ull) : p.rem);
}

// Apply step gp to shard row i: its take, given `prefix` (the pods that fit
// on the nodes before it, saturated at count), then its opening if it is
// one of the step's new nodes; its take goes to takes[gp]. bits: the
// node's NB words, updated in place.
__device__ __forceinline__ void node_apply(const MeshArgs& a, const int* rec,
                                           int gp, int i, int kf,
                                           long long prefix,
                                           const StepPlan& p, int nused,
                                           int& t, uint8_t& open,
                                           unsigned* bits, float* cp) {
  const int count = rec[REC_COUNT], Rk = a.Rk;
  const float* req = (const float*)(rec + a.HW);
  const unsigned* gb = (const unsigned*)(rec + REC_HDR);  // [NB], then t_star's
  long long take = 0;
  if (kf > 0) {
    const long long left = (long long)count - prefix;
    take = kf < left ? kf : left;
    take = take > 0 ? take : 0;
  }
  if (take > 0) {
    const float tf = (float)take;
    for (int r = 0; r < Rk; ++r) cp[r] = __fadd_rn(cp[r], __fmul_rn(tf, req[r]));
    for (int w = 0; w < a.NB; ++w) bits[w] &= gb[w];
  }
  const long long pos = (long long)(a.lo + i) - nused;
  long long on = 0;
  if (pos >= 0 && pos < (long long)p.n_new) {
    on = (long long)p.rem - pos * (long long)p.s;
    on = on < (long long)p.s ? on : (long long)p.s;
    on = on > 0 ? on : 0;
    t = rec[REC_TSTAR];
    open = 1;
    const float tf = (float)on;
    for (int r = 0; r < Rk; ++r) cp[r] = __fmul_rn(tf, req[r]);
    for (int w = 0; w < a.NB; ++w) bits[w] = gb[w] & gb[a.NB + w];
  }
  const long long gt = take + on;
  if (a.track && gt > 0) a.host[(size_t)i * a.W + (gp >> 5)] |= 1u << (gp & 31);
  a.takes[(size_t)gp * a.Ns + i] = (int)gt;
}

// --- the per-step route: one launch a shard a step --------------------------

__global__ void __launch_bounds__(NTM) mesh_step_kernel(MeshArgs a, int g,
                                                         const int* gtot) {
  __shared__ unsigned s_carry, s_tot;
  __shared__ long long s_warp[NWM];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int i = b * NTM + tid;
  const bool valid = i < a.Ns;

  // --- 1. apply step g - 1 with the gathered block totals ---
  if (g > 0) {
    const int gp = g - 1;
    const int* rec = a.recs + (size_t)gp * a.RW;
    const int count = rec[REC_COUNT];
    if (wid == 0)
      saturated_sums(gtot, a.nshards * a.nb, a.shard * a.nb + b,
                     (unsigned)count, lane, &s_carry, &s_tot);
    __syncthreads();
    const int nused = a.hdr[gp & 1];
    const StepPlan p = plan_step(rec, s_tot, nused, a.n_max);
    if (b == 0 && tid == 0) {
      a.hdr[g & 1] = nused + (int)p.n_new;
      if (p.n_new < p.want) a.hdr[2] = 1;
      a.unsched[gp] = plan_unsched(p);
    }
    if (valid) {
      long long prefix = (long long)s_carry + a.pre[i];
      prefix = prefix < count ? prefix : count;
      int t = a.type[i];
      uint8_t open = a.open[i];
      node_apply(a, rec, gp, i, a.kf[i], prefix, p, nused, t, open,
                       a.bits + (size_t)i * a.NB, a.cum + (size_t)i * a.Rk);
      a.type[i] = t;
      a.open[i] = open;
    }
  }

  // --- 2. count step g: kf, the in-block prefix, the block total ---
  if (g < a.Gp) {
    const int* rec = a.recs + (size_t)g * a.RW;
    const int count = rec[REC_COUNT];
    const int kf = valid ? node_kf(a, rec, g, i, a.type[i],
                                         a.open[i] != 0,
                                         a.bits + (size_t)i * a.NB,
                                         a.cum + (size_t)i * a.Rk)
                         : 0;
    long long btot;
    const long long excl = block_scan(kf, lane, wid, s_warp, &btot);
    if (valid) {
      a.kf[i] = kf;
      a.pre[i] = (int)(excl < count ? excl : count);
    }
    if (tid == 0) a.tot[b] = (int)(btot < count ? btot : (long long)count);
  }
}

// --- the persistent route: one cooperative launch a solve -------------------

// Grid: S * nbp blocks of NTM threads, all co-resident. Block x serves
// shard x / nbp; its piece of the shard is the rows [b * chunk, (b + 1) *
// chunk) (b = x % nbp, chunk = npt * NTM), thread tid the rows b * chunk +
// tid * npt + [0, npt). tot: [2, S * nbp] scratch (no initial value).
// NSMEM: the piece's node state in dynamic shared memory, chunk *
// NODE_SMEM(Rk, NB) bytes; else none, the piece's rows of the shard's
// arrays (type, open, bits, cum and the kf scratch) read and written in
// place. Without NSMEM, at most 64 registers a thread: an SM then holds
// four blocks, not three, and the grid is as wide as the node state in
// global memory needs (PERF.md has the times on an H100).
template <bool NSMEM>
__global__ void __launch_bounds__(NTM, NSMEM ? 1 : 4) mesh_persistent_kernel(
    const MeshArgs* __restrict__ shards, int nbp, int npt, int* tot) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_carry, s_tot;
  __shared__ long long s_warp[NWM];
  cg::grid_group grid = cg::this_grid();
  const int j = blockIdx.x, ntot = gridDim.x;
  const int b = j % nbp, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const MeshArgs a = shards[j / nbp];
  const int Rk = a.Rk, Ns = a.Ns, chunk = npt * NTM;
  const int NB = a.NB;
  const size_t p0 = (size_t)b * chunk;  // the piece's first row in the shard
  float* s_cum = NSMEM ? (float*)smem : a.cum + p0 * Rk;  // [chunk, Rk]
  int* s_type = NSMEM ? (int*)(s_cum + (size_t)chunk * Rk)
                      : a.type + p0;                      // [chunk]
  unsigned* s_bits = NSMEM ? (unsigned*)(s_type + chunk)
                           : a.bits + p0 * NB;            // [chunk, NB]
  int* s_kf = NSMEM ? (int*)(s_bits + (size_t)chunk * NB)
                    : a.kf + p0;                          // [chunk]
  uint8_t* s_open = NSMEM ? (uint8_t*)(s_kf + chunk)
                          : a.open + p0;                  // [chunk]
  const int l0 = tid * npt;      // the thread's first row in the piece
  const int i0 = b * chunk + l0; // ... and in the shard

  for (int k = 0; k < (NSMEM ? npt : 0); ++k) {
    const int l = l0 + k, i = i0 + k;
    if (i >= Ns) break;
    s_type[l] = a.type[i];
    s_open[l] = a.open[i];
    for (int w = 0; w < NB; ++w)
      s_bits[(size_t)l * NB + w] = a.bits[(size_t)i * NB + w];
    for (int r = 0; r < Rk; ++r) s_cum[l * Rk + r] = a.cum[(size_t)i * Rk + r];
  }
  int nused = a.hdr[0];  // every block keeps the same chain
  bool clamped = false;

  for (int g = 0; g < a.Gp; ++g) {
    const int* rec = a.recs + (size_t)g * a.RW;
    const int count = rec[REC_COUNT];
    int* slot = tot + (size_t)(g & 1) * ntot;

    // count step g over the thread's run, then the block scan of the runs
    long long run = 0;
    for (int k = 0; k < npt; ++k) {
      const int l = l0 + k, i = i0 + k;
      int kf = 0;
      if (i < Ns)
        kf = node_kf(a, rec, g, i, s_type[l], s_open[l] != 0,
                           s_bits + (size_t)l * NB, s_cum + l * Rk);
      if (NSMEM || i < Ns) s_kf[l] = kf;  // global kf holds Ns rows
      run += kf;
    }
    long long btot;
    const long long excl = block_scan(run, lane, wid, s_warp, &btot);
    if (tid == 0) slot[j] = (int)(btot < count ? btot : (long long)count);
    grid.sync();  // every block's total of step g is in its slot

    // apply step g
    if (wid == 0)
      saturated_sums(slot, ntot, j, (unsigned)count, lane, &s_carry, &s_tot);
    __syncthreads();
    const StepPlan p = plan_step(rec, s_tot, nused, a.n_max);
    if (b == 0 && tid == 0) a.unsched[g] = plan_unsched(p);
    const long long carry = s_carry;
    long long pre = excl;
    for (int k = 0; k < npt; ++k) {
      const int l = l0 + k, i = i0 + k;
      if (i >= Ns) break;
      long long prefix = carry + (pre < count ? pre : count);
      prefix = prefix < count ? prefix : count;
      const int kf = s_kf[l];
      int t = s_type[l];
      uint8_t open = s_open[l];
      node_apply(a, rec, g, i, kf, prefix, p, nused, t, open,
                       s_bits + (size_t)l * NB, s_cum + l * Rk);
      s_type[l] = t;
      s_open[l] = open;
      pre += kf;
    }
    clamped |= p.n_new < p.want;
    nused += (int)p.n_new;
  }

  for (int k = 0; k < (NSMEM ? npt : 0); ++k) {
    const int l = l0 + k, i = i0 + k;
    if (i >= Ns) break;
    a.type[i] = s_type[l];
    a.open[i] = s_open[l];
    for (int w = 0; w < NB; ++w)
      a.bits[(size_t)i * NB + w] = s_bits[(size_t)l * NB + w];
    for (int r = 0; r < Rk; ++r) a.cum[(size_t)i * Rk + r] = s_cum[l * Rk + r];
  }
  // hdr[0] was read by every block of the shard before the first barrier
  if (b == 0 && tid == 0) {
    a.hdr[a.Gp & 1] = nused;
    a.hdr[2] = clamped ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// C interface (bound with ctypes). mesh_scan_new keeps one shard's launch
// arguments on the host and returns a handle (null for malformed
// arguments); mesh_scan_free drops it. Pointers are device pointers of the
// shard's device. Launches run on `stream` with no
// synchronisation and return their cudaError_t (-1: refused arguments).
//
// Per-step route: mesh_scan_step launches step g of one shard.
// Persistent route: mesh_scan_pack copies the S handles' arguments into
// host memory of S * mesh_scan_args_bytes() bytes, which the caller puts
// on the card; mesh_scan_coop_limits and mesh_scan_coop_occupancy give
// what the grid's layout needs; mesh_scan_coop makes the one launch. A
// dynamic shared size of 0 selects the instantiation whose node state
// stays in global memory (every shard's kf scratch allocated).
// ---------------------------------------------------------------------------

extern "C" void* mesh_scan_new(
    const float* alloc, const unsigned long long* availbits,
    const float* zovh, const int* recs, int RW, const int* prior,
    int prior_sharded, const uint8_t* banned, int banned_sharded, int* type,
    uint8_t* open, unsigned* bits, float* cum, unsigned* host, int* kf,
    int* pre, int* tot, int* takes, int* unsched, int* hdr, int T, int Z,
    int C, int Rk, int W, int Gp, int Ns, int lo, int n_max, int shard,
    int nshards, int track) {
  if (T < 1 || Gp < 1 || Rk < 1 || Z < 1 || C < 1 || Ns < 1 ||
      nshards < 1 || shard < 0 || shard >= nshards ||
      (long long)Ns * nshards != n_max || lo != shard * Ns || RW % 4 != 0 ||
      RW < rec_req(node_words(Z, C)) + Rk + (T + 31) / 32 ||
      (track && W < (Gp + 31) / 32))
    return nullptr;
  MeshArgs* a = (MeshArgs*)calloc(1, sizeof(MeshArgs));
  if (a == nullptr) return nullptr;
  a->alloc = alloc;
  a->availbits = availbits;
  a->zovh = zovh;
  a->recs = recs;
  a->prior = prior;
  a->banned = banned;
  a->type = type;
  a->open = open;
  a->bits = bits;
  a->cum = cum;
  a->host = host;
  a->kf = kf;
  a->pre = pre;
  a->tot = tot;
  a->takes = takes;
  a->unsched = unsched;
  a->hdr = hdr;
  a->RW = RW;
  a->prior_sharded = prior_sharded;
  a->banned_sharded = banned_sharded;
  a->T = T;
  a->Z = Z;
  a->C = C;
  a->Rk = Rk;
  a->W = W;
  a->Gp = Gp;
  a->Ns = Ns;
  a->lo = lo;
  a->n_max = n_max;
  a->shard = shard;
  a->nshards = nshards;
  a->nb = (Ns + NTM - 1) / NTM;
  a->track = track;
  a->NB = node_words(Z, C);
  a->AW = avail_words(Z, C);
  a->HW = rec_req(a->NB);
  return a;
}

extern "C" int mesh_scan_step(void* h, int g, const int* gtot, void* stream) {
  const MeshArgs* a = (const MeshArgs*)h;
  if (a == nullptr || a->kf == nullptr || a->pre == nullptr ||
      a->tot == nullptr || g < 0 || g > a->Gp || (g > 0 && gtot == nullptr))
    return -1;
  mesh_step_kernel<<<a->nb, NTM, 0, (cudaStream_t)stream>>>(*a, g, gtot);
  return (int)cudaGetLastError();
}

extern "C" void mesh_scan_free(void* h) { free(h); }

extern "C" int mesh_scan_args_bytes(void) { return (int)sizeof(MeshArgs); }

extern "C" int mesh_scan_pack(void* const* handles, int S, void* out,
                              int need_kf) {
  if (handles == nullptr || out == nullptr || S < 1) return -1;
  const MeshArgs* a0 = (const MeshArgs*)handles[0];
  for (int s = 0; s < S; ++s) {
    const MeshArgs* a = (const MeshArgs*)handles[s];
    if (a == nullptr || a0 == nullptr || a->shard != s || a->nshards != S ||
        a->Gp != a0->Gp || a->Ns != a0->Ns || a->Rk != a0->Rk ||
        a->n_max != a0->n_max || a->NB != a0->NB ||
        (need_kf && a->kf == nullptr))
      return -1;
    memcpy((char*)out + (size_t)s * sizeof(MeshArgs), a, sizeof(MeshArgs));
  }
  return 0;
}

// The persistent kernel's instantiation: node state in shared memory
// (smem > 0) or global.
static const void* persistent_fn(int smem) {
  return smem > 0 ? (const void*)mesh_persistent_kernel<true>
                  : (const void*)mesh_persistent_kernel<false>;
}

static cudaError_t allow_smem(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(persistent_fn(smem),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// out[0]: SMs of the current device; out[1]: the dynamic shared bytes a
// block of the persistent kernel may ask for; out[2]: 1 when the device
// takes cooperative launches.
extern "C" int mesh_scan_coop_limits(int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa, mesh_persistent_kernel<true>);
  if (e != cudaSuccess) return (int)e;
  out[1] = optin - (int)fa.sharedSizeBytes;
  return 0;
}

// out[0]: blocks of the persistent kernel an SM holds at once with `smem`
// dynamic shared bytes each (0: the instantiation with the node state in
// global memory).
extern "C" int mesh_scan_coop_occupancy(int smem, int* out) {
  if (smem < 0) return -1;
  cudaError_t e = allow_smem(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, persistent_fn(smem), NTM, (size_t)smem);
  return (int)e;
}

extern "C" int mesh_scan_coop(const void* args, int S, int nbp, int npt,
                              int smem, int* tot, void* stream) {
  if (args == nullptr || tot == nullptr || S < 1 || nbp < 1 || npt < 1 ||
      smem < 0)
    return -1;
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const MeshArgs* shards = (const MeshArgs*)args;
  void* params[] = {(void*)&shards, (void*)&nbp, (void*)&npt, (void*)&tot};
  e = cudaLaunchCooperativeKernel(
      persistent_fn(smem), dim3(S * nbp), dim3(NTM), params,
      (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
