// solve_scan: the provisioning solve's group scan on Hopper, in two kernels.
//
// Replaces the XLA program karpenter_tpu/ops/solver.py::_solve_kernel (the
// `lax.scan` over pod groups, solver.py:347-483).
//
// Both kernels take a request axis: a bucket of Bp solve requests that share
// one catalog (alloc, availbits, zovh) and one shape (Gp, n_max, Rk, W, ...)
// runs as ONE launch of each, grid (Gp, Bp) for B0 and (CL, Bp) for B with
// one cluster per request; the requests never wait on one another. This is
// the port of karpenter_tpu/ops/solver.py::_solve_batched_impl (a jax.vmap
// of the scan over requests). Per request: the group inputs and records
// [Bp, Gp, ...], takes [Bp, Gp, n_max], unsched [Bp, Gp], ntype [Bp, n_max],
// hdr [Bp, 2] and the global-scratch slabs [Bp, CL, slab]; the starting node
// state is shared (a bucket's rows are fresh solves). Bp = 1 is the serial
// solve.
//
// Kernel B0, offer_argmin_kernel: one block per group, every group at once.
//   The reference's step 2 (solver.py:425-448) reads only the group's row
//   and the catalog, never node state, so it runs before the scan: slots
//   per type (alloc_eff with the zone-overhead branch, the max_per_node
//   clamp), the first-index argmin of price / max(slots, 1) over the T*Z*C
//   offerings, t_star, s = max(slots[t_star], 1), the `best < FLT_MAX` flag
//   and t_star's available zone and captype bits. It also packs what the
//   scan reads per group as bit sets (zone | captype << Z, the compat row,
//   the conflict row) into one record of RW int32 words per group, and
//   each type's available offerings into availbits[T].
//
// Kernel B, solve_scan_kernel: the scan, as ONE thread-block cluster of CL
//   blocks (cudaLaunchKernelEx). Block b owns the contiguous node slice
//   [b*S, (b+1)*S), so rank order is node order and first-fit order holds.
//   For the whole scan each block keeps in dynamic shared memory its slice's
//   node state (type with -1 = closed, zone | captype << Z bits, a kf
//   scratch, cum [Rk][S], hosted-group words) and the catalog rows it reads
//   per node (alloc, availbits, zovh). Where no cluster of <= 16 blocks
//   holds the node state, the slices live in global scratch: the same code
//   through a pointer, chosen by size (ops/solve_scan._scan_layout). Each
//   thread owns a few contiguous nodes of its block's slice for the whole
//   scan, so node state needs no barrier of its own. Per group step:
//     1. wait for the group's record (cp.async into a shared double buffer
//        while the previous step ran) and prefetch the next one;
//     2. each thread computes kf = min(k, count) for its nodes and sums them
//        (k = min_r floor(headroom / req + EPS) capped by max_per_node -
//        prior; 0 where the node is closed or not eligible);
//     3. one block scan of the thread sums: warp shuffles + one shared array;
//     4. warp 0 pushes the block total into slot [parity][rank] of every
//        rank's shared memory with st.async, each store completing 4 bytes
//        of that rank's mbarrier for the parity (a slot is rewritten two
//        steps later, after its readers are past the step between);
//     5. each block waits on its own mbarrier for the CL totals;
//     6. each thread sums them locally: the lower ranks' sum is the block's
//        carry, all of them `placed` (sums saturate at count, which keeps
//        them in 32 bits and leaves the takes exact);
//     7. each thread writes its nodes' takes, updates their state, and opens
//        the new nodes [nused, nused + n_new) that fall in its range, from
//        B0's record (nused is replicated in every thread).
//   cluster.sync() runs twice: after the prologue (every block started, its
//   mbarriers initialised) and at the end (no block leaves while a peer may
//   still store to it).
//
// Bound: counted as the bytes it must move (inputs once, takes out once:
// ~2.6 MB at the main path, under a microsecond at HBM rate) the scan is
// bytes-bound and its operations are far below the card's rates. What
// limits it is the dependent chain of Gp steps; the design keeps each
// step to two block barriers and one mbarrier exchange of CL words, and
// its loads in shared memory.
//
// Numerics (must match the reference's f32 expressions bit for bit):
//   - divides are __fdiv_rn, subtractions __fsub_rn; the EPS add is a
//     separate rounded add; the build uses -fmad=false;
//   - cum + take * req is __fadd_rn(cum, __fmul_rn(take, req)): no FMA
//     contraction (the host decode recomputes cum in numpy);
//   - the reference's f32 prefix is exact below 2^24 and moot once it
//     passes count; here the prefix is integer, its partial sums saturated
//     at count (a prefix at or past count takes nothing), so the takes are
//     the same;
//   - the argmin sentinel is FLT_MAX, the reference's float32 max; ties go
//     to the lower flat index; nothing feasible gives index 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_RK 32
#define BIG_I 1000000000
#define BIG_F 1.0e9f
#define EPS_F 1.0e-4f  // == np.float32(1e-4)

#define NT0 256  // B0 threads per block
#define NWARP0 (NT0 / 32)
#define NT 512   // B threads per block
#define NWARP (NT / 32)
#define CL_MAX 16
#define MAX_DEVICES 64  // devices a per-device memo keeps (others: no memo)

// the per-group record (int32 words) B0 writes and B reads
#define REC_COUNT 0
#define REC_CAP 1     // max_per_node, BIG_I for 0
#define REC_GBITS 2   // allow_zone | allow_cap << Z
#define REC_TSTAR 3
#define REC_S 4       // max(slots[t_star], 1)
#define REC_OK 5      // best cost-per-slot < FLT_MAX
#define REC_TBITS 6   // t_star's available zones | captypes << Z
#define REC_PRIOR 7   // prior[g, 0] (prior_w == 1)
#define REC_BANNED 8  // banned[g, 0] (banned_w == 1)
#define REC_HDR 12    // then req[Rk] (f32 bits), compat bits, conflict words

// (value, index) order of the argmin: smaller value, then lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// max over z of (zone bit set ? zovh[t, z, r] : 0), the reference's
// where(mask, zovh, 0).max(axis=z)
__device__ __forceinline__ float zone_reserve(const float* zovh, int t, int r,
                                              unsigned zm, int Z, int Rk) {
  float o = 0.0f;
  for (int z = 0; z < Z; ++z) {
    const float v = ((zm >> z) & 1u) ? zovh[((size_t)t * Z + z) * Rk + r]
                                     : 0.0f;
    o = z == 0 ? v : fmaxf(o, v);
  }
  return o;
}

__device__ __forceinline__ float fit_ratio(float room, float q) {
  return q > 0.0f ? floorf(__fadd_rn(__fdiv_rn(room, q), EPS_F)) : BIG_F;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Kernel B0: the offer argmin pre-pass
// ---------------------------------------------------------------------------

struct OfferArgs {
  const float* alloc;     // [T, Rk]
  const float* price;     // [T*Z*C]
  const uint8_t* avail;   // [T*Z*C]
  const float* zovh;      // [T, Z, Rk] or null
  const float* req;       // [Bp, Gp, Rk], strides req_bstride, req_stride
  const int* counts;      // [Bp, Gp]
  const uint8_t* compat;  // [Bp, Gp, T]
  const uint8_t* gzone;   // [Bp, Gp, Z]
  const uint8_t* gcap;    // [Bp, Gp, C]
  const int* maxpn;       // [Bp, Gp], 0 = unlimited
  const int* prior;       // [Bp, Gp, prior_w]
  const uint8_t* banned;  // [Bp, Gp, banned_w]
  const uint8_t* conflict;  // [Bp, Gp, conf_w] or null
  int* recs;              // out [Bp, Gp, RW]
  unsigned long long* availbits;  // out [T], bit z*C+c
  long long req_bstride;
  int req_stride, prior_w, banned_w, conf_w, RW;
  int T, Z, C, Rk, W, Gp;
};

#ifdef SOLVE_SCAN_COUNT_WRITES
// debug build: counts the stores to availbits (T a launch when only the
// first request's blocks write it)
__device__ unsigned long long availbits_writes = 0;
#endif

__global__ void __launch_bounds__(NT0) offer_argmin_kernel(OfferArgs a) {
  extern __shared__ int s_slots[];  // [T]
  __shared__ float s_req[MAX_RK];
  __shared__ float s_bv[NWARP0];
  __shared__ int s_bi[NWARP0];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int T = a.T, Z = a.Z, C = a.C, Rk = a.Rk, ZC = Z * C;
  const size_t row = (size_t)b * a.Gp + g;  // [Bp, Gp] row of this block
  // the group's scalars, loaded up front so their latency overlaps the work
  const int count = a.counts[row], mp = a.maxpn[row];
  const int prior0 = a.prior[row * a.prior_w];
  const bool banned0 = a.banned[row * a.banned_w] != 0;
  const unsigned gz = __ballot_sync(
      0xffffffffu, lane < Z && a.gzone[row * Z + lane] != 0);
  const unsigned gc = __ballot_sync(
      0xffffffffu, lane < C && a.gcap[row * C + lane] != 0);
  const int cap_per = mp == 0 ? BIG_I : mp;
  if (tid < Rk)
    s_req[tid] = a.req[(size_t)b * a.req_bstride + (size_t)g * a.req_stride +
                       tid];

  // each type's available offerings as one word (catalog-only: the first
  // request's blocks write it, striding over the types)
  if (b == 0)
    for (int t = g * NT0 + tid; t < T; t += gridDim.x * NT0) {
      unsigned long long ab = 0;
      for (int f = 0; f < ZC; ++f)
        if (a.avail[(size_t)t * ZC + f]) ab |= 1ull << f;
      a.availbits[t] = ab;
#ifdef SOLVE_SCAN_COUNT_WRITES
      atomicAdd(&availbits_writes, 1ull);
#endif
    }
  __syncthreads();  // s_req

  // slots per type, for every type (s reads slots[t_star] even when no
  // offering is feasible, as the reference does)
  const uint8_t* gcompat = a.compat + row * T;
  for (int t = tid; t < T; t += NT0) {
    unsigned zm_open = 0;
    if (a.zovh != nullptr)
      for (int z = 0; z < Z; ++z) {
        if (!((gz >> z) & 1u)) continue;
        for (int c = 0; c < C; ++c)
          if (a.avail[(size_t)t * ZC + z * C + c]) {
            zm_open |= 1u << z;
            break;
          }
      }
    float st = BIG_F;
    for (int r = 0; r < Rk; ++r) {
      float al = a.alloc[(size_t)t * Rk + r];
      if (a.zovh != nullptr)
        al = __fsub_rn(al, zone_reserve(a.zovh, t, r, zm_open, Z, Rk));
      st = fminf(st, fit_ratio(al, s_req[r]));
    }
    const int si = (int)fmaxf(st, 0.0f);
    s_slots[t] = si < cap_per ? si : cap_per;
  }
  __syncthreads();

  // first-index argmin of price / max(slots, 1) over the feasible offerings;
  // each thread walks its types' offerings in index order
  float bv = FLT_MAX;
  int bi = INT_MAX;
  for (int t = tid; t < T; t += NT0) {
    const int si = s_slots[t];
    const bool tok = gcompat[t] && si >= 1;
    const float sf = (float)(si > 1 ? si : 1);
    const uint8_t* av = a.avail + (size_t)t * ZC;
    const float* pr = a.price + (size_t)t * ZC;
    for (int zc = 0, z = 0, c = 0; zc < ZC; ++zc) {
      const bool feas = tok && ((gz >> z) & 1u) && ((gc >> c) & 1u) && av[zc];
      const float v = feas ? __fdiv_rn(pr[zc], sf) : FLT_MAX;
      if (better(v, t * ZC + zc, bv, bi)) {
        bv = v;
        bi = t * ZC + zc;
      }
      if (++c == C) {
        c = 0;
        ++z;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    s_bv[wid] = bv;
    s_bi[wid] = bi;
  }
  __syncthreads();

  // warp 0 reduces the warps' candidates; every lane then knows t_star,
  // and lane zc reads t_star's offering zc
  int* rec = a.recs + row * a.RW;
  if (wid == 0) {
    bv = lane < NWARP0 ? s_bv[lane] : FLT_MAX;
    bi = lane < NWARP0 ? s_bi[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int t_star = bi == INT_MAX ? 0 : bi / ZC;
    const unsigned long long ab =
        (unsigned long long)__ballot_sync(
            0xffffffffu, lane < ZC && a.avail[(size_t)t_star * ZC + lane]) |
        ((unsigned long long)__ballot_sync(
             0xffffffffu,
             lane + 32 < ZC && a.avail[(size_t)t_star * ZC + lane + 32])
         << 32);
    if (lane == 0) {
      unsigned tz = 0, tc = 0;
      for (int z = 0; z < Z; ++z)
        for (int c = 0; c < C; ++c)
          if ((ab >> (z * C + c)) & 1ull) {
            tz |= 1u << z;
            tc |= 1u << c;
          }
      rec[REC_COUNT] = count;
      rec[REC_CAP] = cap_per;
      rec[REC_GBITS] = (int)(gz | (gc << Z));
      rec[REC_TSTAR] = t_star;
      rec[REC_S] = s_slots[t_star] > 1 ? s_slots[t_star] : 1;
      rec[REC_OK] = bv < FLT_MAX ? 1 : 0;
      rec[REC_TBITS] = (int)(tz | (tc << Z));
      rec[REC_PRIOR] = prior0;
      rec[REC_BANNED] = banned0 ? 1 : 0;
      for (int i = REC_BANNED + 1; i < REC_HDR; ++i) rec[i] = 0;
    }
  }
  if (tid < Rk) rec[REC_HDR + tid] = __float_as_int(s_req[tid]);
  // bit sets, one warp per word: compat row, then conflict row
  const int CW = (T + 31) / 32;
  for (int w = wid; w < CW; w += NWARP0) {
    const int t = w * 32 + lane;
    const unsigned word = __ballot_sync(0xffffffffu, t < T && gcompat[t]);
    if (lane == 0) rec[REC_HDR + Rk + w] = (int)word;
  }
  for (int w = wid; w < a.W; w += NWARP0) {
    const int j = w * 32 + lane;
    const bool bit =
        j < a.conf_w && a.conflict[row * a.conf_w + j] != 0;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) rec[REC_HDR + Rk + CW + w] = (int)word;
  }
  for (int i = REC_HDR + Rk + CW + a.W + tid; i < a.RW; i += NT0) rec[i] = 0;
}

// ---------------------------------------------------------------------------
// Kernel B: the scan, one thread-block cluster
// ---------------------------------------------------------------------------

struct ScanArgs {
  const float* alloc;                   // [T, Rk]
  const unsigned long long* availbits;  // [T] (B0)
  const float* zovh;                    // [T, Z, Rk] or null
  const int* recs;                      // [Bp, Gp, RW] (B0)
  const int* prior;                     // [Bp, Gp, prior_w]
  const uint8_t* banned;                // [Bp, Gp, banned_w]
  const int* node_type;                 // [n_max] (every request's start)
  const float* node_cum;                // [n_max, Rk], row stride cum_stride
  const uint8_t* node_zmask;            // [n_max, Z]
  const uint8_t* node_cmask;            // [n_max, C]
  const uint8_t* node_open;             // [n_max]
  int* ntype_out;                       // [Bp, n_max]
  int* takes;                           // [Bp, Gp, n_max]
  int* unsched;                         // [Bp, Gp]
  int* hdr;                             // [Bp, 2]: nused, overflow
  unsigned char* scratch;  // [Bp, CL] global slabs, or null = shared
  long long slab_bytes;
  int RW, prior_w, banned_w, cum_stride;
  int T, Z, C, Rk, W, Gp, n_max, n_used0, S, track;
};

__device__ __forceinline__ unsigned sat_add(unsigned x, unsigned y,
                                            unsigned cap) {
  const unsigned z = x + y;  // x, y <= cap < 2^31: no wrap
  return z < cap ? z : cap;
}

// Sums of the first k of 16 shared values and of all 16 (each <= cap),
// saturated at cap: four 16-byte loads and a tree of adds, no serial chain.
__device__ __forceinline__ void sums16(const unsigned* p, int k, unsigned cap,
                                       unsigned* below, unsigned* all) {
  const uint4* q = (const uint4*)p;
  unsigned long long lo = 0, tot = 0;  // 16 values < 2^31: no wrap
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 u = q[j];
    const unsigned x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      tot += x[e];
      lo += 4 * j + e < k ? x[e] : 0u;
    }
  }
  *below = lo < cap ? (unsigned)lo : cap;
  *all = tot < cap ? (unsigned)tot : cap;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The shared::cluster address of rank r's copy of a shared variable.
__device__ __forceinline__ unsigned mapa(unsigned addr, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(r));
  return out;
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
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

// NODES_SMEM / CAT_SMEM: node slices / catalog rows in shared memory (else
// in global scratch / read in place). One source, instantiated per layout,
// so shared accesses compile to shared-memory loads.
template <bool NODES_SMEM, bool CAT_SMEM>
__global__ void __launch_bounds__(NT, 1) solve_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(NWARP == 16 && CL_MAX == 16, "sums16 reads 16 values");
  __shared__ __align__(16) unsigned s_warp[NWARP];
  // [parity][rank], pushed by each rank; ranks >= CL stay 0
  __shared__ __align__(16) unsigned s_tot[2][CL_MAX];
  // [parity]: completes when all CL totals of a step have landed
  __shared__ __align__(8) unsigned long long s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int T = a.T, Z = a.Z, C = a.C, Rk = a.Rk, W = a.W, S = a.S;
  const int RW = a.RW, n_max = a.n_max, Gp = a.Gp;
  const bool zon = a.zovh != nullptr;
  const int CW = (T + 31) / 32;
  // this cluster's request: its rows of the per-request arrays
  const size_t b = blockIdx.y;
  const int* recs = a.recs + b * Gp * RW;
  const int* prior = a.prior + b * Gp * a.prior_w;
  const uint8_t* banned = a.banned + b * Gp * a.banned_w;
  int* takes = a.takes + b * Gp * n_max;
  int* unsched = a.unsched + b * Gp;
  int* ntype_out = a.ntype_out + b * n_max;
  int* hdr = a.hdr + 2 * b;

  // --- carve shared memory: records, catalog, node slice ---
  int* rec_buf = (int*)smem;  // [2][RW]
  unsigned char* p = smem + (size_t)2 * RW * 4;
  const unsigned long long* c_avail;
  const float* c_alloc;
  const float* c_zovh;
  if constexpr (CAT_SMEM) {
    unsigned long long* sa = (unsigned long long*)p;
    float* sl = (float*)(p + (size_t)T * 8);
    float* sz = sl + (size_t)T * Rk;
    for (int i = tid; i < T; i += NT) sa[i] = a.availbits[i];
    for (int i = tid; i < T * Rk; i += NT) sl[i] = a.alloc[i];
    if (zon)
      for (int i = tid; i < T * Z * Rk; i += NT) sz[i] = a.zovh[i];
    c_avail = sa;
    c_alloc = sl;
    c_zovh = sz;
    const size_t cat = (size_t)T * 8 + (size_t)T * Rk * 4 +
                       (zon ? (size_t)T * Z * Rk * 4 : 0);
    p += (cat + 15) & ~(size_t)15;
  } else {
    c_avail = a.availbits;
    c_alloc = a.alloc;
    c_zovh = a.zovh;
  }
  unsigned char* slab;
  if constexpr (NODES_SMEM) {
    slab = p;
  } else {
    slab = a.scratch + (b * CL + rank) * (size_t)a.slab_bytes;
  }
  int* s_type = (int*)slab;                   // [S], -1 = closed
  unsigned* s_bits = (unsigned*)(s_type + S);  // [S], zone | captype << Z
  int* s_kf = (int*)(s_bits + S);              // [S]
  float* s_cum = (float*)(s_kf + S);           // [Rk][S]
  unsigned* s_host = (unsigned*)(s_cum + (size_t)Rk * S);  // [S][W]

  // --- prologue: the slice's node state, once ---
  const int lo = rank * S;
  const int Sb = max(0, min(S, n_max - lo));  // valid nodes of the slice
  for (int i = tid; i < S; i += NT) {
    const int n = lo + i;
    int t = -1;
    unsigned bits = 0;
    if (i < Sb) {
      if (a.node_open[n]) t = a.node_type[n];
      for (int z = 0; z < Z; ++z)
        bits |= (unsigned)(a.node_zmask[(size_t)n * Z + z] != 0) << z;
      for (int c = 0; c < C; ++c)
        bits |= (unsigned)(a.node_cmask[(size_t)n * C + c] != 0) << (Z + c);
    }
    s_type[i] = t;
    s_bits[i] = bits;
    s_kf[i] = 0;
    for (int r = 0; r < Rk; ++r)
      s_cum[(size_t)r * S + i] =
          i < Sb ? a.node_cum[(size_t)n * a.cum_stride + r] : 0.0f;
    for (int w = 0; w < W; ++w) s_host[(size_t)i * W + w] = 0u;
  }
  if (tid < 2 * CL_MAX) s_tot[tid / CL_MAX][tid % CL_MAX] = 0u;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(&s_bar[0]))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(&s_bar[1]))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // record prefetches are issued by the highest threads, which own the
  // fewest nodes
  const int nchunk = RW / 4;  // 16-byte chunks of a record
  for (int i = NT - 1 - tid; i < nchunk; i += NT)
    cp_async16(rec_buf + 4 * i, recs + 4 * i);
  cp_async_commit();
  cluster.sync();  // every block has started, its barriers initialised

  const int P = (S + NT - 1) / NT;  // nodes a thread owns
  const int i0 = tid * P;
  const int i1 = min(i0 + P, Sb);
  const unsigned zlow = (1u << Z) - 1u;
  int nused = a.n_used0, overflow = 0;

  for (int g = 0; g < Gp; ++g) {
    // --- 1. this group's record; prefetch the next ---
    cp_async_wait_all();
    __syncthreads();  // record g visible; every thread is done with g - 1
    const int* rec = rec_buf + (g & 1) * RW;
    if (g + 1 < Gp) {
      int* nxt = rec_buf + ((g + 1) & 1) * RW;
      const int* src = recs + (size_t)(g + 1) * RW;
      for (int i = NT - 1 - tid; i < nchunk; i += NT)
        cp_async16(nxt + 4 * i, src + 4 * i);
    }
    cp_async_commit();
    const int count = rec[REC_COUNT], cap_per = rec[REC_CAP];
    const unsigned cnt = (unsigned)count;
    const unsigned gbits = (unsigned)rec[REC_GBITS];
    const float* req = (const float*)(rec + REC_HDR);
    const unsigned* ccompat = (const unsigned*)(rec + REC_HDR + Rk);
    const unsigned* conf = ccompat + CW;

    // --- 2. kf for this thread's nodes; sums saturate at count (a prefix
    // at or past count takes nothing, so the takes are exact) ---
    unsigned tsum = 0;
    for (int i = i0; i < i1; ++i) {
      const int t = s_type[i];
      int kf = 0;
      if (t >= 0 && count > 0) {
        const int n = lo + i;
        const unsigned b2 = s_bits[i] & gbits;
        const unsigned zm2 = b2 & zlow, cm2 = b2 >> Z;
        bool elig = (ccompat[t >> 5] >> (t & 31)) & 1u;
        if (elig) {
          const unsigned long long ab = c_avail[t];
          bool off = false;
          for (int z = 0; z < Z && !off; ++z)
            off = ((zm2 >> z) & 1u) &&
                  ((ab >> (z * C)) & (unsigned long long)cm2) != 0ull;
          elig = off;
        }
        if (elig)
          elig = !(a.banned_w > 1 ? banned[(size_t)g * a.banned_w + n] != 0
                                  : rec[REC_BANNED] != 0);
        if (elig && a.track)
          for (int w = 0; w < W; ++w)
            if (s_host[(size_t)i * W + w] & conf[w]) {
              elig = false;
              break;
            }
        if (elig) {
          float kc = BIG_F;
          for (int r = 0; r < Rk; ++r) {
            float ta = c_alloc[(size_t)t * Rk + r];
            if (zon) ta = __fsub_rn(ta, zone_reserve(c_zovh, t, r, zm2, Z, Rk));
            const float room = __fsub_rn(ta, s_cum[(size_t)r * S + i]);
            kc = fminf(kc, fit_ratio(room, req[r]));
          }
          const int k_cap = (int)fmaxf(kc, 0.0f);  // kc <= BIG_F < 2^31
          const int pn = a.prior_w > 1 ? prior[(size_t)g * a.prior_w + n]
                                       : rec[REC_PRIOR];
          const int cap_eff = cap_per - pn > 0 ? cap_per - pn : 0;
          kf = min(min(k_cap, cap_eff), count);
        }
      }
      s_kf[i] = kf;
      tsum = sat_add(tsum, (unsigned)kf, cnt);
    }

    // --- 3. block scan of the thread sums (saturating) ---
    unsigned v = tsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned x = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = sat_add(v, x, cnt);
    }
    unsigned excl = __shfl_up_sync(0xffffffffu, v, 1);
    excl = lane > 0 ? excl : 0u;
    if (lane == 31) s_warp[wid] = v;
    __syncthreads();
    unsigned woff, btot;
    sums16(s_warp, wid, cnt, &woff, &btot);
    // --- 4-6. push the block total into every rank's slot (st.async,
    // which completes 4 bytes of the rank's mbarrier transaction); wait
    // for all CL totals to land here; read them locally ---
    const int par = g & 1;
    const unsigned bar = smem_u32(&s_bar[par]);
    if (tid == 0)  // the phase's one arrival; a peer's bytes may land first
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                       "r"(bar),
                   "r"(CL * 4)
                   : "memory");
    if (wid == 0 && lane < CL)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], "
          "%1, [%2];" ::"r"(mapa(smem_u32(&s_tot[par][rank]), lane)),
          "r"(btot), "r"(mapa(bar, lane))
          : "memory");
    mbar_wait(bar, (unsigned)((g >> 1) & 1));
    unsigned low, tot;
    sums16(s_tot[par], rank, cnt, &low, &tot);

    // --- 7. takes, node state, new nodes ---
    const unsigned rem = cnt - tot;  // tot = min(sum of kf, count) = placed
    const bool sched = rec[REC_OK] != 0 && rem > 0;
    const unsigned s = (unsigned)rec[REC_S];  // >= 1
    const unsigned want = sched ? (rem + s - 1u) / s : 0u;  // < 2^32
    const unsigned room = n_max > nused ? (unsigned)(n_max - nused) : 0u;
    const unsigned n_new = want < room ? want : room;
    if (n_new < want) overflow = 1;
    if (rank == 0 && tid == 0) {
      const unsigned long long put = (unsigned long long)n_new * s;
      unsched[g] = (int)(sched ? (put < rem ? rem - put : 0ull) : rem);
    }
    const int t_star = rec[REC_TSTAR];
    const unsigned nbits = gbits & (unsigned)rec[REC_TBITS];
    // exclusive prefix at node i0 (each term <= count: no overflow)
    long long run = (long long)low + sat_add(woff, excl, cnt);
    for (int i = i0; i < i1; ++i) {
      const int n = lo + i;
      const int kf = s_kf[i];
      long long take = 0;
      if (kf > 0) {
        const long long left = (long long)count - run;
        take = kf < left ? kf : left;
        take = take > 0 ? take : 0;
        run += kf;
      }
      if (take > 0) {
        const float tf = (float)take;
        for (int r = 0; r < Rk; ++r) {
          float* cp = s_cum + (size_t)r * S + i;
          *cp = __fadd_rn(*cp, __fmul_rn(tf, req[r]));
        }
        s_bits[i] &= gbits;
      }
      const int pos = n - nused;
      long long on = 0;
      if (pos >= 0 && (unsigned)pos < n_new) {
        on = (long long)rem - (long long)pos * s;
        on = on < (long long)s ? on : (long long)s;
        on = on > 0 ? on : 0;
        s_type[i] = t_star;
        const float tf = (float)on;
        for (int r = 0; r < Rk; ++r)
          s_cum[(size_t)r * S + i] = __fmul_rn(tf, req[r]);
        s_bits[i] = nbits;
      }
      const long long gt = take + on;
      if (a.track && gt > 0) s_host[(size_t)i * W + (g >> 5)] |= 1u << (g & 31);
      takes[(size_t)g * n_max + n] = (int)gt;
    }
    nused += (int)n_new;
  }

  cp_async_wait_all();
  cluster.sync();  // no block leaves while a peer may still store to it
  for (int i = i0; i < i1; ++i) {
    const int n = lo + i;
    const int t = s_type[i];
    ntype_out[n] = t >= 0 ? t : a.node_type[n];
  }
  if (rank == 0 && tid == 0) {
    hdr[0] = nused;
    hdr[1] = overflow;
  }
}

// ---------------------------------------------------------------------------
// C interface (bound with ctypes). Pointers are device pointers; kernels run
// on `stream` and do not synchronise. Each returns the cudaError_t of its
// launch (0 = launched), -1 for arguments the kernel does not take, or -2
// (kernel B) when the card cannot co-schedule a cluster of CL blocks.
// ---------------------------------------------------------------------------

static bool shapes_ok(int T, int Z, int C, int Rk, int Gp, int Bp) {
  return T >= 1 && Gp >= 1 && Rk >= 1 && Rk <= MAX_RK && Z >= 1 && C >= 1 &&
         Z <= 31 && C <= 31 && Z * C <= 64 && Z + C <= 32 && Bp >= 1 &&
         Bp <= 65535;
}

extern "C" int offer_argmin_launch(
    const float* alloc, const float* price, const uint8_t* avail,
    const float* zovh, const float* req, long long req_bstride,
    int req_stride, const int* counts,
    const uint8_t* compat, const uint8_t* gzone, const uint8_t* gcap,
    const int* maxpn, const int* prior, int prior_w, const uint8_t* banned,
    int banned_w, const uint8_t* conflict, int conf_w, int* recs, int RW,
    unsigned long long* availbits, int T, int Z, int C, int Rk, int Gp, int W,
    int Bp, void* stream) {
  if (!shapes_ok(T, Z, C, Rk, Gp, Bp) || RW % 4 != 0) return -1;
  OfferArgs a;
  a.alloc = alloc;
  a.price = price;
  a.avail = avail;
  a.zovh = zovh;
  a.req = req;
  a.counts = counts;
  a.compat = compat;
  a.gzone = gzone;
  a.gcap = gcap;
  a.maxpn = maxpn;
  a.prior = prior;
  a.banned = banned;
  a.conflict = conflict;
  a.recs = recs;
  a.availbits = availbits;
  a.req_bstride = req_bstride;
  a.req_stride = req_stride;
  a.prior_w = prior_w;
  a.banned_w = banned_w;
  a.conf_w = conf_w;
  a.RW = RW;
  a.T = T;
  a.Z = Z;
  a.C = C;
  a.Rk = Rk;
  a.W = W;
  a.Gp = Gp;
  const size_t smem = sizeof(int) * (size_t)T;
  // a function attribute belongs to one device, so the memo of the largest
  // size set is kept per device (0: the default 48 KiB)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  static size_t smem_set[MAX_DEVICES];
  size_t* set = dev < MAX_DEVICES ? &smem_set[dev] : nullptr;
  if (smem > 48 * 1024 && (set == nullptr || smem > *set)) {
    e = cudaFuncSetAttribute(
        offer_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (set != nullptr) *set = smem;
  }
  offer_argmin_kernel<<<dim3(Gp, Bp), NT0, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel B's launch: one cluster of CL blocks for each of Bp requests.
static cudaLaunchConfig_t cluster_cfg(int CL, int Bp, int smem_bytes,
                                      void* stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, Bp, 1);
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

template <bool NS, bool CS>
static cudaError_t scan_attributes(int CL, int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      solve_scan_kernel<NS, CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e == cudaSuccess && CL > 8)
    e = cudaFuncSetAttribute(solve_scan_kernel<NS, CS>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <bool NS, bool CS>
static int launch_scan(const ScanArgs& a, int CL, int Bp, int smem_bytes,
                       void* stream) {
  cudaError_t e = scan_attributes<NS, CS>(CL, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(CL, Bp, smem_bytes, stream, attr);
  // a cluster that cannot be co-scheduled is refused here, not run partly;
  // one co-resident cluster suffices, as the requests' clusters never wait
  // on one another (more requests than fit run in waves)
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)solve_scan_kernel<NS, CS>, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return -2;
  e = cudaLaunchKernelEx(&cfg, solve_scan_kernel<NS, CS>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int solve_scan_launch(
    const float* alloc, const unsigned long long* availbits,
    const float* zovh, const int* recs, int RW, const int* prior, int prior_w,
    const uint8_t* banned, int banned_w, const int* node_type,
    const float* node_cum, int cum_stride, const uint8_t* node_zmask,
    const uint8_t* node_cmask, const uint8_t* node_open, int* ntype_out,
    int* takes, int* unsched, int* hdr, unsigned char* scratch,
    long long slab_bytes, int T, int Z, int C, int Rk, int W, int Gp,
    int n_max, int n_used0, int S, int cat_smem, int track, int CL,
    int smem_bytes, int nodes_smem, int Bp, void* stream) {
  if (!shapes_ok(T, Z, C, Rk, Gp, Bp) || RW % 4 != 0 || CL < 1 || CL > CL_MAX ||
      S < 1 || (long long)S * CL < n_max || (nodes_smem != 0) != (scratch == nullptr))
    return -1;
  ScanArgs a;
  a.alloc = alloc;
  a.availbits = availbits;
  a.zovh = zovh;
  a.recs = recs;
  a.prior = prior;
  a.banned = banned;
  a.node_type = node_type;
  a.node_cum = node_cum;
  a.node_zmask = node_zmask;
  a.node_cmask = node_cmask;
  a.node_open = node_open;
  a.ntype_out = ntype_out;
  a.takes = takes;
  a.unsched = unsched;
  a.hdr = hdr;
  a.scratch = scratch;
  a.slab_bytes = slab_bytes;
  a.RW = RW;
  a.prior_w = prior_w;
  a.banned_w = banned_w;
  a.cum_stride = cum_stride;
  a.T = T;
  a.Z = Z;
  a.C = C;
  a.Rk = Rk;
  a.W = W;
  a.Gp = Gp;
  a.n_max = n_max;
  a.n_used0 = n_used0;
  a.S = S;
  a.track = track;

  if (nodes_smem)
    return cat_smem ? launch_scan<true, true>(a, CL, Bp, smem_bytes, stream)
                    : launch_scan<true, false>(a, CL, Bp, smem_bytes, stream);
  return cat_smem ? launch_scan<false, true>(a, CL, Bp, smem_bytes, stream)
                  : launch_scan<false, false>(a, CL, Bp, smem_bytes, stream);
}

// The largest cluster (a power of two <= 16) of kernel B that the card can
// co-schedule with `smem_bytes` of dynamic shared memory per block; 0 when
// none can. chip_smoke.py logs it beside the chosen layout.
extern "C" int solve_scan_max_cluster(int smem_bytes) {
  if (scan_attributes<true, true>(CL_MAX, smem_bytes) != cudaSuccess) return 0;
  int best = 0;
  for (int cl = 1; cl <= CL_MAX; cl *= 2) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        cluster_cfg(cl, 1, smem_bytes, nullptr, attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(
            &n, (const void*)solve_scan_kernel<true, true>, &cfg) ==
            cudaSuccess &&
        n >= 1)
      best = cl;
  }
  return best;
}

#ifdef SOLVE_SCAN_COUNT_WRITES
// Debug build: the availbits stores since the last call (which zeroes the
// count), after the work queued so far; -1 on a CUDA error.
extern "C" long long offer_argmin_availbits_writes() {
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  if (cudaDeviceSynchronize() != cudaSuccess ||
      cudaMemcpyFromSymbol(&n, availbits_writes, sizeof n) != cudaSuccess ||
      cudaMemcpyToSymbol(availbits_writes, &zero, sizeof zero) != cudaSuccess)
    return -1;
  return (long long)n;
}
#endif
