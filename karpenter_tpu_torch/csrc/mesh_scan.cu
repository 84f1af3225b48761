// mesh_scan: kernel M, one shard's part of the node-sharded group scan.
//
// Replaces the XLA programs karpenter_tpu/parallel/mesh.py::sharded_solve_fn
// (:66) and karpenter_tpu/ops/solver.py::_mesh_packed_fn (:1162): the
// reference's `lax.scan` over pod groups (solver.py:347-483) with the node
// axis split over a mesh, whose per-step prefix GSPMD turns into
// collectives. Shard s owns the contiguous node range [lo, lo + Ns),
// lo = s * Ns, and keeps that range's node state in its device's global
// memory for the whole scan: type, open flag, zone | captype << Z bits, cum
// [Ns, Rk], hosted-group words [Ns, W], and the step's kf and in-block
// prefix. The catalog rows, the per-group records of kernel B0
// (csrc/solve_scan.cu, run once on every shard) and nused are replicated.
//
// One launch per shard per step g = 0..Gp, one thread per node, nb blocks:
//   1. (g > 0) apply step g - 1. Warp 0 of each block sums the gathered
//      block totals of step g - 1 (a [S * nb] vector, all-gathered between
//      the launches by the host, outside the kernel): those of the blocks
//      below this one are its carry, all of them `placed`, both saturated
//      at count. Each thread's take is min(kf, count - min(carry + pre,
//      count)), clamped at 0; a block whose carry reaches count takes
//      nothing. Then the new nodes [nused, nused + n_new) that fall in the
//      thread's node open at B0's t_star. nused lives in hdr[parity] (the
//      launch reads slot (g-1)&1 and block 0 writes slot g&1), so no block
//      reads a slot another writes in the same launch.
//   2. (g < Gp) count step g: kf = min(k, count) for the thread's node (k
//      from headroom, eligibility, max_per_node - prior, as kernel B), one
//      block scan (64-bit, saturated at count) for the in-block exclusive
//      prefix and the block total, which goes to tot[b] for the next
//      gather.
// A thread's node state needs no barrier: only that thread reads or
// writes it. Nothing syncs across blocks or shards inside a launch.
//
// Bound: bytes. Per step it reads and writes each node's state once (a
// few tens of bytes a node) and writes one take a node; counted as the
// bytes the whole scan must move (inputs once, takes out once) it is far
// under a millisecond at HBM rate. What limits it is the chain of Gp steps
// times S shards of launches and the host's gather between steps: the
// design is the simple, right form of the sharded scan (a CUDA graph of
// the step loop is later work), and it makes no claim to speed on one
// card.
//
// Numerics are kernel B's (must match the reference's f32 expressions bit
// for bit): __fdiv_rn / __fsub_rn, the EPS add as its own rounded add,
// cum + take * req as __fadd_rn(cum, __fmul_rn(take, req)), -fmad=false;
// the prefix is integer and saturating where the reference's is f32 (exact
// below 2^24, and moot once it passes count).

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#define MAX_RK 32
#define BIG_F 1.0e9f
#define EPS_F 1.0e-4f  // == np.float32(1e-4)
#define NTM 256        // threads a block, one node each
#define NWM (NTM / 32)

// B0's per-group record (csrc/solve_scan.cu: the same layout)
#define REC_COUNT 0
#define REC_CAP 1
#define REC_GBITS 2
#define REC_TSTAR 3
#define REC_S 4
#define REC_OK 5
#define REC_TBITS 6
#define REC_PRIOR 7
#define REC_BANNED 8
#define REC_HDR 12

// kernel B's helpers, repeated here (each source builds on its own)
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

struct MeshArgs {
  const float* alloc;                   // [T, Rk]
  const unsigned long long* availbits;  // [T] (B0)
  const float* zovh;                    // [T, Z, Rk] or null
  const int* recs;                      // [Gp, RW] (B0)
  const int* prior;                     // [Gp, Ns] when prior_sharded
  const uint8_t* banned;                // [Gp, Ns] when banned_sharded
  int* type;                            // [Ns] node type (closed: kept)
  uint8_t* open;                        // [Ns]
  unsigned* bits;                       // [Ns] zone | captype << Z
  float* cum;                           // [Ns, Rk]
  unsigned* host;                       // [Ns, W] hosted-group words
  int* kf;                              // [Ns] this step's kf
  int* pre;                             // [Ns] in-block exclusive prefix
  int* tot;                             // [nb] block totals of this step
  int* takes;                           // [Gp, Ns]
  int* unsched;                         // [Gp]
  int* hdr;                             // [4]: nused[2] by parity, overflow
  int RW, prior_sharded, banned_sharded;
  int T, Z, C, Rk, W, Gp, Ns, lo, n_max, shard, nshards, nb, track;
};

__global__ void __launch_bounds__(NTM) mesh_step_kernel(MeshArgs a, int g,
                                                         const int* gtot) {
  __shared__ unsigned s_carry, s_tot;
  __shared__ long long s_warp[NWM];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int i = b * NTM + tid;
  const bool valid = i < a.Ns;
  const int n = a.lo + i;
  const int Z = a.Z, C = a.C, Rk = a.Rk, W = a.W, RW = a.RW;
  const int CW = (a.T + 31) / 32;
  const bool zon = a.zovh != nullptr;

  // --- 1. apply step g - 1 with the gathered block totals ---
  if (g > 0) {
    const int gp = g - 1;
    const int* rec = a.recs + (size_t)gp * RW;
    const int count = rec[REC_COUNT];
    const unsigned cnt = (unsigned)count;
    if (wid == 0) {
      const int j = a.shard * a.nb + b;  // this block's place in node order
      const int ntot = a.nshards * a.nb;
      unsigned long long below = 0, all = 0;  // < 2^31 terms: no wrap
      for (int e = lane; e < ntot; e += 32) {
        const unsigned long long v = (unsigned)gtot[e];
        all += v;
        below += e < j ? v : 0ull;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        below += __shfl_xor_sync(0xffffffffu, below, o);
        all += __shfl_xor_sync(0xffffffffu, all, o);
      }
      if (lane == 0) {
        s_carry = below < cnt ? (unsigned)below : cnt;
        s_tot = all < cnt ? (unsigned)all : cnt;
      }
    }
    __syncthreads();
    const unsigned carry = s_carry, tot = s_tot;
    const unsigned rem = cnt - tot;  // tot = placed
    const bool sched = rec[REC_OK] != 0 && rem > 0;
    const unsigned s = (unsigned)rec[REC_S];  // >= 1
    const unsigned want = sched ? (rem + s - 1u) / s : 0u;
    const int nused = a.hdr[gp & 1];
    const unsigned room = a.n_max > nused ? (unsigned)(a.n_max - nused) : 0u;
    const unsigned n_new = want < room ? want : room;
    if (b == 0 && tid == 0) {
      a.hdr[g & 1] = nused + (int)n_new;
      if (n_new < want) a.hdr[2] = 1;
      const unsigned long long put = (unsigned long long)n_new * s;
      a.unsched[gp] = (int)(sched ? (put < rem ? rem - put : 0ull) : rem);
    }
    if (valid) {
      const float* req = (const float*)(rec + REC_HDR);
      const unsigned gbits = (unsigned)rec[REC_GBITS];
      const int kf = a.kf[i];
      long long take = 0;
      if (kf > 0) {
        long long prefix = (long long)carry + a.pre[i];
        prefix = prefix < count ? prefix : count;
        const long long left = (long long)count - prefix;
        take = kf < left ? kf : left;
        take = take > 0 ? take : 0;
      }
      float* cp = a.cum + (size_t)i * Rk;
      if (take > 0) {
        const float tf = (float)take;
        for (int r = 0; r < Rk; ++r) cp[r] = __fadd_rn(cp[r], __fmul_rn(tf, req[r]));
        a.bits[i] &= gbits;
      }
      const long long pos = (long long)n - nused;
      long long on = 0;
      if (pos >= 0 && pos < (long long)n_new) {
        on = (long long)rem - pos * (long long)s;
        on = on < (long long)s ? on : (long long)s;
        on = on > 0 ? on : 0;
        a.type[i] = rec[REC_TSTAR];
        a.open[i] = 1;
        const float tf = (float)on;
        for (int r = 0; r < Rk; ++r) cp[r] = __fmul_rn(tf, req[r]);
        a.bits[i] = gbits & (unsigned)rec[REC_TBITS];
      }
      const long long gt = take + on;
      if (a.track && gt > 0) a.host[(size_t)i * W + (gp >> 5)] |= 1u << (gp & 31);
      a.takes[(size_t)gp * a.Ns + i] = (int)gt;
    }
  }

  // --- 2. count step g: kf, the in-block prefix, the block total ---
  if (g < a.Gp) {
    const int* rec = a.recs + (size_t)g * RW;
    const int count = rec[REC_COUNT], cap_per = rec[REC_CAP];
    const unsigned gbits = (unsigned)rec[REC_GBITS];
    const float* req = (const float*)(rec + REC_HDR);
    const unsigned* ccompat = (const unsigned*)(rec + REC_HDR + Rk);
    const unsigned* conf = ccompat + CW;
    const unsigned zlow = (1u << Z) - 1u;
    int kf = 0;
    if (valid && a.open[i] && count > 0) {
      const int t = a.type[i];
      const unsigned b2 = a.bits[i] & gbits;
      const unsigned zm2 = b2 & zlow, cm2 = b2 >> Z;
      bool elig = (ccompat[t >> 5] >> (t & 31)) & 1u;
      if (elig) {
        const unsigned long long ab = a.availbits[t];
        bool off = false;
        for (int z = 0; z < Z && !off; ++z)
          off = ((zm2 >> z) & 1u) &&
                ((ab >> (z * C)) & (unsigned long long)cm2) != 0ull;
        elig = off;
      }
      if (elig)
        elig = !(a.banned_sharded ? a.banned[(size_t)g * a.Ns + i] != 0
                                  : rec[REC_BANNED] != 0);
      if (elig && a.track)
        for (int w = 0; w < W; ++w)
          if (a.host[(size_t)i * W + w] & conf[w]) {
            elig = false;
            break;
          }
      if (elig) {
        const float* cp = a.cum + (size_t)i * Rk;
        float kc = BIG_F;
        for (int r = 0; r < Rk; ++r) {
          float ta = a.alloc[(size_t)t * Rk + r];
          if (zon) ta = __fsub_rn(ta, zone_reserve(a.zovh, t, r, zm2, Z, Rk));
          kc = fminf(kc, fit_ratio(__fsub_rn(ta, cp[r]), req[r]));
        }
        const int k_cap = (int)fmaxf(kc, 0.0f);  // kc <= BIG_F < 2^31
        const int pn = a.prior_sharded ? a.prior[(size_t)g * a.Ns + i]
                                       : rec[REC_PRIOR];
        const int cap_eff = cap_per - pn > 0 ? cap_per - pn : 0;
        kf = min(min(k_cap, cap_eff), count);
      }
    }
    // block scan in 64 bits (256 terms < 2^31 each), saturated at count
    long long v = kf;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long x = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += x;
    }
    if (lane == 31) s_warp[wid] = v;
    __syncthreads();
    long long woff = 0, btot = 0;
#pragma unroll
    for (int w = 0; w < NWM; ++w) {
      woff += w < wid ? s_warp[w] : 0;
      btot += s_warp[w];
    }
    const long long excl = woff + v - kf;
    if (valid) {
      a.kf[i] = kf;
      a.pre[i] = (int)(excl < count ? excl : count);
    }
    if (tid == 0) a.tot[b] = (int)(btot < count ? btot : (long long)count);
  }
}

// ---------------------------------------------------------------------------
// C interface (bound with ctypes). mesh_scan_new keeps one shard's launch
// arguments on the host and returns a handle (null for arguments the
// kernel does not take); mesh_scan_step launches step g on `stream` (no
// synchronisation) and returns its cudaError_t; mesh_scan_free drops the
// handle. Pointers are device pointers of the shard's device.
// ---------------------------------------------------------------------------

extern "C" void* mesh_scan_new(
    const float* alloc, const unsigned long long* availbits,
    const float* zovh, const int* recs, int RW, const int* prior,
    int prior_sharded, const uint8_t* banned, int banned_sharded, int* type,
    uint8_t* open, unsigned* bits, float* cum, unsigned* host, int* kf,
    int* pre, int* tot, int* takes, int* unsched, int* hdr, int T, int Z,
    int C, int Rk, int W, int Gp, int Ns, int lo, int n_max, int shard,
    int nshards, int track) {
  if (T < 1 || Gp < 1 || Rk < 1 || Rk > MAX_RK || Z < 1 || C < 1 || Z > 31 ||
      C > 31 || Z * C > 64 || Z + C > 32 || Ns < 1 || nshards < 1 ||
      shard < 0 || shard >= nshards || (long long)Ns * nshards != n_max ||
      lo != shard * Ns || RW % 4 != 0 || (track && W < (Gp + 31) / 32))
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
  return a;
}

extern "C" int mesh_scan_step(void* h, int g, const int* gtot, void* stream) {
  const MeshArgs* a = (const MeshArgs*)h;
  if (a == nullptr || g < 0 || g > a->Gp || (g > 0 && gtot == nullptr))
    return -1;
  mesh_step_kernel<<<a->nb, NTM, 0, (cudaStream_t)stream>>>(*a, g, gtot);
  return (int)cudaGetLastError();
}

extern "C" void mesh_scan_free(void* h) { free(h); }
