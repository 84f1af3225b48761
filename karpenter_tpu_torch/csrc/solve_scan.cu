// solve_scan: the provisioning solve's group scan, one thread block per
// solve.
//
// Replaces the XLA program karpenter_tpu/ops/solver.py::_solve_kernel (the
// `lax.scan` over pod groups, solver.py:347-483). In eager PyTorch each
// group step would be ~40 small launches; here the whole scan is ONE
// launch: the block loops over the Gp groups in order and strides the
// node axis (n_max) across its threads, in tiles of NT nodes.
//
// Per group step, in the reference's order:
//   1. per-node k_cap = min_r floor(headroom / req + EPS), with the
//      zone-overhead reservation subtracted when zone_ovh;
//   2. eligibility: open & compat & (zone & captype masks meet an
//      available offering) & !banned & !conflict-hosted;
//   3. a block-wide exclusive prefix over min(k, count) (int64, so it can
//      neither wrap nor round) and the clamped take;
//   4. the first-index argmin of price / slots over the T*Z*C offerings,
//      a block reduction on (value, index), ties to the lower index;
//   5. min(ceil(rem / s), n_max - nused) new nodes at that offering.
//
// State: node type, cum [n_max, Rk], zone and captype masks (as bit sets),
// the open flag and, when tracking conflicts, the hosted-group bit sets
// live in global scratch the wrapper allocates and initialises; the kernel
// updates them in place. Output: takes [Gp, n_max], unsched [Gp],
// hdr = {nused, overflow}; ntype is the node-type scratch itself.
//
// Bound: counted as the bytes it must move (inputs once, takes out once:
// ~2.6 MB at the main path, under a microsecond at HBM rate) it is
// bytes-bound, and the work per step, O(n_max * Rk + T*Z*C), is far
// below the card's rates. What limits it in practice is neither: the
// dependent chain of Gp steps, with a few block barriers each, on one
// SM. Shared-memory residency of the node state is later work.
//
// Numerics (must match the reference's f32 expressions bit for bit):
//   - divides are __fdiv_rn; the EPS add is a separate rounded add;
//   - cum + take * req is __fadd_rn(cum, __fmul_rn(take, req)): no FMA
//     contraction (the host decode recomputes cum in numpy);
//   - the reference's f32 prefix is exact below 2^24 and moot once it
//     passes count, so the int64 prefix gives the same takes;
//   - the argmin sentinel is FLT_MAX, the reference's float32 max.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#define NT 512           // threads per block
#define NWARP (NT / 32)
#define MAX_RK 32        // projected resource columns
#define BIG_I 1000000000
#define BIG_F 1.0e9f
#define EPS_F 1.0e-4f    // == np.float32(1e-4)

// Inclusive block scan of one int64 per thread; *total gets the block sum.
__device__ __forceinline__ long long block_incl_scan(long long v,
                                                     long long* s_warp,
                                                     long long* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) s_warp[wid] = v;
  __syncthreads();
  if (wid == 0) {
    long long w = lane < NWARP ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < NWARP) s_warp[lane] = w;
  }
  __syncthreads();
  const long long off = wid > 0 ? s_warp[wid - 1] : 0;
  *total = s_warp[NWARP - 1];
  __syncthreads();  // s_warp is reused by the next call
  return v + off;
}

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

__global__ void __launch_bounds__(NT) solve_scan_kernel(
    const float* __restrict__ alloc,               // [T, Rk]
    const float* __restrict__ price,               // [T*Z*C]
    const unsigned long long* __restrict__ availbits,  // [T], bit z*C+c
    const float* __restrict__ zovh,                // [T, Z, Rk] or null
    const float* __restrict__ req,                 // [Gp, Rk]
    const int* __restrict__ counts,                // [Gp]
    const uint8_t* __restrict__ compat,            // [Gp, T]
    const int* __restrict__ gzone,                 // [Gp] zone bits
    const int* __restrict__ gcap,                  // [Gp] captype bits
    const int* __restrict__ maxpn,                 // [Gp], 0 = unlimited
    const int* __restrict__ prior, int prior_w,    // [Gp, prior_w]
    const uint8_t* __restrict__ banned, int banned_w,  // [Gp, banned_w]
    const unsigned* __restrict__ confbits, int W,  // [Gp, W] or null
    int* __restrict__ ntype,                       // [n_max] in/out
    float* __restrict__ cum,                       // [n_max, Rk] in/out
    int* __restrict__ zbits,                       // [n_max] in/out
    int* __restrict__ cbits,                       // [n_max] in/out
    uint8_t* __restrict__ nopen,                   // [n_max] in/out
    unsigned* __restrict__ hosted,                 // [n_max, W] or null
    int* __restrict__ takes,                       // [Gp, n_max] out
    int* __restrict__ unsched,                     // [Gp] out
    int* __restrict__ hdr,                         // [2] out
    int T, int Z, int C, int Rk, int Gp, int n_max, int n_used0) {
  __shared__ float s_req[MAX_RK];
  __shared__ long long s_warp[NWARP];
  __shared__ float s_bv[NWARP];
  __shared__ int s_bi[NWARP];
  __shared__ int s_bs[NWARP];
  __shared__ int s_nused, s_tstar, s_s, s_nnew, s_tz, s_tc, s_rem;
  __shared__ int s_overflow;

  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int ZC = Z * C;
  const bool track = confbits != nullptr;
  if (tid == 0) {
    s_nused = n_used0;
    s_overflow = 0;
  }

  for (int g = 0; g < Gp; ++g) {
    const int count = counts[g];
    const int cap_per = maxpn[g] == 0 ? BIG_I : maxpn[g];
    const unsigned gz = (unsigned)gzone[g], gc = (unsigned)gcap[g];
    const uint8_t* gcompat = compat + (size_t)g * T;
    if (tid < Rk) s_req[tid] = req[(size_t)g * Rk + tid];
    __syncthreads();  // s_req, s_nused of the previous step

    // --- 1-3. fill open nodes in index order (first-fit) ---
    long long carry = 0;  // exclusive prefix at the tile's first node
    for (int base = 0; base < n_max; base += NT) {
      const int n = base + tid;
      long long kf = 0;
      unsigned zm2 = 0, cm2 = 0;
      if (n < n_max && nopen[n]) {
        const int t = ntype[n];
        zm2 = (unsigned)zbits[n] & gz;
        cm2 = (unsigned)cbits[n] & gc;
        bool elig = gcompat[t] != 0;
        if (elig) {
          const unsigned long long ab = availbits[t];
          bool off = false;
          for (int z = 0; z < Z && !off; ++z) {
            if (!((zm2 >> z) & 1u)) continue;
            for (int c = 0; c < C; ++c)
              if (((cm2 >> c) & 1u) && ((ab >> (z * C + c)) & 1ull)) {
                off = true;
                break;
              }
          }
          elig = off;
        }
        if (elig) elig = !banned[(size_t)g * banned_w + (banned_w > 1 ? n : 0)];
        if (elig && track) {
          for (int w = 0; w < W; ++w)
            if (hosted[(size_t)n * W + w] & confbits[(size_t)g * W + w]) {
              elig = false;
              break;
            }
        }
        if (elig) {
          float kc = BIG_F;
          for (int r = 0; r < Rk; ++r) {
            float ta = alloc[(size_t)t * Rk + r];
            if (zovh != nullptr)
              ta = __fsub_rn(ta, zone_reserve(zovh, t, r, zm2, Z, Rk));
            const float room = __fsub_rn(ta, cum[(size_t)n * Rk + r]);
            kc = fminf(kc, fit_ratio(room, s_req[r]));
          }
          const long long k_cap = (long long)fmaxf(kc, 0.0f);
          const int pn = prior[(size_t)g * prior_w + (prior_w > 1 ? n : 0)];
          const long long cap_eff = cap_per - pn > 0 ? cap_per - pn : 0;
          long long k = k_cap < cap_eff ? k_cap : cap_eff;
          kf = k < count ? k : count;
        }
      }
      long long tile_total;
      const long long incl = block_incl_scan(kf, s_warp, &tile_total);
      if (n < n_max) {
        const long long prefix = carry + incl - kf;
        long long tk = (long long)count - prefix;
        tk = kf < tk ? kf : tk;
        const int take = tk > 0 ? (int)tk : 0;
        takes[(size_t)g * n_max + n] = take;
        if (take > 0) {
          const float tf = (float)take;
          for (int r = 0; r < Rk; ++r) {
            float* cp = cum + (size_t)n * Rk + r;
            *cp = __fadd_rn(*cp, __fmul_rn(tf, s_req[r]));
          }
          zbits[n] = (int)zm2;
          cbits[n] = (int)cm2;
          if (track) hosted[(size_t)n * W + (g >> 5)] |= 1u << (g & 31);
        }
      }
      carry += tile_total;
    }
    // placed = min(sum(take), count) = min(sum(kf), count)
    const int rem = count - (int)(carry < count ? carry : count);

    // --- 4. cost-per-slot argmin over the offerings (only when needed) ---
    if (rem > 0) {
      float bv = FLT_MAX;
      int bi = INT_MAX, bs = 0;
      for (int t = tid; t < T; t += NT) {
        const unsigned long long ab = availbits[t];
        int si = 0;
        if (gcompat[t]) {
          unsigned zm_open = 0;
          if (zovh != nullptr)
            for (int z = 0; z < Z; ++z)
              if (((gz >> z) & 1u) && ((ab >> (z * C)) & ((1ull << C) - 1)))
                zm_open |= 1u << z;
          float st = BIG_F;
          for (int r = 0; r < Rk; ++r) {
            float a = alloc[(size_t)t * Rk + r];
            if (zovh != nullptr)
              a = __fsub_rn(a, zone_reserve(zovh, t, r, zm_open, Z, Rk));
            st = fminf(st, fit_ratio(a, s_req[r]));
          }
          si = (int)fmaxf(st, 0.0f);
          si = si < cap_per ? si : cap_per;
        }
        const float slots_f = (float)(si > 1 ? si : 1);
        for (int zc = 0; zc < ZC; ++zc) {
          const int z = zc / C, c = zc % C;
          const bool feas = gcompat[t] && ((gz >> z) & 1u) &&
                            ((gc >> c) & 1u) && ((ab >> zc) & 1ull) && si >= 1;
          const int f = t * ZC + zc;
          const float v = feas ? __fdiv_rn(price[f], slots_f) : FLT_MAX;
          if (better(v, f, bv, bi)) {
            bv = v;
            bi = f;
            bs = si;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, o);
        const int oi = __shfl_down_sync(0xffffffffu, bi, o);
        const int os = __shfl_down_sync(0xffffffffu, bs, o);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
          bs = os;
        }
      }
      if (lane == 0) {
        s_bv[wid] = bv;
        s_bi[wid] = bi;
        s_bs[wid] = bs;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < NWARP; ++w)
          if (better(s_bv[w], s_bi[w], bv, bi)) {
            bv = s_bv[w];
            bi = s_bi[w];
            bs = s_bs[w];
          }
        const bool sched = bv < FLT_MAX;
        const int t_star = bi == INT_MAX ? 0 : bi / ZC;
        const long long s = bs > 1 ? bs : 1;
        const long long want = sched ? (rem + s - 1) / s : 0;
        const int nused = s_nused;
        const long long room = n_max - nused > 0 ? n_max - nused : 0;
        const long long n_new = want < room ? want : room;
        if (n_new < want) s_overflow = 1;
        const long long placed_new =
            n_new * s < rem ? n_new * s : (long long)rem;
        unsched[g] = sched ? (int)(rem - placed_new) : rem;
        const unsigned long long ab = T > 0 ? availbits[t_star] : 0ull;
        unsigned tz = 0, tc = 0;
        for (int z = 0; z < Z; ++z)
          for (int c = 0; c < C; ++c)
            if ((ab >> (z * C + c)) & 1ull) {
              tz |= 1u << z;
              tc |= 1u << c;
            }
        s_tstar = t_star;
        s_s = (int)s;
        s_nnew = (int)n_new;
        s_tz = (int)tz;
        s_tc = (int)tc;
        s_rem = rem;
      }
      __syncthreads();

      // --- 5. open the new nodes ---
      const int nused = s_nused, n_new = s_nnew, s = s_s, r0 = s_rem;
      const int t_star = s_tstar;
      for (int n = tid; n < n_max; n += NT) {
        const int pos = n - nused;
        if (pos < 0 || pos >= n_new) continue;
        long long on = (long long)r0 - (long long)pos * s;
        on = on < s ? on : s;
        const int take = on > 0 ? (int)on : 0;
        takes[(size_t)g * n_max + n] = take;
        ntype[n] = t_star;
        const float tf = (float)take;
        for (int r = 0; r < Rk; ++r)
          cum[(size_t)n * Rk + r] = __fmul_rn(tf, s_req[r]);
        zbits[n] = (int)(gz & (unsigned)s_tz);
        cbits[n] = (int)(gc & (unsigned)s_tc);
        nopen[n] = 1;
        if (track && take > 0)
          hosted[(size_t)n * W + (g >> 5)] |= 1u << (g & 31);
      }
      __syncthreads();  // every thread has read s_nused
      if (tid == 0) s_nused = nused + n_new;
    } else if (tid == 0) {
      unsched[g] = rem;
    }
    __syncthreads();  // node state of this step is visible to the next
  }
  if (tid == 0) {
    hdr[0] = s_nused;
    hdr[1] = s_overflow;
  }
}

// C interface (bound with ctypes). Pointers are device pointers; null
// zovh / confbits / hosted switch zone overhead / conflict tracking off.
// The kernel runs on `stream` and does not synchronise. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int solve_scan_launch(
    const float* alloc, const float* price, const unsigned long long* availbits,
    const float* zovh, const float* req, const int* counts,
    const uint8_t* compat, const int* gzone, const int* gcap, const int* maxpn,
    const int* prior, int prior_w, const uint8_t* banned, int banned_w,
    const unsigned* confbits, int W, int* ntype, float* cum, int* zbits,
    int* cbits, uint8_t* nopen, unsigned* hosted, int* takes, int* unsched,
    int* hdr, int T, int Z, int C, int Rk, int Gp, int n_max, int n_used0,
    void* stream) {
  if (Rk > MAX_RK || Rk < 1 || Z > 31 || C > 31 || Z * C > 64) return -1;
  solve_scan_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      alloc, price, availbits, zovh, req, counts, compat, gzone, gcap, maxpn,
      prior, prior_w, banned, banned_w, confbits, W, ntype, cum, zbits, cbits,
      nopen, hosted, takes, unsched, hdr, T, Z, C, Rk, Gp, n_max, n_used0);
  return (int)cudaGetLastError();
}
