// scan_common.cuh: what kernels B0 and B (solve_scan.cu) and kernel M
// (mesh_scan.cu) share: the layout of B0's per-group record, the zone and
// captype bit strings, and the f32 expressions both scans evaluate as the
// reference does (karpenter_tpu/ops/solver.py::_solve_kernel).
//
// Bit strings: zone z is bit z and captype c bit Z + c of a string of
// NB = ceil((Z + C) / 32) words (a node's and a group's); offering (z, c)
// of a type is bit z * C + c of its AW = ceil(Z * C / 64) u64 availability
// words, read as 2 * AW u32 words.
//
// The record (int32 words): the header below, the group's bit string [NB],
// t_star's [NB] (the zones it offers in some captype, the captypes it
// offers in some zone), req [Rk] (f32 bits), the compat bits
// [ceil(T / 32)], the conflict words [W], zero-padded to whole 16-byte
// chunks (kernel B prefetches it with cp.async).

#pragma once

#define BIG_F 1.0e9f
#define EPS_F 1.0e-4f  // == np.float32(1e-4)

#define REC_COUNT 0
#define REC_CAP 1     // max_per_node, BIG_I for 0
#define REC_TSTAR 2
#define REC_S 3       // max(slots[t_star], 1)
#define REC_OK 4      // best cost-per-slot < FLT_MAX
#define REC_PRIOR 5   // prior[g, 0] (prior_w == 1)
#define REC_BANNED 6  // banned[g, 0] (banned_w == 1)
#define REC_HDR 7     // then gbits [NB], tbits [NB], req [Rk], ...

__host__ __device__ __forceinline__ int node_words(int Z, int C) {
  return (Z + C + 31) >> 5;
}
__host__ __device__ __forceinline__ int avail_words(int Z, int C) {
  return (Z * C + 63) >> 6;
}
// the record's req offset
__host__ __device__ __forceinline__ int rec_req(int NB) {
  return REC_HDR + 2 * NB;
}

__device__ __forceinline__ float fit_ratio(float room, float q) {
  return q > 0.0f ? floorf(__fadd_rn(__fdiv_rn(room, q), EPS_F)) : BIG_F;
}

// Bit p of a string of words.
__device__ __forceinline__ unsigned bit_at(const unsigned* w, int p) {
  return (w[p >> 5] >> (p & 31)) & 1u;
}

// n (1..32) bits of a string of words from bit pos; reads a second word
// only where the bits run into it.
__device__ __forceinline__ unsigned bits_at(const unsigned* w, int pos,
                                            int n) {
  const int q = pos >> 5, s = pos & 31;
  unsigned v = w[q] >> s;
  if (s != 0 && s + n > 32) v |= w[q + 1] << (32 - s);
  return n == 32 ? v : v & ((1u << n) - 1u);
}

// max over z of (zone z set ? zovh[t, z, r] : 0), the reference's
// where(mask, zovh, 0).max(axis=z); word(w) gives zones 32w..32w+31.
template <class Word>
__device__ __forceinline__ float zone_reserve(const float* zovh, int t, int r,
                                              int Z, int Rk, Word word) {
  const float* zr = zovh + (size_t)t * Z * Rk + r;
  float o = 0.0f;
  for (int z0 = 0; z0 < Z; z0 += 32) {
    const unsigned m = word(z0 >> 5);
    const int n = min(32, Z - z0);
    for (int j = 0; j < n; ++j) {
      const float v = ((m >> j) & 1u) ? zr[(size_t)(z0 + j) * Rk] : 0.0f;
      o = z0 + j == 0 ? v : fmaxf(o, v);
    }
  }
  return o;
}

// Whether a type offers some (z, c) with zone z and captype c set in both
// the node's bits nb and the group's bits gb (ab: the type's availability
// words). The captypes both allow are taken 32 at a time, once, before the
// zones.
__device__ __forceinline__ bool offer_in(const unsigned* ab,
                                         const unsigned* nb,
                                         const unsigned* gb, int Z, int C) {
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int n = min(32, C - c0);
    const unsigned cm = bits_at(nb, Z + c0, n) & bits_at(gb, Z + c0, n);
    if (cm == 0u) continue;
    for (int w = 0; w * 32 < Z; ++w) {
      unsigned m = nb[w] & gb[w];
      if (Z - w * 32 < 32) m &= (1u << (Z - w * 32)) - 1u;
      while (m != 0u) {
        const int z = w * 32 + __ffs(m) - 1;
        m &= m - 1u;
        if (bits_at(ab, z * C + c0, n) & cm) return true;
      }
    }
  }
  return false;
}
