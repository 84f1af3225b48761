// screen_k: the consolidation screen's per-(node, group) fit count.
//
// Replaces the Pallas TPU kernel karpenter_tpu/ops/pallas_screen.py
// (screen_k, body _k_kernel):
//
//   k[m, g] = elig[m, g] ? max(min_{r: req[g,r] > 0}
//                                  floor(head[m,r] / req[g,r] + EPS), 0)
//                        : 0          (BIG = 1e9 when the group requests
//                                      nothing)
//
// Design: the output is one flat N*G array. A grid of one wave (as many
// blocks as the SMs hold at once) strides over it; each thread computes 4
// consecutive outputs, reads their 4 elig bytes as one word and writes
// them with one 16-byte store (a masked ragged tail at the end). The whole req matrix
// (G*R floats) sits in shared memory, loaded once per block; head rows are
// read through the read-only path. Everything is fp32. The TPU's 256 x 128
// padding is not carried over.
//
// Bound: bytes. Per (m, g) the kernel reads one elig byte and writes one
// f32 (head and req rows are tiny and reused), so at the main path's
// shape (a few thousand nodes x ~90 groups) it moves about 2 MB: under a
// microsecond at HBM rate, so launch and ramp set its time. One wave with
// no per-tile barrier keeps the ramp and tail short.
//
// Numerics: the divide is IEEE round-to-nearest (__fdiv_rn) and the EPS add
// is a separate rounded add, as in the reference's f32 expression; build
// without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCREEN_BIG 1.0e9f
#define SCREEN_EPS 1.0e-4f  // == np.float32(1e-4)
#define NTA 256             // threads per block
#define SMEM_REQ_MAX (48 * 1024)

__device__ __forceinline__ float k_of(const float* __restrict__ h,
                                      const float* q, int R) {
  float k = SCREEN_BIG;
  for (int r = 0; r < R; ++r) {
    const float qr = q[r];
    const float ratio =
        qr > 0.0f ? floorf(__fadd_rn(__fdiv_rn(__ldg(h + r), qr), SCREEN_EPS))
                  : SCREEN_BIG;
    k = fminf(k, ratio);
  }
  return k;
}

__global__ void __launch_bounds__(NTA) screen_k_kernel(
    const float* __restrict__ head, const float* __restrict__ req,
    int req_stride, const uint8_t* __restrict__ elig, float* __restrict__ out,
    int N, int G, int R, int req_smem) {
  extern __shared__ float sreq[];  // [G][R] when req_smem
  const float* q = req;
  int qs = req_stride;
  if (req_smem) {
    for (int i = threadIdx.x; i < G * R; i += NTA)
      sreq[i] = req[(size_t)(i / R) * req_stride + i % R];
    __syncthreads();
    q = sreq;
    qs = R;
  }
  const long long total = (long long)N * G;
  const long long nquad = (total + 3) / 4;
  for (long long qi = (long long)blockIdx.x * NTA + threadIdx.x; qi < nquad;
       qi += (long long)gridDim.x * NTA) {
    const long long e0 = qi * 4;
    const bool whole = e0 + 4 <= total;
    const int cnt = whole ? 4 : (int)(total - e0);
    uint32_t eb = 0;
    if (whole) {
      eb = __ldg((const unsigned int*)(elig + e0));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < cnt) eb |= (uint32_t)elig[e0 + j] << (8 * j);
    }
    int m = (int)(e0 / G), g = (int)(e0 - (long long)m * G);
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < cnt && ((eb >> (8 * j)) & 0xffu))
        o[j] = fmaxf(k_of(head + (size_t)m * R, q + (size_t)g * qs, R), 0.0f);
      if (++g == G) {
        g = 0;
        ++m;
      }
    }
    if (whole) {
      *(float4*)(out + e0) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < cnt) out[e0 + j] = o[j];
    }
  }
}

// C interface (bound with ctypes). Pointers are device pointers (elig and
// out 16-byte aligned, as PyTorch allocates them); req rows are req_stride
// floats apart. The kernel runs on `stream` and does not synchronise.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int screen_k_launch(const float* head, const float* req,
                               int req_stride, const uint8_t* elig,
                               float* out, int N, int G, int R,
                               void* stream) {
  if (N <= 0 || G <= 0) return 0;
  if (((uintptr_t)elig & 3u) != 0 || ((uintptr_t)out & 15u) != 0) return -1;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t req_bytes = sizeof(float) * (size_t)G * (R > 0 ? R : 1);
  const int req_smem = req_bytes <= SMEM_REQ_MAX;
  // one wave: as many blocks as the SMs hold at once, striding over the rest
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, screen_k_kernel, NTA, req_smem ? req_bytes : 0);
  if (e != cudaSuccess) return (int)e;
  const long long nquad = ((long long)N * G + 3) / 4;
  long long blocks = (nquad + NTA - 1) / NTA;
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > wave) blocks = wave;
  screen_k_kernel<<<(int)blocks, NTA, req_smem ? req_bytes : 0,
                    (cudaStream_t)stream>>>(head, req, req_stride, elig, out,
                                            N, G, R, req_smem);
  return (int)cudaGetLastError();
}
