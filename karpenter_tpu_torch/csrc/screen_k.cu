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
// Design: a 2-D grid over (node tile, group tile), one thread per (m, g).
// The block's req rows sit in shared memory; the R loop runs over a
// runtime R in registers. Everything is fp32. The TPU's 256 x 128 padding
// is not carried over: the ragged edge is masked here.
//
// Bound: bytes. Per (m, g) the kernel reads one elig byte and writes one
// f32 (head and req rows are tiny and reused), so at the main path's
// shape (a few thousand nodes x ~90 groups) it moves about 2 MB and is
// launch-bound on an H100.
//
// Numerics: the divide is IEEE round-to-nearest (__fdiv_rn) and the EPS add
// is a separate rounded add, as in the reference's f32 expression; build
// without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCREEN_BIG 1.0e9f
#define SCREEN_EPS 1.0e-4f  // == np.float32(1e-4)
#define TILE_G 32
#define TILE_N 8

__global__ void screen_k_kernel(const float* __restrict__ head,
                                const float* __restrict__ req,
                                const uint8_t* __restrict__ elig,
                                float* __restrict__ out,
                                int N, int G, int R) {
  extern __shared__ float sreq[];  // [TILE_G][R]: this block's req rows
  const int g0 = blockIdx.y * TILE_G;
  const int tid = threadIdx.y * TILE_G + threadIdx.x;
  for (int i = tid; i < TILE_G * R; i += TILE_G * TILE_N) {
    const int g = g0 + i / R;
    sreq[i] = (g < G) ? req[(size_t)g * R + i % R] : 0.0f;
  }
  __syncthreads();
  const int g = g0 + threadIdx.x;
  const int m = blockIdx.x * TILE_N + threadIdx.y;
  if (g >= G || m >= N) return;
  const float* h = head + (size_t)m * R;
  const float* q = sreq + threadIdx.x * R;
  float k = SCREEN_BIG;
  for (int r = 0; r < R; ++r) {
    const float qr = q[r];
    const float ratio =
        qr > 0.0f ? floorf(__fadd_rn(__fdiv_rn(h[r], qr), SCREEN_EPS))
                  : SCREEN_BIG;
    k = fminf(k, ratio);
  }
  const size_t o = (size_t)m * G + g;
  out[o] = elig[o] ? fmaxf(k, 0.0f) : 0.0f;
}

// C interface (bound with ctypes). Pointers are device pointers; the
// kernel runs on `stream` and does not synchronise. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int screen_k_launch(const float* head, const float* req,
                               const uint8_t* elig, float* out, int N, int G,
                               int R, void* stream) {
  if (N <= 0 || G <= 0) return 0;
  dim3 block(TILE_G, TILE_N);
  dim3 grid((N + TILE_N - 1) / TILE_N, (G + TILE_G - 1) / TILE_G);
  const size_t smem = sizeof(float) * TILE_G * (R > 0 ? R : 1);
  screen_k_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      head, req, elig, out, N, G, R);
  return (int)cudaGetLastError();
}
