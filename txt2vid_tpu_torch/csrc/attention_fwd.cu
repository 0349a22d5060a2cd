// Fused non-local attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `fused_attention` in
// txt2vid_tpu/ops/pallas_attention.py:43-131. Computes, per batch b,
//     o   = softmax(theta @ phi^T) @ g          (unscaled logits)
//     lse = logsumexp(theta @ phi^T, axis=-1)   (optional)
// for theta (B, N, d), phi (B, M, d), g (B, M, dv), without writing the N x M
// map to device memory.
//
// What bounds it: at the generator's shape (d = 4, dv = 16) every key costs a
// query row d + dv multiply-adds and one exponential against d + dv floats of
// K/V, so the work is scalar f32 arithmetic on the CUDA cores (d = 4 is below
// the tensor cores' K minimum of 16) and device-memory traffic is small beside
// it. The design keeps the arithmetic on registers and broadcast shared-memory
// reads: one thread owns one query row (its d query values and dv accumulators
// live in registers), a block stages tiles of phi and g in shared memory that
// every thread of a warp reads at the same address (a broadcast, no bank
// conflicts), and the online softmax rescales the accumulator once per chunk
// of keys rather than once per key.
//
// Inputs are f32 or bf16; arithmetic is f32. Ragged N and M are masked here
// (no exact-divisor block search as on the TPU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 128;   // query rows per block: one per thread
constexpr int kTileM = 64;   // key/value rows staged in shared memory per step
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D, int DV, int CHUNK>
__global__ void __launch_bounds__(kRows)
attention_fwd_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                     const T* __restrict__ g, T* __restrict__ o,
                     float* __restrict__ lse, int n, int m) {
  static_assert(kTileM % CHUNK == 0, "a chunk must not straddle two tiles");
  __shared__ __align__(16) float s_phi[kTileM][D];
  __shared__ __align__(16) float s_g[kTileM][DV];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;

  float q[D];
  const T* q_src = theta + ((size_t)b * n + (live ? row : 0)) * D;
#pragma unroll
  for (int k = 0; k < D; ++k) q[k] = live ? to_f32(q_src[k]) : 0.f;

  float acc[DV];
#pragma unroll
  for (int j = 0; j < DV; ++j) acc[j] = 0.f;
  float run_max = -CUDART_INF_F;
  float run_sum = 0.f;

  const T* phi_b = phi + (size_t)b * m * D;
  const T* g_b = g + (size_t)b * m * DV;

  for (int m0 = 0; m0 < m; m0 += kTileM) {
    const int valid = min(kTileM, m - m0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTileM * D; i += kRows)
      (&s_phi[0][0])[i] = i / D < valid ? to_f32(phi_b[(size_t)m0 * D + i]) : 0.f;
    for (int i = threadIdx.x; i < kTileM * DV; i += kRows)
      (&s_g[0][0])[i] = i / DV < valid ? to_f32(g_b[(size_t)m0 * DV + i]) : 0.f;
    __syncthreads();

    for (int c0 = 0; c0 < valid; c0 += CHUNK) {
      float s[CHUNK];
      float chunk_max = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(q[e], s_phi[c0 + k][e], dot);
        s[k] = c0 + k < valid ? dot : -CUDART_INF_F;
        chunk_max = fmaxf(chunk_max, s[k]);
      }
      // chunk 0 of tile 0 always holds key 0, so new_max is finite from here on
      const float new_max = fmaxf(run_max, chunk_max);
      const float shift = new_max * kLog2e;
      const float corr = exp2f(fmaf(run_max, kLog2e, -shift));
      run_sum *= corr;
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[j] *= corr;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        const float p = exp2f(fmaf(s[k], kLog2e, -shift));
        run_sum += p;
#pragma unroll
        for (int j = 0; j < DV; ++j) acc[j] = fmaf(p, s_g[c0 + k][j], acc[j]);
      }
      run_max = new_max;
    }
  }

  if (!live) return;
  const float inv = 1.f / run_sum;
  T* o_dst = o + ((size_t)b * n + row) * DV;
#pragma unroll
  for (int j = 0; j < DV; ++j) store(o_dst + j, acc[j] * inv);
  if (lse != nullptr) lse[(size_t)b * n + row] = run_max + logf(run_sum);
}

template <typename T, int D, int DV, int CHUNK>
cudaError_t launch(const void* theta, const void* phi, const void* g, void* o,
                   void* lse, int b, int n, int m, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  attention_fwd_kernel<T, D, DV, CHUNK><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(theta), static_cast<const T*>(phi),
      static_cast<const T*>(g), static_cast<T*>(o), static_cast<float*>(lse), n, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* theta, const void* phi, const void* g, void* o,
                     void* lse, int b, int n, int m, int d, int dv,
                     cudaStream_t stream) {
  if (d == 4 && dv == 16)
    return launch<T, 4, 16, 32>(theta, phi, g, o, lse, b, n, m, stream);
  if (d == 16 && dv == 64)
    return launch<T, 16, 64, 16>(theta, phi, g, o, lse, b, n, m, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null. Returns the cudaError_t of
// the launch (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int t2v_attention_fwd(const void* theta, const void* phi, const void* g,
                                 void* o, void* lse, int b, int n, int m, int d,
                                 int dv, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) err = dispatch<float>(theta, phi, g, o, lse, b, n, m, d, dv, s);
  else if (dtype == 1) err = dispatch<__nv_bfloat16>(theta, phi, g, o, lse, b, n, m, d, dv, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
