// Fused non-local attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of `fused_attention_bwd` in
// txt2vid_tpu/ops/pallas_attention.py:
//   K2 `_attn_bwd_dq_kernel`  (:141-168, launched :225-245):  dtheta = ds @ phi
//   K3 `_attn_bwd_dkv_kernel` (:171-204, launched :247-276):  dphi = ds^T @ theta,
//                                                             dg   = p^T @ do
// with s = theta @ phi^T (unscaled), p = exp(s - lse) re-formed from the
// forward's saved row log-sum-exp, and ds = p * (do @ g^T - delta), where
// delta = rowsum(do * o) comes in from the caller. theta is (B, N, d), phi
// (B, M, d), g (B, M, dv), do (B, N, dv); lse and delta are (B, N) float32.
// Neither kernel writes the N x M map to device memory.
//
// What bounds them: every (query, key) pair costs K2 2d + dv and K3 2d + 2dv
// multiply-adds and one exponential, against d + dv floats per row of traffic,
// so the work is scalar f32 arithmetic on the CUDA cores (d = 4 is below the
// tensor cores' K minimum of 16): at the generator's training shape (B, N, M,
// d, dv) = (40, 1024, 256, 4, 16) K2 needs 0.50 GFLOP (0.0075 ms at 67
// TFLOP/s) and K3 0.84 GFLOP (0.0125 ms) against about 5 MB each (0.0015 ms).
//
// The design keeps that arithmetic in registers, as the forward does. The
// TPU's sequential grid axis, which accumulated in VMEM scratch, becomes a
// loop inside the block:
// - K2: one query row per thread. Its d query values, dv output-gradient
//   values, lse, delta and the d accumulators live in registers; tiles of phi
//   and g are staged in shared memory and read by a whole warp at one address
//   (a broadcast, no bank conflicts).
// - K3: one key row per thread, holding phi_k, g_k and the dphi/dg
//   accumulators (2d + 2dv floats, 160 at (16, 64)); tiles of theta, do, lse
//   and delta stream through shared memory. Each do value is read once and
//   feeds both dg and the do.g dot product. At the generator's shape there
//   are only B * M = 10 240 key rows, so the wrapper may cut N into splits
//   (gridDim.z): each writes f32 partial sums to a scratch buffer and a second
//   pass adds them in a fixed order. No atomics, so results repeat bit for
//   bit.
// Long dot products use four partial sums, so they are not one chain of
// dependent FMAs. Ragged N and M are handled by loop bounds and by rows that
// are computed on zeros and not stored. Inputs are f32 or bf16; arithmetic is
// f32; outputs take their input's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;    // K2: query rows per block, one per thread
constexpr int kTileM = 64;    // K2: key rows of phi/g staged per step
constexpr int kKeys = 128;    // K3: key rows per block, one per thread
constexpr int kTileN = 64;    // K3: query rows of theta/do/lse/delta staged per step
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// sum over k < K of a[k] * b[k], in four independent partial sums
template <int K>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k % 4] = fmaf(a[k], b[k], acc[k % 4]);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kRows)
attention_bwd_dq_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                        const T* __restrict__ g, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dtheta, int n, int m) {
  __shared__ __align__(16) float s_phi[kTileM][D];
  __shared__ __align__(16) float s_g[kTileM][DV];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const size_t r = (size_t)b * n + (live ? row : 0);

  float q[D], dq[D], dov[DV];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    q[e] = live ? to_f32(theta[r * D + e]) : 0.f;
    dq[e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < DV; ++j) dov[j] = live ? to_f32(dout[r * DV + j]) : 0.f;
  const float lse2 = live ? lse[r] * kLog2e : 0.f;
  const float dl = live ? delta[r] : 0.f;

  const T* phi_b = phi + (size_t)b * m * D;
  const T* g_b = g + (size_t)b * m * DV;
  for (int m0 = 0; m0 < m; m0 += kTileM) {
    const int valid = min(kTileM, m - m0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < valid * D; i += kRows)
      (&s_phi[0][0])[i] = to_f32(phi_b[(size_t)m0 * D + i]);
    for (int i = threadIdx.x; i < valid * DV; i += kRows)
      (&s_g[0][0])[i] = to_f32(g_b[(size_t)m0 * DV + i]);
    __syncthreads();

#pragma unroll 2
    for (int k = 0; k < valid; ++k) {
      const float p = exp2f(fmaf(dot<D>(q, s_phi[k]), kLog2e, -lse2));
      const float ds = p * (dot<DV>(dov, s_g[k]) - dl);
#pragma unroll
      for (int e = 0; e < D; ++e) dq[e] = fmaf(ds, s_phi[k][e], dq[e]);
    }
  }

  if (!live) return;
  T* dst = dtheta + r * D;
#pragma unroll
  for (int e = 0; e < D; ++e) store(dst + e, dq[e]);
}

// partial == nullptr: write dphi and dg directly. Otherwise write f32 partial
// sums of this block's split of N to partial[blockIdx.z][...], laid out as
// dphi (B*M*D) then dg (B*M*DV), for dkv_reduce_kernel.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kKeys)
attention_bwd_dkv_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                         const T* __restrict__ g, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dphi, T* __restrict__ dg,
                         float* __restrict__ partial, int n, int m, int rows_per_split) {
  __shared__ __align__(16) float s_q[kTileN][D];
  __shared__ __align__(16) float s_do[kTileN][DV];
  __shared__ float s_lse2[kTileN];
  __shared__ float s_delta[kTileN];

  const int b = blockIdx.y;
  const int key = blockIdx.x * kKeys + threadIdx.x;
  const bool live = key < m;
  const size_t kr = (size_t)b * m + (live ? key : 0);

  float kv[D], gv[DV], dk[D], dgk[DV];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    kv[e] = live ? to_f32(phi[kr * D + e]) : 0.f;
    dk[e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < DV; ++j) {
    gv[j] = live ? to_f32(g[kr * DV + j]) : 0.f;
    dgk[j] = 0.f;
  }

  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(n, n_begin + rows_per_split);
  const size_t row0 = (size_t)b * n;
  for (int n0 = n_begin; n0 < n_end; n0 += kTileN) {
    const int valid = min(kTileN, n_end - n0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < valid * D; i += kKeys)
      (&s_q[0][0])[i] = to_f32(theta[(row0 + n0) * D + i]);
    for (int i = threadIdx.x; i < valid * DV; i += kKeys)
      (&s_do[0][0])[i] = to_f32(dout[(row0 + n0) * DV + i]);
    for (int i = threadIdx.x; i < valid; i += kKeys) {
      s_lse2[i] = lse[row0 + n0 + i] * kLog2e;
      s_delta[i] = delta[row0 + n0 + i];
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < valid; ++i) {
      const float p = exp2f(fmaf(dot<D>(kv, s_q[i]), kLog2e, -s_lse2[i]));
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < DV; ++j) {
        const float x = s_do[i][j];
        dgk[j] = fmaf(p, x, dgk[j]);
        acc[j % 4] = fmaf(gv[j], x, acc[j % 4]);
      }
      const float ds = p * (((acc[0] + acc[1]) + (acc[2] + acc[3])) - s_delta[i]);
#pragma unroll
      for (int e = 0; e < D; ++e) dk[e] = fmaf(ds, s_q[i][e], dk[e]);
    }
  }

  if (!live) return;
  if (partial == nullptr) {
#pragma unroll
    for (int e = 0; e < D; ++e) store(dphi + kr * D + e, dk[e]);
#pragma unroll
    for (int j = 0; j < DV; ++j) store(dg + kr * DV + j, dgk[j]);
    return;
  }
  const size_t bm = (size_t)gridDim.y * m;
  float* part = partial + blockIdx.z * bm * (D + DV);
#pragma unroll
  for (int e = 0; e < D; ++e) part[kr * D + e] = dk[e];
#pragma unroll
  for (int j = 0; j < DV; ++j) part[bm * D + kr * DV + j] = dgk[j];
}

// out[i] = sum over splits s, in order, of partial[s][i]; the first B*M*D
// entries are dphi, the rest dg
template <typename T, int D, int DV>
__global__ void dkv_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dphi,
                                  T* __restrict__ dg, size_t bm, int splits) {
  const size_t count = bm * (D + DV);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += partial[s * count + i];
    if (i < bm * D) store(dphi + i, sum);
    else store(dg + (i - bm * D), sum);
  }
}

struct Args {
  const void *theta, *phi, *g, *dout, *lse, *delta;
  int b, n, m;
  cudaStream_t stream;
};

template <typename T, int D, int DV>
cudaError_t launch_dq(const Args& a, void* dtheta) {
  const dim3 grid((a.n + kRows - 1) / kRows, a.b);
  attention_bwd_dq_kernel<T, D, DV><<<grid, kRows, 0, a.stream>>>(
      static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
      static_cast<const T*>(a.g), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dtheta), a.n, a.m);
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t launch_dkv(const Args& a, void* dphi, void* dg, void* scratch, int splits,
                       int rows_per_split) {
  if (splits < 1 || splits > 65535 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < a.n || (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  float* partial = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  const dim3 grid((a.m + kKeys - 1) / kKeys, a.b, splits);
  attention_bwd_dkv_kernel<T, D, DV><<<grid, kKeys, 0, a.stream>>>(
      static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
      static_cast<const T*>(a.g), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dphi), static_cast<T*>(dg), partial, a.n, a.m, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const size_t bm = (size_t)a.b * a.m;
  const size_t count = bm * (D + DV);
  const int threads = 256;
  const size_t want = (count + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  dkv_reduce_kernel<T, D, DV><<<blocks, threads, 0, a.stream>>>(
      partial, static_cast<T*>(dphi), static_cast<T*>(dg), bm, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const Args& a, int d, int dv, void* dtheta) {
  if (d == 4 && dv == 16) return launch_dq<T, 4, 16>(a, dtheta);
  if (d == 16 && dv == 64) return launch_dq<T, 16, 64>(a, dtheta);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dkv(const Args& a, int d, int dv, void* dphi, void* dg,
                         void* scratch, int splits, int rows_per_split) {
  if (d == 4 && dv == 16)
    return launch_dkv<T, 4, 16>(a, dphi, dg, scratch, splits, rows_per_split);
  if (d == 16 && dv == 64)
    return launch_dkv<T, 16, 64>(a, dphi, dg, scratch, splits, rows_per_split);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (theta, phi, g, do and the outputs); lse
// and delta are float32. Each returns the cudaError_t of its launches (0 =
// cudaSuccess); launches are asynchronous on `stream`.
extern "C" int t2v_attention_bwd_dq(const void* theta, const void* phi, const void* g,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dtheta, int b, int n, int m, int d, int dv,
                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{theta, phi, g, dout, lse, delta, b, n, m, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) err = dispatch_dq<float>(a, d, dv, dtheta);
  else if (dtype == 1) err = dispatch_dq<__nv_bfloat16>(a, d, dv, dtheta);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// scratch: float32 [splits][B*M*(d + dv)], needed when splits > 1; split s
// covers query rows [s * rows_per_split, (s + 1) * rows_per_split).
extern "C" int t2v_attention_bwd_dkv(const void* theta, const void* phi, const void* g,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dphi, void* dg, void* scratch, int splits,
                                     int rows_per_split, int b, int n, int m, int d,
                                     int dv, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{theta, phi, g, dout, lse, delta, b, n, m, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    err = dispatch_dkv<float>(a, d, dv, dphi, dg, scratch, splits, rows_per_split);
  else if (dtype == 1)
    err = dispatch_dkv<__nv_bfloat16>(a, d, dv, dphi, dg, scratch, splits, rows_per_split);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
