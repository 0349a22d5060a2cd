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
// Neither kernel writes the N x M map to device memory. Outputs take their
// input's dtype.
//
// What bounds them: every (query, key) pair costs K2 2d + dv and K3 2d + 2dv
// multiply-adds and one exponential, against d + dv values per row of
// traffic, so both are bound by operations. At the generator's training
// shape (B, N, M, d, dv) = (40, 1024, 256, 4, 16) K3's four products are
// 0.84 GFLOP, three TF32 passes of which take 5.1 us at the tensor cores'
// 495 TFLOP/s, and its 10.5 M exponentials 2.5 us at 16 per SM per clock.
//
// K2: scalar float32 on the CUDA cores. One query row per thread; its d
// query values, dv output-gradient values, lse, delta and the d accumulators
// live in registers; tiles of phi and g are staged in shared memory and read
// by a whole warp at one address (a broadcast, no bank conflicts). Long dot
// products use four partial sums, so they are not one chain of dependent FMAs.
//
// K3: the four products on the tensor cores through mma.sync, float32 as
// three TF32 passes and bfloat16 as one pass (fragments and copies in
// tc_mma.cuh; mma.sync rather than wgmma for the reasons given in
// attention_fwd.cu). A block is 4 warps and 64 keys; a warp owns 16 keys,
// holding their phi and g fragments in registers and the dphi and dg
// accumulators in MMA fragments. Tiles of 64 query rows of theta, do, lse
// and delta stream through a two-stage cp.async ring in shared memory; rows
// past N are zero-filled, which makes their terms exactly zero. For each 16
// queries of a tile, in registers:
//   S^T  = phi theta^T                    P^T = exp2(S^T log2 e - lse log2 e)
//   dg  += P^T do                         dP^T = g do^T
//   dS^T = P^T * (dP^T - delta)           dphi += dS^T theta
// P^T and dS^T feed their products as A operands straight from the
// accumulators (bf16: rounded to bf16 first, as the TPU kernel casts p and
// ds). One staged copy of do and theta serves both operand layouts. Keys past
// M get p = 0 and are not stored. At the generator's shape B * M / 64 = 160
// blocks would leave most SMs idle, so the wrapper cuts N into splits
// (gridDim.z) from the device's SM count: each writes f32 partial sums to a
// scratch buffer and a second pass adds them in a fixed order. No atomics,
// so results repeat bit for bit.

#include "tc_mma.cuh"

namespace {

using namespace t2v;

constexpr int kRows = 128;       // K2: query rows per block, one per thread
constexpr int kTileM = 64;       // K2: key rows of phi/g staged per step
constexpr int kDkvWarps = 4;
constexpr int kDkvThreads = 32 * kDkvWarps;
constexpr int kKeys = 16 * kDkvWarps;  // K3: key rows per block, 16 per warp
constexpr int kTileN = 64;       // K3: query rows of theta/do/lse/delta per stage
constexpr int kChunkN = 16;      // K3: query rows per pass through the products

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
__global__ void __launch_bounds__(kDkvThreads)
attention_bwd_dkv_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                         const T* __restrict__ g, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dphi, T* __restrict__ dg,
                         float* __restrict__ partial, int n, int m, int rows_per_split) {
  using Tr = Mma<T>;
  constexpr int SD = row_stride<T, D>();
  constexpr int SV = row_stride<T, DV>();
  constexpr int KD = (D + Tr::K - 1) / Tr::K;  // MMA steps over d, zero-padded
  constexpr int KV = DV / Tr::K;               // MMA steps over dv
  constexpr int KN = kChunkN / Tr::K;          // MMA steps over a chunk's queries
  constexpr int ND = (D + 7) / 8;              // dphi accumulator tiles
  constexpr int NV = DV / 8;                   // dg accumulator tiles
  constexpr int NQ = kChunkN / 8;              // logit tiles per chunk
  static_assert(DV % Tr::K == 0 && kChunkN % Tr::K == 0 && kTileN % kChunkN == 0,
                "tile shapes");
  __shared__ __align__(16) T s_q[2][kTileN * SD];
  __shared__ __align__(16) T s_do[2][kTileN * SV];
  __shared__ __align__(16) float s_lse[2][kTileN];
  __shared__ __align__(16) float s_delta[2][kTileN];

  const int lane = threadIdx.x % 32, r = lane / 4, c = lane % 4;
  const int b = blockIdx.y;
  const int key0 = blockIdx.x * kKeys + threadIdx.x / 32 * 16;
  const T* phi_b = phi + (size_t)b * m * D;
  const T* g_b = g + (size_t)b * m * DV;

  typename Tr::A ka[KD], ga[KV];
#pragma unroll
  for (int ks = 0; ks < KD; ++ks)
    ka[ks] = Tr::load_a([&](int i, int k) {
      return key0 + i < m && k < D ? to_f32(phi_b[(size_t)(key0 + i) * D + k]) : 0.f;
    }, ks * Tr::K, r, c);
#pragma unroll
  for (int ks = 0; ks < KV; ++ks)
    ga[ks] = Tr::load_a([&](int i, int j) {
      return key0 + i < m ? to_f32(g_b[(size_t)(key0 + i) * DV + j]) : 0.f;
    }, ks * Tr::K, r, c);
  const bool live[2] = {key0 + r < m, key0 + r + 8 < m};

  // accumulators: keys r, r + 8 of the warp's 16, columns 8v + 2c, 8v + 2c + 1
  float dk[ND][4] = {};
  float dgv[NV][4] = {};

  const int n_begin = blockIdx.z * rows_per_split;
  const int n_end = min(n, n_begin + rows_per_split);
  const size_t row0 = (size_t)b * n + n_begin;
  const int tiles = (n_end - n_begin + kTileN - 1) / kTileN;
  auto fetch = [&](int tile) {
    const int q0 = tile * kTileN;
    const int valid = min(kTileN, n_end - n_begin - q0);
    const int st = tile % 2;
    copy_rows<T, D, SD, kTileN, kDkvThreads>(s_q[st], theta + (row0 + q0) * D, valid);
    copy_rows<T, DV, SV, kTileN, kDkvThreads>(s_do[st], dout + (row0 + q0) * DV, valid);
    copy_rows<float, 1, 1, kTileN, kDkvThreads>(s_lse[st], lse + row0 + q0, valid);
    copy_rows<float, 1, 1, kTileN, kDkvThreads>(s_delta[st], delta + row0 + q0, valid);
    cp_async_commit();
  };
  fetch(0);
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      fetch(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = tile % 2;
    const T* sq = s_q[st];
    const T* sdo = s_do[st];
    const float* sl = s_lse[st];
    const float* sd = s_delta[st];

#pragma unroll
    for (int q0 = 0; q0 < kTileN; q0 += kChunkN) {
      // P^T = exp(phi theta^T - lse): keys x queries, lse by column. A row
      // past N (zeros, lse 0) gets p = 1 against do = 0 and theta = 0.
      float p[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KD; ++ks)
          Tr::mma(p[j], ka[ks], Tr::load_b([&](int k, int q) {
            return k < D ? to_f32(sq[q * SD + k]) : 0.f;
          }, ks * Tr::K, q0 + 8 * j, r, c));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * c + (e & 1);
          p[j][e] = live[e / 2] ? exp2_approx(fmaf(p[j][e], kLog2e, -sl[q] * kLog2e)) : 0.f;
        }
      }
      // dg += P^T do
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        const typename Tr::A pa = Tr::from_acc(p, ks);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          Tr::mma(dgv[v], pa, Tr::load_b_perm([&](int q, int col) {
            return to_f32(sdo[q * SV + col]);
          }, q0 + ks * Tr::K, 8 * v, r, c));
      }
      // dS^T = P^T * (g do^T - delta), delta by column
      float ds[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KV; ++ks)
          Tr::mma(ds[j], ga[ks], Tr::load_b([&](int col, int q) {
            return to_f32(sdo[q * SV + col]);
          }, ks * Tr::K, q0 + 8 * j, r, c));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - sd[q0 + 8 * j + 2 * c + (e & 1)]);
      }
      // dphi += dS^T theta
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        const typename Tr::A da = Tr::from_acc(ds, ks);
#pragma unroll
        for (int v = 0; v < ND; ++v)
          Tr::mma(dk[v], da, Tr::load_b_perm([&](int q, int k) {
            return k < D ? to_f32(sq[q * SD + k]) : 0.f;
          }, q0 + ks * Tr::K, 8 * v, r, c));
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const size_t bm = (size_t)gridDim.y * m;
  float* part = partial == nullptr ? nullptr : partial + blockIdx.z * bm * (D + DV);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const size_t kr = (size_t)b * m + key0 + r + 8 * i;
#pragma unroll
    for (int v = 0; v < ND; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * v + 2 * c + e;
        if (col >= D) continue;
        if (part == nullptr) store(dphi + kr * D + col, dk[v][2 * i + e]);
        else part[kr * D + col] = dk[v][2 * i + e];
      }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * v + 2 * c + e;
        if (part == nullptr) store(dg + kr * DV + col, dgv[v][2 * i + e]);
        else part[bm * D + kr * DV + col] = dgv[v][2 * i + e];
      }
  }
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
      (long long)splits * rows_per_split < a.n ||
      (long long)(splits - 1) * rows_per_split >= a.n || (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  float* partial = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  const dim3 grid((a.m + kKeys - 1) / kKeys, a.b, splits);
  attention_bwd_dkv_kernel<T, D, DV><<<grid, kDkvThreads, 0, a.stream>>>(
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

template <typename T>
cudaError_t occupancy_dkv(int d, int dv, int* blocks_per_sm) {
  if (d == 4 && dv == 16)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dkv_kernel<T, 4, 16>, kDkvThreads, 0);
  if (d == 16 && dv == 64)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dkv_kernel<T, 16, 64>, kDkvThreads, 0);
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
// covers query rows [s * rows_per_split, (s + 1) * rows_per_split), and every
// split holds at least one row.
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

// K3's occupancy: out[0] = blocks one SM holds at once, out[1] = threads per
// block.
extern "C" int t2v_attention_bwd_dkv_occupancy(int d, int dv, int dtype, int device,
                                               int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) err = occupancy_dkv<float>(d, dv, out);
  else if (dtype == 1) err = occupancy_dkv<__nv_bfloat16>(d, dv, out);
  else err = cudaErrorInvalidValue;
  out[1] = kDkvThreads;
  return static_cast<int>(err);
}
