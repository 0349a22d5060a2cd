// Fused non-local attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `fused_attention` (body `_attn_kernel`) in
// txt2vid_tpu/ops/pallas_attention.py:87-131 (:43-84). Computes, per batch b,
//     o   = softmax(theta @ phi^T) @ g          (unscaled logits)
//     lse = logsumexp(theta @ phi^T, axis=-1)   (optional)
// for theta (B, N, d), phi (B, M, d), g (B, M, dv), without writing the N x M
// map to device memory.
//
// What bounds it: every logit costs d + dv multiply-adds and one exponential
// against d + dv values of traffic per row, so it is bound by operations. At
// the generator's training shape (B, N, M, d, dv) = (40, 1024, 256, 4, 16)
// the three TF32 passes of both products take 2.5 us at the tensor cores'
// 495 TFLOP/s, and the 10.5 M exponentials about as long at 16 per SM per
// clock.
//
// Design (tensor-core fragments and copies in tc_mma.cuh):
// - Both products run on the tensor cores through mma.sync: float32 as three
//   TF32 passes (m16n8k8), which keeps the plain float32 version's accuracy
//   at logits of tens; bfloat16 as one pass (m16n8k16) with p rounded to bf16
//   before p @ g, as the TPU kernel does. d is zero-padded to the MMA depth
//   (8 for TF32, 16 for bf16) while the fragments are built, which is exact.
// - mma.sync, not wgmma: the exponentials take as long as the products, so
//   the tensor cores' rate does not bound the kernel, and register fragments
//   let p flow from one product into the next. wgmma would take g from
//   shared memory only, transposed for tf32, with hi and lo copies staged.
// - A block is 4 warps and 64 query rows; a warp owns 16 rows, their theta
//   fragments held in registers for the whole key loop. The grid is
//   ceil(N / 64) x B: 640 blocks at the training shape (one wave at 5 blocks
//   per SM), 2048 at serving's.
// - Tiles of 64 keys of phi and g stream through a two-stage ring in shared
//   memory filled by cp.async, so the next tile's copy overlaps this one's
//   arithmetic.
// - S = theta phi^T lands in accumulator fragments. The online softmax runs
//   on them in registers: row max over the lane quad by shuffles, the SFU's
//   exp2 of (s - max) log2 e, one rescale of the accumulator per tile. P
//   feeds P @ g from registers.
// - s - max is formed before the scaling by log2 e, as the TPU kernel's
//   exp(s - m) is: at logits of thousands (the cond-128 generator's up0 at
//   its initial weights) a rounded max * log2 e puts the top key's p a part
//   in a thousand off 1, and lse = max + log(sum p) with it.
// - The tensor cores add into their accumulator with truncation, not
//   rounding to nearest, so a sum kept in MMA fragments across a long loop
//   drifts toward zero: over M = 1024 keys o came out 5.6e-6 (relative)
//   short of float64 on average on an H100, where the plain float32 version
//   is unbiased. Each tile's P @ g therefore starts from zero and is added to
//   the running accumulator with an FMA, which rounds to nearest.
//   S = theta phi^T takes its passes through mma_rn for the same reason, as
//   K2 and K3 do, so that the backward's p = exp(s - lse) sees the logits
//   the forward's lse was taken from.
// - The ordinary instructions around the MMAs (TF32 splits, softmax,
//   shared-memory reads) far outnumber them, so the splits are integer
//   operations and exp2 is the SFU's bare instruction.
// - Ragged M: keys past M are zero-filled and get s = -inf. Ragged N: rows
//   past N are computed on zeros and not stored.

#include <math_constants.h>

#include "tc_mma.cuh"

namespace {

using namespace t2v;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kTileM = 64;          // keys of phi and g per stage
// The (4, 16) instantiation is held to 5 blocks per SM (88 registers, no
// spills; unbounded, ptxas takes 113 and fits 4), so the training shape's
// 640 blocks run in one wave of 660 slots on 132 SMs.
constexpr int kMinBlocksD4 = 5;

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads, D == 4 ? kMinBlocksD4 : 1)
attention_fwd_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                     const T* __restrict__ g, T* __restrict__ o,
                     float* __restrict__ lse, int n, int m) {
  using Tr = Mma<T>;
  constexpr int SD = row_stride<T, D>();
  constexpr int SV = row_stride<T, DV>();
  constexpr int KD = (D + Tr::K - 1) / Tr::K;  // MMA steps over d, zero-padded
  constexpr int NV = DV / 8;                   // accumulator tiles over dv
  constexpr int NS = kTileM / 8;               // logit tiles per stage
  static_assert(DV % 8 == 0 && kTileM % Tr::K == 0, "tile shapes");
  __shared__ __align__(16) T s_phi[2][kTileM * SD];
  __shared__ __align__(16) T s_g[2][kTileM * SV];

  const int lane = threadIdx.x % 32, r = lane / 4, c = lane % 4;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows + threadIdx.x / 32 * 16;
  const T* theta_b = theta + (size_t)b * n * D;
  const T* phi_b = phi + (size_t)b * m * D;
  const T* g_b = g + (size_t)b * m * DV;

  typename Tr::A qa[KD];
#pragma unroll
  for (int ks = 0; ks < KD; ++ks)
    qa[ks] = Tr::load_a([&](int i, int k) {
      return row0 + i < n && k < D ? to_f32(theta_b[(size_t)(row0 + i) * D + k]) : 0.f;
    }, ks * Tr::K, r, c);

  // o accumulator: rows r, r + 8 of the warp's 16, columns 8v + 2c, 8v + 2c + 1
  float acc[NV][4] = {};
  float run_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float run_sum[2] = {0.f, 0.f};  // this lane's share of the two rows' sums

  const int tiles = (m + kTileM - 1) / kTileM;
  auto fetch = [&](int tile) {
    const int valid = min(kTileM, m - tile * kTileM);
    copy_rows<T, D, SD, kTileM, kThreads>(s_phi[tile % 2], phi_b + (size_t)tile * kTileM * D,
                                          valid);
    copy_rows<T, DV, SV, kTileM, kThreads>(s_g[tile % 2], g_b + (size_t)tile * kTileM * DV,
                                           valid);
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
    const T* sp = s_phi[tile % 2];
    const T* sg = s_g[tile % 2];
    const int valid = min(kTileM, m - tile * kTileM);

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        Tr::mma_rn(s[j], qa[ks], Tr::load_b([&](int k, int key) {
          return k < D ? to_f32(sp[key * SD + k]) : 0.f;
        }, ks * Tr::K, 8 * j, r, c));
    }

    if (valid < kTileM) {  // the last tile of a ragged M
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * c + (e & 1) >= valid) s[j][e] = -CUDART_INF_F;
    }
    float tile_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tile_max[e / 2] = fmaxf(tile_max[e / 2], s[j][e]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 1));
      tile_max[i] = fmaxf(tile_max[i], __shfl_xor_sync(0xffffffffu, tile_max[i], 2));
      // tile 0 holds key 0, so the running max is finite from there on
      const float new_max = fmaxf(run_max[i], tile_max[i]);
      corr[i] = exp2_approx((run_max[i] - new_max) * kLog2e);
      run_max[i] = new_max;
      run_sum[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx((s[j][e] - run_max[e / 2]) * kLog2e);
        run_sum[e / 2] += s[j][e];
      }
    // this tile's P g in a zeroed tile, then acc = acc * corr + P g rounded
    // to nearest: the tensor cores' accumulation truncates, so summing every
    // tile in the MMA accumulator would bias o toward zero in proportion to M
    float pg[NV][4] = {};
#pragma unroll
    for (int ks = 0; ks < kTileM / Tr::K; ++ks) {
      const typename Tr::A pa = Tr::from_acc(s, ks);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        Tr::mma(pg[v], pa, Tr::load_b_perm([&](int key, int col) {
          return to_f32(sg[key * SV + col]);
        }, ks * Tr::K, 8 * v, r, c));
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[v][e] = fmaf(acc[v][e], corr[e / 2], pg[v][e]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    run_sum[i] += __shfl_xor_sync(0xffffffffu, run_sum[i], 1);
    run_sum[i] += __shfl_xor_sync(0xffffffffu, run_sum[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= n) continue;
    const float inv = 1.f / run_sum[i];
    T* dst = o + ((size_t)b * n + row) * DV + 2 * c;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      store(dst + 8 * v, acc[v][2 * i] * inv);
      store(dst + 8 * v + 1, acc[v][2 * i + 1] * inv);
    }
    if (lse != nullptr && c == 0) lse[(size_t)b * n + row] = run_max[i] + logf(run_sum[i]);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* theta, const void* phi, const void* g, void* o,
                   void* lse, int b, int n, int m, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  attention_fwd_kernel<T, D, DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(theta), static_cast<const T*>(phi),
      static_cast<const T*>(g), static_cast<T*>(o), static_cast<float*>(lse), n, m);
  return cudaGetLastError();
}

// The instantiations: (d, dv) = (4, 16) for the generator's Attention(32),
// (8, 32) for the cond-128 generator's Attention(64) (d = 8 is the TF32 MMA
// depth, no padding; bf16 pads it to 16) and (16, 64) for the discriminator's
// Attention3d(128).
template <typename T>
cudaError_t dispatch(const void* theta, const void* phi, const void* g, void* o,
                     void* lse, int b, int n, int m, int d, int dv,
                     cudaStream_t stream) {
  if (d == 4 && dv == 16) return launch<T, 4, 16>(theta, phi, g, o, lse, b, n, m, stream);
  if (d == 8 && dv == 32) return launch<T, 8, 32>(theta, phi, g, o, lse, b, n, m, stream);
  if (d == 16 && dv == 64) return launch<T, 16, 64>(theta, phi, g, o, lse, b, n, m, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t occupancy(int d, int dv, int* blocks_per_sm) {
  if (d == 4 && dv == 16)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_fwd_kernel<T, 4, 16>, kThreads, 0);
  if (d == 8 && dv == 32)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_fwd_kernel<T, 8, 32>, kThreads, 0);
  if (d == 16 && dv == 64)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_fwd_kernel<T, 16, 64>, kThreads, 0);
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

// out[0] = blocks of one instantiation that one SM holds at once (registers
// and shared memory permitting), out[1] = threads per block.
extern "C" int t2v_attention_fwd_occupancy(int d, int dv, int dtype, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) err = occupancy<float>(d, dv, out);
  else if (dtype == 1) err = occupancy<__nv_bfloat16>(d, dv, out);
  else err = cudaErrorInvalidValue;
  out[1] = kThreads;
  return static_cast<int>(err);
}
