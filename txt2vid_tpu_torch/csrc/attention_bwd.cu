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
// shape (B, N, M, d, dv) = (40, 1024, 256, 4, 16) K2's three products are
// 0.50 GFLOP and K3's four 0.84 GFLOP, three TF32 passes of which take 3.1
// and 5.1 us at the tensor cores' 495 TFLOP/s, and each kernel's 10.5 M
// exponentials 2.5 us at 16 per SM per clock.
//
// Both run their products on the tensor cores through mma.sync, float32 as
// three TF32 passes and bfloat16 as one pass (fragments and copies in
// tc_mma.cuh; mma.sync rather than wgmma for the reasons given in
// attention_fwd.cu).
//
// K2: a block is 4 warps; a warp owns 16 query rows, holding their theta
// fragments (A of S = theta phi^T), do fragments (A of dP = do g^T), lse
// and delta in registers for the whole key loop, as K1 does. Tiles of 64 keys
// of phi and g stream through a two-stage cp.async ring in shared memory; one
// staged copy of phi is the B operand of S and, in the permuted K order of
// from_acc, of dtheta += dS phi; g's tile is read as g^T. For each 16 keys,
// in registers:
//   S  = theta phi^T                      P = exp2((S - lse) log2 e)
//   dP = do g^T                           dS = P * (dP - delta)
//   dtheta += dS phi
// dS feeds its product as the A operand straight from the accumulators
// (bf16: rounded to bf16 first, as the TPU kernel casts ds). d = 4 is
// zero-padded to the MMA depth while fragments are built; keys past M get
// p = 0; rows past N are computed on zeros and not stored. At the
// discriminator's shapes B * ceil(N / 64) is 10-40 blocks, so the wrapper
// lets `splits` (1, 2 or 4) warps of a block share one 16-row query tile,
// warp slot s taking every splits-th 16-key chunk of each staged tile from
// chunk s on. The slots' dtheta partials are added through shared memory in
// slot order: no atomics, so results repeat bit for bit. At the generator's
// shape splits is 1 and each warp owns its own rows, K1's layout.
//
// K3: a block is 4 warps and 64 keys; a warp owns 16 keys, holding their phi
// and g fragments in registers and the dphi and dg accumulators in MMA
// fragments. Tiles of 64 query rows of theta, do, lse
// and delta stream through a two-stage cp.async ring in shared memory; rows
// past N are zero-filled, which makes their terms exactly zero. For each 16
// queries of a tile, in registers:
//   S^T  = phi theta^T                    P^T = exp2((S^T - lse) log2 e)
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
//
// S = theta phi^T takes each MMA step and, in float32, each group of TF32
// passes from zero and adds it rounding to nearest (mma_rn in tc_mma.cuh):
// kept in one accumulator, the passes' truncating adds put the logits about
// two ulps toward zero at d = 16, and against an lse that K1 did not compute
// (twice unit-scale inputs, float64's lse) dtheta, dphi and dg came out
// 4.25e-6 (relative) short of float64 on average on an H100.
//
// S - lse is formed before the scaling by log2 e, as the TPU kernels' exp(s -
// lse) is: at logits of thousands a rounded lse * log2 e would put p a part
// in a thousand off where the forward had it (the top key's 1 of a one-hot
// row), and dg with it.

#include "tc_mma.cuh"

namespace {

using namespace t2v;

constexpr int kDqWarps = 4;
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kTileM = 64;       // K2: keys of phi and g per stage
constexpr int kChunkM = 16;      // K2: keys per pass through the products
// K2's (4, 16) instantiation is held to 5 blocks per SM, as K1's, so the
// training shape's 640 blocks run in one wave of 660 slots on 132 SMs
constexpr int kDqMinBlocksD4 = 5;
constexpr int kDkvWarps = 4;
constexpr int kDkvThreads = 32 * kDkvWarps;
constexpr int kKeys = 16 * kDkvWarps;  // K3: key rows per block, 16 per warp
constexpr int kTileN = 64;       // K3: query rows of theta/do/lse/delta per stage
constexpr int kChunkN = 16;      // K3: query rows per pass through the products

// acc += sum over ks < KS of a[ks] b(ks), the KS MMA steps of one 16-row
// chunk summed from zero and added to acc with a float add. The tensor cores
// add into their accumulator with truncation, not rounding to nearest, so a
// sum kept in MMA fragments across the whole key (K2) or query (K3) loop
// drifts toward zero: over 1024 keys or 4096 queries the gradients came out
// about 5e-6 (relative) short of float64 on average on an H100, where the
// plain float32 versions are unbiased. A float add per chunk rounds to
// nearest.
template <typename Tr, int KS, typename B>
__device__ __forceinline__ void add_chunk(float acc[4], const typename Tr::A (&a)[KS], B b) {
  float t[4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) Tr::mma(t, a[ks], b(ks));
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// acc += a b, one MMA step summed from zero and added with a float add: dP =
// do g^T runs DV / 8 steps deep, and at dv = 64 summing them in one
// accumulator left dtheta and dphi 1.7e-6 short of float64 on an H100, 1.2e-6
// so (the rest comes from S = theta phi^T, two steps deep at d = 16)
template <typename Tr>
__device__ __forceinline__ void add_product(float acc[4], const typename Tr::A& a,
                                            const typename Tr::B& b) {
  float t[4] = {};
  Tr::mma(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// Warp w of a block is slot w % splits of query tile w / splits; the block
// holds kDqWarps / splits tiles of 16 rows.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kDqThreads, D == 4 ? kDqMinBlocksD4 : 1)
attention_bwd_dq_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                        const T* __restrict__ g, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dtheta, int n, int m, int splits) {
  using Tr = Mma<T>;
  constexpr int SD = row_stride<T, D>();
  constexpr int SV = row_stride<T, DV>();
  constexpr int KD = (D + Tr::K - 1) / Tr::K;  // MMA steps over d, zero-padded
  constexpr int KV = DV / Tr::K;               // MMA steps over dv
  constexpr int KC = kChunkM / Tr::K;          // MMA steps over a chunk's keys
  constexpr int ND = (D + 7) / 8;              // dtheta accumulator tiles
  constexpr int NC = kChunkM / 8;              // logit tiles per chunk
  static_assert(DV % Tr::K == 0 && kChunkM % Tr::K == 0 && kTileM % kChunkM == 0,
                "tile shapes");
  __shared__ __align__(16) T s_phi[2][kTileM * SD];
  __shared__ __align__(16) T s_g[2][kTileM * SV];
  static_assert(sizeof(s_g) >= kDqThreads * ND * 4 * sizeof(float),
                "the slots' partial sums are added in s_g");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r = lane / 4, c = lane % 4;
  const int slot = warp % splits;
  const int b = blockIdx.y;
  const int row0 = (blockIdx.x * (kDqWarps / splits) + warp / splits) * 16;
  const T* theta_b = theta + (size_t)b * n * D;
  const T* do_b = dout + (size_t)b * n * DV;
  const T* phi_b = phi + (size_t)b * m * D;
  const T* g_b = g + (size_t)b * m * DV;

  typename Tr::A qa[KD], da[KV];
#pragma unroll
  for (int ks = 0; ks < KD; ++ks)
    qa[ks] = Tr::load_a([&](int i, int k) {
      return row0 + i < n && k < D ? to_f32(theta_b[(size_t)(row0 + i) * D + k]) : 0.f;
    }, ks * Tr::K, r, c);
#pragma unroll
  for (int ks = 0; ks < KV; ++ks)
    da[ks] = Tr::load_a([&](int i, int j) {
      return row0 + i < n ? to_f32(do_b[(size_t)(row0 + i) * DV + j]) : 0.f;
    }, ks * Tr::K, r, c);
  // rows r and r + 8 of the warp's 16; a row past N (zeros, lse and delta 0)
  // gets p = 1 against dP = 0 and delta = 0, so dS = 0
  float lr[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    lr[i] = row < n ? lse[(size_t)b * n + row] : 0.f;
    dl[i] = row < n ? delta[(size_t)b * n + row] : 0.f;
  }

  // accumulator: rows r, r + 8, columns 8v + 2c, 8v + 2c + 1
  float acc[ND][4] = {};

  const int tiles = (m + kTileM - 1) / kTileM;
  auto fetch = [&](int tile) {
    const int valid = min(kTileM, m - tile * kTileM);
    copy_rows<T, D, SD, kTileM, kDqThreads>(s_phi[tile % 2], phi_b + (size_t)tile * kTileM * D,
                                            valid);
    copy_rows<T, DV, SV, kTileM, kDqThreads>(s_g[tile % 2], g_b + (size_t)tile * kTileM * DV,
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
    const int valid = min(kTileM, m - tile * kTileM);

    // two chunks in flight: their products are independent but for acc
#pragma unroll 2
    for (int k0 = slot * kChunkM; row0 < n && k0 < valid; k0 += splits * kChunkM) {
      const T* sp = s_phi[tile % 2] + k0 * SD;
      const T* sg = s_g[tile % 2] + k0 * SV;
      // S = theta phi^T, then P; keys past M (zero-filled) get p = 0
      float p[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KD; ++ks)
          Tr::mma_rn(p[j], qa[ks], Tr::load_b([&](int k, int key) {
            return k < D ? to_f32(sp[key * SD + k]) : 0.f;
          }, ks * Tr::K, 8 * j, r, c));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = k0 + 8 * j + 2 * c + (e & 1) < valid;
          p[j][e] = live ? exp2_approx((p[j][e] - lr[e / 2]) * kLog2e) : 0.f;
        }
      }
      // dS = P * (do g^T - delta), delta by row
      float ds[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KV; ++ks)
          add_product<Tr>(ds[j], da[ks], Tr::load_b([&](int col, int key) {
            return to_f32(sg[key * SV + col]);
          }, ks * Tr::K, 8 * j, r, c));
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl[e / 2]);
      }
      // dtheta += dS phi, the chunk's product summed from zero and added
      // rounding to nearest (see add_chunk)
      typename Tr::A a[KC];
#pragma unroll
      for (int ks = 0; ks < KC; ++ks) a[ks] = Tr::from_acc(ds, ks);
#pragma unroll
      for (int v = 0; v < ND; ++v)
        add_chunk<Tr, KC>(acc[v], a, [&](int ks) {
          return Tr::load_b_perm([&](int key, int k) {
            return k < D ? to_f32(sp[key * SD + k]) : 0.f;
          }, ks * Tr::K, 8 * v, r, c);
        });
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (splits > 1) {  // slot 0 adds the other slots' partials, in slot order
    // part[warp][v][e][lane]: the stages are free now
    float* part = reinterpret_cast<float*>(&s_g[0][0]);
    auto at = [&](int w, int v, int e) { return ((w * ND + v) * 4 + e) * 32 + lane; };
    if (slot != 0) {
#pragma unroll
      for (int v = 0; v < ND; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[at(warp, v, e)] = acc[v][e];
    }
    __syncthreads();
    if (slot != 0) return;
    for (int s = 1; s < splits; ++s)
#pragma unroll
      for (int v = 0; v < ND; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[v][e] += part[at(warp + s, v, e)];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + 8 * i;
    if (row >= n) continue;
    T* dst = dtheta + ((size_t)b * n + row) * D;
#pragma unroll
    for (int v = 0; v < ND; ++v)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * v + 2 * c + e;
        if (col < D) store(dst + col, acc[v][2 * i + e]);
      }
  }
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
          Tr::mma_rn(p[j], ka[ks], Tr::load_b([&](int k, int q) {
            return k < D ? to_f32(sq[q * SD + k]) : 0.f;
          }, ks * Tr::K, q0 + 8 * j, r, c));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * c + (e & 1);
          p[j][e] = live[e / 2] ? exp2_approx((p[j][e] - sl[q]) * kLog2e) : 0.f;
        }
      }
      // dg += P^T do (add_chunk)
      {
        typename Tr::A pa[KN];
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) pa[ks] = Tr::from_acc(p, ks);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          add_chunk<Tr, KN>(dgv[v], pa, [&](int ks) {
            return Tr::load_b_perm([&](int q, int col) {
              return to_f32(sdo[q * SV + col]);
            }, q0 + ks * Tr::K, 8 * v, r, c);
          });
      }
      // dS^T = P^T * (g do^T - delta), delta by column
      float ds[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KV; ++ks)
          add_product<Tr>(ds[j], ga[ks], Tr::load_b([&](int col, int q) {
            return to_f32(sdo[q * SV + col]);
          }, ks * Tr::K, q0 + 8 * j, r, c));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - sd[q0 + 8 * j + 2 * c + (e & 1)]);
      }
      // dphi += dS^T theta (add_chunk)
      typename Tr::A da[KN];
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) da[ks] = Tr::from_acc(ds, ks);
#pragma unroll
      for (int v = 0; v < ND; ++v)
        add_chunk<Tr, KN>(dk[v], da, [&](int ks) {
          return Tr::load_b_perm([&](int q, int k) {
            return k < D ? to_f32(sq[q * SD + k]) : 0.f;
          }, q0 + ks * Tr::K, 8 * v, r, c);
        });
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
cudaError_t launch_dq(const Args& a, void* dtheta, int splits) {
  if (splits != 1 && splits != 2 && splits != 4) return cudaErrorInvalidValue;
  const int rows = 16 * kDqWarps / splits;  // query rows per block
  const dim3 grid((a.n + rows - 1) / rows, a.b);
  attention_bwd_dq_kernel<T, D, DV><<<grid, kDqThreads, 0, a.stream>>>(
      static_cast<const T*>(a.theta), static_cast<const T*>(a.phi),
      static_cast<const T*>(a.g), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dtheta), a.n, a.m, splits);
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

// The instantiations, as attention_fwd.cu's: (d, dv) = (4, 16), (8, 32) and
// (16, 64).
template <typename T>
cudaError_t dispatch_dq(const Args& a, int d, int dv, void* dtheta, int splits) {
  if (d == 4 && dv == 16) return launch_dq<T, 4, 16>(a, dtheta, splits);
  if (d == 8 && dv == 32) return launch_dq<T, 8, 32>(a, dtheta, splits);
  if (d == 16 && dv == 64) return launch_dq<T, 16, 64>(a, dtheta, splits);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dkv(const Args& a, int d, int dv, void* dphi, void* dg,
                         void* scratch, int splits, int rows_per_split) {
  if (d == 4 && dv == 16)
    return launch_dkv<T, 4, 16>(a, dphi, dg, scratch, splits, rows_per_split);
  if (d == 8 && dv == 32)
    return launch_dkv<T, 8, 32>(a, dphi, dg, scratch, splits, rows_per_split);
  if (d == 16 && dv == 64)
    return launch_dkv<T, 16, 64>(a, dphi, dg, scratch, splits, rows_per_split);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t occupancy_dq(int d, int dv, int* blocks_per_sm) {
  if (d == 4 && dv == 16)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dq_kernel<T, 4, 16>, kDqThreads, 0);
  if (d == 8 && dv == 32)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dq_kernel<T, 8, 32>, kDqThreads, 0);
  if (d == 16 && dv == 64)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dq_kernel<T, 16, 64>, kDqThreads, 0);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t occupancy_dkv(int d, int dv, int* blocks_per_sm) {
  if (d == 4 && dv == 16)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dkv_kernel<T, 4, 16>, kDkvThreads, 0);
  if (d == 8 && dv == 32)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dkv_kernel<T, 8, 32>, kDkvThreads, 0);
  if (d == 16 && dv == 64)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_dkv_kernel<T, 16, 64>, kDkvThreads, 0);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (theta, phi, g, do and the outputs); lse
// and delta are float32. Each returns the cudaError_t of its launches (0 =
// cudaSuccess); launches are asynchronous on `stream`.
//
// splits (1, 2 or 4): warps of a block that share one 16-row query tile and
// cut M among them.
extern "C" int t2v_attention_bwd_dq(const void* theta, const void* phi, const void* g,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dtheta, int splits, int b, int n, int m, int d,
                                    int dv, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{theta, phi, g, dout, lse, delta, b, n, m, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) err = dispatch_dq<float>(a, d, dv, dtheta, splits);
  else if (dtype == 1) err = dispatch_dq<__nv_bfloat16>(a, d, dv, dtheta, splits);
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

// K2's and K3's occupancy: out[0] = blocks one SM holds at once, out[1] =
// threads per block.
extern "C" int t2v_attention_bwd_dq_occupancy(int d, int dv, int dtype, int device,
                                              int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) err = occupancy_dq<float>(d, dv, out);
  else if (dtype == 1) err = occupancy_dq<__nv_bfloat16>(d, dv, out);
  else err = cudaErrorInvalidValue;
  out[1] = kDqThreads;
  return static_cast<int>(err);
}

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
