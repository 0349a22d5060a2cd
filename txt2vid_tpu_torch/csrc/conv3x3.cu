// 3x3 float32 convolution (stride 1, padding 1) on the tensor cores for
// Hopper (sm_90a), plain C interface: the forward, the input gradient and
// the weight gradient of the generators' Conv2d layers.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It replaces cuDNN's float32 convolutions, which run on the SIMT float32
// units (67 TFLOP/s on an H100), by implicit GEMMs on the tensor cores.
//
//   y[n, co, p]     = sum_{c, t} w[co, c, t] x[n, c, p + d(t)]    (+ bias[co])
//   dx[n, c, p]     = sum_{co, t} w[co, c, 8 - t] dy[n, co, p + d(t)]
//   dw[co, c, t]    = sum_{n, p} dy[n, co, p] x[n, c, p + d(t)]
//
// for NCHW tensors, taps t = 3 r + s at offsets d(t) = (r - 1, s - 1), and
// zeros outside the plane. The input gradient of a stride-1, padding-1 3x3
// convolution is the same convolution of dy with the weight flipped and
// transposed; the convolution kernel reads that weight through its indexing
// (FLIP), so no copy of the weight is made.
//
// What bounds it: at the cond-128 generator's shapes the GEMMs have
// K = 9 C_in from 288 to 9216, C_out from 32 to 4096 and 512 to 1 M
// positions: from 19 to 618 GFLOP a call against at most about 0.3 GB of
// traffic, so operations bound every one of them. Float32 is three TF32
// passes, so the ceiling is 495 / 3 = 165 TFLOP/s.
//
// Design (the MMA fragments, TF32 splits and cp.async copies of tc_mma.cuh,
// and Hopper's warpgroup MMA, wgmma):
// - Float32 as three TF32 passes, a_lo b_hi + a_hi b_lo + a_hi b_hi, each
//   operand split into hi + lo, both rounded to TF32 to nearest. The tensor
//   cores' adds truncate, so a running accumulator over K in the thousands
//   would drift toward zero, as in the attention kernels: the passes of a few
//   k-steps of 8 are summed from zero, the small ones first, and their sum is
//   added in float32 with round-to-nearest into a sum over 3 chunks of 8
//   channels (216 of K), which is added into the total. With one running
//   round-to-nearest sum over K / 8 terms the output came out 2-4x further
//   from float64 than cuDNN's float32 on an H100; with the two levels it
//   is as close or closer.
// - Summing from zero bounds the error, not its sign. Each truncating add
//   leaves its result short, toward zero, by half an ulp on average, and a
//   partial sum's shortfall shows in the output as far as the partial's
//   sign follows the output's (by the partial's share of it). Over K in the
//   thousands that adds up: uncorrected, the weight gradient (one truncating
//   add a k-step) read 3.7e-8 of the mean magnitude toward zero on an H100,
//   and the convolution (three chained ones a group of taps) 6.3e-8 to
//   7.0e-8, where cuDNN's float32 is unbiased; a GAN's updates add such a
//   drift up. So each partial sum is pushed back before it is added: a
//   k-step's by half an ulp on average (`half_ulp_away`), a group's by the
//   0.83 ulp that measured right for three chained adds (`away_from_zero`).
//   On Gaussian inputs both leave 1e-8 or less; on a cond-128 step's own
//   inputs the convolution 1.8e-8 or less, the weight gradient -1.6e-8 to
//   4.4e-8 (4e-8 to 6e-8 uncorrected): a real step's products are far from
//   uniform in their low bits. Pushing back only the sums a level up (a
//   chunk of 4 k-steps, three chunks of groups) would cost less (363
//   against 391 ms of a cond-128 step's kernels) but left up to 3.1e-8 in
//   the convolution on that step's inputs.
// - The convolution kernel: a block owns a tile of 128 output positions
//   (ti images x th rows x tw columns) and 64 or 32 output channels, and loops
//   over the input channels in chunks of 8. A chunk's input halo (8 channels
//   of ti x (th + 2) x (tw + 2) values, zeros outside the plane) and its
//   weight (all 9 taps) go through a two-stage cp.async ring in shared
//   memory. Each of the 9 taps is then one k-step of 8: its A operand is the
//   halo shifted by the tap, gathered into registers in the mma.sync fragment
//   layout that wgmma's register operand shares; its B operand is the
//   weight, split once per chunk into hi and lo copies in wgmma's K-major
//   layout. Each of the block's two warpgroups multiplies 64 positions by the
//   block's channels with wgmma (m64n64k8 or m64n32k8), three taps at a time.
//   No im2col buffer exists in device memory, and each input value is
//   loaded once per chunk, not 9 times. The input gradient is the same
//   kernel reading the weight flipped and transposed (FLIP).
// - On an H100, mma.sync (K1-K3's route) reached 45-50 TFLOP/s of float32
//   work at the large shapes with every tile tried, the warpgroup MMAs
//   50-55: an MMA's result comes long after its issue, and every three taps
//   wait for theirs (the two-level sum), so two blocks share each SM to
//   overlap one's waits with the other's work.
// - The weight-gradient kernel (mma.sync): a block owns 32 x WARPS_M output
//   channels and 16 input channels (x 9 taps) and loops over chunks of 32
//   positions; dy's chunk and x's halo of it stream through a three-stage
//   ring, and each tap's B fragment reads the halo shifted by the tap.
// - Where a GEMM has too few tiles to fill the card (the ConvLSTM's input
//   gradient; the weight gradient of a layer with few channels and a million
//   positions), the reduction is split across blocks, each writing float32
//   partial sums to a scratch buffer that a second kernel adds in a fixed
//   order with Kahan's compensation: no atomics, so two runs give the same
//   bits.
// - Tile sizes follow the shape (ops/conv.py picks them): the output channels
//   a block, the position tile from the plane, the splits from the tile
//   count and the SM count; shared-memory strides are chosen so a warp's
//   reads fall on distinct banks where the tile allows.

#include "tc_mma.cuh"

namespace t2v {
namespace {

using MF = Mma<float>;

constexpr int kCK = 8;        // input channels per chunk (the MMA depth)
constexpr int kTaps = 9;
constexpr int kStages = 3;     // the weight gradient's ring
constexpr int kSumChunks = 3;  // chunks of 8 input channels a convolution sums apart
constexpr int kSlots = 32;    // positions per chunk of the weight gradient
constexpr int kWgradCh = 16;  // input channels per weight-gradient block
constexpr int kMaxHaloPerThread = 4;

struct ConvArgs {
  const float* x;     // (n, cin, h, w): the input, or dy for the input gradient
  const float* w;     // the weight as stored: (cout, cin, 3, 3), or (cin, cout, 3, 3) under FLIP
  const float* bias;  // (cout) or null; added only when splits == 1
  float* y;           // (n, cout, h, w), or (splits, n, cout, h, w) partial sums
  int n, cin, cout, h, wd;
  int wrow;           // floats per row of the stored weight
  int ti, th, tw;     // the position tile
  int tiles_h, tiles_w, co_tiles;
  int cs;             // halo channel stride in shared memory, floats
  int sb;             // weight row stride in shared memory, floats
  int cps;            // chunks of 8 input channels per split
  int vec;            // weight rows may be copied in 16-byte pieces
};

struct WgradArgs {
  const float* x;     // (n, cin, h, w)
  const float* dy;    // (n, cout, h, w)
  float* dw;          // (cout, cin, 3, 3), or (splits, cout, cin, 3, 3) partial sums
  int n, cin, cout, h, wd;
  int ti, th, tw;     // the position chunk, ti * th * tw <= 32
  int tiles_h, tiles_w, nq;
  int qps;            // chunks per split
  int cs;             // halo channel stride in shared memory, floats
  int ci_tiles;
};

__device__ __forceinline__ void cp_async_bytes16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

// x ~ hi + lo, both rounded to TF32 (to nearest, ties away from zero, as
// Mma<float>::split rounds hi; it truncates lo, which biases each operand's
// representation by up to 2^-23 of it where rounding leaves half that)
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ MF::A make_a(float v0, float v1, float v2, float v3) {
  MF::A a;
  split_rn(v0, a.hi[0], a.lo[0]);
  split_rn(v1, a.hi[1], a.lo[1]);
  split_rn(v2, a.hi[2], a.lo[2]);
  split_rn(v3, a.hi[3], a.lo[3]);
  return a;
}

__device__ __forceinline__ MF::B make_b(float v0, float v1) {
  MF::B b;
  split_rn(v0, b.hi[0], b.lo[0]);
  split_rn(v1, b.hi[1], b.lo[1]);
  return b;
}

// s += x with Kahan's compensation c (s - c is the sum)
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// t pushed away from zero by half an ulp on average: by one ulp where its
// last bit is set, which is independent of the bits a truncation dropped
__device__ __forceinline__ float half_ulp_away(float t) {
  const int b = __float_as_int(t);
  return __int_as_float(b + (b & 1));
}

// c += a b over one k-step: the three passes summed from zero, the small
// ones first, then added to c in float32, rounding to nearest. The large
// pass's add, which truncates, leaves the sum half an ulp short on average;
// half_ulp_away takes that bias out.
__device__ __forceinline__ void mma3_rn(float c[4], const MF::A& a, const MF::B& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  MF::pass(t, a.lo, b.hi);
  MF::pass(t, a.hi, b.lo);
  MF::pass(t, a.hi, b.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += half_ulp_away(t[e]);
}

// Rows [0, R) x floats [0, L) of the row-major weight block at `src` (row
// stride `stride`) into `dst` (row stride sb); rows at or past rv and floats
// at or past lv are zero.
template <int R, int L, int THREADS>
__device__ __forceinline__ void copy_weight(float* dst, int sb, const float* src, int stride,
                                            int rv, int lv, bool vec) {
  if (vec) {
    constexpr int P = L / 4;
    static_assert(L % 4 == 0, "weight rows split into 16-byte pieces");
    for (int i = threadIdx.x; i < R * P; i += THREADS) {
      const int row = i / P, f = (i - row * P) * 4;
      const int bytes = row < rv ? min(max(lv - f, 0), 4) * 4 : 0;
      cp_async_bytes16(dst + row * sb + f, bytes ? src + (size_t)row * stride + f : src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < R * L; i += THREADS) {
      const int row = i / L, f = i - row * L;
      const bool live = row < rv && f < lv;
      cp_async<4>(dst + row * sb + f, live ? src + (size_t)row * stride + f : src, live);
    }
  }
}

// The halo positions a thread copies: up to kMaxHaloPerThread of them, each
// for the channels g, g + groups, ... of a chunk. Position hp of a tile of
// ti x th x tw lies at (i, hh, ww) in ti x (th + 2) x (tw + 2).
struct HaloPlan {
  int hp[kMaxHaloPerThread];
  int i[kMaxHaloPerThread], hh[kMaxHaloPerThread], ww[kMaxHaloPerThread];
  int count, g, groups;

  template <int THREADS>
  __device__ __forceinline__ void init(int ti, int th, int tw) {
    const int rs = tw + 2, pl = (th + 2) * rs, halo = ti * pl;
    groups = max(1, THREADS / halo);
    const int t = threadIdx.x;
    g = t / halo;               // >= groups for threads with no halo work when groups > 1
    count = 0;
#pragma unroll
    for (int j = 0; j < kMaxHaloPerThread; ++j) {
      const int e = groups > 1 ? (j == 0 && g < groups ? t - g * halo : -1) : t + j * THREADS;
      if (e >= 0 && e < halo) {
        hp[j] = e;
        i[j] = e / pl;
        hh[j] = (e - i[j] * pl) / rs;
        ww[j] = e - i[j] * pl - hh[j] * rs;
        count = j + 1;
      } else {
        hp[j] = -1;
        i[j] = hh[j] = ww[j] = 0;
      }
    }
    if (groups == 1) g = 0;
  }
};

// ---------------------------------------------------------------------------
// The convolution: y (positions x cout) = im2col(x) (positions x 9 cin) w^T,
// each k-step an m64nBNk8 warpgroup MMA (wgmma) per 64 positions. A (the
// halo's taps) comes from registers in the mma.sync fragment layout, split
// at the fragment; B (the weight) from shared memory, split once per chunk
// into hi and lo copies in wgmma's K-major layout without swizzle: core
// matrices of 8 output channels x 4 input channels (128 bytes), the two of a
// k-step's 8 input channels 128 bytes apart (the descriptor's LBO), the next
// 8 output channels 256 bytes on (SBO).

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

__device__ __forceinline__ uint64_t wgmma_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kConvStages = 2;

// A group of three taps chains three large adds, each truncating at its
// own partial sum: its sum comes out short by more than one add's half an
// ulp and by less than three (the earlier partials are smaller, and their
// signs follow the group's only in part). On an H100 the outputs sat 6.3e-8
// to 7.0e-8 of their mean magnitude toward zero at every shape of the
// cond-128 generator, where cuDNN's float32 sits within 1e-9 at the
// ConvLSTM's and base.up0's. Each group's sum is pushed away from zero
// before it is added: by one ulp in the first two groups of a chunk and by
// half_ulp_away in the third, 0.83 ulp on average, which left 2e-8 or less
// on Gaussian inputs and on the cond-128 step's own activations and
// gradients (chip_smoke.py phase cond128 holds it there).
__device__ __forceinline__ float away_from_zero(float t, int group) {
  return group < 2 ? __int_as_float(__float_as_int(t) + 1) : half_ulp_away(t);
}

template <int BN, bool FLIP>
__global__ void __launch_bounds__(256, 2)
conv3x3_tc_kernel(const ConvArgs a) {
  constexpr int THREADS = 256;
  constexpr int NR = BN / 2;             // accumulator registers a thread holds
  constexpr int WROWS = FLIP ? kCK : BN;
  constexpr int CANON = kTaps * BN * kCK;  // floats of one split copy of a chunk's weight

  extern __shared__ __align__(16) float smem[];
  float* bhi = smem;
  float* blo = smem + CANON;
  float* raw = smem + 2 * CANON;
  const int stage_floats = kCK * a.cs + WROWS * a.sb;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c = lane & 3;

  const int co_tile = blockIdx.x % a.co_tiles;
  int pos_tile = blockIdx.x / a.co_tiles;
  const int tw_i = pos_tile % a.tiles_w;
  pos_tile /= a.tiles_w;
  const int th_i = pos_tile % a.tiles_h;
  const int ti_i = pos_tile / a.tiles_h;
  const int n0 = ti_i * a.ti, h0 = th_i * a.th, w0 = tw_i * a.tw, co0 = co_tile * BN;
  const int hw = a.h * a.wd;
  const int rs = a.tw + 2, pl = (a.th + 2) * rs;
  const int slots = a.ti * a.th * a.tw;
  const int thw = a.th * a.tw;

  HaloPlan hplan;
  hplan.init<THREADS>(a.ti, a.th, a.tw);
  int hoff[kMaxHaloPerThread];
  bool hlive[kMaxHaloPerThread];
#pragma unroll
  for (int j = 0; j < kMaxHaloPerThread; ++j) {
    const int ni = n0 + hplan.i[j], hi = h0 + hplan.hh[j] - 1, wi = w0 + hplan.ww[j] - 1;
    hlive[j] = hplan.hp[j] >= 0 && ni < a.n && hi >= 0 && hi < a.h && wi >= 0 && wi < a.wd;
    hoff[j] = hlive[j] ? ni * a.cin * hw + hi * a.wd + wi : 0;
  }

  // A fragment: rows warp * 16 + r (+ 8) of the block's 128 positions (warp
  // w % 4 of warpgroup w / 4 holds rows 16 (w % 4) of the group's 64), channel c
  int aoff[2];
#pragma unroll
  for (int h8 = 0; h8 < 2; ++h8) {
    const int p = warp * 16 + r + 8 * h8;
    const int i = p / thw, hh = (p - i * thw) / a.tw, ww = p - i * thw - hh * a.tw;
    aoff[h8] = (p < slots ? i * pl + hh * rs + ww : 0) + c * a.cs;
  }

  const int nch = (a.cin + kCK - 1) / kCK;
  const int c_begin = blockIdx.y * a.cps;
  const int count = min(nch, c_begin + a.cps) - c_begin;

  auto load = [&](int stage, int chunk) {
    float* hs = raw + stage * stage_floats;
    float* ws = hs + kCK * a.cs;
    const int c0 = chunk * kCK;
#pragma unroll
    for (int j = 0; j < kMaxHaloPerThread; ++j) {
      if (j < hplan.count && hplan.hp[j] >= 0) {
        for (int ch = hplan.g; ch < kCK; ch += hplan.groups) {
          const bool live = hlive[j] && c0 + ch < a.cin;
          cp_async<4>(hs + ch * a.cs + hplan.hp[j],
                      live ? a.x + hoff[j] + (size_t)(c0 + ch) * hw : a.x, live);
        }
      }
    }
    if (FLIP) {
      copy_weight<kCK, BN * kTaps, THREADS>(ws, a.sb, a.w + (size_t)c0 * a.wrow + co0 * kTaps,
                                            a.wrow, a.cin - c0, (a.cout - co0) * kTaps,
                                            a.vec != 0);
    } else {
      copy_weight<BN, kCK * kTaps, THREADS>(ws, a.sb, a.w + (size_t)co0 * a.wrow + c0 * kTaps,
                                            a.wrow, a.cout - co0, (a.cin - c0) * kTaps,
                                            a.vec != 0);
    }
  };

  // acc: the sum over the chunks so far; cc: over the current kSumChunks;
  // t: over one group of three taps
  float acc[NR], cc[NR], t[NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) acc[e] = 0.f;

  if (count > 0) load(0, c_begin);
  cp_async_commit();
  for (int it = 0; it < count; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < count) load((it + 1) % kConvStages, c_begin + it + 1);
    cp_async_commit();

    // the chunk's weight, split into hi and lo in the canonical layout: a
    // warp's 32 lanes write 32 consecutive floats and read the staged rows
    // at the row stride ops/conv.py chose to spread them over the banks
    const float* hs = raw + (it % kConvStages) * stage_floats;
    const float* ws = hs + kCK * a.cs;
    // i runs over the canonical layout: 4 input channels (kq) of 8 output
    // channels (nr) of a core matrix, its two halves of 8 channels (kh), the
    // output channels' groups of 8 (g), the taps
    for (int i = tid; i < CANON; i += THREADS) {
      const int kq = i & 3, nr = (i >> 2) & 7, kh = (i >> 5) & 1, g = (i >> 6) % (BN / 8);
      const int tap = i / (BN * kCK);
      const int n = g * 8 + nr, k = kh * 4 + kq;
      const float v = FLIP ? ws[k * a.sb + n * kTaps + (kTaps - 1 - tap)]
                           : ws[n * a.sb + k * kTaps + tap];
      uint32_t vh, vl;
      split_rn(v, vh, vl);
      bhi[i] = __uint_as_float(vh);
      blo[i] = __uint_as_float(vl);
    }
    fence_proxy_async();
    __syncthreads();

    if (it % kSumChunks == 0) {
#pragma unroll
      for (int e = 0; e < NR; ++e) cc[e] = 0.f;
    }
    auto frag = [&](int tap) {
      const int ta = (tap / 3) * rs + (tap % 3);
      return make_a(hs[aoff[0] + ta], hs[aoff[1] + ta], hs[aoff[0] + ta + 4 * a.cs],
                    hs[aoff[1] + ta + 4 * a.cs]);
    };
    // three taps a group: their six small passes, then their three large
    // ones, summed from zero in the tensor cores and added in float32
#pragma unroll
    for (int g3 = 0; g3 < 3; ++g3) {
      const MF::A f0 = frag(3 * g3), f1 = frag(3 * g3 + 1), f2 = frag(3 * g3 + 2);
      const uint64_t h0 = wgmma_desc(bhi + (3 * g3) * BN * kCK);
      const uint64_t h1 = wgmma_desc(bhi + (3 * g3 + 1) * BN * kCK);
      const uint64_t h2 = wgmma_desc(bhi + (3 * g3 + 2) * BN * kCK);
      const uint64_t l0 = wgmma_desc(blo + (3 * g3) * BN * kCK);
      const uint64_t l1 = wgmma_desc(blo + (3 * g3 + 1) * BN * kCK);
      const uint64_t l2 = wgmma_desc(blo + (3 * g3 + 2) * BN * kCK);
      wgmma_fence();
      Wgmma<BN>::mma(t, f0.lo, h0, 0);
      Wgmma<BN>::mma(t, f0.hi, l0, 1);
      Wgmma<BN>::mma(t, f1.lo, h1, 1);
      Wgmma<BN>::mma(t, f1.hi, l1, 1);
      Wgmma<BN>::mma(t, f2.lo, h2, 1);
      Wgmma<BN>::mma(t, f2.hi, l2, 1);
      Wgmma<BN>::mma(t, f0.hi, h0, 1);
      Wgmma<BN>::mma(t, f1.hi, h1, 1);
      Wgmma<BN>::mma(t, f2.hi, h2, 1);
      wgmma_commit();
      wgmma_wait0();
      fence_operand(t);
#pragma unroll
      for (int e = 0; e < NR; ++e) cc[e] += away_from_zero(t[e], g3);
    }
    if (it % kSumChunks == kSumChunks - 1 || it == count - 1) {
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[e] += cc[e];
    }
  }

  float* out = a.y + (size_t)blockIdx.y * a.n * a.cout * hw;
  const bool add_bias = a.bias != nullptr && gridDim.y == 1;
#pragma unroll
  for (int h8 = 0; h8 < 2; ++h8) {
    const int p = warp * 16 + r + 8 * h8;
    const int i = p / thw, hh = (p - i * thw) / a.tw, ww = p - i * thw - hh * a.tw;
    const int ni = n0 + i, hi = h0 + hh, wi = w0 + ww;
    if (p >= slots || ni >= a.n || hi >= a.h || wi >= a.wd) continue;
    float* row = out + (size_t)ni * a.cout * hw + hi * a.wd + wi;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + j * 8 + 2 * c + e;
        if (co < a.cout) row[(size_t)co * hw] = acc[4 * j + 2 * h8 + e] + (add_bias ? a.bias[co] : 0.f);
      }
  }
}

// ---------------------------------------------------------------------------
// The weight gradient: dw (cout x (9 taps x cin)) = dy (cout x positions)
// im2col(x) (positions x (9 taps x cin)). Warps WM x 2: a warp owns 32 output
// channels and 8 input channels at all 9 taps (9 tiles of 8 columns).
template <int WM>
__global__ void __launch_bounds__(WM * 64)
conv3x3_tc_wgrad_kernel(const WgradArgs a) {
  constexpr int THREADS = WM * 64;
  constexpr int BM = 32 * WM;
  constexpr int MT = 2;
  constexpr int DS = kSlots + 4;       // dy row stride: fragment reads on distinct banks

  extern __shared__ __align__(16) float smem[];
  const int stage_floats = BM * DS + kWgradCh * a.cs;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  const int ci_tile = blockIdx.x % a.ci_tiles, co_tile = blockIdx.x / a.ci_tiles;
  const int co0 = co_tile * BM, ci0 = ci_tile * kWgradCh;
  const int hw = a.h * a.wd;
  const int rs = a.tw + 2, pl = (a.th + 2) * rs;
  const int thw = a.th * a.tw, slots = a.ti * thw;

  // dy copies: slot tid % 32, output channels tid / 32 + k * (THREADS / 32)
  const int my_slot = tid % kSlots;
  const int si = my_slot / thw, sh = (my_slot - si * thw) / a.tw, sw = my_slot - si * thw - sh * a.tw;

  HaloPlan hplan;
  hplan.init<THREADS>(a.ti, a.th, a.tw);

  // fragment offsets: the B column (input channel r of the warp's 8, tap t)
  // and the A/B k index (slot) of each k-step
  const int bcol = (wn * 8 + r) * a.cs;
  int soff[kSlots / 8][2];
#pragma unroll
  for (int ks = 0; ks < kSlots / 8; ++ks)
#pragma unroll
    for (int h4 = 0; h4 < 2; ++h4) {
      const int p = ks * 8 + c + 4 * h4;
      const int i = p / thw, hh = (p - i * thw) / a.tw, ww = p - i * thw - hh * a.tw;
      soff[ks][h4] = p < slots ? i * pl + hh * rs + ww : 0;
    }

  const int q_begin = blockIdx.y * a.qps;
  const int count = min(a.nq, q_begin + a.qps) - q_begin;

  auto load = [&](int stage, int q) {
    float* ds = smem + stage * stage_floats;
    float* hs = ds + BM * DS;
    const int tw_i = q % a.tiles_w;
    const int rest = q / a.tiles_w;
    const int th_i = rest % a.tiles_h, ti_i = rest / a.tiles_h;
    const int n0 = ti_i * a.ti, h0 = th_i * a.th, w0 = tw_i * a.tw;
    {
      const int ni = n0 + si, hi = h0 + sh, wi = w0 + sw;
      const bool slot_live = my_slot < slots && ni < a.n && hi < a.h && wi < a.wd;
      const int off = slot_live ? (ni * a.cout + co0) * hw + hi * a.wd + wi : 0;
      for (int row = tid / kSlots; row < BM; row += THREADS / kSlots) {
        const bool live = slot_live && co0 + row < a.cout;
        cp_async<4>(ds + row * DS + my_slot, live ? a.dy + off + (size_t)row * hw : a.dy, live);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxHaloPerThread; ++j) {
      if (j < hplan.count && hplan.hp[j] >= 0) {
        const int ni = n0 + hplan.i[j], hi = h0 + hplan.hh[j] - 1, wi = w0 + hplan.ww[j] - 1;
        const bool pos_live = ni < a.n && hi >= 0 && hi < a.h && wi >= 0 && wi < a.wd;
        const int off = pos_live ? (ni * a.cin + ci0) * hw + hi * a.wd + wi : 0;
        for (int ch = hplan.g; ch < kWgradCh; ch += hplan.groups) {
          const bool live = pos_live && ci0 + ch < a.cin;
          cp_async<4>(hs + ch * a.cs + hplan.hp[j], live ? a.x + off + (size_t)ch * hw : a.x,
                      live);
        }
      }
    }
  };

  float acc[MT][kTaps][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load(s, q_begin + s);
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < count) load(nxt % kStages, q_begin + nxt);
    cp_async_commit();

    const float* ds = smem + (it % kStages) * stage_floats;
    const float* hs = ds + BM * DS;
    float cc[MT][kTaps][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) cc[mt][t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSlots / 8; ++ks) {
      MF::A af[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* d0 = ds + (wm * 32 + mt * 16 + r) * DS + ks * 8 + c;
        af[mt] = make_a(d0[0], d0[8 * DS], d0[4], d0[8 * DS + 4]);
      }
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const int ta = bcol + (t / 3) * rs + (t % 3);
        const MF::B bf = make_b(hs[ta + soff[ks][0]], hs[ta + soff[ks][1]]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3_rn(cc[mt][t], af[mt], bf);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][t][e] += cc[mt][t][e];
  }

  float* out = a.dw + (size_t)blockIdx.y * a.cout * a.cin * kTaps;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int co = co0 + wm * 32 + mt * 16 + r + 8 * h8;
      if (co >= a.cout) continue;
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = ci0 + wn * 8 + 2 * c + e;
          if (ci < a.cin) out[((size_t)co * a.cin + ci) * kTaps + t] = acc[mt][t][2 * h8 + e];
        }
    }
}

// out[i] = sum over s < splits, in order, of part[s * total + i] (+ bias[(i / hw) % cout])
__global__ void conv3x3_tc_reduce_kernel(const float* part, int splits, long long total,
                                         float* out, const float* bias, int hw, int cout) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = part[i], c = 0.f;
    for (int k = 1; k < splits; ++k) kahan_add(s, c, part[k * total + i]);
    s -= c;
    if (bias != nullptr) s += bias[(i / hw) % cout];
    out[i] = s;
  }
}

// Lets a kernel take up to the card's 227 KB of dynamic shared memory, once
// per device.
template <typename K>
cudaError_t prepare(K kernel, bool (&ready)[64], int device) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  return cudaSuccess;
}

template <int BN, bool FLIP>
cudaError_t launch_conv(const ConvArgs& a, int splits, int smem_bytes, int device,
                        cudaStream_t stream) {
  static bool ready[64] = {};
  auto kernel = conv3x3_tc_kernel<BN, FLIP>;
  cudaError_t err = prepare(kernel, ready, device);
  if (err != cudaSuccess) return err;
  const long long pos_tiles = (long long)((a.n + a.ti - 1) / a.ti) * a.tiles_h * a.tiles_w;
  kernel<<<dim3((unsigned)(pos_tiles * a.co_tiles), splits), 256, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int WM>
cudaError_t launch_wgrad(const WgradArgs& a, int splits, int smem_bytes, int device,
                         cudaStream_t stream) {
  static bool ready[64] = {};
  auto kernel = conv3x3_tc_wgrad_kernel<WM>;
  cudaError_t err = prepare(kernel, ready, device);
  if (err != cudaSuccess) return err;
  const int co_tiles = (a.cout + 32 * WM - 1) / (32 * WM);
  kernel<<<dim3(co_tiles * a.ci_tiles, splits), WM * 64, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_conv(const ConvArgs& a, int splits, int cfg, int flip, int smem_bytes,
                          int device, cudaStream_t s) {
  switch (cfg * 2 + (flip ? 1 : 0)) {
    case 0: return launch_conv<64, false>(a, splits, smem_bytes, device, s);
    case 1: return launch_conv<64, true>(a, splits, smem_bytes, device, s);
    case 2: return launch_conv<32, false>(a, splits, smem_bytes, device, s);
    case 3: return launch_conv<32, true>(a, splits, smem_bytes, device, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_wgrad(const WgradArgs& a, int splits, int cfg, int smem_bytes, int device,
                           cudaStream_t s) {
  switch (cfg) {
    case 0: return launch_wgrad<1>(a, splits, smem_bytes, device, s);
    case 1: return launch_wgrad<2>(a, splits, smem_bytes, device, s);
    case 2: return launch_wgrad<4>(a, splits, smem_bytes, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace t2v

using t2v::ConvArgs;
using t2v::WgradArgs;

// The convolution (flip 0) or the input gradient (flip 1). cfg picks the
// block tile: 0 = 128 positions x 64 channels, 1 = 128 x 32 (two warpgroups
// each). y holds splits x n x cout x h x w floats.
extern "C" int t2v_conv3x3(const void* x, const void* w, const void* bias, void* y, int n,
                           int cin, int cout, int h, int wd, int wrow, int ti, int th, int tw,
                           int tiles_h, int tiles_w, int co_tiles, int cs, int sb, int cps,
                           int splits, int vec, int cfg, int flip, int smem_bytes, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvArgs a{static_cast<const float*>(x), static_cast<const float*>(w),
                   static_cast<const float*>(bias), static_cast<float*>(y), n, cin, cout, h,
                   wd, wrow, ti, th, tw, tiles_h, tiles_w, co_tiles, cs, sb, cps, vec};
  return static_cast<int>(t2v::dispatch_conv(a, splits, cfg, flip, smem_bytes, device,
                                             static_cast<cudaStream_t>(stream)));
}

// The weight gradient. cfg picks 32 << cfg output channels a block (1, 2 or
// 4 warp rows); dw holds splits x cout x cin x 9 floats.
extern "C" int t2v_conv3x3_wgrad(const void* x, const void* dy, void* dw, int n, int cin,
                                 int cout, int h, int wd, int ti, int th, int tw, int tiles_h,
                                 int tiles_w, int nq, int qps, int cs, int ci_tiles, int splits,
                                 int cfg, int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WgradArgs a{static_cast<const float*>(x), static_cast<const float*>(dy),
                    static_cast<float*>(dw), n, cin, cout, h, wd, ti, th, tw, tiles_h, tiles_w,
                    nq, qps, cs, ci_tiles};
  return static_cast<int>(t2v::dispatch_wgrad(a, splits, cfg, smem_bytes, device,
                                              static_cast<cudaStream_t>(stream)));
}

// out = the fixed-order sum of `splits` partial results of `total` floats
// each, plus bias[(i / hw) % cout] where bias is given.
extern "C" int t2v_conv3x3_reduce(const void* part, int splits, long long total, void* out,
                                  const void* bias, int hw, int cout, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (total + 255) / 256;
  t2v::conv3x3_tc_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), splits, total, static_cast<float*>(out),
      static_cast<const float*>(bias), hw, cout);
  return static_cast<int>(cudaGetLastError());
}
