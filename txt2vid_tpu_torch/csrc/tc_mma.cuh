// Tensor-core building blocks of the attention kernels (sm_90a): mma.sync
// fragments for float32 through three TF32 passes and for bfloat16 through
// one pass, both accumulating in float32, and cp.async tile copies into
// shared memory.
//
// Fragment coordinates follow the PTX ISA's mma.m16n8k8 (tf32) and
// mma.m16n8k16 (bf16) layouts. A lane holds rows r = lane / 4 and r + 8 of a
// 16-row tile; c = lane % 4 picks its columns. An accumulator tile (16 x 8)
// holds (r, 2c), (r, 2c + 1), (r + 8, 2c), (r + 8, 2c + 1) in elements 0..3.
//
// Float32 as three TF32 passes: x ~ hi + lo with hi = x rounded to TF32 (to
// nearest, ties away from zero, as cvt.rna.tf32.f32) and lo = x - hi, exact
// in float32, truncated to TF32; then a * b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
// (CUTLASS's 3xTF32). lo's truncation and the dropped a_lo b_lo are each
// about 2^-22 of the product, so the result keeps float32's accuracy where
// one pass (2^-11) would move a softmax weight by a percent at logits of tens.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace t2v {

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU's approximation (2 ulp), subnormal results flushed to zero:
// exp2f without the subnormal handling around it
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Shared-memory row stride, in elements, of a staged tile whose rows hold W
// values of T. Rows of up to 16 bytes stay packed; wider rows gain 16 bytes.
// For float32 that gives strides of 4, 20 and 68 words, on which the fragment
// reads below (rows 2c and 2c + 1 at column r, or row r at column c) fall on
// 32 distinct banks.
template <typename T, int W>
__host__ __device__ constexpr int row_stride() {
  return W * (int)sizeof(T) <= 16 ? W : W + 16 / (int)sizeof(T);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(gmem), "n"(BYTES), "r"(live ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copy of rows [0, ROWS) of the row-major (rows, W) array at `src`
// into `dst` with row stride S. Rows at or past `valid` (>= 1) are filled
// with zeros. Every pointer is aligned to the copy's chunk: the rows' width
// in bytes, capped at 16.
template <typename T, int W, int S, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int valid) {
  constexpr int kRowBytes = W * (int)sizeof(T);
  constexpr int kChunk = kRowBytes < 16 ? kRowBytes : 16;
  static_assert(kChunk == 4 || kChunk == 8 || kChunk == 16, "cp.async copies 4, 8 or 16 bytes");
  static_assert(kRowBytes % kChunk == 0 && (S * (int)sizeof(T)) % kChunk == 0,
                "rows must split into whole chunks");
  constexpr int kPerRow = kRowBytes / kChunk;
  constexpr int kElems = kChunk / (int)sizeof(T);
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int row = i / kPerRow, col = (i % kPerRow) * kElems;
    const bool live = row < valid;
    cp_async<kChunk>(dst + row * S + col, src + (size_t)(live ? row : 0) * W + col, live);
  }
}

template <typename T>
struct Mma;

// float32: m16n8k8 TF32, three passes
template <>
struct Mma<float> {
  static constexpr int K = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // The splits are integer operations on the bit pattern: hi as
  // cvt.rna.tf32.f32 rounds a finite x (the cvt compiles to a longer
  // sequence), lo by dropping its low 13 bits. Operands are finite here.
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
  }
  static __device__ __forceinline__ void pass(float c[4], const uint32_t a[4],
                                              const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // c += a b, the small terms first
  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    pass(c, a.lo, b.hi);
    pass(c, a.hi, b.lo);
    pass(c, a.hi, b.hi);
  }
  // c += a b with the two small passes and the large one each summed from
  // zero and added to c in float32, rounding to nearest. In `mma` every pass
  // after the first adds into c with the tensor cores' truncation at c's
  // magnitude, so over d = 16 (two steps) the logits came out about two ulps
  // short of float64 on average.
  static __device__ __forceinline__ void mma_rn(float c[4], const A& a, const B& b) {
    float small[4] = {}, large[4] = {};
    pass(small, a.lo, b.hi);
    pass(small, a.hi, b.lo);
    pass(large, a.hi, b.hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += large[e] + small[e];
  }
  static __device__ __forceinline__ A make_a(float v0, float v1, float v2, float v3) {
    A a;
    split(v0, a.hi[0], a.lo[0]);
    split(v1, a.hi[1], a.lo[1]);
    split(v2, a.hi[2], a.lo[2]);
    split(v3, a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ B make_b(float v0, float v1) {
    B b;
    split(v0, b.hi[0], b.lo[0]);
    split(v1, b.hi[1], b.lo[1]);
    return b;
  }
  // A = rows [0, 16) x columns [k0, k0 + 8) of get(row, k)
  template <typename F>
  static __device__ __forceinline__ A load_a(F get, int k0, int r, int c) {
    return make_a(get(r, k0 + c), get(r + 8, k0 + c), get(r, k0 + c + 4),
                  get(r + 8, k0 + c + 4));
  }
  // B = rows [k0, k0 + 8) x columns [n0, n0 + 8) of get(k, n)
  template <typename F>
  static __device__ __forceinline__ B load_b(F get, int k0, int n0, int r, int c) {
    return make_b(get(k0 + c, n0 + r), get(k0 + c + 4, n0 + r));
  }
  // The A operand over the 8 columns of accumulator tile acc[ks]. Its K order
  // is permuted (position c holds column 2c, position c + 4 column 2c + 1),
  // so the accumulator's elements are the operand's without a shuffle;
  // load_b_perm reads B in the same order.
  static __device__ __forceinline__ A from_acc(const float (*acc)[4], int ks) {
    const float* x = acc[ks];
    return make_a(x[0], x[2], x[1], x[3]);
  }
  template <typename F>
  static __device__ __forceinline__ B load_b_perm(F get, int k0, int n0, int r, int c) {
    return make_b(get(k0 + 2 * c, n0 + r), get(k0 + 2 * c + 1, n0 + r));
  }
};

// bfloat16: m16n8k16, one pass; operands rounded to bf16 where they are packed
template <>
struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  struct A { uint32_t v[4]; };
  struct B { uint32_t v[2]; };

  // lo goes to the lower half: the lower K index of a pair
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(b.v[0]), "r"(b.v[1]));
  }
  // One pass, and S's d <= 16 = K makes one MMA step from zero: there is no
  // truncating add to repair, so this is mma.
  static __device__ __forceinline__ void mma_rn(float c[4], const A& a, const B& b) {
    mma(c, a, b);
  }
  template <typename F>
  static __device__ __forceinline__ A load_a(F get, int k0, int r, int c) {
    const int k = k0 + 2 * c;
    return A{{pack(get(r, k), get(r, k + 1)), pack(get(r + 8, k), get(r + 8, k + 1)),
              pack(get(r, k + 8), get(r, k + 9)), pack(get(r + 8, k + 8), get(r + 8, k + 9))}};
  }
  template <typename F>
  static __device__ __forceinline__ B load_b(F get, int k0, int n0, int r, int c) {
    const int k = k0 + 2 * c;
    return B{{pack(get(k, n0 + r), get(k + 1, n0 + r)),
              pack(get(k + 8, n0 + r), get(k + 9, n0 + r))}};
  }
  // The A operand over accumulator tiles acc[2 ks] and acc[2 ks + 1], in
  // natural K order
  static __device__ __forceinline__ A from_acc(const float (*acc)[4], int ks) {
    const float* x = acc[2 * ks];
    const float* y = acc[2 * ks + 1];
    return A{{pack(x[0], x[1]), pack(x[2], x[3]), pack(y[0], y[1]), pack(y[2], y[3])}};
  }
  template <typename F>
  static __device__ __forceinline__ B load_b_perm(F get, int k0, int n0, int r, int c) {
    return load_b(get, k0, n0, r, c);
  }
};

}  // namespace t2v
