// Shared pieces of the three flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd_dkv.cu, flash_attention_bwd_dq.cu): tile geometry,
// the visibility predicate, asynchronous tile loads and the warp-level
// tensor-core products.
//
// A block is 4 warps (128 threads). It owns a 64-row tile (queries for the
// forward and dQ, keys for dK/dV); warp w owns rows 16w .. 16w+15 of it and
// computes every product of those rows with `mma.sync`:
//   bfloat16: m16n8k16, bf16 operands, fp32 accumulation; operands come from
//             shared memory through `ldmatrix` (`.trans` where the product
//             reduces over the rows of a tile);
//   float32:  m16n8k8 TF32 in the 3xTF32 split: x = hi + lo with
//             hi = rna_tf32(x), lo = rna_tf32(x - hi), and
//             a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b summed in fp32, small
//             terms first: about fp32 accuracy, no single-pass TF32.
//             rna_tf32 gives the bits of cvt.rna.tf32.f32 from an integer
//             add and a mask; every operand is split in the loop that loads
//             it, and with cvt the conversions, not the tensor cores, set
//             the kernels' time on the H100 (PERF.md, section 6).
// Tiles live in shared memory in their input type, rows padded (f32 by 4
// floats, bf16 by 8 values) so that the fragment loads of a warp fall in
// distinct banks. The score-shaped intermediates (S, dP, P, dS) stay in
// registers: the accumulator fragment of one product is the A operand of
// the next. For bf16 the m16n8k16 layouts line up; for TF32 m16n8k8 they
// do not, so the k index of that product is permuted (fragment k t <-> tile
// column 2t, k t+4 <-> column 2t+1) and the B operand is loaded with the
// same permutation.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mxtpu_flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kOwn = 16 * kWarps;      // rows of the tile a block owns (64)

// Row stride, in elements, of a shared tile of head dim D.
template <typename T, int D> __host__ __device__ constexpr int row_stride() {
  return D + (sizeof(T) == 4 ? 4 : 8);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two adjacent outputs (columns d, d+1 of one row) in T.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Does query row r see key kc through the causal band (bottom-right aligned,
// offset Lk - Lq) and the sliding window? The key mask is checked apart.
__device__ __forceinline__ bool in_band(int r, int kc, int off, int causal,
                                        int window) {
  if (!causal) return true;
  if (kc > r + off) return false;
  return window <= 0 || kc > r + off - window;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16) from global to shared memory; with
// valid == false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + n) of a contiguous (L, D) slab into a [R][row_stride]
// shared tile, 16 bytes per cp.async; rows at or past n, or past L, are
// zero. The padding columns are not written.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows_async(T* dst,
                                                const T* __restrict__ src,
                                                int r0, int n, int L) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = D / kPer;     // chunks per row
  constexpr int LD = row_stride<T, D>();
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int g = r0 + r;
    const bool ok = r < n && g < L;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? g : 0) * D + c, ok);
  }
}

// Entries [r0, r0 + n) of a length-L fp32 or int32 vector into [R] shared
// slots (zero past n or L), 4 bytes per cp.async.
template <int R, typename V>
__device__ __forceinline__ void load_vec_async(V* dst, const V* __restrict__ src,
                                               int r0, int n, int L) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool ok = r < n && r0 + r < L;
    cp_async4(dst + r, src + (ok ? r0 + r : 0), ok);
  }
}

// bf16 D = 8 runs the k16 products over 16 columns: zero the padding
// columns 8..15 of an [R][16] tile once, before the first product.
template <typename T, int D, int R>
__device__ __forceinline__ void zero_pad_k16(T* tile) {
  constexpr int LD = row_stride<T, D>();
  if constexpr (sizeof(T) == 2 && D % 16 != 0) {
    for (int r = threadIdx.x; r < R; r += kThreads)
#pragma unroll
      for (int c = D; c < LD; ++c) tile[r * LD + c] = from_float<T>(0.f);
  }
}

// ---------------------------------------------------------------- mma.sync

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d += a . b, one 16x8x16 bf16 tile (fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, one 16x8x8 TF32 tile (fp32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32, to nearest with ties away from zero: for finite x the
// bits that cvt.rna.tf32.f32 gives, from an integer add and a mask
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a . b in 3xTF32: the two cross terms first, then hi . hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc (16 x N) += A (16 x K) . B^T, with the warp's 16 rows of A at `a`
// and the N rows of B at `b`, both [rows][LD] in shared memory, K
// contiguous (S = Q K^T, dP = dO V^T and their transposes). K = D.
template <int N, int K, int LD>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[N / 8][4],
                                            const float* a, const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ar = a + g * LD + t;
  const float* br = b + g * LD + t;
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 8) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(ar[kk], a_hi[0], a_lo[0]);
    split_tf32(ar[8 * LD + kk], a_hi[1], a_lo[1]);
    split_tf32(ar[kk + 4], a_hi[2], a_lo[2]);
    split_tf32(ar[8 * LD + kk + 4], a_hi[3], a_lo[3]);
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(br[nb * 8 * LD + kk], b_hi[0], b_lo[0]);
      split_tf32(br[nb * 8 * LD + kk + 4], b_hi[1], b_lo[1]);
      mma_3xtf32(acc[nb], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

template <int N, int K, int LD>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[N / 8][4],
                                            const __nv_bfloat16* a,
                                            const __nv_bfloat16* b) {
  static_assert(N % 16 == 0, "B rows come in pairs of 8");
  constexpr int K16 = (K + 15) / 16 * 16;  // D = 8 reads the zeroed padding
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = smem_addr(
      a + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
  const uint32_t b0 = smem_addr(
      b + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < K16; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a0 + kk * 2);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b0 + (np * 16 * LD + kk) * 2);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += C (16 x K) . B, with C the fp32 accumulator fragments of
// an earlier product (rounded to T here: P and dS are rounded to the input
// type before their products, as the reference does) and B [K][LD] in
// shared memory, N contiguous (dV += P^T dO, dK += dS^T Q, dQ += dS K).
// N = D, K = the width of the score tile.
template <int N, int K, int LD>
__device__ __forceinline__ void mma_creg_kn(float (&acc)[N / 8][4],
                                            const float (&c)[K / 8][4],
                                            const float* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* br = b + 2 * t * LD + g;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    // fragment column t is tile column 2t, column t + 4 is 2t + 1
    uint32_t a_hi[4], a_lo[4];
    split_tf32(c[kk][0], a_hi[0], a_lo[0]);
    split_tf32(c[kk][2], a_hi[1], a_lo[1]);
    split_tf32(c[kk][1], a_hi[2], a_lo[2]);
    split_tf32(c[kk][3], a_hi[3], a_lo[3]);
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(br[kk * 8 * LD + nb * 8], b_hi[0], b_lo[0]);
      split_tf32(br[kk * 8 * LD + LD + nb * 8], b_hi[1], b_lo[1]);
      mma_3xtf32(acc[nb], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

template <int N, int K, int LD>
__device__ __forceinline__ void mma_creg_kn(float (&acc)[N / 8][4],
                                            const float (&c)[K / 8][4],
                                            const __nv_bfloat16* b) {
  static_assert(K % 16 == 0, "the score tile is a multiple of 16 wide");
  const int lane = threadIdx.x & 31;
  const uint32_t b0 = smem_addr(
      b + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t af[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                            pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                            pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                            pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b0 + (kk * 16 * LD + np * 16) * 2);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
    if constexpr (N % 16 != 0) {  // D = 8: one column block left
      uint32_t bf[2];
      ldsm_x2_t(bf, b0 + (kk * 16 * LD + N - 8) * 2);
      mma_bf16(acc[N / 8 - 1], af, bf[0], bf[1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

}  // namespace mxtpu_flash
