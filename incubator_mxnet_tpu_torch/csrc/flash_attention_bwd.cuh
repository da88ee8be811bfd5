// Shared pieces of the two flash-attention backward kernels
// (flash_attention_bwd_dkv.cu, flash_attention_bwd_dq.cu): tile geometry,
// type conversions, the visibility predicate and the tile loads.
//
// Both kernels recompute the scores of one (64 query x 64 key) tile at a
// time on a 16 x 8 grid of 128 threads: thread (ty, tx) owns query rows
// ty*4 .. ty*4+3 and key columns tx, tx+8, ..., tx+56 of the tile, so every
// value read from shared memory feeds 4 or 8 fused multiply-adds. Tiles are
// stored in fp32 with rows padded to D+1 floats (score tiles to 66), so the
// column-strided reads of a warp fall in distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mxtpu_flash_bwd {

constexpr int kTile = 64;              // rows of every shared tile (largest)
constexpr int kTX = 8;                 // threads across key columns / dims
constexpr int kTY = 16;                // threads across query rows
constexpr int kThreads = kTX * kTY;    // 128
constexpr int kRows = kTile / kTY;     // 4 rows per thread
constexpr int kCols = kTile / kTX;     // 8 columns per thread
constexpr int kPS = kTile + 2;         // padded stride of a score tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The reference rounds P and dS to the storage type before their products.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Does query row r see key kc through the causal band (bottom-right aligned,
// offset Lk - Lq) and the sliding window? The key mask is checked apart.
__device__ __forceinline__ bool in_band(int r, int kc, int off, int causal,
                                        int window) {
  if (!causal) return true;
  if (kc > r + off) return false;
  return window <= 0 || kc > r + off - window;
}

// Rows [r0, r0 + n) of a contiguous (L, D) slab into a [kTile][D + 1] fp32
// tile; rows at or past n, or past L, are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int r0, int n, int L) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int g = r0 + r;
    dst[r * (D + 1) + d] =
        (r < n && g < L) ? to_float(src[(size_t)g * D + d]) : 0.f;
  }
}

// lse and delta of rows [r0, r0 + n) into [kTile] vectors (0 past the end).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int r0, int n, int L) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = r < n && r0 + r < L;
    lse_s[r] = in ? lse[r0 + r] : 0.f;
    delta_s[r] = in ? delta[r0 + r] : 0.f;
  }
}

// Key columns [c0, c0 + n) that the key mask keeps (0 past the end).
__device__ __forceinline__ void load_keep(int* keep_s,
                                          const int32_t* __restrict__ key_mask,
                                          int c0, int n, int Lk) {
  for (int c = threadIdx.x; c < kTile; c += kThreads) {
    const int kc = c0 + c;
    keep_s[c] = (c < n && kc < Lk && (key_mask == nullptr || key_mask[kc] != 0));
  }
}

// s = q . k^T and dp = dO . v^T for the thread's 4 x 8 patch of one tile:
// q_s, do_s hold query rows, k_s, v_s key rows, all [kTile][D + 1].
template <int D>
__device__ __forceinline__ void scores_and_dp(const float* q_s,
                                              const float* do_s,
                                              const float* k_s,
                                              const float* v_s, int ty, int tx,
                                              float (&s)[kRows][kCols],
                                              float (&dp)[kRows][kCols]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qv[i] = q_s[(ty * kRows + i) * DP + d];
      ov[i] = do_s[(ty * kRows + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      kv[j] = k_s[(tx + j * kTX) * DP + d];
      vv[j] = v_s[(tx + j * kTX) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

}  // namespace mxtpu_flash_bwd
