// Flash attention backward, dQ, for Hopper (sm_90a), bound to Python with
// ctypes.
//
// Replaces: the JAX package's Pallas TPU kernel `_bwd_dq_kernel` /
// `_bwd_dq_kernel_nomask` (ops/pallas/flash_attention.py:359-407), launched
// by `_bwd` through `pl.pallas_call` at ops/pallas/flash_attention.py:487.
//
// What it computes, for one (batch*head) and every query row r:
//   s    = (q . k^T) * scale                          fp32 accumulate
//   p    = exp(s - lse) where the key mask and the causal(+window) band let
//          the row see the key, else 0 (a row that sees no key gets dQ = 0)
//   dP   = dO . v^T                                    fp32 accumulate
//   dS   = cast(p * (dP - delta) * scale, k's dtype)
//   dQ  += dS . k                                      fp32 accumulate
// with delta = rowsum(dO * o) (minus the lse cotangent) computed by the
// caller; dQ is written in q's dtype. It is kept apart from the dK/dV
// kernel, as the TPU kernels are, so neither needs atomics: each block owns
// its query tile's rows of dQ and the result is deterministic.
//
// What bounds it on the H100: 6*B*H*D operations per visible (query, key)
// pair (three products) against about 4*B*H*L*D*e bytes: bound by
// arithmetic from short sequences up, on the CUDA cores' fp32 rate for both
// input types in this version.
//
// What this design does about it: one block of 128 threads per
// (batch*head, 64-query tile) keeps Q, dO, lse, delta and the fp32 dQ
// accumulator on chip for its whole loop over K/V tiles, so the score and dS
// tiles never touch device memory. K/V tiles that no row of the block can
// see are skipped (the forward's dead-tile skip). Scalar fp32 FMA; no TF32,
// no tensor cores yet.

#include "flash_attention_bwd.cuh"

namespace {

using namespace mxtpu_flash_bwd;

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + kTile * kPS +
                                  2 * kTile) +
         sizeof(int) * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ key_mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H,
                    int Lq, int Lk, int bq, int bk, float scale, int causal,
                    int window) {
  constexpr int DP = D + 1;
  constexpr int kDims = D / kTX;       // accumulator dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kTile][DP] this block's queries
  float* do_s = q_s + kTile * DP;      // [kTile][DP]
  float* k_s = do_s + kTile * DP;      // [kTile][DP] current K/V tile
  float* v_s = k_s + kTile * DP;       // [kTile][DP]
  float* ds_s = v_s + kTile * DP;      // [kTile q][kPS] dS in k's type
  float* lse_s = ds_s + kTile * kPS;   // [kTile]
  float* delta_s = lse_s + kTile;      // [kTile]
  int* keep_s = reinterpret_cast<int*>(delta_s + kTile);  // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * bq;
  const int off = Lk - Lq;             // bottom-right causal alignment
  const size_t q_base = (size_t)bh * Lq * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  const int32_t* maskb = key_mask ? key_mask + (size_t)b * Lk : nullptr;

  load_rows<T, D>(q_s, q + q_base, q0, bq, Lq);
  load_rows<T, D>(do_s, dout + q_base, q0, bq, Lq);
  load_row_stats(lse_s, delta_s, lse + (size_t)bh * Lq,
                 delta + (size_t)bh * Lq, q0, bq, Lq);

  // accumulator rows: query rows ty*kRows + i; dims tx + j*kTX
  float acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;

  // Keys [k_lo, k_hi) are the only ones any row of this block can see.
  int k_lo = 0, k_hi = Lk;
  if (causal) {
    const int q_last = min(q0 + bq, Lq) - 1;
    k_hi = min(Lk, q_last + off + 1);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }

  for (int t0 = (k_lo / bk) * bk; t0 < k_hi; t0 += bk) {
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_rows<T, D>(k_s, kb, t0, bk, Lk);
    load_rows<T, D>(v_s, vb, t0, bk, Lk);
    load_keep(keep_s, maskb, t0, bk, Lk);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    scores_and_dp<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      const int r = q0 + row;
      const bool row_in = row < bq && r < Lq;
      const float l = lse_s[row];
      const float dl = delta_s[row];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + j * kTX;
        const bool keep =
            row_in && keep_s[c] != 0 && in_band(r, t0 + c, off, causal, window);
        const float p = keep ? expf(s[i][j] * scale - l) : 0.f;
        ds_s[row * kPS + c] = round_to<T>(p * (dp[i][j] - dl) * scale);
      }
    }
    __syncthreads();

    const int nc = min(bk, Lk - t0);
    for (int c = 0; c < nc; ++c) {
      float sv[kRows], kv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sv[i] = ds_s[(ty * kRows + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) kv[j] = k_s[c * DP + tx + j * kTX];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty * kRows + i;
    const int r = q0 + row;
    if (row < bq && r < Lq) {
#pragma unroll
      for (int j = 0; j < kDims; ++j)
        dq[q_base + (size_t)r * D + tx + j * kTX] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int Lq, int Lk,
                   int bq, int bk, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + bq - 1) / bq, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Lq, Lk, bq, bk,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v,
                         const void* key_mask, const void* dout,
                         const void* lse, const void* delta, void* dq, int B,
                         int H, int Lq, int Lk, int bq, int bk, float scale,
                         int causal, int window, cudaStream_t stream) {
#define MXTPU_DQ_CASE(DIM)                                                    \
  case DIM:                                                                   \
    return launch<T, DIM>(q, k, v, key_mask, dout, lse, delta, dq, B, H, Lq,  \
                          Lk, bq, bk, scale, causal, window, stream);
  switch (D) {
    MXTPU_DQ_CASE(8)
    MXTPU_DQ_CASE(16)
    MXTPU_DQ_CASE(32)
    MXTPU_DQ_CASE(64)
    MXTPU_DQ_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_DQ_CASE
}

}  // namespace

extern "C" {

// q, dout (B,H,Lq,D), k, v (B,H,Lk,D) contiguous, all of one dtype
// (0 = float32, 1 = bfloat16); key_mask int32 (B,Lk) contiguous or null;
// lse, delta float32 (B,H,Lq); dq like q. bq, bk: tile sizes in [1, 64];
// window <= 0 means no window. Returns the CUDA error code (0 = launched).
int mxtpu_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int dtype, int B, int H, int Lq, int Lk, int D,
                                 int bq, int bk, float scale, int causal,
                                 int window, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || bq < 1 || bq > kTile || bk < 1 ||
      bk > kTile || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(D, q, k, v, key_mask, dout, lse, delta, dq,
                                    B, H, Lq, Lk, bq, bk, scale, causal, window,
                                    s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(D, q, k, v, key_mask, dout, lse,
                                            delta, dq, B, H, Lq, Lk, bq, bk,
                                            scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
