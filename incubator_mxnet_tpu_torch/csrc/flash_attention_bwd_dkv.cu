// Flash attention backward, dK and dV, for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces: the JAX package's Pallas TPU kernel `_bwd_dkv_kernel` /
// `_bwd_dkv_kernel_nomask` (ops/pallas/flash_attention.py:299-356),
// launched by `_bwd` through `pl.pallas_call` at
// ops/pallas/flash_attention.py:450.
//
// What it computes, for one (batch*head) and every key column c:
//   s    = (q . k^T) * scale                          fp32 accumulate
//   p    = exp(s - lse) where the key mask and the causal(+window) band let
//          the row see the key, else 0 (rows that see no key give p = 0)
//   dV  += cast(p, dO's dtype)^T . dO                  fp32 accumulate
//   dP   = dO . v^T                                    fp32 accumulate
//   dS   = cast(p * (dP - delta) * scale, q's dtype)
//   dK  += dS^T . q                                    fp32 accumulate
// with delta = rowsum(dO * o) (minus the lse cotangent) computed by the
// caller. dK and dV are written in k's and v's dtype. No atomics: each block
// owns its key tile's rows of dK and dV, so the result is deterministic.
//
// What bounds it on the H100: 8*B*H*D operations per visible (query, key)
// pair (four products) against about 4*B*H*L*D*e + 2*B*H*Lk*D*e bytes, so
// like the forward it is bound by arithmetic from short sequences up, on the
// CUDA cores' fp32 rate for both input types in this version.
//
// What this design does about it: one block of 128 threads per
// (batch*head, 64-key tile) keeps K, V and the fp32 dK/dV accumulators on
// chip for its whole loop over query tiles, so K and V are read once and
// the score, P and dS tiles never touch device memory. Query tiles that no
// key of the block can see (the causal band, the window) are skipped, as
// `_causal_live` (flash_attention.py:154) skips them. Scalar fp32 FMA; no
// TF32, no tensor cores yet.

#include "flash_attention_bwd.cuh"

namespace {

using namespace mxtpu_flash_bwd;

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + 2 * kTile * kPS +
                                  2 * kTile) +
         sizeof(int) * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int32_t* __restrict__ key_mask,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Lq, int Lk, int bq, int bk,
                     float scale, int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int kDims = D / kTX;       // accumulator dims per thread
  extern __shared__ float smem[];
  float* k_s = smem;                   // [kTile][DP] this block's keys
  float* v_s = k_s + kTile * DP;       // [kTile][DP]
  float* q_s = v_s + kTile * DP;       // [kTile][DP] current query tile
  float* do_s = q_s + kTile * DP;      // [kTile][DP]
  float* p_s = do_s + kTile * DP;      // [kTile q][kPS] P in dO's type
  float* ds_s = p_s + kTile * kPS;     // [kTile q][kPS] dS in q's type
  float* lse_s = ds_s + kTile * kPS;   // [kTile]
  float* delta_s = lse_s + kTile;      // [kTile]
  int* keep_s = reinterpret_cast<int*>(delta_s + kTile);  // [kTile]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * bk;
  const int off = Lk - Lq;             // bottom-right causal alignment
  const T* qb = q + (size_t)bh * Lq * D;
  const T* dob = dout + (size_t)bh * Lq * D;
  const float* lseb = lse + (size_t)bh * Lq;
  const float* deltab = delta + (size_t)bh * Lq;

  load_rows<T, D>(k_s, k + (size_t)bh * Lk * D, k0, bk, Lk);
  load_rows<T, D>(v_s, v + (size_t)bh * Lk * D, k0, bk, Lk);
  load_keep(keep_s, key_mask ? key_mask + (size_t)b * Lk : nullptr, k0, bk,
            Lk);

  // accumulator rows: key columns ty*kRows + i; dims tx + j*kTX
  float dk_acc[kRows][kDims], dv_acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDims; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // Query rows [q_lo, q_hi) are the only ones that see a key of this block.
  int q_lo = 0, q_hi = Lq;
  if (causal) {
    const int k_last = min(k0 + bk, Lk) - 1;
    q_lo = max(0, k0 - off);
    if (window > 0) q_hi = min(Lq, k_last - off + window);
  }

  for (int t0 = (q_lo / bq) * bq; t0 < q_hi; t0 += bq) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
    load_rows<T, D>(q_s, qb, t0, bq, Lq);
    load_rows<T, D>(do_s, dob, t0, bq, Lq);
    load_row_stats(lse_s, delta_s, lseb, deltab, t0, bq, Lq);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    scores_and_dp<D>(q_s, do_s, k_s, v_s, ty, tx, s, dp);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      const int r = t0 + row;
      const bool row_in = row < bq && r < Lq;
      const float l = lse_s[row];
      const float dl = delta_s[row];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + j * kTX;
        const bool keep =
            row_in && keep_s[c] != 0 && in_band(r, k0 + c, off, causal, window);
        const float p = keep ? expf(s[i][j] * scale - l) : 0.f;
        p_s[row * kPS + c] = round_to<T>(p);
        ds_s[row * kPS + c] = round_to<T>(p * (dp[i][j] - dl) * scale);
      }
    }
    __syncthreads();

    const int nr = min(bq, Lq - t0);
    for (int r = 0; r < nr; ++r) {
      float pv[kRows], sv[kRows], ov[kDims], qv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = p_s[r * kPS + ty * kRows + i];
        sv[i] = ds_s[r * kPS + ty * kRows + i];
      }
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        ov[j] = do_s[r * DP + tx + j * kTX];
        qv[j] = q_s[r * DP + tx + j * kTX];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDims; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  const size_t k_base = (size_t)bh * Lk * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int c = ty * kRows + i;
    const int kc = k0 + c;
    if (c < bk && kc < Lk) {
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const size_t g = k_base + (size_t)kc * D + tx + j * kTX;
        dk[g] = from_float<T>(dk_acc[i][j]);
        dv[g] = from_float<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int B, int H, int Lq,
                   int Lk, int bq, int bk, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + bk - 1) / bk, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Lq, Lk, bq, bk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v,
                         const void* key_mask, const void* dout,
                         const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int Lq, int Lk, int bq,
                         int bk, float scale, int causal, int window,
                         cudaStream_t stream) {
#define MXTPU_DKV_CASE(DIM)                                                   \
  case DIM:                                                                   \
    return launch<T, DIM>(q, k, v, key_mask, dout, lse, delta, dk, dv, B, H,  \
                          Lq, Lk, bq, bk, scale, causal, window, stream);
  switch (D) {
    MXTPU_DKV_CASE(8)
    MXTPU_DKV_CASE(16)
    MXTPU_DKV_CASE(32)
    MXTPU_DKV_CASE(64)
    MXTPU_DKV_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_DKV_CASE
}

}  // namespace

extern "C" {

// q, dout (B,H,Lq,D), k, v (B,H,Lk,D) contiguous, all of one dtype
// (0 = float32, 1 = bfloat16); key_mask int32 (B,Lk) contiguous or null;
// lse, delta float32 (B,H,Lq); dk, dv like k. bq, bk: tile sizes in
// [1, 64]; window <= 0 means no window. Returns the CUDA error code
// (0 = launched).
int mxtpu_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* key_mask, const void* dout,
                                  const void* lse, const void* delta, void* dk,
                                  void* dv, int dtype, int B, int H, int Lq,
                                  int Lk, int D, int bq, int bk, float scale,
                                  int causal, int window, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || bq < 1 || bq > kTile || bk < 1 ||
      bk > kTile || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(D, q, k, v, key_mask, dout, lse, delta, dk,
                                    dv, B, H, Lq, Lk, bq, bk, scale, causal,
                                    window, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(D, q, k, v, key_mask, dout, lse,
                                            delta, dk, dv, B, H, Lq, Lk, bq,
                                            bk, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
