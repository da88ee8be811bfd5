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
// it is bound by arithmetic from short sequences up: on the bf16 tensor
// cores (989 TFLOP/s) for bf16, on the TF32 tensor cores at a third of their
// 495 TFLOP/s for fp32 (3xTF32 issues three products for each).
//
// What this design does about it: one block of 4 warps per (batch*head,
// 64-key tile) keeps K, V (in their input type) and the fp32 dK/dV
// accumulators (registers) on chip for its whole loop over query tiles, so
// K and V are read once and the score, P and dS tiles never leave the
// registers. All four products run on the tensor cores with `mma.sync`
// (flash_attention_mma.cuh: bf16 m16n8k16 through ldmatrix; fp32 as 3xTF32
// m16n8k8): S^T = K Q^T and dP^T = V dO^T from shared memory, then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T taken straight from the
// accumulators as A operands. Q, dO, lse and delta stream through a
// two-stage ring filled by cp.async, so the load of query tile t+1 runs
// under the products of tile t. Query tiles are 64 rows in bf16 and 32 in
// float32, halved at D = 128 (the dK/dV accumulators, S^T and dP^T share
// the thread's 255 registers, and the 3xTF32 split needs more). Query tiles
// that no key of the block can see (the causal band, the window) are
// skipped, as `_causal_live` (flash_attention.py:154) skips them.
// `wgmma` is not used: its TF32 operands must be K-major in shared memory,
// which dV += P^T dO and dK += dS^T Q are not.

#include "flash_attention_mma.cuh"

namespace {

using namespace mxtpu_flash;

// query rows per streamed tile: 64 (bf16) or 32 (float32), halved at
// D = 128, so that the dK/dV accumulators, S^T and dP^T fit in registers
template <typename T, int D> __host__ __device__ constexpr int stream_rows() {
  return (sizeof(T) == 2 ? 64 : 32) / (D > 64 ? 2 : 1);
}

template <typename T, int D> constexpr size_t smem_bytes() {
  constexpr int LD = row_stride<T, D>(), BQ = stream_rows<T, D>();
  return sizeof(T) * (size_t)(2 * kOwn + 4 * BQ) * LD +
         sizeof(float) * 4 * BQ;
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
  constexpr int LD = row_stride<T, D>();
  constexpr int BQ = stream_rows<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);     // [kOwn][LD] this block's keys
  T* v_s = k_s + kOwn * LD;                // [kOwn][LD]
  T* q_s = v_s + kOwn * LD;                // [2][BQ][LD] query tile ring
  T* do_s = q_s + 2 * BQ * LD;             // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                               // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * bk;
  const int off = Lk - Lq;               // bottom-right causal alignment
  const T* qb = q + (size_t)bh * Lq * D;
  const T* dob = dout + (size_t)bh * Lq * D;
  const float* lseb = lse + (size_t)bh * Lq;
  const float* deltab = delta + (size_t)bh * Lq;

  zero_pad_k16<T, D, 2 * kOwn + 4 * BQ>(k_s);  // every tile, bf16 D = 8
  load_rows_async<T, D, kOwn>(k_s, k + (size_t)bh * Lk * D, k0, bk, Lk);
  load_rows_async<T, D, kOwn>(v_s, v + (size_t)bh * Lk * D, k0, bk, Lk);

  // The thread's two key rows (accumulator rows g and g + 8 of its warp).
  int kr[2];
  bool keep[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = warp * 16 + g + 8 * h;
    kr[h] = k0 + c;
    keep[h] = c < bk && kr[h] < Lk &&
              (key_mask == nullptr || key_mask[(size_t)b * Lk + kr[h]] != 0);
  }

  // Query rows [q_lo, q_hi) are the only ones that see a key of this block.
  int q_lo = 0, q_hi = Lq;
  if (causal) {
    const int k_last = min(k0 + bk, Lk) - 1;
    q_lo = max(0, k0 - off);
    if (window > 0) q_hi = min(Lq, k_last - off + window);
  }
  const int first = (q_lo / bq) * bq;
  const int n_tiles = q_hi > first ? (q_hi - first + bq - 1) / bq : 0;

  auto issue = [&](int i) {
    const int t0 = first + i * bq, st = i & 1;
    load_rows_async<T, D, BQ>(q_s + st * BQ * LD, qb, t0, bq, Lq);
    load_rows_async<T, D, BQ>(do_s + st * BQ * LD, dob, t0, bq, Lq);
    load_vec_async<BQ>(lse_s + st * BQ, lseb, t0, bq, Lq);
    load_vec_async<BQ>(delta_s + st * BQ, deltab, t0, bq, Lq);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const T* k_w = k_s + warp * 16 * LD;
  const T* v_w = v_s + warp * 16 * LD;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = first + i * bq, st = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();

    const T* q_t = q_s + st * BQ * LD;
    const T* do_t = do_s + st * BQ * LD;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;

    // S^T (keys x queries) and dP^T, then P^T and dS^T in place
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
    mma_rows_nk<BQ, D, LD>(s, k_w, q_t);
    mma_rows_nk<BQ, D, LD>(dp, v_w, do_t);
#pragma unroll
    for (int nb = 0; nb < BQ / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = nb * 8 + 2 * t + (e & 1);
        const int r = t0 + col;
        const bool vis = keep[h] && col < bq && r < Lq &&
                         in_band(r, kr[h], off, causal, window);
        const float p = vis ? expf(s[nb][e] * scale - lse_t[col]) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - delta_t[col]) * scale;
      }
    }
    mma_creg_kn<D, BQ, LD>(dv_acc, s, do_t);
    mma_creg_kn<D, BQ, LD>(dk_acc, dp, q_t);
  }
  cp_async_wait_all();

  const size_t k_base = (size_t)bh * Lk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = warp * 16 + g + 8 * h;
    if (c < bk && kr[h] < Lk) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const size_t o = k_base + (size_t)kr[h] * D + nb * 8 + 2 * t;
        store2(dk + o, dk_acc[nb][2 * h], dk_acc[nb][2 * h + 1]);
        store2(dv + o, dv_acc[nb][2 * h], dv_acc[nb][2 * h + 1]);
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
  if (bq == 0) bq = stream_rows<T, D>();
  if (bk == 0) bk = kOwn;
  if (bq < 1 || bq > stream_rows<T, D>() || bk < 1 || bk > kOwn)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, D>();
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

// q, dout (B,H,Lq,D), k, v (B,H,Lk,D) contiguous and 16-byte aligned, all of
// one dtype (0 = float32, 1 = bfloat16); key_mask int32 (B,Lk) contiguous
// or null; lse, delta float32 (B,H,Lq); dk, dv like k. bq: query rows per
// streamed tile, from 1 to 64 in bf16 and 32 in float32 (half that at
// D = 128); bk: keys per block, in [1, 64]; 0 takes the largest. window <= 0
// means no window.
// Returns the CUDA error code (0 = launched).
int mxtpu_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* key_mask, const void* dout,
                                  const void* lse, const void* delta, void* dk,
                                  void* dv, int dtype, int B, int H, int Lq,
                                  int Lk, int D, int bq, int bk, float scale,
                                  int causal, int window, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || (long long)B * H > 65535)
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
