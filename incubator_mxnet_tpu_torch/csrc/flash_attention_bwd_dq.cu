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
// arithmetic from short sequences up, on the bf16 tensor cores for bf16 and
// on the TF32 tensor cores at a third of their rate (3xTF32) for fp32.
//
// What this design does about it: one block of 4 warps per (batch*head,
// 64-query tile) keeps Q, dO (in their input type), each row's lse and
// delta and the fp32 dQ accumulator (registers) on chip for its whole loop
// over K/V tiles, so the score and dS tiles never leave the registers. The
// three products run on the tensor cores with `mma.sync`
// (flash_attention_mma.cuh: bf16 m16n8k16 through ldmatrix; fp32 as 3xTF32
// m16n8k8): S = Q K^T and dP = dO V^T from shared memory, then dQ += dS K
// with dS taken straight from the accumulators as the A operand. K, V and
// the key mask stream through a two-stage ring of 64-key tiles filled by
// cp.async, so the load of tile t+1 runs under the products of tile t. K/V
// tiles that no row of the block can see are skipped (the forward's
// dead-tile skip). `wgmma` is not used: its TF32 operands must be K-major
// in shared memory, which dQ += dS K is not.

#include "flash_attention_mma.cuh"

namespace {

using namespace mxtpu_flash;

constexpr int kBK = 64;                  // keys per streamed tile

template <typename T, int D> constexpr size_t smem_bytes() {
  constexpr int LD = row_stride<T, D>();
  return sizeof(T) * (size_t)(2 * kOwn + 4 * kBK) * LD +
         sizeof(int32_t) * 2 * kBK;
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
  constexpr int LD = row_stride<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);     // [kOwn][LD] this block's queries
  T* do_s = q_s + kOwn * LD;               // [kOwn][LD]
  T* k_s = do_s + kOwn * LD;               // [2][kBK][LD] K/V tile ring
  T* v_s = k_s + 2 * kBK * LD;             // [2][kBK][LD]
  int32_t* keep_s = reinterpret_cast<int32_t*>(v_s + 2 * kBK * LD);  // [2][kBK]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * bq;
  const int off = Lk - Lq;               // bottom-right causal alignment
  const size_t q_base = (size_t)bh * Lq * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  const int32_t* maskb = key_mask ? key_mask + (size_t)b * Lk : nullptr;

  zero_pad_k16<T, D, 2 * kOwn + 4 * kBK>(q_s);  // every tile, bf16 D = 8
  load_rows_async<T, D, kOwn>(q_s, q + q_base, q0, bq, Lq);
  load_rows_async<T, D, kOwn>(do_s, dout + q_base, q0, bq, Lq);

  // The thread's two query rows (accumulator rows g and g + 8 of its warp),
  // with their lse and delta.
  int qr[2];
  bool row_in[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h;
    qr[h] = q0 + row;
    row_in[h] = row < bq && qr[h] < Lq;
    lse_r[h] = row_in[h] ? lse[(size_t)bh * Lq + qr[h]] : 0.f;
    delta_r[h] = row_in[h] ? delta[(size_t)bh * Lq + qr[h]] : 0.f;
  }

  // Keys [k_lo, k_hi) are the only ones any row of this block can see.
  int k_lo = 0, k_hi = Lk;
  if (causal) {
    const int q_last = min(q0 + bq, Lq) - 1;
    k_hi = min(Lk, q_last + off + 1);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  const int first = (k_lo / bk) * bk;
  const int n_tiles = k_hi > first ? (k_hi - first + bk - 1) / bk : 0;

  auto issue = [&](int i) {
    const int t0 = first + i * bk, st = i & 1;
    load_rows_async<T, D, kBK>(k_s + st * kBK * LD, kb, t0, bk, Lk);
    load_rows_async<T, D, kBK>(v_s + st * kBK * LD, vb, t0, bk, Lk);
    if (maskb) load_vec_async<kBK>(keep_s + st * kBK, maskb, t0, bk, Lk);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  float acc[D / 8][4];
  zero(acc);
  const T* q_w = q_s + warp * 16 * LD;
  const T* do_w = do_s + warp * 16 * LD;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = first + i * bk, st = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();

    const T* k_t = k_s + st * kBK * LD;
    const T* v_t = v_s + st * kBK * LD;
    const int32_t* keep_t = keep_s + st * kBK;

    // S and dP (queries x keys), then dS in place of S
    float s[kBK / 8][4], dp[kBK / 8][4];
    zero(s);
    zero(dp);
    mma_rows_nk<kBK, D, LD>(s, q_w, k_t);
    mma_rows_nk<kBK, D, LD>(dp, do_w, v_t);
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = nb * 8 + 2 * t + (e & 1);
        const int kc = t0 + col;
        const bool vis = row_in[h] && col < bk && kc < Lk &&
                         (maskb == nullptr || keep_t[col] != 0) &&
                         in_band(qr[h], kc, off, causal, window);
        const float p = vis ? expf(s[nb][e] * scale - lse_r[h]) : 0.f;
        s[nb][e] = p * (dp[nb][e] - delta_r[h]) * scale;
      }
    }
    mma_creg_kn<D, kBK, LD>(acc, s, k_t);
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row_in[h]) {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        store2(dq + q_base + (size_t)qr[h] * D + nb * 8 + 2 * t,
               acc[nb][2 * h], acc[nb][2 * h + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int H, int Lq, int Lk,
                   int bq, int bk, float scale, int causal, int window,
                   cudaStream_t stream) {
  if (bq == 0) bq = kOwn;
  if (bk == 0) bk = kBK;
  if (bq < 1 || bq > kOwn || bk < 1 || bk > kBK) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, D>();
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

// q, dout (B,H,Lq,D), k, v (B,H,Lk,D) contiguous and 16-byte aligned, all of
// one dtype (0 = float32, 1 = bfloat16); key_mask int32 (B,Lk) contiguous
// or null; lse, delta float32 (B,H,Lq); dq like q. bq: query rows per
// block, bk: keys per streamed tile, both in [1, 64]; 0 takes the largest.
// window <= 0 means no window. Returns the CUDA error code (0 = launched).
int mxtpu_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int dtype, int B, int H, int Lq, int Lk, int D,
                                 int bq, int bk, float scale, int causal,
                                 int window, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || (long long)B * H > 65535)
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
