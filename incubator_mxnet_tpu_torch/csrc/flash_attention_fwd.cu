// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces: the JAX package's Pallas TPU kernel `_fwd_kernel` /
// `_fwd_kernel_nomask` (ops/pallas/flash_attention.py:181-234), launched by
// `_fwd` through `pl.pallas_call` at ops/pallas/flash_attention.py:273.
//
// What it computes (the same function, not the same tiling):
//   s   = (q . k^T) * scale                     fp32 accumulate
//   s   = -1e30 where the key mask is 0 or the causal(+window) band hides it
//   online softmax over K/V tiles: m, l, acc kept in fp32;
//   p   = exp(s - m) on visible entries, 0 on hidden ones;
//   acc += cast(p, V's dtype) . v               fp32 accumulate
//   o   = acc / l  in q's dtype
//   lse = m + log(max(l, 1e-30))                fp32
// A row that sees no key (l = 0 at the end) outputs the mean of V over all
// Lk keys, the uniform softmax that the reference gives over scores all
// filled with -1e30, and lse = -1e30. Such a row costs one extra pass over
// V, taken only by a block that holds one: rows that see a key pay nothing
// for it, and the dead-tile skip stays.
// Causal masking is bottom-right aligned (col <= row + Lk - Lq); a sliding
// window additionally keeps col > row + Lk - Lq - window. K/V tiles that no
// row of the block can see are never loaded (the TPU kernel's dead-tile skip).
//
// What bounds it on the H100: 4*B*H*Lq*Lk*D operations against about
// 4*B*H*L*D*e bytes (q, k, v and o read or written once, e bytes each), so
// about L/e operations per byte. In fp32 that passes the CUDA cores' balance
// point (67 TFLOP/s over 3.35 TB/s, ~20 per byte) from L ~ 80 up: BERT's
// longer buckets are bound by arithmetic. In bf16 the tensor cores' balance
// point (~295 per byte) is passed only beyond L ~ 590, so a tensor-core bf16
// kernel would be bound by memory at every bucket the server uses.
//
// What this design does about it: one thread block per (batch*head, q tile)
// keeps the (BQ x BK) score tile and the (BQ x D) accumulator on chip for the
// whole K/V loop, so scores never touch device memory and every K/V byte is
// read once per q tile. The block's 128 threads form a 16 x 8 grid; each
// thread owns a 4 x 8 patch of scores and a 4 x D/8 patch of the output, so
// every value read from shared memory feeds 4 or 8 fused multiply-adds.
// Shared rows are padded so that no warp hits a bank twice. The arithmetic
// is scalar fp32 FMA for both input types (exact fp32 for fp32 inputs, no
// TF32); bf16 inputs are widened on load, so this version is held to the
// CUDA cores' fp32 rate and to shared-memory bandwidth in both types.
// Tensor cores (wgmma), TMA loads and a pipelined K/V ring are the next
// step and are not used here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                // query rows per block (largest tile)
constexpr int kBK = 64;                // keys per K/V tile (largest tile)
constexpr int kTX = 8;                 // threads across key columns / head dims
constexpr int kTY = 16;                // threads across query rows
constexpr int kThreads = kTX * kTY;    // 128
constexpr int kRows = kBQ / kTY;       // query rows per thread
constexpr int kCols = kBK / kTX;       // score columns per thread
constexpr int kPS = kBK + 2;           // padded stride of the P tile
constexpr float kNeg = -1e30f;         // the reference's mask fill

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

// The reference casts P to V's dtype before the PV product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                  kBQ * kPS) +
         sizeof(int) * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ key_mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                 int Lk, int bq, int bk, float scale, int causal, int window) {
  constexpr int DP = D + 1;            // padded row stride of Q and K tiles
  constexpr int kDims = D / kTX;       // output dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBQ][DP]
  float* k_s = q_s + kBQ * DP;         // [kBK][DP]
  float* v_s = k_s + kBK * DP;         // [kBK][D]
  float* p_s = v_s + kBK * D;          // [kBQ][kPS]
  int* keep_s = reinterpret_cast<int*>(p_s + kBQ * kPS);  // [kBK]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * bq;
  const int off = Lk - Lq;             // bottom-right causal alignment
  const size_t q_base = (size_t)bh * Lq * D;
  const size_t k_base = (size_t)bh * Lk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qr = q0 + r;
    q_s[r * DP + d] =
        (r < bq && qr < Lq) ? to_float(q[q_base + (size_t)qr * D + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  // Keys [k_lo, k_hi) are the only ones any row of this block can see.
  int k_lo = 0, k_hi = Lk;
  if (causal) {
    const int q_last = min(q0 + bq, Lq) - 1;
    k_hi = min(Lk, q_last + off + 1);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }

  for (int t0 = (k_lo / bk) * bk; t0 < k_hi; t0 += bk) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kc = t0 + c;
      const bool in = c < bk && kc < Lk;
      const size_t g = k_base + (size_t)kc * D + d;
      k_s[c * DP + d] = in ? to_float(k[g]) : 0.f;
      v_s[c * D + d] = in ? to_float(v[g]) : 0.f;
    }
    for (int c = tid; c < kBK; c += kThreads) {
      const int kc = t0 + c;
      keep_s[c] = (c < bk && kc < Lk &&
                   (key_mask == nullptr || key_mask[(size_t)b * Lk + kc] != 0));
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty * kRows + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tx + j * kTX) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      const int r = q0 + row;
      bool vis[kCols];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + j * kTX;
        const int kc = t0 + c;
        bool keep = keep_s[c] != 0;
        if (causal) {
          keep = keep && kc <= r + off;
          if (window > 0) keep = keep && kc > r + off - window;
        }
        vis[j] = keep;
        s[i][j] = keep ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of one row are 8 neighbouring lanes of one warp
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        p_s[row * kPS + tx + j * kTX] = round_to<T>(p);
      }
#pragma unroll
      for (int w = 1; w < kTX; w <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int nc = min(bk, Lk - t0);
    for (int c = 0; c < nc; ++c) {
      float pv[kRows], vv[kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) vv[j] = v_s[c * D + tx + j * kTX];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // Rows that see no key: the column sums of V over all Lk keys, from one
  // extra pass (kThreads / D groups of keys, one dim per thread), into p_s.
  bool empty = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    empty |= ty * kRows + i < bq && q0 + ty * kRows + i < Lq && l[i] == 0.f;
  float* vsum_s = p_s;                 // [kThreads / D][D] partial sums
  if (__syncthreads_or(empty)) {
    constexpr int kGroups = kThreads / D;
    const int d = tid % D, grp = tid / D;
    float part = 0.f;
    for (int c = grp; c < Lk; c += kGroups)
      part += to_float(v[k_base + (size_t)c * D + d]);
    vsum_s[grp * D + d] = part;
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty * kRows + i;
    const int r = q0 + row;
    if (row < bq && r < Lq) {
      const float lf = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const int d = tx + j * kTX;
        float out = acc[i][j] / lf;
        if (l[i] == 0.f) {
          float sum = 0.f;
          for (int grp = 0; grp < kThreads / D; ++grp)
            sum += vsum_s[grp * D + d];
          out = sum / (float)Lk;
        }
        o[q_base + (size_t)r * D + d] = from_float<T>(out);
      }
      if (tx == 0) lse[(size_t)bh * Lq + r] = m[i] + logf(lf);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, void* o, void* lse, int B, int H,
                   int Lq, int Lk, int bq, int bk, float scale, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + bq - 1) / bq, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<T*>(o), static_cast<float*>(lse), H, Lq, Lk, bq, bk, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v,
                         const void* key_mask, void* o, void* lse, int B,
                         int H, int Lq, int Lk, int bq, int bk, float scale,
                         int causal, int window, cudaStream_t stream) {
#define MXTPU_FLASH_CASE(DIM)                                                 \
  case DIM:                                                                   \
    return launch<T, DIM>(q, k, v, key_mask, o, lse, B, H, Lq, Lk, bq, bk,    \
                          scale, causal, window, stream);
  switch (D) {
    MXTPU_FLASH_CASE(8)
    MXTPU_FLASH_CASE(16)
    MXTPU_FLASH_CASE(32)
    MXTPU_FLASH_CASE(64)
    MXTPU_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTPU_FLASH_CASE
}

}  // namespace

extern "C" {

// q (B,H,Lq,D), k/v (B,H,Lk,D) contiguous, all of one dtype
// (0 = float32, 1 = bfloat16); key_mask int32 (B,Lk) contiguous or null;
// o like q; lse float32 (B,H,Lq). bq, bk: tile sizes in [1, 64]; 0 takes
// 64. window <= 0 means no window. Returns the CUDA error code (0 =
// launched).
int mxtpu_flash_attention_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* o, void* lse,
                              int dtype, int B, int H, int Lq, int Lk, int D,
                              int bq, int bk, float scale, int causal,
                              int window, void* stream) {
  if (bq == 0) bq = kBQ;
  if (bk == 0) bk = kBK;
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || bq < 1 || bq > kBQ || bk < 1 ||
      bk > kBK || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<float>(D, q, k, v, key_mask, o, lse, B, H, Lq, Lk, bq,
                              bk, scale, causal, window, s);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16>(D, q, k, v, key_mask, o, lse, B, H, Lq,
                                      Lk, bq, bk, scale, causal, window, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
