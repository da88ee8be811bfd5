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
// V, taken only by a block that holds one.
// Causal masking is bottom-right aligned (col <= row + Lk - Lq); a sliding
// window additionally keeps col > row + Lk - Lq - window.
//
// What bounds it on the H100: 4*D operations per visible (query, key) pair
// (two products) against about 4*B*H*L*D*e bytes (q, k, v and o read or
// written once, e bytes each), so about L/e operations per byte. In float32
// the fastest rate at fp32 accuracy is the TF32 tensor cores' over three
// (3xTF32, ~165 TFLOP/s, ~49 operations per byte of HBM): bound by
// arithmetic from L ~ 200 up. In bf16 the tensor cores' balance point (~295
// per byte) is passed only beyond L ~ 590, so every bucket the server uses
// is bound by memory there.
//
// What this design does about it: one block of 4 warps per (batch*head,
// 64-query tile) keeps Q (in its input type), each row's running max and
// sum and the fp32 output accumulator (registers) on chip for its whole
// loop over K/V tiles, so scores never touch device memory and every K/V
// byte is read once per query tile. Both products run on the tensor cores
// with `mma.sync` (flash_attention_mma.cuh: bf16 m16n8k16 through ldmatrix;
// fp32 as 3xTF32 m16n8k8, about fp32 accuracy): S = Q K^T from shared
// memory, the online softmax on S's accumulator fragments (a row lives in
// the 4 lanes of a quad), then O += P V with P taken straight from those
// registers as the A operand, rounded to V's type; P never goes to shared
// memory. K and V stream through a two-stage ring of 64-key tiles filled by
// cp.async, so the load of tile t+1 runs under the products of tile t. Only
// keys [k_lo, k_hi) are visited: the causal band and window bound them (the
// TPU kernel's dead-tile skip), and so do the first and last key that the
// key mask keeps in the block's batch row, found by one block-wide
// reduction. Requests padded to a longer bucket therefore load and compute
// none of their padding tiles. The same reduction counts the keys kept: a
// mask with no holes in [k_lo, k_hi) (a prefix, as the serving and training
// paths send) is then not read again, and a tile of 64 keys that no band
// cuts skips the visibility test; a mask with holes streams with K and V.

#include "flash_attention_mma.cuh"

namespace {

using namespace mxtpu_flash;

constexpr int kBK = 64;                // keys per streamed tile
constexpr float kNeg = -1e30f;         // the reference's mask fill
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D> constexpr size_t smem_bytes() {
  constexpr int LD = row_stride<T, D>();
  return sizeof(T) * (size_t)(kOwn + 4 * kBK) * LD +
         sizeof(int32_t) * 2 * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ key_mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                 int Lk, int bq, int bk, float scale, int causal, int window) {
  constexpr int LD = row_stride<T, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);     // [kOwn][LD] this block's queries
  T* k_s = q_s + kOwn * LD;                // [2][kBK][LD] K/V tile ring
  T* v_s = k_s + 2 * kBK * LD;             // [2][kBK][LD]
  int32_t* keep_s =
      reinterpret_cast<int32_t*>(v_s + 2 * kBK * LD);  // [2][kBK] key mask
  __shared__ int range_s[3 * kWarps];

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

  zero_pad_k16<T, D, kOwn + 4 * kBK>(q_s);  // every tile, bf16 D = 8
  load_rows_async<T, D, kOwn>(q_s, q + q_base, q0, bq, Lq);

  // The thread's two query rows (accumulator rows g and g + 8 of its warp).
  int qr[2];
  bool row_in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h;
    qr[h] = q0 + row;
    row_in[h] = row < bq && qr[h] < Lq;
  }

  // Keys [k_lo, k_hi) are the only ones any row of this block can see: the
  // causal band and window, narrowed to the first and last key the key mask
  // keeps (a mask that keeps none leaves the range empty). The tiles read
  // the mask only when it has holes in that range: a prefix mask, which is
  // what the serving and training paths send, is all said by the range.
  int k_lo = 0, k_hi = Lk;
  if (causal) {
    const int q_last = min(q0 + bq, Lq) - 1;
    k_hi = min(Lk, q_last + off + 1);
    if (window > 0) k_lo = max(0, q0 + off - window + 1);
  }
  bool holes = false;
  if (maskb) {
    int lo = k_hi, hi = k_lo - 1, kept = 0;
    // four loads in flight at once: a row of 512 keys is one round trip
    for (int c0 = k_lo + threadIdx.x; c0 < k_hi; c0 += 4 * kThreads) {
      int m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * kThreads;
        m[u] = c < k_hi ? maskb[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * kThreads;  // grows with u and c0
        if (m[u] != 0) {
          lo = min(lo, c);
          hi = c;
          ++kept;
        }
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    kept = __reduce_add_sync(0xffffffffu, kept);
    if (lane == 0) {
      range_s[warp] = lo;
      range_s[kWarps + warp] = hi;
      range_s[2 * kWarps + warp] = kept;
    }
    __syncthreads();
    kept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lo = min(lo, range_s[w]);
      hi = max(hi, range_s[kWarps + w]);
      kept += range_s[2 * kWarps + w];
    }
    k_lo = lo;
    k_hi = hi + 1;
    holes = kept < k_hi - k_lo;
  }
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + bk - 1) / bk : 0;

  // Tiles start at k_lo. Keys at or past k_hi are hidden from every row, so
  // they are not read: their rows of the tile (and of the mask) are zero.
  auto issue = [&](int i) {
    const int t0 = k_lo + i * bk, st = i & 1;
    const int n = min(bk, k_hi - t0);
    load_rows_async<T, D, kBK>(k_s + st * kBK * LD, kb, t0, n, Lk);
    load_rows_async<T, D, kBK>(v_s + st * kBK * LD, vb, t0, n, Lk);
    if (holes) load_vec_async<kBK>(keep_s + st * kBK, maskb, t0, n, Lk);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  float acc[D / 8][4];
  zero(acc);
  float m_r[2] = {kNeg, kNeg};           // running max of each row
  float l_r[2] = {0.f, 0.f};             // this lane's share of the row sum
  const T* q_w = q_s + warp * 16 * LD;

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = k_lo + i * bk, st = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();

    const T* k_t = k_s + st * kBK * LD;
    const T* v_t = v_s + st * kBK * LD;
    const int32_t* keep_t = keep_s + st * kBK;

    float s[kBK / 8][4];
    zero(s);
    mma_rows_nk<kBK, D, LD>(s, q_w, k_t);

    // Scale, hide, and take each row's max over the tile (a row's 64
    // columns lie in the 4 lanes of a quad). A tile of 64 keys in
    // [k_lo, k_hi), with no band and no holes, is seen whole by every row.
    float mx[2] = {kNeg, kNeg};
    if (!holes && !causal && bk == kBK && t0 + kBK <= k_hi) {
#pragma unroll
      for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
        }
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int col = nb * 8 + 2 * t + (e & 1);
          const int kc = t0 + col;
          const bool vis = col < bk && kc < k_hi &&
                           (!holes || keep_t[col] != 0) &&
                           in_band(qr[h], kc, off, causal, window);
          s[nb][e] = vis ? s[nb][e] * scale : kNeg;
          mx[h] = fmaxf(mx[h], s[nb][e]);
        }
      }
    }
    float alpha[2], m_l2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = exp2f((m_r[h] - m_new) * kLog2e);
      m_r[h] = m_new;
      m_l2[h] = m_new * kLog2e;
      l_r[h] *= alpha[h];
    }
    // p = exp(s - m) on visible entries (every hidden one holds exactly
    // kNeg, a visible one more), in place of s.
#pragma unroll
    for (int nb = 0; nb < kBK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            s[nb][e] > kNeg ? exp2f(fmaf(s[nb][e], kLog2e, -m_l2[h])) : 0.f;
        l_r[h] += p;
        s[nb][e] = p;
      }
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      acc[nb][0] *= alpha[0];
      acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1];
      acc[nb][3] *= alpha[1];
    }
    mma_creg_kn<D, kBK, LD>(acc, s, v_t);
  }
  cp_async_wait_all();

  bool empty = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    empty |= row_in[h] && l_r[h] == 0.f;
  }

  // Rows that see no key: the column sums of V over all Lk keys, from one
  // extra pass (kThreads / D groups of keys, one dim per thread), into the
  // K ring, which no warp reads any more once every thread has passed the
  // barrier.
  constexpr int kGroups = kThreads / D;
  float* vsum_s = reinterpret_cast<float*>(k_s);  // [kGroups][D]
  if (__syncthreads_or(empty)) {
    const int d = threadIdx.x % D, grp = threadIdx.x / D;
    float part = 0.f;
    for (int c = grp; c < Lk; c += kGroups)
      part += to_float(vb[(size_t)c * D + d]);
    vsum_s[grp * D + d] = part;
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_in[h]) continue;
    const float lf = fmaxf(l_r[h], 1e-30f);
    const float inv = 1.f / lf;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int d = nb * 8 + 2 * t;
      float o0 = acc[nb][2 * h] * inv, o1 = acc[nb][2 * h + 1] * inv;
      if (l_r[h] == 0.f) {
        float s0 = 0.f, s1 = 0.f;
        for (int grp = 0; grp < kGroups; ++grp) {
          s0 += vsum_s[grp * D + d];
          s1 += vsum_s[grp * D + d + 1];
        }
        o0 = s0 / (float)Lk;
        o1 = s1 / (float)Lk;
      }
      store2(o + q_base + (size_t)qr[h] * D + d, o0, o1);
    }
    if (t == 0) lse[(size_t)bh * Lq + qr[h]] = m_r[h] + logf(lf);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, void* o, void* lse, int B, int H,
                   int Lq, int Lk, int bq, int bk, float scale, int causal,
                   int window, cudaStream_t stream) {
  if (bq == 0) bq = kOwn;
  if (bk == 0) bk = kBK;
  if (bq < 1 || bq > kOwn || bk < 1 || bk > kBK) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, D>();
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

// q (B,H,Lq,D), k/v (B,H,Lk,D) contiguous and 16-byte aligned, all of one
// dtype (0 = float32, 1 = bfloat16); key_mask int32 (B,Lk) contiguous or
// null; o like q; lse float32 (B,H,Lq). bq: query rows per block, bk: keys
// per streamed tile, both in [1, 64]; 0 takes 64. window <= 0 means no
// window. Returns the CUDA error code (0 = launched).
int mxtpu_flash_attention_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* o, void* lse,
                              int dtype, int B, int H, int Lq, int Lk, int D,
                              int bq, int bk, float scale, int causal,
                              int window, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(D, q, k, v, key_mask, o, lse, B, H, Lq,
                                    Lk, bq, bk, scale, causal, window, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(D, q, k, v, key_mask, o, lse, B,
                                            H, Lq, Lk, bq, bk, scale, causal,
                                            window, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
