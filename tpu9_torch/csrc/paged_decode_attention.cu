// Paged decode attention for Hopper (sm_90a), over a bf16 pool or an int8
// pool with f32 per-vector scales, found through a block table, or over a
// contiguous bf16 cache.
//
// Replaces three TPU kernels of tpu9/ops/paged_attention.py:
//   paged_decode_attention        (_paged_kernel, _table_block, _head_update,
//                                  _finalize_heads)   -> Payload bf16, Table
//   paged_decode_attention_quant  (_paged_quant_kernel) -> Payload int8, Table
//   ragged_decode_attention       (_kernel)           -> Payload bf16, Contiguous
// All compute the same function: one query token per sequence attends over
// that sequence's valid prefix of its KV cache. The block-table kernels find
// the prefix's blocks in a shared pool through the table. The ragged kernel
// reads a contiguous [B, S, KH, D] cache, which is a pool of B * S/BS blocks
// whose table is implicit: block j of sequence b is b * (S/BS) + j (the
// Contiguous policy computes it and reads no table).
//
//   q           [B, QH, D]        bf16 (the [B, 1, QH, D] decode query)
//   k/v_pool    [N, BS, KH, D]    bf16, or int8, shared by every sequence
//   k/v_scale   [N, BS, KH]       f32, int8 pool only: one absmax scale per
//                                 (token, head) vector, indexed like the pool
//   block_table [B, MB]           int32, logical block j -> physical pool block
//                                 (absent for the contiguous cache: MB = S/BS)
//   cache_len   [B]               int32, valid positions incl. the current token
//   out         [B, QH, D]        bf16
//
// Semantics carried over: scale D^-0.5 applied to q in f32; GQA puts query
// heads h*g .. h*g+g-1 over kv head h; positions >= cache_len[b] are masked;
// online softmax in f32; out = acc / max(l, 1e-30), so len 0 gives zeros.
// Only the ceil(len/BS) valid table entries of a row are ever read: entries
// past the prefix may hold anything, and the blocks (and scales) they name
// are never touched (the TPU kernels got the same effect by clamping their
// index maps).
//
// int8 dequantization happens in registers, in f32, with the scale folded in
// after each dot product: the score of token t is (q . k_int[t]) * s_k[t],
// and its p * v update is (p * s_v[t]) * v_int[t]. That is the TPU kernel's
// (k_int * s_k) and (v_int * s_v) up to f32 rounding, with one multiply per
// token row in place of one per element.
//
// What bounds it: device-memory bytes. Each call must read
// sum_b len_b * KH * (D * E + S) * 2 (k and v) bytes of pool, E = 2 and
// S = 0 for bf16, E = 1 and S = 4 (the scale) for int8; the arithmetic is
// 4 * QH * D flops per cached position, far below the ~295 flop/byte at
// which H100 bf16 compute would become the limit. So the design is about
// reading the pool once, along D, and nothing else:
//
// - One CTA per (kv head h, sequence b) with 128 threads. The CTA keeps the
//   g query rows of its GQA group in registers, so each k/v row is read once
//   for all g heads that share it.
// - Thread (token lane tl, slice dc) owns 8 consecutive elements of D, so the
//   D/8 lanes that share a token issue one contiguous load each: 16 bytes of
//   bf16, or 8 bytes of int8 plus the token's 4-byte scale, which the lanes
//   of a token read as one broadcast.
//   Scores reduce over those lanes with warp shuffles, go to shared memory,
//   one warp per query row computes the block's max/sum, and every thread
//   rescales and accumulates p * v for its 8 columns and g rows in f32
//   registers. The token lanes' partial sums meet in shared memory once, at
//   the end.
// - With one CTA per SM there are too few warps to hide the latency of a
//   load used right away, so each thread issues the loads of 4-8 token rows
//   before it uses the first (kUnroll).
// - Masked positions inside the last valid block are never loaded.
// - The contiguous cache takes the same path with its implicit table, so it
//   too reads only ceil(len/BS) blocks of each sequence and nothing past
//   len (the TPU kernel clamped its index map for that).
//
// Known limit: at B = 8 and KH = 8 the grid is 64 CTAs on 132 SMs, so half
// the card idles during decode. Splitting each sequence's blocks across CTAs
// with a second reduction pass (flash-decoding) is the later perf work. An
// int8 row is 8 bytes a thread where 16 would fill the load width: packing
// two token rows per load is later work too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ void to_f32(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void to_f32(const uint2& raw, float (&out)[8]) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

// 8 consecutive elements of a pool row: their load type, and whether the
// pool carries per-vector scales
template <typename T> struct Payload;
template <> struct Payload<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr bool kScaled = false;
};
template <> struct Payload<int8_t> {
  using Raw = uint2;
  static constexpr bool kScaled = true;
};

// where block j of sequence b lies in the pool
struct Table {          // B1, B2: the sequence's row of the block table
  __device__ static int64_t block(const int32_t* table, int b, int j, int max_blocks) {
    return table[(int64_t)b * max_blocks + j];
  }
};
struct Contiguous {     // B4: the [B, S, KH, D] cache, max_blocks = S / BS per sequence
  __device__ static int64_t block(const int32_t*, int b, int j, int max_blocks) {
    return (int64_t)b * max_blocks + j;
  }
};

template <typename T, typename Addr, int G, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_table,
                    const int32_t* __restrict__ cache_len,
                    __nv_bfloat16* __restrict__ out,
                    int kv_heads, int block_s, int max_blocks, float scale) {
  using Raw = typename Payload<T>::Raw;
  constexpr bool kScaled = Payload<T>::kScaled;
  constexpr int kLanesPerRow = D / 8;                // 8-element slices per token row
  constexpr int kTokenLanes = kThreads / kLanesPerRow;
  constexpr int kWarps = kThreads / 32;
  // token rows whose loads a thread issues together (fewer for G = 8,
  // whose q rows and accumulators already hold 128 registers)
  constexpr int kUnroll = G >= 8 ? 4 : 8;
  // scores/probabilities [G][block_s]; after the last block, the token
  // lanes' partial accumulators [kTokenLanes][G][D]
  extern __shared__ float smem[];
  __shared__ float m_sh[G], l_sh[G], alpha_sh[G];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int dc = tid % kLanesPerRow;
  const int tl = tid / kLanesPerRow;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_heads = kv_heads * G;
  const int len = max(cache_len[b], 0);
  const int64_t row_stride = (int64_t)kv_heads * D;   // between tokens of a block

  float qr[G][8];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((int64_t)b * q_heads + h * G + r) * D + dc * 8);
    to_f32(raw, qr[r]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[r][i] *= scale;
  }
  float acc[G][8];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  if (tid < G) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  __syncthreads();

  // a length past the table's width reads no further than its last column
  const int n_blocks = min((len + block_s - 1) / block_s, max_blocks);
  for (int j = 0; j < n_blocks; ++j) {
    const int64_t phys = Addr::block(block_table, b, j, max_blocks);
    const int valid = min(block_s, len - j * block_s);
    const int64_t base = (phys * block_s * kv_heads + h) * D + dc * 8;
    const int64_t scale_base = phys * block_s * kv_heads + h;   // int8 only

    // scores, kUnroll token rows per thread at a time: their loads are all
    // issued before the first is used, so each thread keeps kUnroll loads
    // in flight. Every lane of a warp runs the same trip count (block_s is
    // a multiple of kTokenLanes), so the shuffles below stay converged.
    for (int t0 = tl; t0 < block_s; t0 += kTokenLanes * kUnroll) {
      Raw raw[kUnroll];
      float sk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokenLanes;
        raw[u] = t < valid ? *reinterpret_cast<const Raw*>(k_pool + base + t * row_stride)
                         : Raw{};
        if constexpr (kScaled) sk[u] = t < valid ? k_scale[scale_base + t * kv_heads] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokenLanes;
        float part[G];
#pragma unroll
        for (int r = 0; r < G; ++r) part[r] = 0.f;
        if (t < valid) {
          float kf[8];
          to_f32(raw[u], kf);
#pragma unroll
          for (int r = 0; r < G; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) part[r] += qr[r][i] * kf[i];
        }
#pragma unroll
        for (int r = 0; r < G; ++r)
#pragma unroll
          for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
        if constexpr (kScaled) {
#pragma unroll
          for (int r = 0; r < G; ++r) part[r] *= sk[u];
        }
        if (dc == 0 && t < block_s) {
#pragma unroll
          for (int r = 0; r < G; ++r) smem[r * block_s + t] = t < valid ? part[r] : kNegInf;
        }
      }
    }
    __syncthreads();

    // online-softmax statistics, one warp per query row
    for (int r = warp; r < G; r += kWarps) {
      float* s = smem + r * block_s;
      float mx = kNegInf;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, s[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < block_s; t += 32) {
        const float p = t < valid ? expf(s[t] - m_new) : 0.f;
        s[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_sh[r] = alpha;
        l_sh[r] = alpha * l_sh[r] + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();

    // rescale, then accumulate p * v over the valid tokens
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float a = alpha_sh[r];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] *= a;
    }
    for (int t0 = tl; t0 < valid; t0 += kTokenLanes * kUnroll) {
      Raw raw[kUnroll];
      float sv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokenLanes;
        raw[u] = t < valid ? *reinterpret_cast<const Raw*>(v_pool + base + t * row_stride)
                         : Raw{};
        if constexpr (kScaled) sv[u] = t < valid ? v_scale[scale_base + t * kv_heads] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokenLanes;
        if (t < valid) {
          float vf[8];
          to_f32(raw[u], vf);
          float s_t = 1.f;   // folded away for the bf16 pool
          if constexpr (kScaled) s_t = sv[u];
#pragma unroll
          for (int r = 0; r < G; ++r) {
            const float p = smem[r * block_s + t] * s_t;
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][i] += p * vf[i];
          }
        }
      }
    }
    __syncthreads();   // the next block overwrites the probabilities
  }

  float* red = smem;
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) red[(tl * G + r) * D + dc * 8 + i] = acc[r][i];
  __syncthreads();
  for (int o = tid; o < G * D; o += kThreads) {
    const int r = o / D;
    const int d = o % D;
    float sum = 0.f;
    for (int l = 0; l < kTokenLanes; ++l) sum += red[(l * G + r) * D + d];
    out[((int64_t)b * q_heads + h * G + r) * D + d] =
        __float2bfloat16(sum / fmaxf(l_sh[r], 1e-30f));
  }
}

template <typename T, typename Addr, int G, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* block_table, const void* cache_len, void* out,
           int batch, int kv_heads, int block_s, int max_blocks, float scale,
           cudaStream_t stream) {
  constexpr int kTokenLanes = kThreads / (D / 8);
  const int score_floats = G * block_s;
  const int red_floats = kTokenLanes * G * D;
  const size_t smem = sizeof(float) * (score_floats > red_floats ? score_floats : red_floats);
  const dim3 grid(kv_heads, batch);
  paged_decode_kernel<T, Addr, G, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(cache_len), static_cast<__nv_bfloat16*>(out), kv_heads,
      block_s, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

// Picks the (G, D) instance; cudaErrorInvalidValue for a shape it has none
// for. k/v_scale are null for the bf16 pool, block_table for the contiguous
// cache.
template <typename T, typename Addr>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* block_table, const void* cache_len, void* out,
             int batch, int q_heads, int kv_heads, int head_dim, int block_s, int max_blocks,
             float scale, void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || block_s <= 0 || block_s % 16 != 0 ||
      block_s > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = q_heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPU9_CASE(G, D)                                                                    \
  if (g == G && head_dim == D)                                                             \
    return launch<T, Addr, G, D>(q, k_pool, v_pool, k_scale, v_scale, block_table, cache_len, \
                                 out, batch, kv_heads, block_s, max_blocks, scale, s);
  TPU9_CASE(1, 64) TPU9_CASE(2, 64) TPU9_CASE(4, 64) TPU9_CASE(8, 64)
  TPU9_CASE(1, 128) TPU9_CASE(2, 128) TPU9_CASE(4, 128) TPU9_CASE(8, 128)
#undef TPU9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel has no instance for. The
// Python wrappers validate shapes, types, contiguity and alignment first.
extern "C" int tpu9_paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* block_table,
    const void* cache_len, void* out, int batch, int q_heads, int kv_heads, int head_dim,
    int block_s, int max_blocks, float scale, void* stream) {
  return dispatch<__nv_bfloat16, Table>(q, k_pool, v_pool, nullptr, nullptr, block_table,
                                        cache_len, out, batch, q_heads, kv_heads, head_dim,
                                        block_s, max_blocks, scale, stream);
}

extern "C" int tpu9_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_table, const void* cache_len, void* out, int batch,
    int q_heads, int kv_heads, int head_dim, int block_s, int max_blocks, float scale,
    void* stream) {
  return dispatch<int8_t, Table>(q, k_pool, v_pool, k_scale, v_scale, block_table, cache_len,
                                 out, batch, q_heads, kv_heads, head_dim, block_s, max_blocks,
                                 scale, stream);
}

// The contiguous cache [B, S, KH, D]: seq_len = S, a multiple of block_s.
extern "C" int tpu9_ragged_decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, const void* cache_len, void* out,
    int batch, int q_heads, int kv_heads, int head_dim, int block_s, int seq_len, float scale,
    void* stream) {
  if (block_s <= 0 || seq_len % block_s != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16, Contiguous>(q, k_cache, v_cache, nullptr, nullptr, nullptr,
                                             cache_len, out, batch, q_heads, kv_heads, head_dim,
                                             block_s, seq_len / block_s, scale, stream);
}
