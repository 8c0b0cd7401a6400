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
//   part_acc    [B, QH, NS, D]    f32 scratch: each split's unnormalised output
//   part_ml     [B, QH, NS, 2]    f32 scratch: each split's running max and sum
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
// which H100 bf16 compute would become the limit. Reading a few MB at
// 3.35 TB/s takes microseconds, so what stands between a launch and that
// bound is latency: enough loads in flight on every SM, and no CTA that
// walks a long sequence while the others have finished.
//
// Split-KV (flash-decoding), two kernels from one entry point:
//
// - split_decode_kernel: the grid is (kv head h, sequence b, split s). Split
//   s owns the table columns [s * bps, (s + 1) * bps) of sequence b; the
//   wrapper sizes NS and bps from the shapes alone (split_plan in
//   ops/paged_attention.py), never from the lengths, so a launch makes no
//   host read and stays capturable in a CUDA graph. A split whose first
//   column is at or past ceil(len/BS) exits at once: it reads no table entry
//   and writes nothing. So a sequence holds ceil(ceil(len/BS)/bps) CTAs, and
//   the launch takes about the time of one split of bps blocks, where one
//   CTA per (sequence, kv head) took the time of the longest sequence and
//   left most SMs idle (64 CTAs on 132 SMs at B = 8, KH = 8; 8 at B = 1).
//   Each CTA computes its range's running max m, sum l and unnormalised
//   accumulator acc[g][D] in f32 as the one-CTA kernel did for the whole
//   sequence, and writes them to part_acc / part_ml.
// - combine_kernel: one CTA of D threads per (sequence, query head). It reads
//   cache_len[b] itself and merges only the splits that hold positions:
//   m* = max m_i, out = sum e^(m_i - m*) acc_i / max(sum e^(m_i - m*) l_i,
//   1e-30), in bf16. Length 0 merges nothing and gives zeros; one split
//   gives acc / max(l, 1e-30), the one-CTA result up to summation order.
//
// Inside a split CTA (128 threads):
// - The CTA keeps the g query rows of its GQA group in registers, so each
//   k/v row is read once for all g heads that share it.
// - Thread (token lane tl, slice dc) owns kElems consecutive elements of D,
//   so the D/kElems lanes that share a token issue one contiguous 16-byte
//   load each: 8 bf16, or 16 int8 plus the token's 4-byte scale, which the
//   lanes of a token read as one broadcast. (Neighbouring token rows of one
//   head lie KH * D elements apart in [N, BS, KH, D], so a 16-byte int8 load
//   must cover 16 elements of one row, not two rows.) The G = 8 int8
//   instance keeps 8 elements (8 bytes) a thread: at 16 its query rows and
//   accumulators alone would take 256 registers, past the 255 a thread has.
// - Scores reduce over those lanes with warp shuffles, go to shared memory,
//   one warp per query row computes the block's max/sum, and every thread
//   rescales and accumulates p * v for its kElems columns and g rows in f32
//   registers. The token lanes' partial sums meet in shared memory once, at
//   the end.
// - Each thread issues the loads of 4-8 token rows before it uses the first
//   (kUnroll), so every thread keeps 32-128 bytes in flight.
// - D = 256 (gemma) keeps a thread's share of a row: twice the lanes a
//   row (a whole warp for 8-element rows) and half the token lanes, so a
//   thread's registers are those of its D = 128 instance. The reduction
//   scratch kTokenLanes * G * D floats stays at most 32 KB (G = 8, or G =
//   4 with 16-element rows), under the 48 KB a launch gets without opting
//   in, as does the score scratch G * BS floats (32 KB at G = 8, BS = 1024).
// - Masked positions inside the last valid block are never loaded.
// - The contiguous cache takes the same path with its implicit table, so it
//   too reads only ceil(len/BS) blocks of each sequence and nothing past
//   len (the TPU kernel clamped its index map for that).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

// 8 bf16 (one 16-byte load) to f32
__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// the 4 int8 of a 32-bit word to f32, sign-extended by arithmetic shifts
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<float>(static_cast<int32_t>(w << (24 - 8 * i)) >> 24);
}

// What one thread loads of a pool row: kElems consecutive elements of D in
// one load of type Raw, their conversion to f32, and whether the pool
// carries per-vector scales
template <typename T, int G> struct Payload;
template <int G> struct Payload<__nv_bfloat16, G> {
  static constexpr int kElems = 8;                  // 16 bytes
  using Raw = uint4;
  static constexpr bool kScaled = false;
  static constexpr int kMinCtas = 1;                // per SM, for __launch_bounds__
  __device__ static void to_f32(const Raw& raw, float (&out)[kElems]) {
    bf16x8_to_f32(raw, out);
  }
};
template <int G> struct Payload<int8_t, G> {
  // 16 bytes; 8 bytes for G = 8, whose 16-element rows would not fit in
  // the registers (see the note at the top)
  static constexpr int kElems = G >= 8 ? 8 : 16;
  using Raw = typename std::conditional<kElems == 16, uint4, uint2>::type;
  static constexpr bool kScaled = true;
  // 16-element rows take 219 registers at 8 loads in flight, which leaves
  // room for 2 CTAs an SM; at 4 loads in flight they fit 3 CTAs an SM (at
  // most 168 registers, no spills), which hides more latency
  static constexpr int kMinCtas = kElems == 16 ? 3 : 1;
  __device__ static void to_f32(const Raw& raw, float (&out)[kElems]) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kElems / 4; ++i) int8x4_to_f32(w[i], out + 4 * i);
  }
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

// table columns of sequence b that hold positions
__device__ __forceinline__ int valid_blocks(const int32_t* cache_len, int b, int block_s,
                                            int max_blocks) {
  const int len = max(cache_len[b], 0);
  // a length past the table's width reads no further than its last column
  return min((len + block_s - 1) / block_s, max_blocks);
}

template <typename T, typename Addr, int G, int D>
__global__ void __launch_bounds__(kThreads, Payload<T, G>::kMinCtas)
split_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_table,
                    const int32_t* __restrict__ cache_len,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml,
                    int kv_heads, int block_s, int max_blocks, int blocks_per_split,
                    float scale) {
  using P = Payload<T, G>;
  using Raw = typename P::Raw;
  constexpr bool kScaled = P::kScaled;
  constexpr int kElems = P::kElems;
  constexpr int kLanesPerRow = D / kElems;           // threads per token row
  constexpr int kTokenLanes = kThreads / kLanesPerRow;
  constexpr int kWarps = kThreads / 32;
  // token rows whose loads a thread issues together: fewer for G = 8,
  // whose q rows and accumulators already hold 128 registers, and for
  // 16-element rows, whose loads are twice as wide
  constexpr int kUnroll = (G >= 8 || kElems == 16) ? 4 : 8;
  // scores/probabilities [G][block_s]; after the last block, the token
  // lanes' partial accumulators [kTokenLanes][G][D]
  extern __shared__ float smem[];
  __shared__ float m_sh[G], l_sh[G], alpha_sh[G];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_blocks = valid_blocks(cache_len, b, block_s, max_blocks);
  const int j_begin = split * blocks_per_split;
  if (j_begin >= n_blocks) return;     // the whole CTA, before any barrier
  const int j_end = min(j_begin + blocks_per_split, n_blocks);

  const int tid = threadIdx.x;
  const int dc = tid % kLanesPerRow;
  const int tl = tid / kLanesPerRow;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_heads = kv_heads * G;
  const int len = cache_len[b];
  const int64_t row_stride = (int64_t)kv_heads * D;   // between tokens of a block

  float qr[G][kElems];
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int c = 0; c < kElems / 8; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + ((int64_t)b * q_heads + h * G + r) * D + dc * kElems + c * 8);
      bf16x8_to_f32(raw, qr[r] + c * 8);
    }
#pragma unroll
    for (int i = 0; i < kElems; ++i) qr[r][i] *= scale;
  }
  float acc[G][kElems];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[r][i] = 0.f;
  if (tid < G) {
    m_sh[tid] = kNegInf;
    l_sh[tid] = 0.f;
  }
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const int64_t phys = Addr::block(block_table, b, j, max_blocks);
    const int valid = min(block_s, len - j * block_s);
    const int64_t base = (phys * block_s * kv_heads + h) * D + dc * kElems;
    const int64_t scale_base = phys * block_s * kv_heads + h;   // int8 only

    // scores, kUnroll token rows per thread at a time: their loads are all
    // issued before the first is used, so each thread keeps kUnroll loads
    // in flight. Every lane of a warp runs the same trip count (block_s is
    // a multiple of the tokens a warp covers), so the shuffles below stay
    // converged.
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
          float kf[kElems];
          P::to_f32(raw[u], kf);
#pragma unroll
          for (int r = 0; r < G; ++r)
#pragma unroll
            for (int i = 0; i < kElems; ++i) part[r] += qr[r][i] * kf[i];
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
      for (int i = 0; i < kElems; ++i) acc[r][i] *= a;
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
          float vf[kElems];
          P::to_f32(raw[u], vf);
          float s_t = 1.f;   // folded away for the bf16 pool
          if constexpr (kScaled) s_t = sv[u];
#pragma unroll
          for (int r = 0; r < G; ++r) {
            const float p = smem[r * block_s + t] * s_t;
#pragma unroll
            for (int i = 0; i < kElems; ++i) acc[r][i] += p * vf[i];
          }
        }
      }
    }
    __syncthreads();   // the next block overwrites the probabilities
  }

  // the token lanes' accumulators meet in shared memory; the split's
  // partial output, max and sum go to the scratch
  float* red = smem;
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int i = 0; i < kElems; ++i) red[(tl * G + r) * D + dc * kElems + i] = acc[r][i];
  __syncthreads();
  const int n_splits = gridDim.z;
  const int64_t part_row = ((int64_t)b * q_heads + h * G) * n_splits + split;
  for (int o = tid; o < G * D; o += kThreads) {
    const int r = o / D;
    const int d = o % D;
    float sum = 0.f;
    for (int l = 0; l < kTokenLanes; ++l) sum += red[(l * G + r) * D + d];
    part_acc[(part_row + (int64_t)r * n_splits) * D + d] = sum;
  }
  if (tid < G) {
    float* ml = part_ml + (part_row + (int64_t)tid * n_splits) * 2;
    ml[0] = m_sh[tid];
    ml[1] = l_sh[tid];
  }
}

// Merges the partials of one (sequence b, query head) into its output row;
// thread d owns element d.
template <int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               const int32_t* __restrict__ cache_len, __nv_bfloat16* __restrict__ out,
               int q_heads, int block_s, int max_blocks, int blocks_per_split,
               int n_splits) {
  const int qh = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int n_blocks = valid_blocks(cache_len, b, block_s, max_blocks);
  const int used = (n_blocks + blocks_per_split - 1) / blocks_per_split;
  const int64_t row = (int64_t)b * q_heads + qh;
  const float* ml = part_ml + row * n_splits * 2;
  const float* acc = part_acc + row * n_splits * D + d;
  float m_max = kNegInf;
#pragma unroll 4
  for (int i = 0; i < used; ++i) m_max = fmaxf(m_max, ml[2 * i]);
  float num = 0.f, den = 0.f;
#pragma unroll 4
  for (int i = 0; i < used; ++i) {
    const float w = expf(ml[2 * i] - m_max);
    num += w * acc[(int64_t)i * D];
    den += w * ml[2 * i + 1];
  }
  out[row * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

template <typename T, typename Addr, int G, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* block_table, const void* cache_len, void* out,
           void* part_acc, void* part_ml, int batch, int kv_heads, int block_s,
           int max_blocks, int n_splits, int blocks_per_split, float scale,
           cudaStream_t stream) {
  constexpr int kTokenLanes = kThreads / (D / Payload<T, G>::kElems);
  const int score_floats = G * block_s;
  const int red_floats = kTokenLanes * G * D;
  const size_t smem = sizeof(float) * (score_floats > red_floats ? score_floats : red_floats);
  split_decode_kernel<T, Addr, G, D><<<dim3(kv_heads, batch, n_splits), kThreads, smem,
                                       stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(cache_len), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), kv_heads, block_s, max_blocks, blocks_per_split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<D><<<dim3(kv_heads * G, batch), D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int32_t*>(cache_len), static_cast<__nv_bfloat16*>(out), kv_heads * G,
      block_s, max_blocks, blocks_per_split, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// Picks the (G, D) instance; cudaErrorInvalidValue for a shape it has none
// for, or for a split plan that does not cover the table's columns. k/v_scale
// are null for the bf16 pool, block_table for the contiguous cache.
template <typename T, typename Addr>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* block_table, const void* cache_len, void* out,
             void* part_acc, void* part_ml, int batch, int q_heads, int kv_heads, int head_dim,
             int block_s, int max_blocks, int n_splits, int blocks_per_split, float scale,
             void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || block_s <= 0 || block_s % 16 != 0 ||
      block_s > 1024 || max_blocks <= 0 || blocks_per_split <= 0 || n_splits <= 0 ||
      n_splits > 65535 || (int64_t)n_splits * blocks_per_split < max_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = q_heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPU9_CASE(G, D)                                                                    \
  if (g == G && head_dim == D)                                                             \
    return launch<T, Addr, G, D>(q, k_pool, v_pool, k_scale, v_scale, block_table, cache_len, \
                                 out, part_acc, part_ml, batch, kv_heads, block_s,         \
                                 max_blocks, n_splits, blocks_per_split, scale, s);
  TPU9_CASE(1, 64) TPU9_CASE(2, 64) TPU9_CASE(4, 64) TPU9_CASE(8, 64)
  TPU9_CASE(1, 128) TPU9_CASE(2, 128) TPU9_CASE(4, 128) TPU9_CASE(8, 128)
  TPU9_CASE(1, 256) TPU9_CASE(2, 256) TPU9_CASE(4, 256) TPU9_CASE(8, 256)
#undef TPU9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each launches the split kernel and then the combine kernel on the stream
// and returns cudaGetLastError() after the first launch that failed, or
// after the second (0 = both launched); cudaErrorInvalidValue for a shape
// the kernels have no instance for. The Python wrappers validate shapes,
// types, contiguity and alignment first, and allocate the scratch.
extern "C" int tpu9_paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* block_table,
    const void* cache_len, void* out, void* part_acc, void* part_ml, int batch, int q_heads,
    int kv_heads, int head_dim, int block_s, int max_blocks, int n_splits,
    int blocks_per_split, float scale, void* stream) {
  return dispatch<__nv_bfloat16, Table>(q, k_pool, v_pool, nullptr, nullptr, block_table,
                                        cache_len, out, part_acc, part_ml, batch, q_heads,
                                        kv_heads, head_dim, block_s, max_blocks, n_splits,
                                        blocks_per_split, scale, stream);
}

extern "C" int tpu9_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_table, const void* cache_len, void* out,
    void* part_acc, void* part_ml, int batch, int q_heads, int kv_heads, int head_dim,
    int block_s, int max_blocks, int n_splits, int blocks_per_split, float scale,
    void* stream) {
  return dispatch<int8_t, Table>(q, k_pool, v_pool, k_scale, v_scale, block_table, cache_len,
                                 out, part_acc, part_ml, batch, q_heads, kv_heads, head_dim,
                                 block_s, max_blocks, n_splits, blocks_per_split, scale,
                                 stream);
}

// The contiguous cache [B, S, KH, D]: seq_len = S, a multiple of block_s.
extern "C" int tpu9_ragged_decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, const void* cache_len, void* out,
    void* part_acc, void* part_ml, int batch, int q_heads, int kv_heads, int head_dim,
    int block_s, int seq_len, int n_splits, int blocks_per_split, float scale,
    void* stream) {
  if (block_s <= 0 || seq_len % block_s != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16, Contiguous>(q, k_cache, v_cache, nullptr, nullptr, nullptr,
                                             cache_len, out, part_acc, part_ml, batch, q_heads,
                                             kv_heads, head_dim, block_s, seq_len / block_s,
                                             n_splits, blocks_per_split, scale, stream);
}
