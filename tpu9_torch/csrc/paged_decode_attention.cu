// Paged decode attention for Hopper (sm_90a), over a bf16 pool or an int8
// pool with f32 per-vector scales, found through a block table, or over a
// contiguous bf16 cache.
//
// Replaces three TPU kernels of tpu9/ops/paged_attention.py:
//   paged_decode_attention        (_paged_kernel, _table_block, _head_update,
//                                  _finalize_heads)   -> bf16 pool, Table
//   paged_decode_attention_quant  (_paged_quant_kernel) -> int8 pool, Table
//   ragged_decode_attention       (_kernel)           -> bf16, Contiguous
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
// Semantics carried over: scale D^-0.5; GQA puts query heads h*g ..
// h*g+g-1 over kv head h; positions >= cache_len[b] are masked; online
// softmax in f32; out = acc / max(l, 1e-30), so len 0 gives zeros. Only the
// ceil(len/BS) valid table entries of a row are read, and no position at or
// past len is loaded: entries past the prefix may hold anything, and the
// blocks (and scales) they name are never touched (the TPU kernels got the
// same effect by clamping their index maps).
//
// What bounds it: device-memory bytes. Each call must read
// sum_b len_b * KH * (D * E + S) * 2 (k and v) bytes of pool, E = 2 and
// S = 0 for bf16, E = 1 and S = 4 (the scale) for int8; the arithmetic is
// 4 * QH * D flops per cached position, far below the ~295 flop/byte at
// which H100 bf16 compute would become the limit. Reading a few MB at
// 3.35 TB/s takes microseconds, so what stands between a launch and that
// bound is latency: enough bytes in flight on every SM, and every SM busy.
//
// Split-KV (flash-decoding), two kernels from one entry point:
//
// - split_decode_kernel: the grid is (kv head h, sequence b, split s).
//   Split s owns positions [s * ST, (s + 1) * ST) of sequence b, ST a
//   multiple of 64 that may cut a block (a 128-position block holds two
//   64-position splits) or span several; the wrapper takes NS and ST from
//   the shapes alone (split_plan in ops/paged_attention.py), never from
//   the lengths, so a launch makes no host read and stays capturable in a
//   CUDA graph. A split that starts at or past len exits at once: it reads
//   no table entry and writes nothing. Each CTA computes its range's running
//   max m, sum l and unnormalised accumulator acc[g][D] in f32 and writes
//   them to part_acc / part_ml. Cutting inside a block is what fills the
//   card at one kv head: gemma-2b (KH = 1) at B = 8 has 93 live
//   64-position CTAs where one CTA a block gave 26.
// - combine_kernel: one CTA of D threads per (sequence, query head). It reads
//   cache_len[b] itself and merges only the ceil(len/ST) splits that hold
//   positions: m* = max m_i, out = sum e^(m_i - m*) acc_i /
//   max(sum e^(m_i - m*) l_i, 1e-30), in bf16. Length 0 merges nothing and
//   gives zeros. Each thread reads one split's (m, l) and the weights meet
//   in shared memory, so a thread's loads of its accumulator column are
//   independent of one another (64-position splits give up to 34 of them).
//
// Inside a split CTA: one producer warp and one consumer warpgroup (160
// threads), walking the split's 64-position tiles.
//
// - Staging by TMA. The pool is a 2-D tensor [N * BS rows, KH * D columns]
//   (the contiguous cache [B * S, KH * D]); a tile of kv head h is 64 rows
//   of columns [h * D, (h + 1) * D), loaded as four boxes of 16 rows (BS is
//   a multiple of 16, so a box never crosses a block, and blocks of 16 or
//   32 positions fill one tile from several blocks). bf16 boxes are 64
//   columns of 128-byte swizzled panels, D/64 a box; an int8 box is one
//   unswizzled run of D bytes a row. Before the CTA's barrier the producer
//   prefetches both tensor maps, makes the mbarriers, and its lane i reads
//   the table entry of the i-th block the split touches, while the
//   consumers load q; then per tile lane c issues box c. The k and v tiles
//   land in a ring of stages (2 at D = 64, else 1: 32 KB of bf16 tiles at
//   D <= 128, so five CTAs fit an SM, 64 KB at D = 256, three), each tile
//   with a "full" mbarrier (TMA transaction bytes) and an "empty" one (an
//   arrival per consumer warp): k is released after its product, v after
//   its own, so the next k tile loads under the current PV product. More
//   resident CTAs beat a deeper ring: a CTA's prologue, products and
//   epilogue are latency that other CTAs' loads hide (a ring of 4/2/1
//   stages, three CTAs an SM, was slower at D = 128 on the card).
// - Never past len. Only boxes that lie wholly below len go to TMA. The one
//   16-row run with len inside it is loaded by the consumers: its rows
//   below len with plain 16-byte loads from the pool, all issued before the
//   first store, its rows at or past len and the v rows after it zeroed
//   (a PV product multiplies them by P = 0, which must not meet a NaN).
//   These stores, like every generic store to a wgmma operand, are followed
//   by fence.proxy.async and a barrier of the warpgroup.
// - int8 tiles are staged as int8 (half the bytes) and widened to bf16 into
//   a swizzled tile W by the consumers before each product (int8 is exact in
//   bf16; the widening permutes bytes into f32 mantissas rather than
//   converting integers, whose instruction runs at a quarter rate). The
//   staged tile is released once widened. The tile's scales are strided by
//   KH, so each consumer thread reads the two it needs (its two keys,
//   below) with plain loads, issued before it waits for the tile.
// - The GQA group on tensor cores. Scores are computed transposed, keys as
//   the 64 rows and the group's query heads as the N = 8 columns (rows past
//   the group are zero in the q tile): S^T = K Q^T, wgmma m64n8k16, bf16
//   operands from shared memory, f32 accumulators, D/16 k-steps in two
//   chains (even and odd k-steps) added at the end. A thread
//   of the warpgroup holds 2 keys x 2 heads of S^T. The scale (and for int8
//   the token's s_k) multiplies the f32 score, the same number as scaling q
//   first up to f32 rounding; the running max of a head meets across the
//   four warps through shared memory once a tile. Then O^T += V^T P^T:
//   wgmma m64n16k16, V^T the MN-major A operand read from the tile as it
//   landed, one product a 64-dimension panel and 16 keys, P^T the K-major B
//   operand written by the consumers into a 16 x 64 tile. O^T's columns are
//   the heads of S^T's columns, so a thread rescales by its own heads'
//   factors. The accumulators are 4 + 8 D/64 floats a thread.
// - Why P goes in as two bf16 parts. The chip check holds the kernel to one
//   bf16 ulp of the twin's f32 result plus 1e-4. A P rounded once to bf16
//   (2^-9 relative) misses that near zero: a sum of n such errors over v of
//   unit rms is about 2^-9 / sqrt(n) rms(v), above 1e-4 at the lengths that
//   decode sees. So the B operand's 16 columns are P_hi = bf16(p) and P_lo =
//   bf16(p - P_hi), p carried to about 2^-17; the two halves of O^T are
//   added once at the end. For the int8 pool p is first multiplied by the
//   token's s_v: the same number as p times (v_int * s_v), up to f32
//   rounding, with one multiply a key in place of one an element.
// - Why wgmma and not mma.sync: the operands stay in shared memory where
//   TMA put them, with no ldmatrix pass, and one warpgroup issues a 64-key
//   product without any shuffling of fragments between warps.
// - The f32 sums run in another order than the twin's; the online softmax
//   runs in base 2 (exp2 of scores scaled by log2(e)), and the split's max
//   is written back in natural-log units for the combine.

#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int kConsumers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kTile = 64;                     // positions of a tile: wgmma's M
constexpr int kCols = 8;                      // S^T columns: the group, padded
constexpr int kMaxGroup = kCols;
constexpr int kBoxRows = 16;                  // rows of a TMA box: a block is a multiple

// Shared memory of one instance, in bytes from a 1024-byte aligned base:
// the ring of k/v tiles, the widened tile W (int8), the q tile, the P^T
// tile, the cross-warp maxima and sums, the mbarriers.
template <typename T, int D>
struct Layout {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 2 : 1;
  static constexpr int kTileBytes = kTile * D * (kInt8 ? 1 : 2);   // one k (or v) tile as staged
  static constexpr int kPanelBytes = kTile * kRowBytes;            // a bf16 tile's 64-column panel
  static constexpr int kW = kStages * 2 * kTileBytes;               // after the ring: stage s's k, then v
  static constexpr int kQ = kW + (kInt8 ? kTile * D * 2 : 0);
  static constexpr int kP = kQ + kPanels * kCols * kRowBytes;      // [8 rows] a panel
  static constexpr int kRed = kP + 2 * kCols * kRowBytes;          // P_hi rows, then P_lo rows
  static constexpr int kBars = kRed + 2 * 4 * kCols * 4;           // maxima, then sums
  static constexpr int kBytes = kBars + 4 * kStages * 8 + 1024;    // + alignment slack
};

// where block j of sequence b lies in the pool
struct Table {          // B1, B2: the sequence's row of the block table
  __device__ static int block(const int32_t* table, int b, int j, int max_blocks) {
    return table[static_cast<int64_t>(b) * max_blocks + j];
  }
};
struct Contiguous {     // B4: the [B, S, KH, D] cache, max_blocks = S / BS per sequence
  __device__ static int block(const int32_t*, int b, int j, int max_blocks) {
    return b * max_blocks + j;
  }
};

// the positions of sequence b the kernels read: its length, no further
// than the table's width
__device__ __forceinline__ int seq_positions(const int32_t* cache_len, int b, int block_s,
                                             int max_blocks) {
  return min(max(cache_len[b], 0), block_s * max_blocks);
}

// 16 int8 as 16 bf16 (exact), in two 16-byte halves. Each byte, offset to
// unsigned (x + 128), becomes the low mantissa byte of the f32 2^23 + x +
// 128 (a byte permute), and 2^23 + 128 is subtracted: exact, and no
// integer-to-float conversion, which runs at a quarter of the FP32 rate.
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo, uint4& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.f;
    out[2 * i] = pack_bf16(f[0], f[1]);
    out[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

template <typename T, typename Addr, int D>
__global__ void __launch_bounds__(kThreads)
split_decode_kernel(const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ block_table,
                    const int32_t* __restrict__ cache_len,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml,
                    int group, int kv_heads, int block_s, int max_blocks, int split_tokens,
                    float scale_log2) {
  using L = Layout<T, D>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kPanels = L::kPanels;
  constexpr int kStages = L::kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int len = seq_positions(cache_len, b, block_s, max_blocks);
  const int start = split * split_tokens;
  if (start >= len) return;          // the whole CTA, before any barrier
  const int end = min(start + split_tokens, len);
  const int n_tiles = (end - start + kTile - 1) / kTile;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));   // base, generic
  auto k_tile = [&](int t) { return (t % kStages) * 2 * L::kTileBytes; };
  auto v_tile = [&](int t) { return k_tile(t) + L::kTileBytes; };
  const uint32_t bars = base + L::kBars;
  auto full_k = [&](int t) { return bars + 8 * (t % kStages); };
  auto full_v = [&](int t) { return bars + 8 * (kStages + t % kStages); };
  auto empty_k = [&](int t) { return bars + 8 * (2 * kStages + t % kStages); };
  auto empty_v = [&](int t) { return bars + 8 * (3 * kStages + t % kStages); };

  const int tid = threadIdx.x;
  const int64_t row_stride = static_cast<int64_t>(kv_heads) * D;   // between pool rows
  const int j0 = start / block_s;                  // the split's first table column
  if (tid >= kConsumers) {
    // producer warp: the tensor maps fetched early, the mbarriers made,
    // and lane i's load of the pool block of the split's i-th table
    // column issued, all before the CTA's barrier
    const int lane = tid - kConsumers;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&k_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&v_map))
                   : "memory");
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full_k(s), 1);
        mbar_init(full_v(s), 1);
        mbar_init(empty_k(s), 4);                            // one arrival per consumer warp
        mbar_init(empty_v(s), 4);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    const int j_last = (end - 1) / block_s;
    const int my_block =
        j0 + lane <= j_last ? Addr::block(block_table, b, j0 + lane, max_blocks) : 0;
    named_barrier(2, kThreads);            // the CTA's: the mbarriers exist
    const int col0 = h * D;
    for (int t = 0; t < n_tiles; ++t) {
      const int p0 = start + t * kTile;
      const int boxes = min(kTile, end - p0) / kBoxRows;    // the boxes wholly below len
      const uint32_t bytes = static_cast<uint32_t>(boxes * kBoxRows * D * sizeof(T));
      const int pos = p0 + lane * kBoxRows;
      const int j = pos / block_s;
      int blk = __shfl_sync(0xffffffffu, my_block, min(j - j0, 31));
      if (lane < boxes && j - j0 > 31) blk = Addr::block(block_table, b, j, max_blocks);
      const int row = blk * block_s + pos % block_s;
      // k, then v: each stage is reloaded once the consumers released it,
      // k after its product and v after its own
      for (int kv = 0; kv < 2; ++kv) {
        const uint32_t full = kv ? full_v(t) : full_k(t);
        const uint32_t dst = base + (kv ? v_tile(t) : k_tile(t));
        const CUtensorMap* map = kv ? &v_map : &k_map;
        if (t >= kStages) mbar_wait(kv ? empty_v(t) : empty_k(t), ((t / kStages) & 1) ^ 1);
        if (lane == 0) mbar_expect_tx(full, bytes);
        __syncwarp();
        if (lane < boxes) {
          if constexpr (kInt8) {
            tma_load_2d(dst + lane * kBoxRows * D, map, full, col0, row);
          } else {
#pragma unroll
            for (int p = 0; p < kPanels; ++p)
              tma_load_2d(dst + p * L::kPanelBytes + lane * kBoxRows * kRowBytes, map, full,
                          col0 + 64 * p, row);
          }
        }
      }
    }
    return;
  }

  // consumers: the group's q rows as the K-major B operand [8 rows, D],
  // rows past the group zero, loaded before the CTA's barrier and stored
  // after it
  constexpr int kQChunks = kCols * D / 8;                  // 16-byte chunks of the tile
  constexpr int kQPer = (kQChunks + kConsumers - 1) / kConsumers;
  uint4 q_val[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kConsumers;
    const int r = i / (D / 8);
    q_val[u] = r < group ? *reinterpret_cast<const uint4*>(
                               q + ((static_cast<int64_t>(b) * kv_heads + h) * group + r) * D +
                               (i % (D / 8)) * 8)
                         : make_uint4(0, 0, 0, 0);
  }
  named_barrier(2, kThreads);              // the CTA's: the mbarriers exist
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kConsumers;
    const int c = i % (D / 8);
    if (i < kQChunks)
      *reinterpret_cast<uint4*>(smem + L::kQ + (c / 8) * kCols * kRowBytes +
                                swizzle128(i / (D / 8), c % 8)) = q_val[u];
  }
  fence_proxy_async();
  named_barrier(1, kConsumers);

  // consumers
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int key_a = 16 * warp + lane / 4;        // this thread's rows of S^T (and of O^T)
  const int key_b = key_a + 8;
  const int col = 2 * (lane % 4);                // its two columns: heads col, col + 1
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  float m2[2] = {kNegInf, kNegInf};              // running max, base-2 units
  float l_part[2] = {0.f, 0.f};                  // running sum over this thread's keys
  float o[kPanels][8];                           // O^T: P_hi half (0-3), P_lo half (4-7)
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[p][i] = 0.f;

  // the pool row of position pos of this sequence (pos < len)
  auto pool_row = [&](int pos) {
    return static_cast<int64_t>(Addr::block(block_table, b, pos / block_s, max_blocks)) * block_s +
           pos % block_s;
  };
  // The int8 tile at `staged` widened into W, its first `rows` rows, and
  // zeros in W's rows [rows, zero_to).
  auto widen_tile = [&](int staged, int rows, int zero_to) {
    for (int i = tid; i < zero_to * (D / 16); i += kConsumers) {
      const int r = i / (D / 16);
      const int c = i % (D / 16);                // 16-byte run of int8
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (r < rows)
        widen16(*reinterpret_cast<const uint4*>(smem + staged + r * D + c * 16), lo, hi);
      unsigned char* panel = smem + L::kW + (c / 4) * L::kPanelBytes;
      *reinterpret_cast<uint4*>(panel + swizzle128(r, 2 * (c % 4))) = lo;
      *reinterpret_cast<uint4*>(panel + swizzle128(r, 2 * (c % 4) + 1)) = hi;
    }
  };
  // The 16-row run of a tile that TMA left to the consumers, rows
  // [first, first + 16) with len inside it: rows below `valid` from the
  // pool (one block holds the run), the rest zeros, into the k and v tiles
  // as staged. Every load is issued before the first store.
  auto fill_tail = [&](int k_at, int v_at, int p0, int first, int valid) {
    constexpr int kRowPieces = D * sizeof(T) / 16;           // 16-byte pieces a row
    constexpr int kPer = 2 * kBoxRows * kRowPieces / kConsumers;
    const int64_t row0 = pool_row(p0 + first);
    uint4 val[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kConsumers;
      const int r = (i / kRowPieces) % kBoxRows;
      const int c = i % kRowPieces;
      const T* pool = i < kBoxRows * kRowPieces ? k_pool : v_pool;
      val[u] = first + r < valid
                   ? *reinterpret_cast<const uint4*>(pool + (row0 + r) * row_stride + h * D +
                                                     c * (16 / sizeof(T)))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kConsumers;
      const int r = first + (i / kRowPieces) % kBoxRows;
      const int c = i % kRowPieces;
      const int at = i < kBoxRows * kRowPieces ? k_at : v_at;
      const int off = kInt8 ? r * D + c * 16 : (c / 8) * L::kPanelBytes + swizzle128(r, c % 8);
      *reinterpret_cast<uint4*>(smem + at + off) = val[u];
    }
  };

  // Zeros in rows [rows, 64) of the bf16 tile at `at`: the v rows a
  // partial tile's PV product multiplies by P = 0.
  auto zero_rows = [&](int at, int rows) {
    for (int i = tid; i < (kTile - rows) * (D / 8); i += kConsumers) {
      const int r = rows + i / (D / 8);
      const int c = i % (D / 8);
      *reinterpret_cast<uint4*>(smem + at + (c / 8) * L::kPanelBytes + swizzle128(r, c % 8)) =
          make_uint4(0, 0, 0, 0);
    }
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = start + t * kTile;
    const int valid = min(kTile, end - p0);
    const int tma_rows = valid / kBoxRows * kBoxRows;
    const int rows = (valid + kBoxRows - 1) / kBoxRows * kBoxRows;   // the rows the products use
    const uint32_t parity = (t / kStages) & 1;
    const bool tail = tma_rows < valid;
    float sk[2] = {1.f, 1.f}, sv[2] = {1.f, 1.f};
    if constexpr (kInt8) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = r ? key_b : key_a;
        if (key < valid) {
          const int64_t at = pool_row(p0 + key) * kv_heads + h;
          sk[r] = k_scale[at];
          sv[r] = v_scale[at];
        }
      }
    }
    const bool partial = valid < kTile;
    // W (int8), or a single stage's rows written here, may still be read
    // by the previous tile's products in another warp
    if (t > 0 && (kInt8 || (kStages == 1 && partial))) named_barrier(1, kConsumers);
    if (tail) fill_tail(k_tile(t), v_tile(t), p0, tma_rows, valid);
    if constexpr (kInt8) {
      if (tail) named_barrier(1, kConsumers);   // the tail rows, staged, for every thread
      mbar_wait(full_k(t), parity);
      widen_tile(k_tile(t), rows, rows);
      fence_proxy_async();
      named_barrier(1, kConsumers);
      if (lane == 0) mbar_arrive(empty_k(t));    // the staged k is in W
    } else {
      if (partial) {
        zero_rows(v_tile(t), rows);
        fence_proxy_async();
        named_barrier(1, kConsumers);
      }
      mbar_wait(full_k(t), parity);
    }

    // S^T = K Q^T: 64 keys x 8 heads, the even and odd k-steps in two
    // accumulators so that two chains of products run side by side
    const uint32_t k_op = base + (kInt8 ? L::kW : k_tile(t));
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, sc2[4] = {0.f, 0.f, 0.f, 0.f};
    fence_operands(sc);
    fence_operands(sc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = (kk / 4) * L::kPanelBytes + (kk % 4) * 32;
      wgmma_n8(kk % 2 ? sc2 : sc, smem_desc(k_op + at, 16, 1024),
               smem_desc(base + L::kQ + (kk / 4) * kCols * kRowBytes + (kk % 4) * 32, 16, 1024),
               kk > 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(sc2);
    if constexpr (!kInt8) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k(t));  // this warp is done with the k tile
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] += sc2[i];

    // sc[i]: key (i < 2 ? key_a : key_b), head col + i % 2
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = i < 2 ? key_a : key_b;
      float x = sc[i] * scale_log2;
      if constexpr (kInt8) x *= sk[i / 2];
      s[i] = key < valid ? x : kNegInf;
    }
    float tile_max[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off *= 2)
        tile_max[j] = fmaxf(tile_max[j], __shfl_xor_sync(0xffffffffu, tile_max[j], off));
    if (lane < 4) {
      red[warp * kCols + col] = tile_max[0];
      red[warp * kCols + col + 1] = tile_max[1];
    }
    named_barrier(1, kConsumers);
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = red[col + j];
#pragma unroll
      for (int w = 1; w < 4; ++w) mx = fmaxf(mx, red[w * kCols + col + j]);
      const float m_new = fmaxf(m2[j], mx);
      alpha[j] = fast_exp2(m2[j] - m_new);
      m2[j] = m_new;
    }
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = fast_exp2(s[i] - m2[i % 2]);   // masked: 0
#pragma unroll
    for (int j = 0; j < 2; ++j) l_part[j] = l_part[j] * alpha[j] + p[j] + p[j + 2];
    // P^T as the B operand: row n (head; n + 8 its low part), column key
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = i < 2 ? key_a : key_b;
      const int n = col + i % 2;
      float x = p[i];
      if constexpr (kInt8) x *= sv[i / 2];
      const __nv_bfloat16 hi = __float2bfloat16(x);
      const __nv_bfloat16 lo = __float2bfloat16(x - __bfloat162float(hi));
      const uint32_t at = (key % 8) * 2;
      *reinterpret_cast<__nv_bfloat16*>(smem + L::kP + swizzle128(n, key / 8) + at) = hi;
      *reinterpret_cast<__nv_bfloat16*>(smem + L::kP + swizzle128(n + kCols, key / 8) + at) = lo;
    }
    if constexpr (kInt8) {
      mbar_wait(full_v(t), parity);
      widen_tile(v_tile(t), rows, kTile);
    }
    fence_proxy_async();
    named_barrier(1, kConsumers);
    if (kInt8 && lane == 0) mbar_arrive(empty_v(t));   // the staged v is in W
    if constexpr (!kInt8) mbar_wait(full_v(t), parity);

    // O^T = alpha O^T + V^T [P_hi P_lo]^T: D/64 panels x 4 k-steps of 16
    // keys (P is 0 past the valid keys, and v zero there)
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int i = 0; i < 8; ++i) o[pn][i] *= alpha[i % 2];
    const uint32_t v_op = base + (kInt8 ? L::kW : v_tile(t));
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_operands(o[pn]);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n16_mn(o[pn],
                     smem_desc(v_op + pn * L::kPanelBytes + kk * 16 * kRowBytes, L::kPanelBytes,
                               1024),
                     smem_desc(base + L::kP + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_operands(o[pn]);
    if constexpr (!kInt8) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v(t));  // this warp is done with the v tile
    }
  }

  // the sums meet across the lanes that share a head, then across warps
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int off = 4; off < 32; off *= 2)
      l_part[j] += __shfl_xor_sync(0xffffffffu, l_part[j], off);
  float* sums = red + 4 * kCols;
  if (lane < 4) {
    sums[warp * kCols + col] = l_part[0];
    sums[warp * kCols + col + 1] = l_part[1];
  }
  named_barrier(1, kConsumers);
  const int n_splits = gridDim.z;
  const int q_heads = kv_heads * group;
  const int64_t part_row = (static_cast<int64_t>(b) * q_heads + h * group) * n_splits + split;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int head = col + j;
    if (head >= group) continue;
    float* acc = part_acc + (part_row + static_cast<int64_t>(head) * n_splits) * D;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      acc[64 * pn + key_a] = o[pn][j] + o[pn][4 + j];
      acc[64 * pn + key_b] = o[pn][2 + j] + o[pn][6 + j];
    }
    if (warp == 0 && lane < 4) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) l += sums[w * kCols + head];
      float* ml = part_ml + (part_row + static_cast<int64_t>(head) * n_splits) * 2;
      ml[0] = m2[j] * kLn2;                       // natural-log units for the combine
      ml[1] = l;
    }
  }
}

// the sum or the max of one value of each of the D threads of a CTA, on
// every thread (`scratch` holds D/32 floats; the CTA's threads all call it)
template <int D, bool kMax>
__device__ __forceinline__ float cta_reduce(float x, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                      // scratch's previous use is over
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = x;
  __syncthreads();
  x = scratch[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) x = kMax ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

// Merges the partials of one (sequence b, query head) into its output row;
// thread d owns element d. The splits' (m, l) pairs are read one a thread
// and their weights shared through shared memory, D splits at a time, so
// the accumulators' loads are all independent.
template <int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               const int32_t* __restrict__ cache_len, __nv_bfloat16* __restrict__ out,
               int q_heads, int block_s, int max_blocks, int split_tokens, int n_splits) {
  __shared__ float w_sh[D];
  __shared__ float scratch[D / 32];
  const int qh = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int len = seq_positions(cache_len, b, block_s, max_blocks);
  const int used = (len + split_tokens - 1) / split_tokens;
  const int64_t row = (int64_t)b * q_heads + qh;
  const float2* ml = reinterpret_cast<const float2*>(part_ml + row * n_splits * 2);
  const float* acc = part_acc + row * n_splits * D + d;
  float m_max = kNegInf;
  for (int i = d; i < used; i += D) m_max = fmaxf(m_max, ml[i].x);
  m_max = cta_reduce<D, true>(m_max, scratch);
  float num = 0.f, den = 0.f;
  for (int c0 = 0; c0 < used; c0 += D) {
    const int n = min(D, used - c0);
    if (d < n) {
      const float2 s = ml[c0 + d];
      const float w = expf(s.x - m_max);
      w_sh[d] = w;
      den += w * s.y;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < n; ++i) num += w_sh[i] * acc[(int64_t)(c0 + i) * D];
    __syncthreads();
  }
  den = cta_reduce<D, false>(den, scratch);
  out[row * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

template <typename T, typename Addr, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* block_table, const void* cache_len, void* out,
           void* part_acc, void* part_ml, int batch, int kv_heads, int group, int block_s,
           int max_blocks, int64_t pool_rows, int n_splits, int split_tokens, float scale,
           cudaStream_t stream) {
  using L = Layout<T, D>;
  constexpr bool kInt8 = L::kInt8;
  // the pool's device current on this thread: the tensor-map encoder needs
  // its context, and a thread that made no runtime call yet has none
  cudaPointerAttributes where;
  cudaError_t err = cudaPointerGetAttributes(&where, k_pool);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(where.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool attr_set = false;    // the dynamic shared memory above 48 KB, once
  if (!attr_set) {
    err = cudaFuncSetAttribute(split_decode_kernel<T, Addr, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const uint64_t cols = static_cast<uint64_t>(kv_heads) * D;
  CUtensorMap k_map, v_map;
  if (!encode_map_2d(encode, &k_map, k_pool, kInt8, cols, pool_rows, kInt8 ? D : 64, kBoxRows) ||
      !encode_map_2d(encode, &v_map, v_pool, kInt8, cols, pool_rows, kInt8 ? D : 64, kBoxRows))
    return static_cast<int>(cudaErrorInvalidValue);
  split_decode_kernel<T, Addr, D><<<dim3(kv_heads, batch, n_splits), kThreads, L::kBytes,
                                    stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(cache_len), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), group, kv_heads, block_s, max_blocks, split_tokens,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<D><<<dim3(kv_heads * group, batch), D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int32_t*>(cache_len), static_cast<__nv_bfloat16*>(out), kv_heads * group,
      block_s, max_blocks, split_tokens, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// Picks the D instance (the group is a runtime argument: S^T always has 8
// columns); cudaErrorInvalidValue for a shape it has none for, or for a
// split plan that does not cover the table's positions. k/v_scale are null
// for the bf16 pool, block_table for the contiguous cache. `pool_rows` is
// the row extent of the pool's tensor maps.
template <typename T, typename Addr>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* block_table, const void* cache_len, void* out,
             void* part_acc, void* part_ml, int batch, int q_heads, int kv_heads, int head_dim,
             int block_s, int max_blocks, int64_t pool_rows, int n_splits, int split_tokens,
             float scale, void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || q_heads / kv_heads > kMaxGroup ||
      block_s <= 0 || block_s % 16 != 0 || block_s > 1024 || max_blocks <= 0 ||
      split_tokens <= 0 || split_tokens % kTile != 0 || n_splits <= 0 || n_splits > 65535 ||
      batch > 65535 || (int64_t)n_splits * split_tokens < (int64_t)max_blocks * block_s ||
      pool_rows <= 0 || pool_rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = q_heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPU9_CASE(D)                                                                            \
  if (head_dim == D)                                                                            \
    return launch<T, Addr, D>(q, k_pool, v_pool, k_scale, v_scale, block_table, cache_len, out, \
                              part_acc, part_ml, batch, kv_heads, group, block_s, max_blocks,   \
                              pool_rows, n_splits, split_tokens, scale, s);
  TPU9_CASE(64) TPU9_CASE(128) TPU9_CASE(256)
#undef TPU9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each launches the split kernel and then the combine kernel on the stream
// and returns cudaGetLastError() after the first launch that failed, or
// after the second (0 = both launched); cudaErrorInvalidValue for a shape
// the kernels have no instance for (or a tensor map the encoder refuses),
// cudaErrorNotSupported when no tensor-map encoder is found. The
// Python wrappers validate shapes, types, contiguity and alignment first,
// and allocate the scratch. The pool's tensor maps span the rows a 32-bit
// TMA coordinate reaches (the wrappers refuse a larger pool): the rows read
// are those the table names, as for any load through a table.
extern "C" int tpu9_paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* block_table,
    const void* cache_len, void* out, void* part_acc, void* part_ml, int batch, int q_heads,
    int kv_heads, int head_dim, int block_s, int max_blocks, int n_splits, int split_tokens,
    float scale, void* stream) {
  return dispatch<__nv_bfloat16, Table>(q, k_pool, v_pool, nullptr, nullptr, block_table,
                                        cache_len, out, part_acc, part_ml, batch, q_heads,
                                        kv_heads, head_dim, block_s, max_blocks, INT_MAX,
                                        n_splits, split_tokens, scale, stream);
}

extern "C" int tpu9_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_table, const void* cache_len, void* out,
    void* part_acc, void* part_ml, int batch, int q_heads, int kv_heads, int head_dim,
    int block_s, int max_blocks, int n_splits, int split_tokens, float scale, void* stream) {
  return dispatch<int8_t, Table>(q, k_pool, v_pool, k_scale, v_scale, block_table, cache_len,
                                 out, part_acc, part_ml, batch, q_heads, kv_heads, head_dim,
                                 block_s, max_blocks, INT_MAX, n_splits, split_tokens, scale,
                                 stream);
}

// The contiguous cache [B, S, KH, D]: seq_len = S, a multiple of block_s.
extern "C" int tpu9_ragged_decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, const void* cache_len, void* out,
    void* part_acc, void* part_ml, int batch, int q_heads, int kv_heads, int head_dim,
    int block_s, int seq_len, int n_splits, int split_tokens, float scale, void* stream) {
  if (block_s <= 0 || seq_len % block_s != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16, Contiguous>(
      q, k_cache, v_cache, nullptr, nullptr, nullptr, cache_len, out, part_acc, part_ml, batch,
      q_heads, kv_heads, head_dim, block_s, seq_len / block_s,
      static_cast<int64_t>(batch) * seq_len, n_splits, split_tokens, scale, stream);
}
