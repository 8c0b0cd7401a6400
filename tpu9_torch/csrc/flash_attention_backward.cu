// Flash attention backward for Hopper (sm_90a): dq, dk and dv of the flash
// forward (flash_attention.cu), bf16 in and out, f32 accumulation.
//
// Replaces the gradient of the TPU kernel flash_attention of
// tpu9/ops/attention.py (_flash_kernel). That kernel has no gradient: the
// JAX package differentiates its plain twin xla_attention (ROADMAP C11). This
// computes that gradient, causal (mask k_pos > q_pos, no offset) or not,
// with GQA:
//
//   q, out, d_out  [B, T, QH, D]   bf16, T a multiple of 64
//   k, v           [B, S, KH, D]   bf16, S a multiple of 64, KH divides QH
//   lse            [B, QH, T]      f32, the forward's row log-sum-exp
//   delta          [B, QH, T]      f32 scratch, written by the first pass
//   dq             [B, T, QH, D]   bf16
//   dk, dv         [B, S, KH, D]   bf16
//
// With x = q.k * scale (masked), p = exp(x - lse) (the forward's
// probabilities, recomputed without a softmax pass), delta = rowsum(d_out *
// out), dP = d_out V^T and dS = P * (dP - delta):
//   dv = P^T d_out,  dk = scale dS^T Q,  dq = scale dS K,
// a kv head's dk and dv summed over its group of q heads in f32. Three
// launches on the caller's stream:
//
// 1. delta_kernel: delta in f32, D/8 threads a (sequence, row, q head), 16
//    bytes of out and d_out each.
// 2. dkdv_kernel: one CTA a (k/v tile, kv head, sequence). Its k and v tiles
//    stay in shared memory while it walks the 64-row q tiles of every q head
//    of its group (causal: from the tile holding its first key down). A
//    producer warpgroup loads each q tile, its d_out tile (TMA, 4-D maps as
//    the forward's) and its 64 lse and delta values (the bulk-copy engine)
//    into a ring of two stages, each guarded by a "full" mbarrier (TMA
//    transaction bytes) and an "empty" one (one arrival per consumer warp).
//    Two consumer warpgroups; dk and dv stay in f32 registers across the
//    walk, so the group's sum needs no atomics.
//    - D = 64, 128: 128 keys a CTA, 64 a consumer, each with all D columns.
//      A consumer takes S^T = K Q^T and dP^T = V dO^T for its keys (wgmma,
//      both operands K-major, 64 keys x 64 q rows), P^T = exp2(S^T scale
//      log2(e) - lse log2(e)) with the mask and dS^T = P^T (dP^T - delta),
//      then dV += P^T dO and dK += dS^T Q with the bf16 P^T and dS^T as
//      register A fragments (dO and Q MN-major): four products a tile.
//    - D = 256: two 64 x 256 f32 accumulators a thread (256 registers)
//      would not fit, so a CTA takes 64 keys and each consumer one pair of
//      products over all of them: consumer 0 S^T = K Q^T, P^T and dV +=
//      P^T dO; consumer 1 dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK
//      += dS^T Q (each 64 keys x 64 q rows, then one 64 x 256 accumulator
//      a thread). Consumer 0 hands its f32 P^T to consumer 1 through
//      shared memory in register order (two buffers, a named-barrier
//      arrive/sync pair each way), so the two run a step apart and one's
//      softmax runs under the other's products: four products a tile,
//      where both consumers taking the whole S^T and dP^T and splitting
//      the columns took six. Its CTAs run in chunks of (kv head,
//      sequence) units, each chunk k tile major (heaviest first), the chunk
//      as many units as have about 4 MB of q and d_out: the units in flight
//      share their q and d_out tiles in L2. (At D <= 128 the CTAs run k
//      tile major over every unit.)
// 3. dq_kernel: one CTA a (128-row q tile, q head, sequence), the forward's
//    shape: q and d_out tiles stay in shared memory while a producer loads
//    the k/v tiles (64 keys; 32 at D = 256, where two stages of 64-key tiles
//    beside the q and d_out tiles would pass 227 KB) into a ring of two
//    stages; each consumer (64 rows) computes S = Q K^T and dP = dO V^T,
//    P and dS as above with its rows' lse and delta, and dQ += dS K (dS as
//    register A fragments, K MN-major). Its CTAs run in chunks of (q head,
//    sequence) units with about 8 MB of k and v, each chunk q tile major
//    (the last, heaviest first). At D = 256 a 64-row CTA over 64-key tiles
//    (the consumers splitting S, dP and dQ's columns as the dk/dv kernel
//    does) and consumer 0 skipping the diagonal block's upper half, which
//    its rows never see, were each timed against this and were slower at
//    gemma-7b's train shape: it stays as it was.
//
// Products per (64-row q tile, 64-key tile) pair: S, dP, dV and dK in the
// dk/dv kernel, S, dP and dQ again in the dq kernel: seven. Every sum runs
// in a fixed order (dq over the key tiles in ascending order), so the
// results are deterministic.
//
// The dq route: dQ = dS K taken in the dk/dv kernel from the same dS^T and
// added into an f32 [B, T, QH, D] workspace by atomics (zeroed by the delta
// pass, cast to bf16 by a fourth) would save the dq kernel's S and dP. It
// was built and timed against this one on the H100 and lost: its adds
// reach the workspace once per tile pair, 302 MB of f32 atomics at
// gemma-7b's train shape, which L2 took longer to absorb than the dq
// kernel takes in all, and at D = 256 the third accumulator set leaves no
// registers to overlap the chain. It also made dq vary from call to call.
//
// What bounds it: at the train shapes (gemma-7b B=8, T=S=512, 16/16 heads,
// D=256; llama-1b B=4, T=S=1024, 32/8 heads, D=64), the bytes (q, k, v,
// out, d_out read once and dq, dk, dv written once at 3.35 TB/s) for gemma,
// the tensor-core operations for llama (8 flops per (q head, dim, attended
// pair) at 989 TFLOP/s). Neither bound is near (the kernels reach 18-30%
// of it): each CTA's chain of products, softmax and waits is, with the k/v
// (dq) or q/d_out (dk/dv) tiles reread from L2 by every CTA of a unit,
// which the chunked orders keep resident. The rounding is the forward's: P
// and dS rounded to bf16 for their products, sums in f32.
//
// Rows and keys past T or S: T and S are multiples of 64. The dk/dv
// kernel's 64-row q tiles never pass T; its 128-key tile at D <= 128 may
// pass S by 64 keys, which TMA zero-fills and the mask gives p = 0, and
// which are not stored. The dq kernel's 128-row tile may pass T by 64 rows:
// zero-filled, lse and delta read as 0, so p = 1 and dS = 0 there, and not
// stored.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;        // producer warpgroup + 2 consumer warpgroups
constexpr int kStages = 2;           // the rings of both kernels
constexpr int kBlockQ = 64;          // q rows of a tile
constexpr int kBlockM = 128;         // q rows of a dq CTA, 64 per consumer
// the bytes a chunk of CTAs rereads (their units' q and d_out in the dk/dv
// kernel, their k and v in the dq kernel): the sizes timed fastest at the
// train shapes
constexpr long long kKVChunkBytes = 4 << 20;
constexpr long long kQChunkBytes = 8 << 20;

// The dkdv kernel's shared memory: the k and v tiles, the q and d_out rings,
// at D = 256 the two f32 P^T hand-off buffers, the lse/delta ring, the
// mbarriers; every tile on a 1024-byte boundary. At D = 256: 224 KB of
// tiles.
template <int D>
struct KVLayout {
  static constexpr bool kSplitProducts = D == 256;         // a consumer per product pair
  static constexpr int kBlockN = kSplitProducts ? 64 : 128;    // keys of the CTA
  static constexpr int kKVBytes = kBlockN * D * 2;
  static constexpr int kQBytes = kBlockQ * D * 2;          // one q (or d_out) stage
  static constexpr int kXBytes = 64 * kBlockQ * 4;         // P^T, 64 x 64 f32
  static constexpr int kStatBytes = 2 * kBlockQ * 4;       // one stage's lse, then delta
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kX = kDO + kStages * kQBytes;
  static constexpr int kStats = kX + (kSplitProducts ? 2 * kXBytes : 0);
  static constexpr int kBars = kStats + kStages * kStatBytes;  // kv_full, full and empty per stage
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// The dq kernel's: the q and d_out tiles, the k and v rings, the mbarriers.
template <int D>
struct QLayout {
  static constexpr int kBlockN = D == 256 ? 32 : 64;       // keys of a ring stage
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;    // q_full, full and empty per stage
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t use(int it) {          // the parity of a stage's it-th use
  return static_cast<uint32_t>((it / kStages) & 1);
}

// The unit and tile of CTA `cta`: chunks of `chunk` units, each chunk's
// CTAs tile major, so that a chunk's units run side by side.
__device__ __forceinline__ void unit_tile(int cta, int units, int tiles, int chunk, int& unit,
                                          int& tile) {
  const int first = cta / (chunk * tiles) * chunk;
  const int in_chunk = min(chunk, units - first);
  const int r = cta - first * tiles;
  tile = r / in_chunk;
  unit = first + r % in_chunk;
}

// -- 1. delta ------------------------------------------------------------------

// delta[b, h, t] = sum_d d_out[b, t, h, d] out[b, t, h, d], in f32: D/8
// threads a row of [B, T, QH] order, 16 bytes of each a thread, summed by
// shuffles inside the row's threads.
template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ d_out,
             float* __restrict__ delta, long long rows, int seq_q, int q_heads) {
  constexpr int kLanes = D / 8;                            // 8, 16 or 32: a warp holds whole rows
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  float sum = 0.f;
  if (row < rows) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * D + part * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(d_out + row * D + part * 8);
    const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(oh[i]);
      const float2 b = __bfloat1622float2(gh[i]);
      sum = fmaf(a.x, b.x, fmaf(a.y, b.y, sum));
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && part == 0) {
    const long long bt = row / q_heads;
    delta[(bt / seq_q * q_heads + row % q_heads) * seq_q + bt % seq_q] = sum;
  }
}

// -- 2. dk and dv --------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
            const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int batch, int seq_q,
            int seq_k, int q_heads, int kv_heads, float scale, float scale_log2, int chunk) {
  using L = KVLayout<D>;
  constexpr int kBlockN = L::kBlockN;
  constexpr int kPanels = D / kPanel;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));         // base, generic
  const uint32_t k_sh = base + L::kK;
  const uint32_t v_sh = base + L::kV;
  const uint32_t kv_full = base + L::kBars;
  auto full = [&](int it) { return kv_full + 8 * (1 + it % kStages); };
  auto empty = [&](int it) { return kv_full + 8 * (1 + kStages + it % kStages); };
  auto q_stage = [&](int it) { return base + L::kQ + (it % kStages) * L::kQBytes; };
  auto do_stage = [&](int it) { return base + L::kDO + (it % kStages) * L::kQBytes; };
  auto stats = [&](int it) { return L::kStats + (it % kStages) * L::kStatBytes; };

  // the unit: k/v tile kt (tile 0 first: a causal tile walks the q tiles
  // from its first key down, so the low tiles are the heaviest), kv head,
  // sequence
  int unit, kt;
  unit_tile(blockIdx.x, kv_heads * batch, (seq_k + kBlockN - 1) / kBlockN, chunk, unit, kt);
  const int kvh = unit % kv_heads;
  const int b = unit / kv_heads;
  const int k0 = kt * kBlockN;
  const int group = q_heads / kv_heads;
  const int q_tiles = seq_q / kBlockQ;
  const int qt0 = kCausal ? min(k0 / kBlockQ, q_tiles) : 0;  // q tiles above see no key here
  const int per_head = q_tiles - qt0;
  const int n_iters = group * per_head;                      // (q head, q tile) pairs
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);                                // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads the k and v tiles once, then keeps the q,
    // d_out and lse/delta ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKVBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(k_sh + p * kBlockN * kRowBytes, &k_map, kv_full, p * kPanel, kvh, k0, b);
        tma_load(v_sh + p * kBlockN * kRowBytes, &v_map, kv_full, p * kPanel, kvh, k0, b);
      }
      for (int it = 0; it < n_iters; ++it) {
        const int h = kvh * group + it / per_head;
        const int q0 = (qt0 + it % per_head) * kBlockQ;
        // a stage is reloaded once the consumers released its last use
        if (it >= kStages) mbar_wait(empty(it), use(it) ^ 1);
        mbar_expect_tx(full(it), 2 * L::kQBytes + L::kStatBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(q_stage(it) + p * kBlockQ * kRowBytes, &q_map, full(it), p * kPanel, h, q0, b);
          tma_load(do_stage(it) + p * kBlockQ * kRowBytes, &do_map, full(it), p * kPanel, h, q0,
                   b);
        }
        const long long row = (static_cast<long long>(b) * q_heads + h) * seq_q + q0;
        bulk_load(base + stats(it), lse + row, kBlockQ * 4, full(it));
        bulk_load(base + stats(it) + kBlockQ * 4, delta + row, kBlockQ * 4, full(it));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  if constexpr (!L::kSplitProducts) {
    // this consumer's 64 keys (rows of its k and v operands), all columns
    const int key_a = k0 + 64 * c + 16 * warp + lane / 4;    // this thread's two keys
    const int key_b = key_a + 8;
    const uint32_t k_rows = k_sh + 64 * c * kRowBytes;
    const uint32_t v_rows = v_sh + 64 * c * kRowBytes;
    float dk_acc[D / 2], dv_acc[D / 2];                      // 64 keys x D
    float st[32], dp[32];           // S^T then P^T, dP^T then dS^T: 64 keys x 64 q rows
    uint32_t pa[4][4], da[4][4];    // P^T and dS^T as bf16 A fragments, 4 k-steps of 16 rows
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int q0 = (qt0 + it % per_head) * kBlockQ;
      const uint32_t qs = q_stage(it);
      const uint32_t dos = do_stage(it);
      mbar_wait(full(it), use(it));
      // S^T = K Q^T and dP^T = V dO^T: D/16 k-steps, 4 per 64-column panel
      fence_operands(st);
      fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk(st, smem_desc(k_rows + (kk / 4) * kBlockN * kRowBytes + col, 16, 1024),
                 smem_desc(qs + (kk / 4) * kBlockQ * kRowBytes + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk(dp, smem_desc(v_rows + (kk / 4) * kBlockN * kRowBytes + col, 16, 1024),
                 smem_desc(dos + (kk / 4) * kBlockQ * kRowBytes + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      const float* s_lse = reinterpret_cast<const float*>(smem + stats(it));
      const float* s_delta = s_lse + kBlockQ;
      // the mask can be true only where the tile crosses the diagonal or S
      const bool edge = (kCausal && k0 + 64 * c + 63 > q0) || k0 + 64 * c + 64 > seq_k;
      wgmma_wait<1>();                                       // S^T done
      fence_operands(st);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);   // q row in the tile
        const int key = (i / 2) % 2 ? key_b : key_a;
        const float p = fast_exp2(fmaf(st[i], scale_log2, -s_lse[col] * kLog2e));
        st[i] = edge && (key >= seq_k || (kCausal && key > q0 + col)) ? 0.f : p;
      }
      wgmma_wait<0>();                                       // dP^T done
      fence_operands(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = st[i] * (dp[i] - s_delta[8 * (i / 4) + 2 * (lane % 4) + (i & 1)]);
      pack_p<4>(st, pa);
      pack_p<4>(dp, da);
      // dV += P^T dO and dK += dS^T Q: 4 k-steps of 16 q rows (2048 bytes);
      // the column panels are the leading byte offset apart
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv(dv_acc, pa[kk], smem_desc(dos + kk * 16 * kRowBytes, kBlockQ * kRowBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv(dk_acc, da[kk], smem_desc(qs + kk * 16 * kRowBytes, kBlockQ * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      fence_operands(pa);
      fence_operands(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(it));                 // this warp is done with the stage
    }

    const long long kv_row = static_cast<long long>(kv_heads) * D;
    const long long at_a = (static_cast<long long>(b) * seq_k + key_a) * kv_row +
                           static_cast<long long>(kvh) * D + 2 * (lane % 4);
    const long long at_b = at_a + 8 * kv_row;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (key_a < seq_k) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at_a + 8 * i) =
            __floats2bfloat162_rn(dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at_a + 8 * i) =
            __floats2bfloat162_rn(dv_acc[4 * i], dv_acc[4 * i + 1]);
      }
      if (key_b < seq_k) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at_b + 8 * i) =
            __floats2bfloat162_rn(dk_acc[4 * i + 2] * scale, dk_acc[4 * i + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at_b + 8 * i) =
            __floats2bfloat162_rn(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
      }
    }
  } else {
    // consumer 0: S^T = K Q^T, P^T, dV += P^T dO; consumer 1: dP^T = V dO^T,
    // dS^T = P^T (dP^T - delta) with consumer 0's f32 P^T, dK += dS^T Q.
    // Each holds one 64 x 256 accumulator over the CTA's 64 keys.
    const int t = threadIdx.x % 128;
    const int key_a = k0 + 16 * warp + lane / 4;             // this thread's two keys
    const int key_b = key_a + 8;
    const uint32_t rows_a = c == 0 ? k_sh : v_sh;             // the score product's operands
    float acc[D / 2];               // dV (consumer 0) or dK (consumer 1): 64 keys x D
    float sc[32];                   // S^T then P^T, or dP^T then dS^T: 64 keys x 64 q rows
    uint32_t fa[4][4];              // P^T or dS^T as bf16 A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int q0 = (qt0 + it % per_head) * kBlockQ;
      const uint32_t qs = q_stage(it);
      const uint32_t dos = do_stage(it);
      const uint32_t rows_b = c == 0 ? qs : dos;
      mbar_wait(full(it), use(it));
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;              // a fresh sum, not carried
      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk / 4) * 64 * kRowBytes + (kk % 4) * 32;
        wgmma_qk(sc, smem_desc(rows_a + col, 16, 1024), smem_desc(rows_b + col, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      const float* s_lse = reinterpret_cast<const float*>(smem + stats(it));
      const float* s_delta = s_lse + kBlockQ;
      // P^T in f32, in register order: thread t's 4j..4j+3 at float4 j*128 + t
      float4* p_buf = reinterpret_cast<float4*>(smem + L::kX + (it % 2) * L::kXBytes) + t;
      if (c == 0) {
        // the mask can be true only where the tile crosses the diagonal
        const bool edge = kCausal && k0 + 63 > q0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);   // q row in the tile
          const int key = (i / 2) % 2 ? key_b : key_a;
          const float p = fast_exp2(fmaf(sc[i], scale_log2, -s_lse[col] * kLog2e));
          sc[i] = edge && key > q0 + col ? 0.f : p;
        }
        // the buffer's last P^T (two tiles back) read by consumer 1
        if (it >= 2) named_barrier(3 + it % 2, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          p_buf[j * 128] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
        named_barrier_arrive(1 + it % 2, 256);               // this tile's P^T is there
      } else {
        named_barrier(1 + it % 2, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 p = p_buf[j * 128];
          const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            sc[i] = pj[e] * (sc[i] - s_delta[8 * (i / 4) + 2 * (lane % 4) + (i & 1)]);
          }
        }
        if (it + 2 < n_iters) named_barrier_arrive(3 + it % 2, 256);   // the buffer is free
      }
      pack_p<4>(sc, fa);
      // dV += P^T dO or dK += dS^T Q: 4 k-steps of 16 q rows, all D columns,
      // the panels the leading byte offset apart
      const uint32_t b_op = c == 0 ? dos : qs;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv(acc, fa[kk], smem_desc(b_op + kk * 16 * kRowBytes, kBlockQ * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(fa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(it));                 // this warp is done with the stage
    }
    __nv_bfloat16* out = c == 0 ? dv : dk;
    const float s_out = c == 0 ? 1.f : scale;
    const long long kv_row = static_cast<long long>(kv_heads) * D;
    const long long at_a = (static_cast<long long>(b) * seq_k + key_a) * kv_row +
                           static_cast<long long>(kvh) * D + 2 * (lane % 4);
    const long long at_b = at_a + 8 * kv_row;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(out + at_a + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i] * s_out, acc[4 * i + 1] * s_out);
      *reinterpret_cast<__nv_bfloat162*>(out + at_b + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2] * s_out, acc[4 * i + 3] * s_out);
    }
  }
}

// -- 3. dq -----------------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
          const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int batch, int seq_q, int seq_k, int q_heads,
          int kv_heads, float scale, float scale_log2, int chunk) {
  using L = QLayout<D>;
  constexpr int kBlockN = L::kBlockN;
  constexpr int kPanels = D / kPanel;
  constexpr int kN = kBlockN / 2;                            // score registers a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_sh = base + L::kQ;
  const uint32_t do_sh = base + L::kDO;
  const uint32_t q_full = base + L::kBars;
  auto full = [&](int j) { return q_full + 8 * (1 + j % kStages); };
  auto empty = [&](int j) { return q_full + 8 * (1 + kStages + j % kStages); };
  auto k_stage = [&](int j) { return base + L::kK + (j % kStages) * L::kKVBytes; };
  auto v_stage = [&](int j) { return base + L::kV + (j % kStages) * L::kKVBytes; };

  // the unit: q tile (the last first: a causal tile walks the keys up to
  // its last row), q head, sequence
  const int q_tiles = (seq_q + kBlockM - 1) / kBlockM;
  int unit, rank;                                            // rank 0: the last q tile
  unit_tile(blockIdx.x, q_heads * batch, q_tiles, chunk, unit, rank);
  const int qt = q_tiles - 1 - rank;
  const int h = unit % q_heads;
  const int b = unit / q_heads;
  const int q0 = qt * kBlockM;
  int n_tiles = seq_k / kBlockN;
  if (kCausal) n_tiles = min(n_tiles, (min(q0 + kBlockM, seq_q) + kBlockN - 1) / kBlockN);
  const int kvh = h / (q_heads / kv_heads);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(q_sh + p * kBlockM * kRowBytes, &q_map, q_full, p * kPanel, h, q0, b);
        tma_load(do_sh + p * kBlockM * kRowBytes, &do_map, q_full, p * kPanel, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= kStages) mbar_wait(empty(j), use(j) ^ 1);
        mbar_expect_tx(full(j), 2 * L::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(k_stage(j) + p * kBlockN * kRowBytes, &k_map, full(j), p * kPanel, kvh,
                   j * kBlockN, b);
          tma_load(v_stage(j) + p * kBlockN * kRowBytes, &v_map, full(j), p * kPanel, kvh,
                   j * kBlockN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int row_min = q0 + 64 * c;
    const int rows[2] = {row_min + 16 * warp + lane / 4, row_min + 16 * warp + lane / 4 + 8};
    const long long stat_row = (static_cast<long long>(b) * q_heads + h) * seq_q;
    float lse2[2], dl[2];                                    // rows past T: 0 (their dS is 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = rows[r] < seq_q ? lse[stat_row + rows[r]] * kLog2e : 0.f;
      dl[r] = rows[r] < seq_q ? delta[stat_row + rows[r]] : 0.f;
    }
    const uint32_t q_rows = q_sh + 64 * c * kRowBytes;      // this half, in each panel
    const uint32_t do_rows = do_sh + 64 * c * kRowBytes;

    float dq_acc[D / 2];            // 64 rows x D
    float s[kN], dp[kN];            // S then P, dP then dS: 64 rows x kBlockN keys
    uint32_t da[kBlockN / 16][4];   // dS as bf16 A fragments
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const uint32_t ks = k_stage(j);
      const uint32_t vs = v_stage(j);
      mbar_wait(full(j), use(j));
      fence_operands(s);
      fence_operands(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk(s, smem_desc(q_rows + (kk / 4) * kBlockM * kRowBytes + col, 16, 1024),
                 smem_desc(ks + (kk / 4) * kBlockN * kRowBytes + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk(dp, smem_desc(do_rows + (kk / 4) * kBlockM * kRowBytes + col, 16, 1024),
                 smem_desc(vs + (kk / 4) * kBlockN * kRowBytes + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      const bool edge = kCausal && j * kBlockN + kBlockN - 1 > row_min;
      wgmma_wait<1>();                                       // S done
      fence_operands(s);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int r = (i / 2) % 2;
        const int key = j * kBlockN + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const float p = fast_exp2(fmaf(s[i], scale_log2, -lse2[r]));
        s[i] = edge && key > rows[r] ? 0.f : p;
      }
      wgmma_wait<0>();                                       // dP done
      fence_operands(dp);
#pragma unroll
      for (int i = 0; i < kN; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
      pack_p<kBlockN / 16>(dp, da);
      // dQ += dS K: kBlockN/16 k-steps of 16 keys; K MN-major, its column
      // panels the leading byte offset apart
      fence_operands(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_pv(dq_acc, da[kk], smem_desc(ks + kk * 16 * kRowBytes, kBlockN * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dq_acc);
      fence_operands(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j));
    }

    const long long q_row = static_cast<long long>(q_heads) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= seq_q) continue;
      __nv_bfloat16* dst = dq + (static_cast<long long>(b) * seq_q + rows[r]) * q_row +
                           static_cast<long long>(h) * D + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
            dq_acc[4 * i + 2 * r] * scale, dq_acc[4 * i + 2 * r + 1] * scale);
    }
  }
}

// -- host side ----------------------------------------------------------------

// Units a chunk of CTAs takes: as many as have about `bytes` of the
// operands their CTAs reread (`unit_bytes` each), at least one, at most all.
int chunk_units(long long bytes, long long unit_bytes, int units) {
  return static_cast<int>(max(1LL, min(static_cast<long long>(units), bytes / unit_bytes)));
}

template <int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* out, const void* d_out,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int seq_q,
           int seq_k, int q_heads, int kv_heads, float scale, int device, cudaStream_t stream) {
  using KV = KVLayout<D>;
  using Q = QLayout<D>;
  // the device's context current on this thread: the tensor-map encoder
  // needs one, and a thread that made no runtime call yet has none (the
  // autograd engine runs a backward on a thread of its own)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool attr_set = false;    // the dynamic shared memory above 48 KB, once
  if (!attr_set) {
    err = cudaFuncSetAttribute(dkdv_kernel<D, kCausal>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, KV::kBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<D, kCausal>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the dkdv kernel's boxes: 64 q rows, the CTA's keys; the dq kernel's:
  // 128 q rows, a ring stage's keys
  CUtensorMap q64, do64, k_kv, v_kv, q128, do128, k_q, v_q;
  if (!encode_map(encode, &q64, q, D, q_heads, seq_q, batch, kBlockQ) ||
      !encode_map(encode, &do64, d_out, D, q_heads, seq_q, batch, kBlockQ) ||
      !encode_map(encode, &k_kv, k, D, kv_heads, seq_k, batch, KV::kBlockN) ||
      !encode_map(encode, &v_kv, v, D, kv_heads, seq_k, batch, KV::kBlockN) ||
      !encode_map(encode, &q128, q, D, q_heads, seq_q, batch, kBlockM) ||
      !encode_map(encode, &do128, d_out, D, q_heads, seq_q, batch, kBlockM) ||
      !encode_map(encode, &k_q, k, D, kv_heads, seq_k, batch, Q::kBlockN) ||
      !encode_map(encode, &v_q, v, D, kv_heads, seq_k, batch, Q::kBlockN))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * kLog2e;
  const long long rows = static_cast<long long>(batch) * seq_q * q_heads;
  delta_kernel<D><<<static_cast<unsigned>((rows * (D / 8) + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(d_out), delta,
      rows, seq_q, q_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_units = kv_heads * batch;
  const int k_tiles = (seq_k + KV::kBlockN - 1) / KV::kBlockN;
  // a unit's CTAs reread its group's q and d_out; at D <= 128 the CTAs go
  // k tile major over every unit
  const int kv_chunk = KV::kSplitProducts
                     ? chunk_units(kKVChunkBytes, 4LL * q_heads / kv_heads * seq_q * D, kv_units)
                     : kv_units;
  dkdv_kernel<D, kCausal><<<static_cast<unsigned>(k_tiles) * kv_units, kThreads, KV::kBytes,
                            stream>>>(
      q64, do64, k_kv, v_kv, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), batch, seq_q, seq_k, q_heads, kv_heads, scale, scale_log2,
      kv_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_units = q_heads * batch;
  // a unit's CTAs reread its kv head's k and v
  const int q_chunk = chunk_units(kQChunkBytes, 4LL * seq_k * D, q_units);
  dq_kernel<D, kCausal><<<static_cast<unsigned>((seq_q + kBlockM - 1) / kBlockM) * q_units,
                          kThreads, Q::kBytes, stream>>>(
      q128, do128, k_q, v_q, lse, delta, static_cast<__nv_bfloat16*>(dq), batch, seq_q, seq_k,
      q_heads, kv_heads, scale, scale_log2, q_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the last launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels have no instance for (or a
// tensor map the driver refuses), cudaErrorNotSupported when the driver has
// no tensor-map encoder. `device` is the CUDA device that holds the
// tensors. The Python wrapper validates shapes, types, contiguity and
// alignment first, and allocates the outputs and `delta`.
extern "C" int tpu9_flash_attention_backward_bf16(const void* q, const void* k, const void* v,
                                                  const void* out, const void* d_out,
                                                  const float* lse, float* delta, void* dq,
                                                  void* dk, void* dv, int batch, int seq_q,
                                                  int seq_k, int q_heads, int kv_heads,
                                                  int head_dim, int causal, float scale,
                                                  int device, void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || seq_q <= 0 || seq_k <= 0 ||
      seq_q % 64 != 0 || seq_k % 64 != 0 ||
      static_cast<long long>((seq_q + kBlockM - 1) / kBlockM) * q_heads * batch > INT_MAX / 2 ||
      static_cast<long long>((seq_k + 63) / 64) * kv_heads * batch > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPU9_CASE(D, C)                                                                        \
  if (head_dim == D && (causal != 0) == C)                                                     \
    return launch<D, C>(q, k, v, out, d_out, lse, delta, dq, dk, dv, batch, seq_q, seq_k,      \
                        q_heads, kv_heads, scale, device, s);
  TPU9_CASE(64, true) TPU9_CASE(64, false) TPU9_CASE(128, true) TPU9_CASE(128, false)
  TPU9_CASE(256, true) TPU9_CASE(256, false)
#undef TPU9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
