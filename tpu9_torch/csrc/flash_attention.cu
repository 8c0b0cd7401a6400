// Flash attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the TPU kernel flash_attention of tpu9/ops/attention.py
// (_flash_kernel). It computes the same function: blocked online-softmax
// attention of q over k/v, with GQA, causal (mask k_pos > q_pos, no offset;
// tiles above the diagonal skipped) or not.
//
//   q    [B, T, QH, D]   bf16, T a multiple of 64
//   k/v  [B, S, KH, D]   bf16, S a multiple of 64, KH divides QH
//   out  [B, T, QH, D]   bf16
//
// All three are read in their own layout: no transposed copy is made.
// Query head h reads kv head h / (QH/KH).
//
// What bounds it: at the dense engine's prefill buckets (T = S = 128, 512,
// 2048; QH 32, KH 8, D 128 for llama3-8b; QH 16, KH 16, D 256 for
// gemma-7b) the tensor-core operations from T = 2048 on (4*D*QH*T(T+1)/2
// flops at 989 TFLOP/s against q, k, v and out once at 3.35 TB/s), the
// bytes below that. The design is FlashAttention-3's shape:
//
// - A unit of work is one (128-row q tile, q head, sequence): its CTA walks
//   the k/v tiles of kBlockN keys (128; 64 at D = 256, below) in a loop,
//   with the running max, sum and output in registers. CUDA blocks run in
//   no order, so the loop takes the place of the TPU kernel's sequential k
//   grid axis and its VMEM scratch.
// - The grid is persistent: one CTA an SM, each taking its units from the
//   heaviest-first order in rounds (one place a round, from the other end
//   in odd rounds, so that short causal units even out long ones). The
//   producer loads the next unit's q tile and first k/v tiles while the
//   consumers finish this one: 0.0805-0.0809 -> 0.0754 ms at causal
//   T=2048, D=128, D=64 0.0573 -> 0.0537-0.0541.
// - Both products are wgmma, the only path to the tensor cores' full rate
//   on this card (mma.sync is not). S = Q K^T is m64n128k16 with both
//   operands in shared memory (K stored [keys, D] is the K-major B
//   operand); O += P V takes P from registers, where the f32 score fragment
//   converts to the bf16 A fragment in place, and V stored [keys, D] as the
//   MN-major ("transposed") B operand.
// - Shared-memory reads: a warpgroup's four warps read each k and v tile
//   once, together, where the mma.sync design had every warp ldmatrix the
//   whole tile for its own 16 rows.
// - Loads: warpgroup 0 is a producer that gives its registers up
//   (setmaxnreg.dec) while one of its threads issues TMA loads: the q tile
//   once, then k and v tiles into rings of 2 stages, each stage guarded by
//   a "full" mbarrier (TMA transaction bytes) and an "empty" one (one
//   arrival per consumer warp once its product has read the stage). No
//   consumer thread spends an instruction or a register on a load.
// - Overlap: warpgroups 1 and 2 are the consumers (setmaxnreg.inc), 64 q
//   rows each. Each issues Q K_j^T and P_{j-1} V_{j-1} together, with the
//   output's rescale between the two (FlashAttention-3's order), and the
//   two consumers take turns to issue (named barriers), so that one's
//   softmax runs under the other's products. The turns: 0.0816 -> 0.0805
//   ms at causal T=2048, D=128, and 0.0841 -> 0.0811 in another call. The
//   rescale's place: D=64 0.0587 -> 0.0572, D=128 level. Issuing the two
//   products together was timed only before the softmax below, level with
//   issuing them apart; the later levers were built and timed on it. Inside
//   one warpgroup the softmax does not overlap its own P V: ptxas puts the
//   wait for that product above the softmax (forcing the order behind a
//   branch made it serialise every product for registers).
// - The softmax: row maxima of the raw scores, the scale and log2(e)
//   folded into one FMA per score, exp2 on the MUFU unit (ex2.approx.ftz),
//   masks in their own pass on the tiles that cross the diagonal or S:
//   0.1098 -> 0.0818 ms (the MUFU exp2 alone: 0.1042).
// - Tiles land 128-byte swizzled: a D=128 row is 256 bytes, so each tile
//   is D/64 panels of [rows][64] bf16, one TMA box each, and the wgmma
//   descriptors step through the panels (K-major: 32 bytes a k-step inside
//   a panel; MN-major: the panel stride is the leading byte offset).
// - D = 256 (gemma) keeps the two 64-row consumer warpgroups and halves
//   the k/v tile to 64 keys. With 128-key tiles the q tile (64 KB) and two
//   stages of k and v (4 x 64 KB) would need 320 KB of the SM's 227; with
//   64-key tiles they take 64 + 4 x 32 = 192 KB. A consumer thread then
//   holds the 64 x 256 f32 output (128 registers), a 64 x 64 score tile
//   (32, from an m64n64k16 Q K^T) and its bf16 P fragment (16): 176, about
//   D=128's 64 + 64 + 32 = 160, inside the 240 that setmaxnreg gives it,
//   so no instance needs one consumer of 64 rows. O += P V is one m64n256k16
//   product a 16-key step (N = 256, the largest wgmma N), over 4 panels of
//   v. A 128-row q tile spans two 64-key tiles, so a causal unit walks
//   2(qt + 1) of them, and consumer 0's last one is wholly masked (its
//   probabilities are 0).
// - The tensor maps are 4-D, (D, heads, sequence, batch), so the rows of a
//   tile past T or S are zero-filled by TMA and never come from the next
//   sequence; keys past S are masked to -inf explicitly (a zero key scores
//   0), and q rows past T are not stored.
// - The probabilities are rounded to bf16 for the PV product, the row sums
//   stay f32. Each p then carries a relative error of at most 2^-9.
// - Causal: a q tile stops at the diagonal tile, and only that tile is
//   masked. In the order of the units the q tiles come heaviest first, and
//   the q heads of one kv head are neighbours, so that their k/v tiles are
//   read from L2.
//
// Times: device alone on one H100 80GB HBM3 at 700 W, chip_smoke.time_ms
// as scripts/decode_kernel_times.py --flash uses it, each variant built
// from a copy of this package (PERF.md section 6). At D = 256 the causal
// T = 2048 prefill takes 0.077 ms at gemma-7b's heads (SDPA 0.099); the
// shorter buckets, and gemma-2b's one kv head, trail SDPA by 3-12%.

#include <cuda.h>   // CUtensorMap and its encoder's types; the encoder itself
                    // comes through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;         // q rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;           // k/v ring
constexpr int kThreads = 384;        // producer warpgroup + 2 consumer warpgroups
constexpr int kPanel = 64;           // bf16 columns of one 128-byte swizzled panel
constexpr int kRowBytes = 128;       // bytes of one panel row
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  // keys per k/v tile: 64 at D = 256, where 128-key tiles would not fit
  // (see the note at the top)
  static constexpr int kBlockN = D == 256 ? 64 : 128;
  // shared memory: the q tile, then the k and v rings, then the mbarriers;
  // every tile starts on a 1024-byte boundary (one 128-byte swizzle atom is
  // 8 rows of 128 bytes)
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;      // one k (or v) stage
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes; // q full/empty, full/empty per k and v stage
  static constexpr int kBytes = kBars + 8 * (2 + 4 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// returns once at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (the asm statements above do not name them).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor for a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

#define TPU9_F8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TPU9_F32(d, i) TPU9_F8(d, i), TPU9_F8(d, i + 8), TPU9_F8(d, i + 16), TPU9_F8(d, i + 24)

#define TPU9_R32                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TPU9_R64                                                                       \
  TPU9_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "  \
           "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
           "%61, %62, %63"
#define TPU9_R128                                                                      \
  TPU9_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "   \
           "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
           "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "     \
           "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "    \
           "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define TPU9_F128(d, i) TPU9_F32(d, i), TPU9_F32(d, i + 32), TPU9_F32(d, i + 64), TPU9_F32(d, i + 96)

// d (64 x 128, f32) = a (64 x 16) b (16 x 128) [+ d]: both operands K-major
// in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TPU9_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TPU9_F32(d, 0), TPU9_F32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) = a (64 x 16) b (16 x 64) [+ d]: the 64-key tiles of D = 256
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TPU9_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TPU9_F32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += a (64 x 16, bf16 registers) b (16 x N): b MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" TPU9_R128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : TPU9_F128(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TPU9_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TPU9_F32(d, 0), TPU9_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TPU9_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TPU9_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x (MUFU.EX2; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// -- the kernel ---------------------------------------------------------------

// One consumer's 64 q rows: the running max and sum of its two rows (m, l;
// l is this thread's part), and the rows and tile edge it masks against.
struct Rows {
  float m[2];
  float l[2];
  int row_min, row_a, row_b, lane;
};

// The online softmax of one 64 x kBlockN score tile in place: mask where
// the tile crosses the diagonal or S, new row maxima (of the raw scores),
// the factor `alpha` for the output so far, p = 2^(x * scale * log2(e) -
// max * scale * log2(e)) in `sc` (f32; the scale folded into one FMA), and
// the running sums.
template <bool kCausal, int kBlockN>
__device__ __forceinline__ void online_softmax(float (&sc)[kBlockN / 2], Rows& r,
                                               float (&alpha)[2], int j, int seq_k,
                                               float scale_log2) {
  constexpr int kN = kBlockN / 2;
  if ((kCausal && j * kBlockN + kBlockN - 1 > r.row_min) || (j + 1) * kBlockN > seq_k) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int col = j * kBlockN + (i / 4) * 8 + (r.lane % 4) * 2 + (i & 1);
      if (col >= seq_k || (kCausal && col > ((i / 2) % 2 ? r.row_b : r.row_a))) sc[i] = kNegInf;
    }
  }
  float mx[2] = {r.m[0], r.m[1]};
#pragma unroll
  for (int i = 0; i < kN; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = fast_exp2((r.m[i] - mx[i]) * scale_log2);
    r.m[i] = mx[i];
    ms[i] = mx[i] * scale_log2;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -ms[(i / 2) % 2]));
    rs[(i / 2) % 2] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) r.l[i] = r.l[i] * alpha[i] + rs[i];
}

// P in the A fragment of each 16-key step kk: score chunks 2kk and 2kk + 1
// rounded to bf16, in the accumulator's own register order
template <int kSteps>
__device__ __forceinline__ void pack_p(const float (&sc)[8 * kSteps], uint32_t (&pa)[kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i / 2) % 2];
}

// One unit of work: the (128-row q tile, q head, sequence) at place `idx`
// of the heaviest-first order (q tiles from the last, then sequences, then
// q heads, so that the q heads of one kv head are neighbours), and the
// number of k/v tiles it walks.
struct Work {
  int h, b, q0, n_tiles;
};

template <bool kCausal, int kBlockN>
__device__ __forceinline__ Work work_at(int idx, int q_tiles, int q_heads, int batch, int seq_k) {
  const int per_tile = q_heads * batch;
  const int qt = q_tiles - 1 - idx / per_tile;
  Work w;
  w.h = idx % q_heads;
  w.b = (idx % per_tile) / q_heads;
  w.q0 = qt * kBlockM;
  w.n_tiles = (seq_k + kBlockN - 1) / kBlockN;
  // tiles past the diagonal see nothing
  if (kCausal) w.n_tiles = min(w.n_tiles, (qt + 1) * (kBlockM / kBlockN));
  return w;
}

// The persistent grid's order: CTA i takes place i of every round of
// gridDim.x places, counted from the other end in odd rounds, so that the
// short causal tiles of the last rounds even out the long ones of the first.
__device__ __forceinline__ int place(int round) {
  return round * gridDim.x + (round % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
             int batch, int seq_q, int seq_k, int q_heads, int kv_heads, float scale_log2) {
  using L = Layout<D>;
  constexpr int kBlockN = L::kBlockN;
  constexpr int kPanels = D / kPanel;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_sh = base;
  const uint32_t k_sh = base + L::kK;
  const uint32_t v_sh = base + L::kV;
  // mbarriers: q_full, q_empty, then full and empty for each k stage and v
  // stage; k/v tiles are counted over the CTA's whole life (`it`)
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  auto full_k = [&](int it) { return q_full + 8 * (2 + it % kStages); };
  auto full_v = [&](int it) { return q_full + 8 * (2 + kStages + it % kStages); };
  auto empty_k = [&](int it) { return q_full + 8 * (2 + 2 * kStages + it % kStages); };
  auto empty_v = [&](int it) { return q_full + 8 * (2 + 3 * kStages + it % kStages); };
  // the parity of k/v tile it's use of its stage
  auto use = [](int it) { return static_cast<uint32_t>((it / kStages) & 1); };

  const int q_tiles = (seq_q + kBlockM - 1) / kBlockM;
  const int n_work = q_tiles * q_heads * batch;
  const int group = q_heads / kv_heads;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);                                  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the q tile and both rings full, running
    // ahead into the CTA's next unit of work
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int round = 0; place(round) < n_work; ++round) {
        const Work w = work_at<kCausal, kBlockN>(place(round), q_tiles, q_heads, batch, seq_k);
        // the consumers are done with the last unit's q tile
        if (round > 0) mbar_wait(q_empty, (round - 1) & 1);
        mbar_expect_tx(q_full, L::kQBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(q_sh + p * kBlockM * kRowBytes, &q_map, q_full, p * kPanel, w.h, w.q0, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++it) {
          const uint32_t off = (it % kStages) * L::kKVBytes;
          // each stage is reloaded once the consumers released its previous
          // tile, it - kStages
          if (it >= kStages) mbar_wait(empty_k(it), use(it) ^ 1);
          mbar_expect_tx(full_k(it), L::kKVBytes);
          for (int p = 0; p < kPanels; ++p)
            tma_load(k_sh + off + p * kBlockN * kRowBytes, &k_map, full_k(it), p * kPanel,
                     w.h / group, j * kBlockN, w.b);
          if (it >= kStages) mbar_wait(empty_v(it), use(it) ^ 1);
          mbar_expect_tx(full_v(it), L::kKVBytes);
          for (int p = 0; p < kPanels; ++p)
            tma_load(v_sh + off + p * kBlockN * kRowBytes, &v_map, full_v(it), p * kPanel,
                     w.h / group, j * kBlockN, w.b);
        }
      }
    }
  } else {
    // consumers: warpgroup c = wg - 1 owns q rows [q0 + 64c, q0 + 64c + 64)
    // of each unit of work
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const uint32_t q_rows = q_sh + 64 * c * kRowBytes;      // this half, in each q panel
    Rows r;
    r.lane = threadIdx.x % 32;

    float o[D / 2];                 // 64 x D accumulator: chunk i of 8 columns in o[4i .. 4i+3]
    float sc[kBlockN / 2];          // 64 x kBlockN scores, then probabilities, the same layout
    uint32_t pa[kBlockN / 16][4];   // the probabilities of the tile before, in bf16
    float alpha[2];                 // its factor for the output so far
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;

    // S = Q K^T for k/v tile it: D/16 k-steps, 4 per 64-column panel, 32
    // bytes apart
    auto qk = [&](int it) {
      const uint32_t ks = k_sh + (it % kStages) * L::kKVBytes;
      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk(sc, smem_desc(q_rows + (kk / 4) * kBlockM * kRowBytes + col, 16, 1024),
                 smem_desc(ks + (kk / 4) * kBlockN * kRowBytes + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O = O * alpha + P V for k/v tile it: kBlockN/16 key steps of 16 rows
    // (2048 bytes) each; the D panels are the leading byte offset apart
    auto pv = [&](int it) {
      const uint32_t vs = v_sh + (it % kStages) * L::kKVBytes;
      rescale(o, alpha);
      mbar_wait(full_v(it), use(it));
      fence_operands(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_pv(o, pa[kk], smem_desc(vs + kk * 16 * kRowBytes, kBlockN * kRowBytes, 1024));
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {                      // this warp is done with a stage
      __syncwarp();
      if (r.lane == 0) mbar_arrive(bar);
    };
    // The two consumers take turns to issue their products (named barriers
    // 1 and 2, 256 threads: one warpgroup waits, the other arrives), so that
    // one's softmax runs under the other's products.
    auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory"); };
    auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory"); };

    if (c == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // consumer 0 goes first
    int it = 0;
    for (int round = 0; place(round) < n_work; ++round) {
      const Work w = work_at<kCausal, kBlockN>(place(round), q_tiles, q_heads, batch, seq_k);
      r.row_min = w.q0 + 64 * c;
      // this thread's two query rows: g and g + 8 of its warp's 16
      r.row_a = r.row_min + 16 * warp + r.lane / 4;
      r.row_b = r.row_a + 8;
      r.m[0] = r.m[1] = kNegInf;
      r.l[0] = r.l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

      mbar_wait(q_full, round & 1);
      mbar_wait(full_k(it), use(it));
      my_turn();
      qk(it);
      your_turn();
      wgmma_wait<0>();
      fence_operands(sc);
      release(empty_k(it));
      if (w.n_tiles == 1) release(q_empty);
      online_softmax<kCausal, kBlockN>(sc, r, alpha, 0, seq_k, scale_log2);
      pack_p(sc, pa);
      // Tile j: Q K_j^T and P_{j-1} V_{j-1} are issued together (the
      // output's rescale between them, where no product holds the output),
      // then the softmax of tile j, then the bf16 P_j once P_{j-1} V_{j-1}
      // is done.
      for (int j = 1; j < w.n_tiles; ++j) {
        mbar_wait(full_k(it + j), use(it + j));
        my_turn();
        qk(it + j);
        pv(it + j - 1);
        your_turn();
        wgmma_wait<1>();                                    // Q K_j^T done
        fence_operands(sc);
        release(empty_k(it + j));
        if (j == w.n_tiles - 1) release(q_empty);           // the q tile is free for the next unit
        online_softmax<kCausal, kBlockN>(sc, r, alpha, j, seq_k, scale_log2);
        wgmma_wait<0>();                                    // P_{j-1} V_{j-1} done
        fence_operands(o);
        release(empty_v(it + j - 1));
        pack_p(sc, pa);
      }
      it += w.n_tiles;
      my_turn();
      pv(it - 1);
      // consumer 1 has no turn after its last unit's last product
      if (c == 0 || place(round + 1) < n_work) your_turn();
      wgmma_wait<0>();
      fence_operands(o);
      release(empty_v(it - 1));

      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float l = r.l[i] + __shfl_xor_sync(0xffffffffu, r.l[i], 1);
        inv[i] = 1.f / fmaxf(l + __shfl_xor_sync(0xffffffffu, l, 2), 1e-30f);
      }
      const int64_t q_row = static_cast<int64_t>(q_heads) * D;
      __nv_bfloat16* out_a = out + (static_cast<int64_t>(w.b) * seq_q + r.row_a) * q_row +
                             static_cast<int64_t>(w.h) * D;
      __nv_bfloat16* out_b = out_a + 8 * q_row;
      const int col0 = (r.lane % 4) * 2;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        if (r.row_a < seq_q)
          *reinterpret_cast<__nv_bfloat162*>(out_a + 8 * i + col0) =
              __floats2bfloat162_rn(o[4 * i] * inv[0], o[4 * i + 1] * inv[0]);
        if (r.row_b < seq_q)
          *reinterpret_cast<__nv_bfloat162*>(out_b + 8 * i + col0) =
              __floats2bfloat162_rn(o[4 * i + 2] * inv[1], o[4 * i + 3] * inv[1]);
      }
    }
  }
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [batch, seq, heads, D] bf16 tensor as the 4-D map (D, heads, seq,
// batch) with boxes of 64 columns x `rows` rows of one head: rows past
// `seq` are zero-filled inside the box, never read from the next sequence.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d, int heads, int seq,
                int batch, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(seq) * heads * d * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int seq_q,
           int seq_k, int q_heads, int kv_heads, float scale, cudaStream_t stream) {
  constexpr int kSmem = Layout<D>::kBytes;
  static bool attr_set = false;    // the dynamic shared memory above 48 KB, once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D, kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(encode, &q_map, q, D, q_heads, seq_q, batch, kBlockM) ||
      !encode_map(encode, &k_map, k, D, kv_heads, seq_k, batch, Layout<D>::kBlockN) ||
      !encode_map(encode, &v_map, v, D, kv_heads, seq_k, batch, Layout<D>::kBlockN))
    return static_cast<int>(cudaErrorInvalidValue);
  // a persistent grid: one CTA per SM at most, each walking its units of
  // work (the next unit's loads overlap this one's last products)
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_work =
      static_cast<long long>((seq_q + kBlockM - 1) / kBlockM) * q_heads * batch;
  const int grid = static_cast<int>(n_work < sms ? n_work : sms);
  flash_kernel<D, kCausal><<<grid, kThreads, kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), batch, seq_q, seq_k, q_heads,
      kv_heads, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel has no instance for (or a
// tensor map the driver refuses), cudaErrorNotSupported when the driver
// has no tensor-map encoder. The Python wrapper validates shapes, types,
// contiguity and alignment first.
extern "C" int tpu9_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         int batch, int seq_q, int seq_k, int q_heads,
                                         int kv_heads, int head_dim, int causal, float scale,
                                         void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || seq_q <= 0 || seq_k <= 0 ||
      seq_q % 64 != 0 || seq_k % 64 != 0 ||
      static_cast<long long>((seq_q + kBlockM - 1) / kBlockM) * q_heads * batch > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPU9_CASE(D, C)                                                                   \
  if (head_dim == D && (causal != 0) == C)                                                \
    return launch<D, C>(q, k, v, out, batch, seq_q, seq_k, q_heads, kv_heads, scale, s);
  TPU9_CASE(64, true) TPU9_CASE(64, false) TPU9_CASE(128, true) TPU9_CASE(128, false)
  TPU9_CASE(256, true) TPU9_CASE(256, false)
#undef TPU9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
