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
//   lse  [B, QH, T]      f32, optional (null: not written): each row's
//                        natural-log log-sum-exp of its scaled, masked
//                        scores, (m + log2 l) ln 2 with the base-2 max m and
//                        the sum l that normalise the row; the backward
//                        (flash_attention_backward.cu) recomputes the
//                        probabilities from it
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
// - The grid is persistent: one CTA an SM, each taking its units in rounds
//   (`work_at`; at D <= 128 heaviest first, one place a round, from the
//   other end in odd rounds, so that short causal units even out long
//   ones). The producer loads the next unit's q tile and first k/v tiles
//   while the consumers finish this one: 0.0805-0.0809 -> 0.0754 ms at
//   causal T=2048, D=128, D=64 0.0573 -> 0.0537-0.0541.
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
//   (32, from an m64n64k16 Q K^T) and its bf16 P fragment (16): 176, inside
//   the 240 that setmaxnreg gives it. O += P V is one m64n256k16 product a
//   16-key step (N = 256, the largest wgmma N), over 4 panels of v. Its
//   own design, each lever timed against the one before in turns in one
//   call (scripts/decode_kernel_times.py --flash on a variant tree; device
//   alone, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6):
//   - Unit order for L2 (`work_at`). Each round takes gridDim.x / q_tiles
//     units, a unit's q tiles on neighbouring CTAs (heaviest first on the
//     first CTA in even rounds, on the last in odd ones, so that two rounds
//     weigh the same everywhere): the CTAs in flight share the fewest k/v
//     sets, read from L2. The heaviest-first order over all units read the
//     67 MB of k/v at gemma-7b's train shape (B=8, T=S=512, 16/16) again
//     in every q-tile round. Forward with lse there: 0.1100 -> 0.0725;
//     pairs of a unit's heaviest and lightest tile on one CTA, each round
//     covering twice the units, gave 0.0835-0.0852; T = 2048 0.0768 ->
//     0.0761 (pairs 0.0788-0.0796).
//   - Consumer 0 of a causal unit skips its last 64-key tile, wholly above
//     its rows (a uniform loop bound, not an `if` around a wgmma; it takes
//     an empty turn and releases the tile once it landed). No bit changes:
//     those probabilities were 0 and their factor 1. Not timed alone.
//   - The output stores. A quad's 4 x 4 transpose of bf16 pairs
//     (`store_group`), 16 bytes a thread, in place of a bf16 pair a store:
//     the train shape 0.0677 (against the parent, D = 128 2048
//     0.0754-0.0757 -> 0.0729; D = 64 slower, 0.0533-0.0538 ->
//     0.0552-0.0555, so it keeps a bf16 pair a store). Then each
//     consumer's bf16 output through a 64 x 128 half-tile of shared memory
//     (32 KB of the 35 left) and TMA stores (128-row units at D = 256):
//     0.0615-0.0616.
//   - Short buckets (kSplit): where 128-row units would leave SMs idle and
//     64-row units fill at most one wave, or one round of long causal rows
//     (8 q tiles or more) would wait for its heaviest unit, a unit is 64
//     rows and its two consumers split the key tiles (even, odd; a ring of
//     3 stages, each used by one consumer). Each puts its output and row
//     max and sum into its last tile's stages, and each merges and stores
//     half of the columns: o = (o_0 2^(m_0 - m) + o_1 2^(m_1 - m)) / (l_0
//     2^(m_0 - m) + l_1 2^(m_1 - m)). gemma-7b causal 128 0.0157 -> 0.0130,
//     gemma-2b causal 2048 0.0595 -> 0.0494. At the tp=4 rank's train shape
//     (128 units of 4 q tiles) 128-row units were faster (0.0300 against
//     0.0327), hence the rule (the wrapper's `flash_split_keys`, passed
//     in as `split`).
//   - Registers: q_tiles and the GQA group are parameters, and a unit's
//     fields and a thread's rows are recomputed from fresh reads of
//     %ctaid.x and %tid.x after the main loop: values computed before it
//     and held across it (or across setmaxnreg) spilled.
//   - Not built: rescaling O only when a row's max rises (on these random
//     rows a warp's 16 maxima rise in most 64-key tiles), and 80-key tiles.
// - The tensor maps are 4-D, (D, heads, sequence, batch), so the rows of a
//   tile past T or S are zero-filled by TMA and never come from the next
//   sequence; keys past S are masked to -inf explicitly (a zero key scores
//   0), and q rows past T are not stored.
// - The probabilities are rounded to bf16 for the PV product, the row sums
//   stay f32. Each p then carries a relative error of at most 2^-9.
// - Causal: a q tile stops at the diagonal tile, and only that tile is
//   masked. The q heads of one kv head are neighbours in every order, so
//   that their k/v tiles are read from L2.
//
// Times: device alone on one NVIDIA H100 80GB HBM3 at 700.00 W,
// chip_smoke.time_ms as scripts/decode_kernel_times.py --flash uses it,
// each variant built from a copy of this package (PERF.md section 6, in
// turns with the one before). D = 256, B = 1: gemma-7b causal 128 0.0135
// (SDPA 0.0144-0.0146), 512 0.0225 (0.0239-0.0242), 2048 0.0687-0.0690
// (0.0976-0.0988), non-causal 512 0.0226-0.0227 (0.0236-0.0244); gemma-2b
// 0.0125, 0.0189-0.0191, 0.0487-0.0491 (0.0577-0.0581), 0.0188. The
// gemma-7b train shape with lse 0.0615-0.0616 (SDPA 0.0669-0.0671), its
// tp=4 rank 0.0276 (0.0286-0.0288).

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;         // q rows of a unit, 64 per consumer warpgroup
constexpr int kThreads = 384;        // producer warpgroup + 2 consumer warpgroups

// kSplit (D = 256 only, when 128-row units would leave SMs idle): a unit is
// 64 q rows, and the two consumers split its k/v tiles (even and odd)
// between them, merged through shared memory at the end.
template <int D, bool kSplit>
struct Layout {
  static constexpr int kRows = kSplit ? 64 : kBlockM;       // q rows of a unit
  // keys per k/v tile: 64 at D = 256, where 128-key tiles would not fit
  // (see the note at the top)
  static constexpr int kBlockN = D == 256 ? 64 : 128;
  static constexpr int kStages = kSplit ? 3 : 2;            // k/v ring
  // shared memory: the q tile, then the k and v rings, then the consumers'
  // output half-tiles (kStaged) or their rows' max and sum (kSplit), then
  // the mbarriers; every tile starts on a 1024-byte boundary (one 128-byte
  // swizzle atom is 8 rows of 128 bytes)
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;          // one k (or v) stage
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  // D = 256, 128-row units: each consumer's bf16 output goes out through a
  // half-tile (64 rows x 128 columns) of its own and TMA stores
  static constexpr bool kStaged = D == 256 && !kSplit;
  static constexpr int kHalfBytes = 64 * 128 * 2;
  // the half-tiles (kStaged), or a float2 a row a consumer (kSplit)
  static constexpr int kO = kV + kStages * kKVBytes;
  static constexpr int kBars =                              // q full/empty, full/empty per k and v stage
      kO + (kStaged ? 2 * kHalfBytes : 0) + (kSplit ? 2 * 64 * 8 : 0);
  static constexpr int kBytes = kBars + 8 * (2 + 4 * kStages) + 1024;  // + alignment slack
};
static_assert(Layout<256, true>::kBytes <= 232448 && Layout<256, false>::kBytes <= 232448 &&
                  Layout<128, false>::kBytes <= 232448,
              "a CTA's shared memory passes the 227 KB an SM gives it");

// -- the kernel ---------------------------------------------------------------

// One consumer's 64 q rows: the running max and sum of its two rows (m, l;
// l is this thread's part), the first of the 64 and the thread's lane.
struct Rows {
  float m[2];
  float l[2];
  int row_min, lane;
};

// threadIdx.x read afresh (volatile): the rows derived from it are
// recomputed where they are used, not held in registers across the main
// loop (where the 64 x 256 output takes 128 of them)
__device__ __forceinline__ int tid() {
  int x;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(x));
  return x;
}

// this thread's first query row of a consumer's 64 from row_min: row g of
// its warp's 16 (its other row is g + 8)
__device__ __forceinline__ int row_of(int row_min) {
  const int t = tid();
  return row_min + 16 * ((t / 32) % 4) + (t % 32) / 4;
}

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
    const int row_a = row_of(r.row_min);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int col = j * kBlockN + (i / 4) * 8 + (r.lane % 4) * 2 + (i & 1);
      if (col >= seq_k || (kCausal && col > row_a + 8 * ((i / 2) % 2))) sc[i] = kNegInf;
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

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i / 2) % 2];
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}

__device__ __forceinline__ void ld_shared_v4(uint32_t addr, float& a, float& b, float& c,
                                             float& d) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(a), "=f"(b), "=f"(c), "=f"(d)
               : "r"(addr)
               : "memory");
}

// -- TMA stores: a box of shared memory to a 4-D tensor map, in a bulk group

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// returns once this thread's committed bulk stores have read their shared
// memory (`read`), or are done
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// a[i] for a lane-dependent i in 0..3, by selects (no local memory)
__device__ __forceinline__ uint32_t pick(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// One row's chunks of 8 columns 4m .. 4m + 3 (a chunk = 16 bytes of bf16),
// this thread's bf16 pair of each in u, to `dst` (the row's first column),
// if `keep`. A thread holds 2 columns of each 8; a 4 x 4 transpose of
// 32-bit words inside its quad (lane t takes, from lane t ^ d, its word of
// chunk 4m + t) gives it 8 consecutive columns, one 16-byte store, so that
// a warp's store fills whole 32-byte sectors: a quarter of the store
// instructions of one bf16 pair each, and no half-written sectors.
__device__ __forceinline__ void store_group(const uint32_t (&u)[4], __nv_bfloat16* dst, int m,
                                            int t, bool keep) {
  uint32_t v[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const uint32_t x = pick(u, t ^ d);
    v[d] = d ? __shfl_xor_sync(0xffffffffu, x, d) : x;      // lane t ^ d's columns of chunk 4m + t
  }
  const uint4 cols = make_uint4(pick(v, t), pick(v, t ^ 1), pick(v, t ^ 2), pick(v, t ^ 3));
  if (keep) *reinterpret_cast<uint4*>(dst + 8 * (4 * m + t)) = cols;
}

// One row of a consumer's 64 x D f32 output (`e`: 0 its row g, 2 its row g
// + 8), times `inv`, in bf16 to `dst`, if `keep` (`store_group`).
template <int D>
__device__ __forceinline__ void store_row(const float (&o)[D / 2], int e, float inv,
                                          __nv_bfloat16* dst, int t, bool keep) {
#pragma unroll
  for (int m = 0; m < D / 32; ++m) {
    uint32_t u[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      u[s] = pack_bf16(o[4 * (4 * m + s) + e] * inv, o[4 * (4 * m + s) + e + 1] * inv);
    store_group(u, dst, m, t, keep);
  }
}

// One unit of work: q rows [q0, q0 + kRows) of q head h of sequence b, and
// the number of k/v tiles it walks (the producer loads them all).
struct Work {
  int h, b, q0, n_tiles;
};

// blockIdx.x read afresh (volatile): what the D = 256 orders derive from
// it is recomputed where it is used, not held in a register (or spilled)
// across the main loop
__device__ __forceinline__ int cta() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  return x;
}

// The persistent grid's order at D <= 128: CTA i takes place i of every
// round of gridDim.x places, counted from the other end in odd rounds, so
// that the short causal tiles of the last rounds even out the long ones of
// the first.
__device__ __forceinline__ int place(int round) {
  return round * gridDim.x + (round % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// The CTA's k-th unit of work into w; false when it has no more. Units are (q tile, q head, sequence); `q_tiles`
// counts the q tiles of kRows rows. The orders:
// - kSplit: one unit a CTA, heaviest first (the last q tile first).
// - D = 256: rounds of units by (sequence, q head), the q heads of one kv
//   head neighbours; in a round each unit's q tiles run side by side on
//   q_tiles neighbouring CTAs, the heaviest first on the first CTA in even
//   rounds and on the last in odd ones, so that two rounds weigh the same
//   on every CTA, and the units in flight, whose k/v L2 holds, are the
//   fewest: gridDim.x / q_tiles.
// - D <= 128 (and D = 256 beyond gridDim.x q tiles): the heaviest-first
//   order of `place`, q tiles from the last, then sequences, then q heads.
template <int D, bool kCausal, bool kSplit>
__device__ __forceinline__ bool work_at(int k, int q_tiles, int q_heads, int batch, int seq_k,
                                        Work& w) {
  using L = Layout<D, kSplit>;
  const int per_tile = q_heads * batch;
  int qt, unit;
  if constexpr (kSplit) {
    if (k > 0) return false;
    qt = q_tiles - 1 - cta() / per_tile;
    unit = cta() % per_tile;
  } else {
    // D = 256: rounds of gridDim.x / q_tiles units (host: a multiple of
    // q_tiles CTAs, at most one a SM)
    const int per_round = D == 256 ? static_cast<int>(gridDim.x) / q_tiles : 0;
    if (per_round > 0) {
      const int slot = cta() / q_tiles, pos = cta() % q_tiles;
      unit = k * per_round + slot;
      if (unit >= per_tile) return false;
      qt = (k & 1) ? pos : q_tiles - 1 - pos;
    } else {
      const int idx = place(k);
      if (idx >= q_tiles * per_tile) return false;
      qt = q_tiles - 1 - idx / per_tile;
      unit = idx % per_tile;
    }
  }
  w.h = unit % q_heads;
  w.b = unit / q_heads;
  w.q0 = qt * L::kRows;
  w.n_tiles = (seq_k + L::kBlockN - 1) / L::kBlockN;
  // tiles past the diagonal see nothing
  if (kCausal) w.n_tiles = min(w.n_tiles, (w.q0 + L::kRows + L::kBlockN - 1) / L::kBlockN);
  return true;
}

// The k/v tiles consumer c computes of unit w: all of them, but (causal, 64
// keys a tile) not consumer 0's last, which its rows never see; kSplit:
// every other one, from tile c.
template <int D, bool kCausal, bool kSplit>
__device__ __forceinline__ int consumer_tiles(const Work& w, int c) {
  using L = Layout<D, kSplit>;
  if constexpr (kSplit) return (w.n_tiles - c + 1) / 2;
  if (kCausal && L::kBlockN == 64) return min(w.n_tiles, (w.q0 + 64 * c + 64) / 64);
  return w.n_tiles;
}

template <int D, bool kCausal, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
             __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse, int batch, int seq_q, int seq_k, int q_heads, int q_tiles,
             int group, float scale_log2) {
  using L = Layout<D, kSplit>;
  constexpr int kBlockN = L::kBlockN;
  constexpr int kStages = L::kStages;
  constexpr int kPanels = D / kPanel;
  constexpr int kStride = kSplit ? 2 : 1;                  // a consumer's step through the tiles
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

  // q_tiles (of kRows rows) and the GQA group come as parameters: read from
  // the constant bank where used, nothing is held across setmaxnreg
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);                                  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      // kSplit: one consumer uses a stage, else both
      mbar_init(empty_k(s), kSplit ? 4 : 8);
      mbar_init(empty_v(s), kSplit ? 4 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the q tile and both rings full, running
    // ahead into the CTA's next unit of work
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // the ring's stage and its use's parity, stepped (no division: this
      // thread has 24 registers)
      int stage = 0, reuse = 0;
      uint32_t parity = 0;
      Work w;
      for (int k = 0; work_at<D, kCausal, kSplit>(k, q_tiles, q_heads, batch, seq_k, w); ++k) {
        // the consumers are done with the last unit's q tile
        if (k > 0) mbar_wait(q_empty, (k - 1) & 1);
        mbar_expect_tx(q_full, L::kQBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(q_sh + p * L::kRows * kRowBytes, &q_map, q_full, p * kPanel, w.h, w.q0, w.b);
        for (int j = 0; j < w.n_tiles; ++j) {
          const uint32_t off = stage * L::kKVBytes;
          // each stage is reloaded once the consumers released its previous
          // tile, kStages before
          if (reuse) mbar_wait(empty_k(stage), parity ^ 1);
          mbar_expect_tx(full_k(stage), L::kKVBytes);
          for (int p = 0; p < kPanels; ++p)
            tma_load(k_sh + off + p * kBlockN * kRowBytes, &k_map, full_k(stage), p * kPanel,
                     w.h / group, j * kBlockN, w.b);
          if (reuse) mbar_wait(empty_v(stage), parity ^ 1);
          mbar_expect_tx(full_v(stage), L::kKVBytes);
          for (int p = 0; p < kPanels; ++p)
            tma_load(v_sh + off + p * kBlockN * kRowBytes, &v_map, full_v(stage), p * kPanel,
                     w.h / group, j * kBlockN, w.b);
          if (++stage == kStages) {
            stage = 0;
            parity ^= 1;
            reuse = 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c = wg - 1 owns q rows [q0 + 64c, q0 + 64c + 64)
    // of each unit of work (kSplit: both own the unit's 64 rows)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const uint32_t q_rows = q_sh + (kSplit ? 0 : 64 * c * kRowBytes);  // this half, in each q panel
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
        wgmma_qk(sc, smem_desc(q_rows + (kk / 4) * L::kRows * kRowBytes + col, 16, 1024),
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
    // one's softmax runs under the other's products. Both take the same
    // number of turns a unit: the one with fewer tiles takes empty ones.
    auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory"); };
    auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory"); };

    if (c == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // consumer 0 goes first
    int it = 0;
    Work w, next;
    for (int k = 0; work_at<D, kCausal, kSplit>(k, q_tiles, q_heads, batch, seq_k, w); ++k) {
      const bool more = work_at<D, kCausal, kSplit>(k + 1, q_tiles, q_heads, batch, seq_k, next);
      const int n0 = consumer_tiles<D, kCausal, kSplit>(w, 0);
      const int n1 = consumer_tiles<D, kCausal, kSplit>(w, 1);
      const int mine = c == 0 ? n0 : n1;
      const int turns = max(n0 > 0 ? n0 + 1 : 0, n1 > 0 ? n1 + 1 : 0);
      int taken = 0;
      // the end of this consumer's turn; consumer 1 has no turn after its
      // last unit's last product
      auto end_turn = [&]() {
        ++taken;
        if (c == 0 || more || taken < turns) your_turn();
      };
      // the empty turns of the consumer with fewer tiles, right after its
      // last product, so that the other's last product does not wait for
      // this one's epilogue
      auto pad_turns = [&]() {
        if constexpr (D == 256) {
          while (taken < turns) {
            my_turn();
            end_turn();
          }
        }
      };
      const int first = kSplit ? c : 0;                     // this consumer's first tile
      r.row_min = w.q0 + (kSplit ? 0 : 64 * c);
      r.m[0] = r.m[1] = kNegInf;
      r.l[0] = r.l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

      mbar_wait(q_full, k & 1);
      if (!kSplit || mine > 0) {
        int j = first;
        mbar_wait(full_k(it + j), use(it + j));
        my_turn();
        qk(it + j);
        your_turn();                                        // a product turn follows
        ++taken;
        wgmma_wait<0>();
        fence_operands(sc);
        release(empty_k(it + j));
        if (mine == 1) release(q_empty);
        online_softmax<kCausal, kBlockN>(sc, r, alpha, j, seq_k, scale_log2);
        pack_p(sc, pa);
        // Tile j: Q K_j^T and P_{j-1} V_{j-1} are issued together (the
        // output's rescale between them, where no product holds the
        // output), then the softmax of tile j, then the bf16 P_j once
        // P_{j-1} V_{j-1} is done.
        for (int jj = 1; jj < mine; ++jj) {
          j += kStride;
          mbar_wait(full_k(it + j), use(it + j));
          my_turn();
          qk(it + j);
          pv(it + j - kStride);
          your_turn();
          ++taken;
          wgmma_wait<1>();                                  // Q K_j^T done
          fence_operands(sc);
          release(empty_k(it + j));
          if (jj == mine - 1) release(q_empty);             // the q tile is free for the next unit
          online_softmax<kCausal, kBlockN>(sc, r, alpha, j, seq_k, scale_log2);
          wgmma_wait<0>();                                  // P_{j-1} V_{j-1} done
          fence_operands(o);
          release(empty_v(it + j - kStride));
          pack_p(sc, pa);
        }
        my_turn();
        pv(it + j);
        end_turn();
        pad_turns();
        wgmma_wait<0>();
        fence_operands(o);
        release(empty_v(it + j));
      }
      pad_turns();

      float l_row[2];               // the rows' sums over the quad's four threads
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_row[i] = r.l[i] + __shfl_xor_sync(0xffffffffu, r.l[i], 1);
        l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
      }
      // the output of one consumer alone: normalised, stored, its lse written
      auto plain = [&]() {
        // the unit again (D = 256: from a fresh read of blockIdx.x, so that
        // none of its fields is kept across the main loop), and this
        // thread's two query rows: g and g + 8 of its warp's 16
        if constexpr (D == 256) work_at<D, kCausal, kSplit>(k, q_tiles, q_heads, batch, seq_k, w);
        const int row_a = row_of(w.q0 + (kSplit ? 0 : 64 * c)), row_b = row_a + 8;
        float inv[2], row_lse[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float l = fmaxf(l_row[i], 1e-30f);
          inv[i] = 1.f / l;
          // the row's natural-log log-sum-exp of its scaled scores, from the
          // same max and sum that normalise it
          row_lse[i] = (r.m[i] * scale_log2 + log2f(l)) * kLn2;
        }
        if (lse != nullptr && r.lane % 4 == 0) {
          float* lse_row = lse + (static_cast<int64_t>(w.b) * q_heads + w.h) * seq_q;
          if (row_a < seq_q) lse_row[row_a] = row_lse[0];
          if (row_b < seq_q) lse_row[row_b] = row_lse[1];
        }
        const int64_t q_row = static_cast<int64_t>(q_heads) * D;
        __nv_bfloat16* out_a = out + (static_cast<int64_t>(w.b) * seq_q + row_a) * q_row +
                               static_cast<int64_t>(w.h) * D;
        if constexpr (L::kStaged) {
          // through this consumer's half-tile, [64 rows][64 columns] x 2
          // panels, 128-byte swizzled as the output's tensor map reads it
          // (a warp's 8 rows x 16 bytes land in distinct banks); one half
          // of the columns at a time, each sent by two TMA boxes, the
          // buffer reused once the last send has read it. Rows past T are
          // clipped by TMA.
          const uint32_t half = base + L::kO + c * L::kHalfBytes;
          const int g = row_of(0);                          // the thread's row of the 64
          const bool lead = tid() % 128 == 0;               // issues this consumer's sends
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {
            if (lead) bulk_wait<true>();
            named_barrier(4 + c, 128);
#pragma unroll
            for (int i = 16 * hc; i < 16 * hc + 16; ++i) {
              const uint32_t panel = half + ((i / 8) % 2) * (64 * kRowBytes);
              st_shared_b32(panel + swizzle128(g, i % 8) + 4 * (r.lane % 4),
                            pack_bf16(o[4 * i] * inv[0], o[4 * i + 1] * inv[0]));
              st_shared_b32(panel + swizzle128(g + 8, i % 8) + 4 * (r.lane % 4),
                            pack_bf16(o[4 * i + 2] * inv[1], o[4 * i + 3] * inv[1]));
            }
            fence_proxy_async();
            named_barrier(4 + c, 128);
            if (lead) {
              for (int p = 0; p < 2; ++p)
                tma_store(&o_map, half + p * 64 * kRowBytes, (2 * hc + p) * kPanel, w.h,
                          w.q0 + 64 * c, w.b);
              bulk_commit();
            }
          }
        } else if constexpr (D >= 128) {
          store_row<D>(o, 0, inv[0], out_a, r.lane % 4, row_a < seq_q);
          store_row<D>(o, 2, inv[1], out_a + 8 * q_row, r.lane % 4, row_b < seq_q);
        } else {
          // D = 64: a bf16 pair a store (the transpose did not pay there)
          __nv_bfloat16* out_b = out_a + 8 * q_row;
          const int col0 = (r.lane % 4) * 2;
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            if (row_a < seq_q)
              *reinterpret_cast<__nv_bfloat162*>(out_a + 8 * i + col0) =
                  __floats2bfloat162_rn(o[4 * i] * inv[0], o[4 * i + 1] * inv[0]);
            if (row_b < seq_q)
              *reinterpret_cast<__nv_bfloat162*>(out_b + 8 * i + col0) =
                  __floats2bfloat162_rn(o[4 * i + 2] * inv[1], o[4 * i + 3] * inv[1]);
          }
        }
      };
      if constexpr (!kSplit) {
        plain();
      } else {
        work_at<D, kCausal, kSplit>(k, q_tiles, q_heads, batch, seq_k, w);  // read afresh
        if (consumer_tiles<D, kCausal, kSplit>(w, 1) == 0) {
          if (c == 0) plain();                              // consumer 1 had no tile
        } else {
          // Both consumers have tiles: each puts its output (in its own
          // register order, 16 bytes a thread side by side) into the k and
          // v stages of its last tile, which no load reaches again, and its
          // rows' max and sum into the stats area; then each merges and
          // stores half of the columns (chunks of 8 [D/16 c, D/16 (c + 1))):
          // o = (o_0 2^(m_0 - m) + o_1 2^(m_1 - m)) / (l_0 2^(m_0 - m) + l_1
          // 2^(m_1 - m)), m the larger max.
          const int slot_t = tid() % 128;
          auto slot = [&](int cc, int i4) {
            const int stage =
                (it + cc + 2 * (consumer_tiles<D, kCausal, kSplit>(w, cc) - 1)) % kStages;
            return i4 < D / 16 ? k_sh + stage * L::kKVBytes + (i4 * 128 + slot_t) * 16
                               : v_sh + stage * L::kKVBytes + ((i4 - D / 16) * 128 + slot_t) * 16;
          };
          const uint32_t stats = base + L::kO + row_of(0) * 8;  // + 512 for consumer 1's
#pragma unroll
          for (int i4 = 0; i4 < D / 8; ++i4)
            st_shared_v4(slot(c, i4), o[4 * i4], o[4 * i4 + 1], o[4 * i4 + 2], o[4 * i4 + 3]);
          const int t = r.lane % 4;
          if (t == 0) {
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(stats + 512 * c),
                         "f"(r.m[0]), "f"(l_row[0]) : "memory");
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(stats + 512 * c + 64),
                         "f"(r.m[1]), "f"(l_row[1]) : "memory");
          }
          named_barrier(3, 256);
          const int row_a = row_of(w.q0), row_b = row_a + 8;
          const int64_t q_row = static_cast<int64_t>(q_heads) * D;
          __nv_bfloat16* out_a = out + (static_cast<int64_t>(w.b) * seq_q + row_a) * q_row +
                                 static_cast<int64_t>(w.h) * D;
          float a[2][2], inv[2];    // a[consumer][row]: each partial's factor
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float m[2], l[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                           : "=f"(m[cc]), "=f"(l[cc])
                           : "r"(stats + 512 * cc + 64 * i)
                           : "memory");
            const float mx = fmaxf(m[0], m[1]);
            a[0][i] = fast_exp2((m[0] - mx) * scale_log2);
            a[1][i] = fast_exp2((m[1] - mx) * scale_log2);
            const float sum = fmaxf(l[0] * a[0][i] + l[1] * a[1][i], 1e-30f);
            inv[i] = 1.f / sum;
            // the row's natural-log log-sum-exp of its scaled scores, from
            // the same max and sum that normalise it
            if (c == 0 && lse != nullptr && t == 0 && row_a + 8 * i < seq_q)
              lse[(static_cast<int64_t>(w.b) * q_heads + w.h) * seq_q + row_a + 8 * i] =
                  (mx * scale_log2 + log2f(sum)) * kLn2;
          }
#pragma unroll
          for (int mm = 0; mm < D / 64; ++mm) {
            const int m = D / 64 * c + mm;                  // chunks 4m .. 4m + 3
            uint32_t ua[4], ub[4];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              float x0[4], x1[4];
              ld_shared_v4(slot(0, 4 * m + s), x0[0], x0[1], x0[2], x0[3]);
              ld_shared_v4(slot(1, 4 * m + s), x1[0], x1[1], x1[2], x1[3]);
              ua[s] = pack_bf16((x0[0] * a[0][0] + x1[0] * a[1][0]) * inv[0],
                                (x0[1] * a[0][0] + x1[1] * a[1][0]) * inv[0]);
              ub[s] = pack_bf16((x0[2] * a[0][1] + x1[2] * a[1][1]) * inv[1],
                                (x0[3] * a[0][1] + x1[3] * a[1][1]) * inv[1]);
            }
            store_group(ua, out_a, m, t, row_a < seq_q);
            store_group(ub, out_a + 8 * q_row, m, t, row_b < seq_q);
          }
        }
      }
      // the tiles past this consumer's rows (consumer 0, causal at D =
      // 256): loaded for consumer 1, released once they landed, so that
      // this arrival cannot count towards the stage's previous use
      if constexpr (D == 256 && kCausal && !kSplit) {
        for (int j = mine; j < w.n_tiles; ++j) {
          mbar_wait(full_k(it + j), use(it + j));
          release(empty_k(it + j));
          mbar_wait(full_v(it + j), use(it + j));
          release(empty_v(it + j));
        }
      }
      if constexpr (!kSplit) it += w.n_tiles;                // kSplit: one unit a CTA
    }
    // the last TMA stores done before the CTA's shared memory goes
    if (L::kStaged && tid() % 128 == 0) bulk_wait<false>();
  }
}

// -- host side ----------------------------------------------------------------

template <int D, bool kCausal, bool kSplit>
int run(const void* q, const void* k, const void* v, void* out, float* lse, int batch, int seq_q,
        int seq_k, int q_heads, int kv_heads, float scale, int sms, cudaStream_t stream) {
  using L = Layout<D, kSplit>;
  static bool attr_set = false;    // the dynamic shared memory above 48 KB, once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D, kCausal, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!encode_map(encode, &q_map, q, D, q_heads, seq_q, batch, L::kRows) ||
      (L::kStaged && !encode_map(encode, &o_map, out, D, q_heads, seq_q, batch, 64)) ||
      !encode_map(encode, &k_map, k, D, kv_heads, seq_k, batch, L::kBlockN) ||
      !encode_map(encode, &v_map, v, D, kv_heads, seq_k, batch, L::kBlockN))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long q_tiles = (seq_q + L::kRows - 1) / L::kRows;
  const long long units = q_tiles * q_heads * batch;
  long long grid = units;
  if (!kSplit) {
    // a persistent grid: one CTA per SM at most, each walking its units of
    // work (the next unit's loads overlap this one's last products); at D =
    // 256 whole rounds of a unit's q tiles
    grid = units < sms ? units : sms;
    if (D == 256 && q_tiles <= sms) {
      const long long per_round = sms / q_tiles;
      grid = (per_round < q_heads * batch ? per_round : q_heads * batch) * q_tiles;
    }
  }
  flash_kernel<D, kCausal, kSplit><<<static_cast<unsigned>(grid), kThreads, L::kBytes, stream>>>(
      q_map, k_map, v_map, L::kStaged ? o_map : q_map, static_cast<__nv_bfloat16*>(out), lse,
      batch, seq_q, seq_k, q_heads,
      static_cast<int>(q_tiles), q_heads / kv_heads, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch, int seq_q,
           int seq_k, int q_heads, int kv_heads, bool split, float scale, int device,
           cudaStream_t stream) {
  // the device's context current on this thread: the tensor-map encoder
  // needs one, and a thread that made no runtime call yet has none
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (D == 256) {
    if (split)
      return run<D, kCausal, true>(q, k, v, out, lse, batch, seq_q, seq_k, q_heads, kv_heads,
                                   scale, sms, stream);
  } else if (split) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run<D, kCausal, false>(q, k, v, out, lse, batch, seq_q, seq_k, q_heads, kv_heads, scale,
                                sms, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel has no instance for (or a
// tensor map the driver refuses), cudaErrorNotSupported when the driver
// has no tensor-map encoder. `device` is the CUDA device that holds the
// tensors. `split` (D = 256 only) takes the 64-row units whose consumers
// split the keys; the Python wrapper chooses it (`flash_split_keys`), and
// validates shapes, types, contiguity and alignment first.
extern "C" int tpu9_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         float* lse,
                                         int batch, int seq_q, int seq_k, int q_heads,
                                         int kv_heads, int head_dim, int causal, int split,
                                         float scale, int device, void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || seq_q <= 0 || seq_k <= 0 ||
      seq_q % 64 != 0 || seq_k % 64 != 0 ||
      static_cast<long long>(seq_q / 64) * q_heads * batch > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPU9_CASE(D, C)                                                                   \
  if (head_dim == D && (causal != 0) == C)                                                \
    return launch<D, C>(q, k, v, out, lse, batch, seq_q, seq_k, q_heads, kv_heads,       \
                        split != 0, scale, device, s);
  TPU9_CASE(64, true) TPU9_CASE(64, false) TPU9_CASE(128, true) TPU9_CASE(128, false)
  TPU9_CASE(256, true) TPU9_CASE(256, false)
#undef TPU9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
