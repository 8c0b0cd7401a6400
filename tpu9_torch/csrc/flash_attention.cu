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
// All three are read in their own layout through row strides (QH*D and
// KH*D elements between tokens): no transposed copy is made. Query head h
// reads kv head h / (QH/KH).
//
// What bounds it: at the prefill lengths of the dense engine (T = S = 128,
// 512, 2048; QH 32, KH 8, D 128) the tensor-core operations bound it from
// T = 2048 on (4*D*QH*T(T+1)/2 flops at 989 TFLOP/s against q, k, v and out
// once at 3.35 TB/s) and the bytes below that. So the design keeps the
// two products on the tensor cores, keeps the scores and the probabilities
// out of device memory, and reads each k/v tile once per CTA:
//
// - The TPU kernel carries the softmax state across the sequential k axis
//   of its grid in VMEM; CUDA blocks run in no order, so here one CTA owns
//   one (q tile of 64 rows, q head, sequence) and walks the k/v tiles in a
//   loop, with the running max, sum and output in registers.
// - 4 warps x 16 query rows. QK^T and PV are mma.sync.m16n8k16 bf16 -> f32
//   (FA2's shape). Operand fragments come from shared memory through
//   ldmatrix (.trans for V); rows are padded by 8 elements so the 8 rows of
//   one ldmatrix fall in distinct banks.
// - The k/v tiles (64 rows) are double-buffered in shared memory: cp.async
//   copies tile j+1 while tile j is computed.
// - The scale is applied to the f32 scores (folded with log2(e) for exp2);
//   the probabilities are rounded to bf16 for the PV product, the row sums
//   stay f32. Each p then carries a relative error of at most 2^-9.
// - Causal: a q tile stops at the diagonal tile and only tiles crossing the
//   diagonal are masked. The q tiles are the slowest grid axis and are
//   scanned heaviest-first, so the last wave is made of short tiles.
//
// Not done yet (later perf work): wgmma and TMA, a persistent schedule,
// head_dim 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;            // q rows per CTA, k/v rows per tile
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a * b for one m16n8k16 tile: a row-major 16x16, b "col" 16x8
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
constexpr int smem_bytes() {
  // q tile + two stages of (k tile, v tile), rows padded to D + 8
  return (1 + 2 * 2) * kTile * (D + 8) * 2;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int seq_q,
             int seq_k, int q_heads, int kv_heads, float scale_log2) {
  constexpr int kStride = D + 8;          // padded smem row, elements
  constexpr int kChunks = D / 8;          // 16-byte chunks per row
  constexpr int kSteps = D / 16;          // k-steps of QK^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_sh = q_sh + kTile * kStride;            // [2][kTile][kStride]
  __nv_bfloat16* v_sh = k_sh + 2 * kTile * kStride;        // [2][kTile][kStride]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;               // heaviest q tile first
  const int kvh = h / (q_heads / kv_heads);
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t q_row = (int64_t)q_heads * D;
  const int64_t kv_row = (int64_t)kv_heads * D;
  const __nv_bfloat16* q_base = q + ((int64_t)b * seq_q + q0) * q_row + (int64_t)h * D;
  const __nv_bfloat16* k_base = k + (int64_t)b * seq_k * kv_row + (int64_t)kvh * D;
  const __nv_bfloat16* v_base = v + (int64_t)b * seq_k * kv_row + (int64_t)kvh * D;

  for (int c = tid; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    cp_async16(q_sh + r * kStride + col, q_base + r * q_row + col);
  }
  auto load_kv = [&](int stage, int tile) {
    const int64_t off = (int64_t)tile * kTile * kv_row;
    __nv_bfloat16* ks = k_sh + stage * kTile * kStride;
    __nv_bfloat16* vs = v_sh + stage * kTile * kStride;
    for (int c = tid; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      cp_async16(ks + r * kStride + col, k_base + off + r * kv_row + col);
      cp_async16(vs + r * kStride + col, v_base + off + r * kv_row + col);
    }
  };
  int n_tiles = seq_k / kTile;
  if (kCausal) n_tiles = min(n_tiles, qt + 1);   // tiles past the diagonal see nothing
  load_kv(0, 0);
  cp_async_commit();                              // group 0: the q tile and k/v tile 0

  // this thread's two query rows: g and g + 8 of the warp's 16
  const int row_a = q0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                        // this thread's part of the row sums
  uint32_t qf[kSteps][4];

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, j + 1);
    cp_async_commit();
    cp_async_wait_one();                          // everything but tile j + 1 has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        ldmatrix_x4(qf[kk], q_sh + (warp * 16 + lane % 16) * kStride + kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* ks = k_sh + (j & 1) * kTile * kStride;
    const __nv_bfloat16* vs = v_sh + (j & 1) * kTile * kStride;

    // scores S = Q K^T for the warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane / 16) * 8 + lane % 8) * kStride + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale (in the exp2 domain), mask, online softmax
    const bool masked = kCausal && (j + 1) * kTile - 1 > q0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int col = j * kTile + nt * 8 + (lane % 4) * 2 + (e & 1);
          if (col > (e < 2 ? row_a : row_b)) x = kNegInf;
        }
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e / 2]);
        s[nt][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * kStride +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();   // the next iteration's prefetch overwrites this stage
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* out_a = out + ((int64_t)b * seq_q + row_a) * q_row + (int64_t)h * D;
  __nv_bfloat16* out_b = out_a + 8 * q_row;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(out_a + col) =
        __floats2bfloat162_rn(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(out_b + col) =
        __floats2bfloat162_rn(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
}

template <int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int seq_q,
           int seq_k, int q_heads, int kv_heads, float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  static bool attr_set = false;    // the dynamic shared memory above 48 KB, once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D, kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(q_heads, batch, seq_q / kTile);
  flash_kernel<D, kCausal><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), seq_q, seq_k,
      q_heads, kv_heads, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel has no instance for. The
// Python wrapper validates shapes, types, contiguity and alignment first.
extern "C" int tpu9_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                         int batch, int seq_q, int seq_k, int q_heads,
                                         int kv_heads, int head_dim, int causal, float scale,
                                         void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads != 0 || seq_q <= 0 || seq_k <= 0 ||
      seq_q % kTile != 0 || seq_k % kTile != 0 || batch > 65535 || seq_q / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPU9_CASE(D, C)                                                                   \
  if (head_dim == D && (causal != 0) == C)                                                \
    return launch<D, C>(q, k, v, out, batch, seq_q, seq_k, q_heads, kv_heads, scale, s);
  TPU9_CASE(64, true) TPU9_CASE(64, false) TPU9_CASE(128, true) TPU9_CASE(128, false)
#undef TPU9_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
