// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA loads, wgmma products and their shared-memory descriptors, and the
// host's tensor-map encoder. Included by flash_attention.cu (the forward),
// flash_attention_backward.cu (its gradient) and paged_decode_attention.cu
// (the decode kernels); ops/_build.py hashes this header into every
// library's name.

#pragma once

#include <cuda.h>   // CUtensorMap and its encoder's types; the encoder itself
                    // comes through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kPanel = 64;           // bf16 columns of one 128-byte swizzled panel
constexpr int kRowBytes = 128;       // bytes of one panel row
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// one box of a 2-D tensor map: column c0, row c1
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory writes of this thread made visible to the async proxy (the
// operands wgmma reads): after the writes, before the barrier that hands
// them to the product.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `threads` threads (a multiple of 32) on hardware barrier `id`
// (0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrival at hardware barrier `id` without waiting: the threads that
// bar.sync on it (`threads` together with the arriving ones) go on once all
// have arrived and see the shared-memory writes made before the arrive, a
// one-way hand-off
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory by the bulk-copy engine, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
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

// The same for the bf16 A fragments an asynchronous product reads from
// registers: they stay live until the wait that follows this.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// A shared-memory matrix descriptor for a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// A tile is D/64 panels of [rows][64] bf16. K-major (the reduction runs
// along a row): the start steps 32 bytes a 16-wide k-step inside a panel,
// the stride offset is 1024 (8 rows). MN-major (the reduction runs down the
// rows, the "transpose" bit): the start steps 16 rows (2048 bytes) a
// k-step, the leading offset is the panel stride, the stride offset 1024.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

#define TPU9_F8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TPU9_F16(d, i) TPU9_F8(d, i), TPU9_F8(d, i + 8)
#define TPU9_F32(d, i) TPU9_F8(d, i), TPU9_F8(d, i + 8), TPU9_F8(d, i + 16), TPU9_F8(d, i + 24)

#define TPU9_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TPU9_R32                                                                       \
  TPU9_R16 ", %16, %17, "                                                              \
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

// d (64 x 64, f32) = a (64 x 16) b (16 x 64) [+ d]
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TPU9_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TPU9_F32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32, f32) = a (64 x 16) b (16 x 32) [+ d]
__device__ __forceinline__ void wgmma_qk(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" TPU9_R16
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : TPU9_F16(d, 0)
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

// d (64 x 8, f32) = a (64 x 16) b (16 x 8) [+ d]: both operands K-major in
// shared memory
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16, f32) += a (64 x 16) b (16 x 16): a MN-major in shared memory
// (the transpose bit), b K-major
__device__ __forceinline__ void wgmma_n16_mn(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : TPU9_F8(d, 0)
      : "l"(a), "l"(b), "r"(1));
}

// Byte offset of 16-byte chunk `chunk` (of the 8 in a 128-byte row) of row
// `row` in a 128-byte-swizzled panel whose base is 1024-byte aligned: the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads.
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return static_cast<uint32_t>(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
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

// An f32 accumulator tile of 16 kSteps columns as the bf16 A fragments of
// a product that reduces over those columns: chunks 2kk and 2kk + 1 of 8
// columns are k-step kk, in the accumulator's own register order.
// Accumulator element i of a thread (lane l of warp w of the warpgroup)
// sits at row 16w + l/4 + 8((i/2)%2), column 8(i/4) + 2(l%4) + (i%2).
template <int kSteps>
__device__ __forceinline__ void pack_p(const float (&sc)[8 * kSteps], uint32_t (&pa)[kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
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

// A row-major [rows, cols] matrix (row stride `cols` elements of
// `elem_bytes`) as a 2-D map with boxes of box_cols x box_rows: bf16 in
// 128-byte swizzled panels (box_cols 64), or int8 unswizzled.
bool encode_map_2d(EncodeTiled encode, CUtensorMap* map, const void* base, bool int8,
                   uint64_t cols, uint64_t rows, int box_cols, int box_rows) {
  const int elem_bytes = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
