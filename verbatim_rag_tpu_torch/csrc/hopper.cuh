// Hopper (sm_90a) building blocks shared by the wgmma kernels of
// `flash_attention.cu`, `flash_attention_bwd.cu` and `section.cu`: TMA tensor
// maps and tile loads, bulk copies, mbarriers, and warpgroup MMA (wgmma) on
// 128-byte-swizzled shared tiles. Hand-written PTX; nothing here allocates or
// synchronises the device.
//
// Every attention tile is a slab of rows of one head of a [B, S, H, D]
// contiguous bf16 tensor: D = 64 gives rows of 128 bytes, exactly one
// 128-byte swizzle span (ModernBERT's heads); D = 32 rows of 64 bytes, one
// 64-byte swizzle span (MiniLM's heads). The bucket tables use 128-byte
// chunks of row-major [N, d] rows (64 bf16 or 128 int8 values). TMA writes a
// tile swizzled (with the 128-byte swizzle 16-byte chunk c of row r lands at
// chunk c ^ (r % 8); with the 64-byte one at c ^ ((r / 2) % 4)), rows and
// bytes past the tensor zero-filled; wgmma reads it through a descriptor with
// the same swizzle, either K-major (the bytes of a row are the contraction:
// Q·Kᵀ, dO·Vᵀ, queries·rowsᵀ) or MN-major (rows are the contraction: P·V,
// dS·K, Pᵀ·dO, dSᵀ·Q), so no product needs a transposed copy. A K-major
// k-step is 32 bytes in every type (16 bf16, 32 int8), so one descriptor
// step serves both swizzles and both types.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kWarpgroup = 128;

// Bytes of one bf16 head row of dim D: 128 (D = 64) or 64 (D = 32), each one
// swizzle span of the same width.
template <int D>
__host__ __device__ constexpr int head_row_bytes() {
  static_assert(D == 32 || D == 64, "attention tiles take head dims 32 and 64");
  return D * 2;
}

// ---- host: tensor maps ------------------------------------------------------------

// A TMA map over a [batch, seq, heads, D] contiguous bf16 tensor whose box is
// `rows` consecutive positions of one (batch, head): coordinates (0, h, s, b),
// swizzled by the row's own width (128 bytes for D = 64, 64 for D = 32).
// Rows past seq are zero-filled. Returns 0 or a CUDA error code.
template <int D>
inline int make_tile_map(CUtensorMap* map, const void* base, int batch, int seq, int heads,
                         int rows) {
  constexpr int kBytes = head_row_bytes<D>();
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)kBytes, (cuuint64_t)heads * kBytes,
                                 (cuuint64_t)seq * heads * kBytes};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  const CUresult rc = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// A TMA map over a row-major [n_rows, row_bytes] matrix whose rows start
// `pitch` bytes apart (a multiple of 16, TMA's stride rule; any row width),
// whose box is 128 bytes of `rows` consecutive rows: int8 codes or bf16
// values as bytes (coordinates (byte, row)), or, with `f32`, float32 values
// (coordinates (column, row), a box of 32 columns). Bytes past a row (the
// pitch's padding included: it is never read) and rows past n_rows are
// zero-filled. Returns 0 or a CUDA error code.
inline int make_rows_map(CUtensorMap* map, const void* base, long long n_rows, int row_bytes,
                         long long pitch, int rows, bool f32 = false) {
  const int elt = f32 ? 4 : 1;
  if (row_bytes <= 0 || row_bytes % elt != 0 || pitch < row_bytes || pitch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)(row_bytes / elt), (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {128u / elt, (cuuint32_t)rows};
  const cuuint32_t elem_strides[2] = {1u, 1u};
  const CUresult rc = cuTensorMapEncodeTiled(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// ---- device: shared memory, mbarriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the swizzle's period:
// tiles must start on it). Launches ask for 1024 bytes more than they use.
__device__ __forceinline__ uint8_t* smem_base_1024(uint8_t* raw) {
  const uint32_t off = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return raw + off;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA data the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the phase of parity `parity` has completed. A phase that has
// not completed 10 s after the first try means a broken protocol (a load
// that never lands, an arrival that never comes): the kernel traps, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t first = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (first == 0)
      first = now;
    else if (now - first > 10000000000ull)
      __trap();
  }
}

// TMA: the box of `map` at (0, h, s, b) into shared memory at dst (1024-byte
// aligned); its bytes count against the barrier's expected transactions.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// TMA: the box of a `make_rows_map` map at (byte, row) into shared memory at
// dst (1024-byte aligned), counted against the barrier like tma_load_tile.
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int byte, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(byte), "r"(row)
      : "memory");
}

// Bulk copy of `bytes` contiguous bytes (a multiple of 16, both addresses
// 16-byte aligned) into shared memory, counted against the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- device: wgmma -----------------------------------------------------------------

// Descriptor of a swizzled tile of kBytes-byte rows at p (K-major or
// MN-major alike), one swizzle span a row: 8-row groups 8·kBytes apart
// (SBO), the leading offset unused (one span covers the row's values; for
// MN-major it would be the stride between spans along N, and N is one span
// here), layout type 1 = 128-byte swizzle, 2 = 64-byte swizzle. A K-major
// k16 slice starts 32 bytes further per step (+2 in the address field), an
// MN-major one 16 rows further (+16·kBytes / 16).
template <int kBytes>
__device__ __forceinline__ uint64_t desc_sw(const void* p) {
  static_assert(kBytes == 128 || kBytes == 64, "swizzled rows of 128 or 64 bytes");
  constexpr uint64_t kLayout = kBytes == 128 ? 1 : 2;
  constexpr uint64_t kSbo = (8 * kBytes) >> 4;
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (kSbo << 32) | (kLayout << 62);
}
__device__ __forceinline__ uint64_t desc_sw128(const void* p) { return desc_sw<128>(p); }
constexpr uint64_t kDescKStep = 32 >> 4;  // K-major: next 16 values
template <int kBytes>
__host__ __device__ constexpr uint64_t desc_row_step() {  // MN-major: next 16 rows
  return (16 * kBytes) >> 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins register values across the asynchronous products: the compiler may
// neither read an accumulator before the wgmma.wait that completes it nor
// move a write past the wgmma.fence that publishes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64×64] (+)= A·Bᵀ: A [64 × 16] and B [64 × 16] both K-major in shared
// memory (descriptors). scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64×128] (+)= A·Bᵀ: A [64 × 16] and B [128 × 16] both K-major in shared
// memory (descriptors). scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64×128] (+)= A·Bᵀ on int8: A [64 × 32] and B [128 × 32] s8 codes, both
// K-major in shared memory (the only layout integer wgmma takes), exact s32
// sums. scale_d = 0 overwrites D. The s32 accumulator has the f32 layout
// documented below.
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64×64] += A·B: A [64 × 16] from registers (see `acc_to_a`), B [16 × 64]
// MN-major in shared memory (rows of 64 contiguous values; the descriptor's
// transpose bit), so a row-major tile serves as B with no transposed copy.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// D[64×32] += A·B: as `wgmma_m64n64k16_rs` with B [16 × 32] MN-major (rows
// of 32 contiguous values: 64 bytes, one 64-byte swizzle span).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// O[64×D] += P·V for the attention head dims: m64n64 (D = 64) or m64n32
// (D = 32), V MN-major.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64)
    wgmma_m64n64k16_rs(d, a, desc_b);
  else
    wgmma_m64n32k16_rs(d, a, desc_b);
}

// Accumulator layout of a wgmma m64nN tile (f32 or s32): warp w of the warpgroup
// holds rows 16w + g and 16w + g + 8 (g = lane / 4, t = lane % 4); element
// 4j + e is (row 16w + g + 8·(e / 2), column 8j + 2t + e % 2). That is the
// mma.sync C layout per 8-column tile, and the register-A layout of the next
// product: columns 16kc..16kc+15 (elements 8kc..8kc+7), rounded to bf16, are
// the A fragment of k-step kc.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&c)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 8; ++kc) {
    a[kc][0] = pack_bf16(c[8 * kc + 0], c[8 * kc + 1]);
    a[kc][1] = pack_bf16(c[8 * kc + 2], c[8 * kc + 3]);
    a[kc][2] = pack_bf16(c[8 * kc + 4], c[8 * kc + 5]);
    a[kc][3] = pack_bf16(c[8 * kc + 6], c[8 * kc + 7]);
  }
}

// The masks on a warpgroup's tile: 64 rows [r, r + 63] (query rows, or for
// dk/dv the q tile seen from its keys: the band is symmetric) against keys
// [k, k_last]. A pair is live when its key is below len and, for
// window >= 0, |row − key| <= window / 2.
__device__ __forceinline__ bool any_live(int r, int k, int k_last, int len, int window) {
  const int half = window / 2;
  return k < len && (window < 0 || (k - (r + 63) <= half && r - k_last <= half));
}
__device__ __forceinline__ bool all_live(int r, int k, int k_last, int len, int window) {
  const int half = window / 2;
  return k_last < len && (window < 0 || (k_last - r <= half && r + 63 - k <= half));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hopper
