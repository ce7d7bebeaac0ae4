// Packed strided bucket tables for the int8 tier, hand-written for Hopper (sm_90a).
//
// Two entry points share one main loop:
//
//   section_tables — replaces the TPU kernel
//     `verbatim_rag_tpu/ops/section.py::_make_section_kernel` (pallas_call in
//     `section_bucket_tables`): up to three arms (dense, SPLADE sketch, ...) in
//     one launch, one packed table per arm, additive mask;
//   bucket_max_v2  — replaces `verbatim_rag_tpu/ops/fused_topk.py`
//     `_bucket_max_v2_onedot_kernel` / `_bucket_max_v2_chunked_kernel`
//     (pallas_call in `matmul_bucket_max_v2`): one corpus, the mask applied by
//     select, the table written unpacked as (value, position).
//
// Both compute, for query b and table column c = block·128 + lane, the maximum
// over positions p < block/128 of
//     pack(score(b, row), p)                  row = block·B + p·128 + lane,
// where pack overwrites the score's low 7 mantissa bits with p (the bits are
// cleared first), so one maximum carries value and position. The score is
//     int8 rows:  (float(int32 dot of the codes) * q_scale[b]) * c_scale[row]
//     bf16 rows:  the float32 dot (bf16 operands, f32 accumulate)
// section_tables then adds mask_add[row] (0 or -1e30; no mask: nothing added);
// bucket_max_v2 replaces the packed value by -1e30 where mask[row] == 0. The
// running maximum starts at -1e30. The int8 path is bit-equal to the plain
// version: int32 sums are exact and each float operation is the same.
//
// Layout: rows are row-major [N, d] (the TPU kernel wants transposed [d, N]
// copies for its MXU; here the corpus rows are B operands as they lie), d·elt
// a multiple of 16 bytes. One CTA of 8 warps owns a tile of 64 queries × 128
// lanes of one column block and walks the block's positions:
//   - the query tile stays in shared memory for the whole walk;
//   - the corpus is streamed in stages of 128 rows × 128 bytes through a
//     3-deep cp.async ring;
//   - each warp computes 16 queries × 64 lanes with mma.sync (m16n8k32 s8·s8→s32
//     for int8, m16n8k16 bf16→f32); in bytes both take the same fragments, so
//     one shared-memory layout (rows padded by 16 bytes: conflict-free 32-bit
//     fragment loads) serves both;
//   - after the last stage of a position the accumulators are scaled, packed,
//     masked and folded into a running maximum held in registers.
// Grid: x = query tiles (fastest, so the tiles of one column block run
// together and share its rows in L2), y = column blocks, z = arms.
//
// Bound on an H100 SXM at the serving point (B=512, N=1,007,616, dense 384 +
// sketch 768 int8): 1.19 T int8 operations (0.60 ms at 1,979 TOP/s) against
// 1.17 GB of rows, scales and mask (0.35 ms at 3.35 TB/s), so operations bound
// it. mma.sync, not wgmma, and an epilogue of ~10 instructions per score keep
// it above that bound; a TMA/wgmma pipeline is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 128;        // bucket width: table columns per block
constexpr int kQueries = 64;       // queries per CTA
constexpr int kWarps = 8;          // 4 (queries) × 2 (lanes)
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;        // bytes of a row per stage
constexpr int kPad = 16;           // shared-memory row padding
constexpr int kStageStride = kChunk + kPad;
constexpr int kStages = 3;
constexpr int kStageBytes = kLanes * kStageStride;
constexpr int kMaxArms = 3;
constexpr int kPosMask = 0x7F;
constexpr float kNegInf = -1e30f;

struct Arm {
  const uint8_t* q;       // [batch, d] int8 codes or bf16
  const uint8_t* corpus;  // [n_rows, d]
  const float* qscale;    // [batch] (int8 arms)
  const float* cscale;    // [n_rows] (int8 arms)
  float* out;             // [batch, n_blocks·128]
  int* out_pos;           // bucket_max_v2: [batch, n_blocks·128]
  int row_bytes;
  int is_int8;
};

struct Params {
  Arm arm[kMaxArms];
  const float* mask_add;   // section_tables: [n_rows] or null
  const uint8_t* mask_sel; // bucket_max_v2: [n_rows] 0/1
  int batch;
  long long n_rows;
  int block;
  int n_blocks;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One arm's tile: 64 queries × 128 lanes of column block `blk`.
// kSelect: false = section_tables (additive mask, packed output),
//          true  = bucket_max_v2 (select mask, value + position output).
template <bool kInt8, bool kSelect>
__device__ __forceinline__ void run_tile(const Params& prm, const Arm& arm, int blk, int q0,
                                         uint8_t* smem) {
  using Acc = std::conditional_t<kInt8, int, float>;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int warp_q = (warp & 3) * 16;
  const int warp_l = (warp >> 2) * 64;

  const int row_bytes = arm.row_bytes;
  const int padded = (row_bytes + kChunk - 1) / kChunk * kChunk;
  const int q_stride = padded + kPad;
  uint8_t* q_s = smem;
  uint8_t* stages = smem + kQueries * q_stride;

  const int n_chunks = padded / kChunk;
  const int n_pos = prm.block / kLanes;
  const int total = n_pos * n_chunks;
  const long long block_row0 = static_cast<long long>(blk) * prm.block;

  // Query tile: rows past the batch and bytes past the row are zero.
  const int q_pieces = padded / 16;
  for (int i = tid; i < kQueries * q_pieces; i += kThreads) {
    const int r = i / q_pieces;
    const int c = (i - r * q_pieces) * 16;
    uint8_t* dst = q_s + r * q_stride + c;
    if (q0 + r < prm.batch && c < row_bytes) {
      cp_async16(dst, arm.q + static_cast<long long>(q0 + r) * row_bytes + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }

  auto load_stage = [&](int it) {
    const int p = it / n_chunks;
    const int off0 = (it - p * n_chunks) * kChunk;
    uint8_t* stage = stages + (it % kStages) * kStageBytes;
    const uint8_t* src = arm.corpus + (block_row0 + p * kLanes) * row_bytes;
    for (int i = tid; i < kLanes * (kChunk / 16); i += kThreads) {
      const int r = i / (kChunk / 16);
      const int c = (i % (kChunk / 16)) * 16;
      uint8_t* dst = stage + r * kStageStride + c;
      if (off0 + c < row_bytes) {
        cp_async16(dst, src + static_cast<long long>(r) * row_bytes + off0 + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  float qscale[2] = {0.f, 0.f};
  if constexpr (kInt8) {
    for (int h = 0; h < 2; ++h) {
      const int b = q0 + warp_q + g + 8 * h;
      qscale[h] = b < prm.batch ? arm.qscale[b] : 0.f;
    }
  }

  Acc acc[8][4];
  float best[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nt][i] = 0;
      best[nt][i] = kNegInf;
    }
  }

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }

  int p = 0;
  int chunk = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait_stages();
    __syncthreads();
    if (it + kStages - 1 < total) load_stage(it + kStages - 1);
    cp_async_commit();

    const uint8_t* stage = stages + (it % kStages) * kStageBytes;
    const int left = row_bytes - chunk * kChunk;
    const int k_steps = left >= kChunk ? kChunk / 32 : (left + 31) / 32;
    for (int ks = 0; ks < k_steps; ++ks) {
      const uint8_t* qa = q_s + (warp_q + g) * q_stride + chunk * kChunk + ks * 32 + t * 4;
      const uint32_t a0 = ld32(qa);
      const uint32_t a1 = ld32(qa + 8 * q_stride);
      const uint32_t a2 = ld32(qa + 16);
      const uint32_t a3 = ld32(qa + 8 * q_stride + 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint8_t* cb = stage + (warp_l + nt * 8 + g) * kStageStride + ks * 32 + t * 4;
        mma(acc[nt], a0, a1, a2, a3, ld32(cb), ld32(cb + 16));
      }
    }

    if (++chunk == n_chunks) {
      // Epilogue of position p: scale, pack, mask, running maximum.
      const long long row_base = block_row0 + p * kLanes + warp_l + t * 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long row = row_base + nt * 8 + (i & 1);
          float v;
          if constexpr (kInt8) {
            v = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(acc[nt][i])), qscale[i >> 1]),
                          __ldg(arm.cscale + row));
          } else {
            v = acc[nt][i];
          }
          v = __int_as_float((__float_as_int(v) & ~kPosMask) | p);
          if constexpr (kSelect) {
            if (__ldg(prm.mask_sel + row) == 0) v = kNegInf;
          } else if (prm.mask_add != nullptr) {
            v = __fadd_rn(v, __ldg(prm.mask_add + row));
          }
          best[nt][i] = fmaxf(best[nt][i], v);
          acc[nt][i] = 0;
        }
      }
      chunk = 0;
      ++p;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

  const long long width = static_cast<long long>(prm.n_blocks) * kLanes;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = q0 + warp_q + g + 8 * (i >> 1);
      if (b >= prm.batch) continue;
      const long long col = static_cast<long long>(blk) * kLanes + warp_l + nt * 8 + t * 2 + (i & 1);
      const long long idx = static_cast<long long>(b) * width + col;
      if constexpr (kSelect) {
        const int bits = __float_as_int(best[nt][i]);
        arm.out[idx] = __int_as_float(bits & ~kPosMask);
        arm.out_pos[idx] = bits & kPosMask;
      } else {
        arm.out[idx] = best[nt][i];
      }
    }
  }
}

template <bool kSelect>
__global__ void __launch_bounds__(kThreads, 2) bucket_tables_kernel(const Params prm) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Arm& arm = prm.arm[blockIdx.z];
  const int q0 = blockIdx.x * kQueries;
  const int blk = blockIdx.y;
  if (arm.is_int8) {
    run_tile<true, kSelect>(prm, arm, blk, q0, smem);
  } else {
    run_tile<false, kSelect>(prm, arm, blk, q0, smem);
  }
}

int smem_bytes(int row_bytes) {
  const int padded = (row_bytes + kChunk - 1) / kChunk * kChunk;
  return kQueries * (padded + kPad) + kStages * kStageBytes;
}

template <bool kSelect>
int launch(const Params& prm, int n_arms, cudaStream_t stream) {
  int smem = 0;
  for (int a = 0; a < n_arms; ++a) {
    const int rb = prm.arm[a].row_bytes;
    if (rb <= 0 || rb % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (prm.arm[a].is_int8 && (prm.arm[a].qscale == nullptr || prm.arm[a].cscale == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = smem_bytes(rb) > smem ? smem_bytes(rb) : smem;
  }
  if (prm.block <= 0 || prm.block % kLanes != 0 || prm.block / kLanes > kPosMask + 1 ||
      prm.n_rows % prm.block != 0 || prm.n_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(bucket_tables_kernel<kSelect>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.batch + kQueries - 1) / kQueries, prm.n_blocks, n_arms);
  bucket_tables_kernel<kSelect><<<grid, kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(int batch, long long n_rows, int block) {
  Params prm = {};
  prm.batch = batch;
  prm.n_rows = n_rows;
  prm.block = block;
  prm.n_blocks = block > 0 ? static_cast<int>(n_rows / block) : 0;
  return prm;
}

}  // namespace

// Per arm a < n_arms: q[a] [batch, d_a], corpus[a] [n_rows, d_a] (int8 when
// is_int8[a], else bf16), qscale[a] [batch] and cscale[a] [n_rows] float32 for
// int8 arms, out[a] [batch, n_rows/block·128] float32; mask_add [n_rows]
// float32 or null. All contiguous. Returns the CUDA error code of the launch.
extern "C" int section_tables(int n_arms, const void* const* q, const void* const* corpus,
                              const void* const* qscale, const void* const* cscale,
                              void* const* out, const int* row_bytes, const int* is_int8,
                              const void* mask_add, int batch, long long n_rows, int block,
                              void* stream) {
  if (n_arms < 1 || n_arms > kMaxArms) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  Params prm = make_params(batch, n_rows, block);
  for (int a = 0; a < n_arms; ++a) {
    prm.arm[a] = Arm{static_cast<const uint8_t*>(q[a]), static_cast<const uint8_t*>(corpus[a]),
                     static_cast<const float*>(qscale[a]), static_cast<const float*>(cscale[a]),
                     static_cast<float*>(out[a]), nullptr, row_bytes[a], is_int8[a]};
  }
  prm.mask_add = static_cast<const float*>(mask_add);
  return launch<false>(prm, n_arms, static_cast<cudaStream_t>(stream));
}

// q [batch, d], corpus [n_rows, d] (int8 when is_int8, else bf16), qscale
// [batch] / cscale [n_rows] float32 for int8, mask [n_rows] bool; out_val
// [batch, n_rows/block·128] float32 (low 7 bits cleared), out_pos the same
// shape int32 (position in the bucket). Returns the CUDA error code.
extern "C" int bucket_max_v2(const void* q, const void* corpus, const void* qscale,
                             const void* cscale, const void* mask, void* out_val, void* out_pos,
                             int row_bytes, int is_int8, int batch, long long n_rows, int block,
                             void* stream) {
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (mask == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Params prm = make_params(batch, n_rows, block);
  prm.arm[0] = Arm{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(corpus),
                   static_cast<const float*>(qscale), static_cast<const float*>(cscale),
                   static_cast<float*>(out_val), static_cast<int*>(out_pos), row_bytes, is_int8};
  prm.mask_sel = static_cast<const uint8_t*>(mask);
  return launch<true>(prm, 1, static_cast<cudaStream_t>(stream));
}
