// Bucket tables for the candidate stage, hand-written for Hopper (sm_90a).
//
// Three entry points share one main loop:
//
//   section_tables — replaces the TPU kernel
//     `verbatim_rag_tpu/ops/section.py::_make_section_kernel` (pallas_call in
//     `section_bucket_tables`): up to three arms (dense, SPLADE sketch, ...) in
//     one launch, one packed table per arm, additive mask;
//   bucket_max_v2  — replaces `verbatim_rag_tpu/ops/fused_topk.py`
//     `_bucket_max_v2_onedot_kernel` / `_bucket_max_v2_chunked_kernel`
//     (pallas_call in `matmul_bucket_max_v2`): one corpus, the mask applied by
//     select, the table written unpacked as (value, position);
//   bucket_max_v1  — replaces `verbatim_rag_tpu/ops/fused_topk.py`
//     `_bucket_max_kernel` (pallas_call in `matmul_bucket_max`): buckets of
//     128 CONSECUTIVE rows, exact maximum and highest-lane argmax.
//
// section_tables and bucket_max_v2 compute, for query b and table column
// c = block·128 + lane, the maximum over positions p < block/128 of
//     pack(score(b, row), p)                  row = block·B + p·128 + lane,
// where pack overwrites the score's low 7 mantissa bits with p (the bits are
// cleared first), so one maximum carries value and position. The score is
//     int8 rows:    (float(int32 dot of the codes) * q_scale[b]) * c_scale[row]
//     bf16 rows:    the float32 dot (bf16 operands, f32 accumulate)
//     float32 rows: the float32 dot (FMA on the CUDA cores, never TF32)
// section_tables then adds mask_add[row] (0 or -1e30; no mask: nothing added);
// bucket_max_v2 replaces the packed value by -1e30 where mask[row] == 0. The
// running maximum starts at -1e30. The int8 path is bit-equal to the plain
// version: int32 sums are exact and each float operation is the same.
//
// bucket_max_v1 scores bf16 or float32 rows the same way (masked rows score
// exactly -1e30, by a select) and writes, for bucket g = row / 128, the
// maximum over the bucket's 128 lanes and the global row of the highest lane
// that holds it. Stage p of column block `block` is exactly bucket
// block·B/128 + p, so v1 is a third epilogue of the same walk: after each
// position the tile is reduced across lanes instead of folded into a running
// maximum per lane. The result does not depend on the block size.
//
// Layout: rows are row-major [N, d] (the TPU kernel wants transposed [d, N]
// copies for its MXU; here the corpus rows are B operands as they lie), d·elt
// a multiple of 16 bytes. bucket_max_v2 on int8 and bf16 rows runs on its own
// kernel, wgmma fed by TMA (`bucket_v2_wgmma_kernel`, described where it is
// defined). The other walks share this one: one CTA of 8 warps owns a tile of
// queries × 128 lanes of one column block and walks the block's positions:
//   - the query tile stays in shared memory for the whole walk;
//   - the corpus is streamed in stages of 128 rows × 128 bytes through a
//     3-deep cp.async ring;
//   - int8 and bf16 rows (MmaTile): 64 queries; each warp computes 16
//     queries × 64 lanes with mma.sync (m16n8k32 s8·s8→s32 for int8, m16n8k16
//     bf16→f32); in bytes both take the same fragments, so one shared-memory
//     layout (rows padded by 16 bytes: conflict-free 32-bit fragment loads)
//     serves both;
//   - float32 rows (FmaTile): 32 queries, so that a 768-wide query tile
//     (32 × 3,088 B) and the three stages fit the 227 KB a block may use;
//     warp w computes queries 4w..4w+3 against all 128 lanes, each thread 4
//     queries × lanes {l, l+32, l+64, l+96} with 16-byte shared loads
//     (conflict-free with the 144-byte row stride; the query loads are warp
//     broadcasts) and 64 FMAs per 8 loads;
//   - after the last stage of a position the accumulators are scaled, packed,
//     masked and folded into a running maximum held in registers (section,
//     v2), or reduced across the 128 lanes and written out (v1).
// Grid: x = query tiles (fastest, so the tiles of one column block run
// together and share its rows in L2), y = column blocks, z = arms.
//
// Bounds on an H100 SXM: at the serving point (B=512, N=1,007,616, dense 384
// + sketch 768 int8) 1.19 T int8 operations (0.60 ms at 1,979 TOP/s) against
// 1.17 GB of rows, scales and mask (0.35 ms at 3.35 TB/s), so operations bound
// it; the float32 arms at the same shape take 0.59 T multiply-adds, 17.8 ms
// at the 67 TFLOP/s CUDA-core rate. v1 at B=512, N=999,424, bf16: 0.80 ms
// (d=768) / 0.40 ms (d=384) of tensor-core operations against 1.54 / 0.77 GB.
// On the shared walk, mma.sync and an epilogue of ~10 instructions per score
// issued by the warps that issue the products keep the tensor-core kinds
// above that bound. The v2 wgmma kernel streams the rows by TMA and lets one
// warpgroup's epilogue run beside the other's products; section and v1 can
// move onto the same walk.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kLanes = 128;        // bucket width: table columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;        // bytes of a row per stage
constexpr int kPad = 16;           // shared-memory row padding
constexpr int kStageStride = kChunk + kPad;
constexpr int kStages = 3;
constexpr int kStageBytes = kLanes * kStageStride;
constexpr int kMaxArms = 3;
constexpr int kPosMask = 0x7F;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kV1ReduceBytes = 2 * 64 * 8;  // v1, MmaTile: two lane-warps' (value, lane) a query
constexpr float kNegInf = -1e30f;

enum Kind : int { kBf16 = 0, kInt8 = 1, kF32 = 2 };
enum Mode : int { kSection = 0, kBucketV2 = 1, kBucketV1 = 2 };

struct Arm {
  const uint8_t* q;       // [batch, d] int8 codes, bf16 or float32
  const uint8_t* corpus;  // [n_rows, d]
  const float* qscale;    // [batch] (int8 arms)
  const float* cscale;    // [n_rows] (int8 arms)
  float* out;             // section, v2: [batch, n_blocks·128]; v1: [batch, n_rows/128]
  int* out_pos;           // v2: position in the bucket; v1: global row (out's shape)
  int row_bytes;
  int kind;
};

struct Params {
  Arm arm[kMaxArms];
  const float* mask_add;   // section_tables: [n_rows] or null
  const uint8_t* mask_sel; // bucket_max_v1 / v2: [n_rows] 0/1
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

// v1's order on (value, lane): the larger value, then the higher lane.
__device__ __forceinline__ void keep_best(float& v, int& l, float ov, int ol) {
  if (ov > v || (ov == v && ol > l)) {
    v = ov;
    l = ol;
  }
}

__device__ __forceinline__ float masked(const Params& prm, long long row, float v) {
  return __ldg(prm.mask_sel + row) != 0 ? v : kNegInf;
}

__device__ __forceinline__ void write_v1(const Params& prm, const Arm& arm, int b,
                                         long long bucket, float v, int lane) {
  const long long idx = static_cast<long long>(b) * (prm.n_rows / kLanes) + bucket;
  arm.out[idx] = v;
  arm.out_pos[idx] = static_cast<int>(bucket * kLanes + lane);
}

// Tensor-core tile (int8 codes or bf16): 64 queries × 128 lanes, 8 warps as
// 4 (queries) × 2 (lanes), each warp 16 queries × 64 lanes. A thread's output
// (nt, i) is the m16n8 accumulator fragment's: query warp_q + g + 8·(i >> 1),
// lane warp_l + nt·8 + t·2 + (i & 1).
template <bool kInt8>
struct MmaTile {
  using Acc = std::conditional_t<kInt8, int, float>;
  static constexpr int kQueries = 64;
  static constexpr int kA = 8;
  static constexpr int kB = 4;

  Acc acc[kA][kB];
  float best[kA][kB];
  float qscale[2];
  int g, t, warp_q, warp_l;

  __device__ MmaTile(const Arm& arm, int q0, int batch) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    warp_q = (warp & 3) * 16;
    warp_l = (warp >> 2) * 64;
    for (int h = 0; h < 2; ++h) {
      const int b = q0 + warp_q + g + 8 * h;
      qscale[h] = kInt8 && b < batch ? arm.qscale[b] : 0.f;
    }
  }

  __device__ int query(int a, int b) const { return warp_q + g + 8 * (b >> 1); }
  __device__ int lane(int a, int b) const { return warp_l + a * 8 + t * 2 + (b & 1); }

  __device__ float score(const Arm& arm, int a, int b, long long row) const {
    if constexpr (kInt8) {
      return __fmul_rn(__fmul_rn(__int2float_rn(acc[a][b]), qscale[b >> 1]),
                       __ldg(arm.cscale + row));
    } else {
      return acc[a][b];
    }
  }

  // Accumulate `bytes` of every row: the stage against the query tile's
  // bytes [q_off, q_off + bytes). Bytes past a row are zero on both sides.
  __device__ void mac(const uint8_t* q_s, int q_stride, const uint8_t* stage, int q_off,
                      int bytes) {
    const int k_steps = (bytes + 31) / 32;
    for (int ks = 0; ks < k_steps; ++ks) {
      const uint8_t* qa = q_s + (warp_q + g) * q_stride + q_off + ks * 32 + t * 4;
      const uint32_t a0 = ld32(qa);
      const uint32_t a1 = ld32(qa + 8 * q_stride);
      const uint32_t a2 = ld32(qa + 16);
      const uint32_t a3 = ld32(qa + 8 * q_stride + 16);
#pragma unroll
      for (int nt = 0; nt < kA; ++nt) {
        const uint8_t* cb = stage + (warp_l + nt * 8 + g) * kStageStride + ks * 32 + t * 4;
        mma(acc[nt], a0, a1, a2, a3, ld32(cb), ld32(cb + 16));
      }
    }
  }

  // v1: reduce the 64 queries × 128 lanes of bucket `bucket` (rows
  // row0 .. row0 + 127) across lanes: within the thread, over the four
  // threads of a fragment row group, then across the two lane-warps through
  // shared memory.
  __device__ void reduce_v1(const Params& prm, const Arm& arm, long long row0, long long bucket,
                            int q0, uint8_t* red) {
    float* red_v = reinterpret_cast<float*>(red);
    int* red_l = reinterpret_cast<int*>(red + 2 * kQueries * 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bv = -__int_as_float(0x7f800000);
      int bl = -1;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int l = lane(a, 2 * h + e);
          keep_best(bv, bl, masked(prm, row0 + l, score(arm, a, 2 * h + e, row0 + l)), l);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
        keep_best(bv, bl, ov, ol);
      }
      if (t == 0) {
        const int slot = (warp_l / 64) * kQueries + warp_q + g + 8 * h;
        red_v[slot] = bv;
        red_l[slot] = bl;
      }
    }
    __syncthreads();
    const int r = threadIdx.x;
    if (r < kQueries && q0 + r < prm.batch) {
      float bv = red_v[r];
      int bl = red_l[r];
      keep_best(bv, bl, red_v[kQueries + r], red_l[kQueries + r]);
      write_v1(prm, arm, q0 + r, bucket, bv, bl);
    }
  }
};

// CUDA-core tile (float32 rows): 32 queries × 128 lanes. Warp w owns queries
// 4w..4w+3 against all 128 lanes; thread l of the warp owns output (a, b) =
// query 4w + a, lane l + 32·b.
struct FmaTile {
  static constexpr int kQueries = 32;
  static constexpr int kA = 4;
  static constexpr int kB = 4;

  float acc[kA][kB];
  float best[kA][kB];
  int qg, lg;

  __device__ FmaTile(const Arm&, int, int) {
    qg = threadIdx.x / 32;
    lg = threadIdx.x & 31;
  }

  __device__ int query(int a, int b) const { return qg * kA + a; }
  __device__ int lane(int a, int b) const { return lg + 32 * b; }
  __device__ float score(const Arm&, int a, int b, long long) const { return acc[a][b]; }

  __device__ void mac(const uint8_t* q_s, int q_stride, const uint8_t* stage, int q_off,
                      int bytes) {
    for (int k = 0; k < bytes; k += 16) {
      float4 qv[kA], cv[kB];
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        qv[a] = *reinterpret_cast<const float4*>(q_s + (qg * kA + a) * q_stride + q_off + k);
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        cv[b] = *reinterpret_cast<const float4*>(stage + (lg + 32 * b) * kStageStride + k);
      }
#pragma unroll
      for (int a = 0; a < kA; ++a) {
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          float s = acc[a][b];
          s = fmaf(qv[a].x, cv[b].x, s);
          s = fmaf(qv[a].y, cv[b].y, s);
          s = fmaf(qv[a].z, cv[b].z, s);
          acc[a][b] = fmaf(qv[a].w, cv[b].w, s);
        }
      }
    }
  }

  // v1: every lane of a query lives in one warp: reduce within the thread,
  // then over the warp with shuffles.
  __device__ void reduce_v1(const Params& prm, const Arm& arm, long long row0, long long bucket,
                            int q0, uint8_t*) {
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      float bv = -__int_as_float(0x7f800000);
      int bl = -1;
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        keep_best(bv, bl, masked(prm, row0 + lane(a, b), acc[a][b]), lane(a, b));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
        keep_best(bv, bl, ov, ol);
      }
      const int b = q0 + query(a, 0);
      if (lg == 0 && b < prm.batch) write_v1(prm, arm, b, bucket, bv, bl);
    }
  }
};

// One arm's tile: Tile::kQueries queries × 128 lanes of column block `blk`.
template <class Tile, int kMode>
__device__ __forceinline__ void run_tile(const Params& prm, const Arm& arm, int blk,
                                         uint8_t* smem) {
  const int q0 = blockIdx.x * Tile::kQueries;
  if (q0 >= prm.batch) return;  // a narrower tile of another arm sized the grid
  const int tid = threadIdx.x;
  const int row_bytes = arm.row_bytes;
  const int padded = (row_bytes + kChunk - 1) / kChunk * kChunk;
  const int q_stride = padded + kPad;
  uint8_t* q_s = smem;
  uint8_t* stages = smem + Tile::kQueries * q_stride;
  uint8_t* red = stages + kStages * kStageBytes;

  const int n_chunks = padded / kChunk;
  const int n_pos = prm.block / kLanes;
  const int total = n_pos * n_chunks;
  const long long block_row0 = static_cast<long long>(blk) * prm.block;

  // Query tile: rows past the batch and bytes past the row are zero.
  const int q_pieces = padded / 16;
  for (int i = tid; i < Tile::kQueries * q_pieces; i += kThreads) {
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

  Tile tile(arm, q0, prm.batch);
#pragma unroll
  for (int a = 0; a < Tile::kA; ++a) {
#pragma unroll
    for (int b = 0; b < Tile::kB; ++b) {
      tile.acc[a][b] = 0;
      tile.best[a][b] = kNegInf;
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

    const int left = row_bytes - chunk * kChunk;
    tile.mac(q_s, q_stride, stages + (it % kStages) * kStageBytes, chunk * kChunk,
             left < kChunk ? left : kChunk);

    if (++chunk == n_chunks) {
      const long long row0 = block_row0 + p * kLanes;
      if constexpr (kMode == kBucketV1) {
        tile.reduce_v1(prm, arm, row0, block_row0 / kLanes + p, q0, red);
      } else {
        // Position p: scale, pack, mask, running maximum.
#pragma unroll
        for (int a = 0; a < Tile::kA; ++a) {
#pragma unroll
          for (int b = 0; b < Tile::kB; ++b) {
            const long long row = row0 + tile.lane(a, b);
            float v = tile.score(arm, a, b, row);
            v = __int_as_float((__float_as_int(v) & ~kPosMask) | p);
            if constexpr (kMode == kBucketV2) {
              if (__ldg(prm.mask_sel + row) == 0) v = kNegInf;
            } else if (prm.mask_add != nullptr) {
              v = __fadd_rn(v, __ldg(prm.mask_add + row));
            }
            tile.best[a][b] = fmaxf(tile.best[a][b], v);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < Tile::kA; ++a) {
#pragma unroll
        for (int b = 0; b < Tile::kB; ++b) tile.acc[a][b] = 0;
      }
      chunk = 0;
      ++p;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if constexpr (kMode == kBucketV1) return;

  const long long width = static_cast<long long>(prm.n_blocks) * kLanes;
#pragma unroll
  for (int a = 0; a < Tile::kA; ++a) {
#pragma unroll
    for (int b = 0; b < Tile::kB; ++b) {
      const int bq = q0 + tile.query(a, b);
      if (bq >= prm.batch) continue;
      const long long col = static_cast<long long>(blk) * kLanes + tile.lane(a, b);
      const long long idx = static_cast<long long>(bq) * width + col;
      if constexpr (kMode == kBucketV2) {
        const int bits = __float_as_int(tile.best[a][b]);
        arm.out[idx] = __int_as_float(bits & ~kPosMask);
        arm.out_pos[idx] = bits & kPosMask;
      } else {
        arm.out[idx] = tile.best[a][b];
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) bucket_tables_kernel(const Params prm) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Arm& arm = prm.arm[blockIdx.z];
  const int blk = blockIdx.y;
  if (arm.kind == kF32) {
    run_tile<FmaTile, kMode>(prm, arm, blk, smem);
  } else if constexpr (kMode != kBucketV2) {  // v2's int8 and bf16 rows: bucket_v2_wgmma_kernel
    if (arm.kind == kBf16) {
      run_tile<MmaTile<false>, kMode>(prm, arm, blk, smem);
    } else if constexpr (kMode != kBucketV1) {  // v1 takes no int8 rows
      run_tile<MmaTile<true>, kMode>(prm, arm, blk, smem);
    }
  }
}

int tile_queries(int kind) { return kind == kF32 ? FmaTile::kQueries : MmaTile<false>::kQueries; }

int smem_bytes(int kind, int row_bytes, int mode) {
  const int padded = (row_bytes + kChunk - 1) / kChunk * kChunk;
  const int reduce = mode == kBucketV1 && kind != kF32 ? kV1ReduceBytes : 0;
  return tile_queries(kind) * (padded + kPad) + kStages * kStageBytes + reduce;
}

template <int kMode>
int launch(const Params& prm, int n_arms, cudaStream_t stream) {
  int smem = 0;
  int rows_per_tile = MmaTile<false>::kQueries;
  for (int a = 0; a < n_arms; ++a) {
    const Arm& arm = prm.arm[a];
    const int rb = arm.row_bytes;
    if (rb <= 0 || rb % 16 != 0 || arm.kind < kBf16 || arm.kind > kF32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (arm.kind == kInt8 &&
        (kMode == kBucketV1 || arm.qscale == nullptr || arm.cscale == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = smem_bytes(arm.kind, rb, kMode) > smem ? smem_bytes(arm.kind, rb, kMode) : smem;
    rows_per_tile = tile_queries(arm.kind) < rows_per_tile ? tile_queries(arm.kind) : rows_per_tile;
  }
  const bool packed = kMode != kBucketV1;
  if (smem > kMaxSmem || prm.block <= 0 || prm.block % kLanes != 0 ||
      (packed && prm.block / kLanes > kPosMask + 1) || prm.n_rows % prm.block != 0 ||
      prm.n_blocks > 65535 || (kMode != kSection && prm.mask_sel == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(bucket_tables_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((prm.batch + rows_per_tile - 1) / rows_per_tile, prm.n_blocks, n_arms);
  bucket_tables_kernel<kMode><<<grid, kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// ---- bucket-max v2 on int8 and bf16 rows: wgmma fed by TMA -----------------------------
//
// One CTA of 288 threads (two consumer warpgroups and one TMA producer warp)
// owns `queries` (128 or 64) queries × the 128 lanes of one column block and
// walks the block's positions p. The query tile is loaded once and stays in
// shared memory as ceil(row_bytes / 128) chunks of [queries][128 B]; the
// position's 128 rows stream through a ring of `stages` 16 KB stages
// (128 rows × 128 bytes, one chunk), each with a full and an empty mbarrier.
// Per position the producer also bulk-copies the rows' mask bytes and, for
// int8, their c_scale into a side slot (4 slots, own barriers), so the
// epilogue reads them from shared memory.
//   queries = 128: warpgroup w takes queries 64w..64w+63 against every
//     position; both read each stage, which is free after 256 arrivals;
//   queries = 64 (rows too wide for a 128-query tile beside a 4-deep ring,
//     such as bf16 d = 768): warpgroup 0 walks alone through the whole ring.
//     Splitting the positions between the warpgroups (each through half the
//     ring: a warpgroup must meet its stages in order, as an mbarrier's parity
//     wait cannot tell a phase from the one two later) measured slower:
//     half of a 7-stage ring cannot hide the loads of 12-chunk positions.
// Each position is one accumulator of 64 queries × 128 lanes (wgmma m64n128,
// k32 s8·s8→s32 or k16 bf16→f32, both operands K-major: the queries' and
// rows' bytes are the contraction), issued one chunk (4 k-steps) a commit; a
// stage is released as soon as the products of the next chunk are in
// flight, and ring slots and phases are counted, not divided out (a runtime
// % and / a chunk measured costly). At d = 384-768 a position is
// only 3-12 chunks, so each warpgroup's drain (wgmma.wait 0) and epilogue at
// every position are what keep the tensor cores from their rate. Measured
// slower, and so not taken: the query tiles of a column block as one
// cluster; the warpgroups taking turns to issue (ping-pong: one waits for
// the other's whole mainloop); two accumulators per warpgroup issuing the
// next position before the epilogue (past 168 registers, so no producer
// warp: loads issued from inside a consumer warpgroup starve the ring).
constexpr int kV2Consumers = 2 * hopper::kWarpgroup;
constexpr int kV2Threads = kV2Consumers + 32;
constexpr int kV2StageBytes = kLanes * kChunk;       // 128 rows × 128 bytes
constexpr int kV2Side = 4;                           // positions of side data in flight
constexpr int kV2SideBytes = kLanes * 4 + kLanes;    // c_scale [128] float32, then mask [128]
constexpr int kV2MaxStages = 8;

int v2_smem_bytes(int queries, int n_chunks, int stages) {
  return n_chunks * queries * kChunk + stages * kV2StageBytes + kV2Side * kV2SideBytes +
         (1 + 2 * stages + 2 * kV2Side) * 8 + 1024;  // + barriers, + alignment slack
}

template <bool kInt8>
__global__ void __launch_bounds__(kV2Threads, 1)
bucket_v2_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap x_map,
                       const float* __restrict__ qscale, const float* __restrict__ cscale,
                       const uint8_t* __restrict__ mask, float* __restrict__ out,
                       int* __restrict__ out_pos, int batch, int block, int n_blocks,
                       int n_chunks, int queries, int stages) {
  using namespace hopper;
  using Acc = std::conditional_t<kInt8, int, float>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base_1024(smem_raw);
  const int q_chunk_bytes = queries * kChunk;
  uint8_t* q_tile = smem;                                  // chunk c at c · q_chunk_bytes
  uint8_t* ring = smem + n_chunks * q_chunk_bytes;         // stage s at s · kV2StageBytes
  uint8_t* side = ring + stages * kV2StageBytes;           // slot j at j · kV2SideBytes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(side + kV2Side * kV2SideBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + stages;
  uint64_t* side_full = empty + stages;
  uint64_t* side_empty = side_full + kV2Side;

  const bool split = queries == 128;  // else warpgroup 0 walks alone
  const int q0 = blockIdx.x * queries;
  const int n_pos = block / kLanes;
  const long long block_row0 = static_cast<long long>(blockIdx.y) * block;

  if (threadIdx.x == 0) {
    const int consumers = split ? kV2Consumers : kWarpgroup;  // arrivals that free a slot
    mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    for (int j = 0; j < kV2Side; ++j) {
      mbar_init(&side_full[j], 1);
      mbar_init(&side_empty[j], consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kV2Consumers) {
    // Producer: the query tile, then per position its side data and chunks.
    if (threadIdx.x == kV2Consumers) {
      mbar_arrive_expect_tx(q_full, n_chunks * q_chunk_bytes);
      for (int c = 0; c < n_chunks; ++c)
        tma_load_rows(q_tile + c * q_chunk_bytes, &q_map, q_full, c * kChunk, q0);
      const uint32_t side_tx = (kInt8 ? kLanes * 4 : 0) + kLanes;
      int next = 0;  // the ring's next slot, and how many times it has gone round
      uint32_t lap = 0;
      for (int p = 0; p < n_pos; ++p) {
        const long long row0 = block_row0 + static_cast<long long>(p) * kLanes;
        const int j = p % kV2Side;
        if (p >= kV2Side) mbar_wait(&side_empty[j], ((p / kV2Side) - 1) & 1);
        mbar_arrive_expect_tx(&side_full[j], side_tx);
        uint8_t* slot = side + j * kV2SideBytes;
        if (kInt8) bulk_load(slot, cscale + row0, kLanes * 4, &side_full[j]);
        bulk_load(slot + kLanes * 4, mask + row0, kLanes, &side_full[j]);
        for (int c = 0; c < n_chunks; ++c) {
          const int s = next;
          if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
          mbar_arrive_expect_tx(&full[s], kV2StageBytes);
          tma_load_rows(ring + s * kV2StageBytes, &x_map, &full[s], c * kChunk,
                        static_cast<int>(row0));
          if (++next == stages) {
            next = 0;
            ++lap;
          }
        }
      }
    }
    return;
  }

  // Consumers: this thread holds queries wq + r and wq + r + 8 of the tile
  // and lanes 8j + 2t + {0, 1} (the accumulator layout, see hopper.cuh).
  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 1 && !split) return;  // 64 queries: warpgroup 0 walks alone
  const int tw = threadIdx.x % kWarpgroup;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int wq = split ? 64 * wg : 0;
  const int r = tw / 32 * 16 + g;
  float qs[2] = {0.f, 0.f};
  if constexpr (kInt8) {
    for (int h = 0; h < 2; ++h) {
      const int b = q0 + wq + r + 8 * h;
      qs[h] = b < batch ? qscale[b] : 0.f;
    }
  }
  Acc acc[64];
  float best[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) best[x] = kNegInf;

  mbar_wait(q_full, 0);
  const uint64_t q_desc = desc_sw128(q_tile + wq * kChunk);
  int next = 0, prev = 0;  // this warpgroup's next stage of its ring, the one before
  uint32_t lap = 0;
  for (int p = 0; p < n_pos; ++p) {
    for (int c = 0; c < n_chunks; ++c) {
      const int s = next;
      mbar_wait(&full[s], lap & 1);
      const uint64_t a = q_desc + static_cast<uint64_t>((c * q_chunk_bytes) >> 4);
      const uint64_t x = desc_sw128(ring + s * kV2StageBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 32; ++ks) {
        if constexpr (kInt8)
          wgmma_m64n128k32_s8_ss(acc, a + ks * kDescKStep, x + ks * kDescKStep, c | ks);
        else
          wgmma_m64n128k16_ss(acc, a + ks * kDescKStep, x + ks * kDescKStep, c | ks);
      }
      wgmma_commit();
      if (c > 0) {  // the previous chunk's products are done: free its stage
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++next == stages) {
        next = 0;
        ++lap;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[prev]);

    // Position p: scale, pack, mask, running maximum (the float operations
    // and order of the plain version, so int8 tables are bit-equal).
    const int j = p % kV2Side;
    mbar_wait(&side_full[j], (p / kV2Side) & 1);
    const uint8_t* slot = side + j * kV2SideBytes;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + 2 * t;
      const uint32_t m2 = *reinterpret_cast<const uint16_t*>(slot + kLanes * 4 + col);
      float2 c2 = make_float2(0.f, 0.f);
      if constexpr (kInt8) c2 = *reinterpret_cast<const float2*>(slot + col * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * n + e;
        float v;
        if constexpr (kInt8)
          v = __fmul_rn(__fmul_rn(__int2float_rn(acc[x]), qs[e >> 1]), e & 1 ? c2.y : c2.x);
        else
          v = acc[x];
        v = __int_as_float((__float_as_int(v) & ~kPosMask) | p);
        // A masked row would fold in -1e30, which best never falls below.
        if ((m2 >> (8 * (e & 1))) & 0xFFu) best[x] = fmaxf(best[x], v);
      }
    }
    mbar_arrive(&side_empty[j]);
  }

  const long long width = static_cast<long long>(n_blocks) * kLanes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = q0 + wq + r + 8 * h;
    if (b >= batch) continue;
    const long long row_base = static_cast<long long>(b) * width + blockIdx.y * kLanes + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int b0 = __float_as_int(best[4 * n + 2 * h]);
      const int b1 = __float_as_int(best[4 * n + 2 * h + 1]);
      *reinterpret_cast<float2*>(out + row_base + 8 * n) =
          make_float2(__int_as_float(b0 & ~kPosMask), __int_as_float(b1 & ~kPosMask));
      *reinterpret_cast<int2*>(out_pos + row_base + 8 * n) =
          make_int2(b0 & kPosMask, b1 & kPosMask);
    }
  }
}

int launch_v2_wgmma(const void* q, const void* corpus, const void* qscale, const void* cscale,
                    const void* mask, void* out, void* out_pos, int row_bytes, int kind, int batch,
                    long long n_rows, int block, int queries, int stages, cudaStream_t stream) {
  const int n_chunks = (row_bytes + kChunk - 1) / kChunk;
  const int smem = v2_smem_bytes(queries, n_chunks, stages);
  const bool int8 = kind == kInt8;
  if (row_bytes <= 0 || row_bytes % 16 != 0 || (queries != 64 && queries != 128) ||
      stages < 2 || stages > kV2MaxStages || smem > kMaxSmem || block <= 0 ||
      block % kLanes != 0 || block / kLanes > kPosMask + 1 || n_rows % block != 0 ||
      n_rows / block > 65535 || n_rows >= (1ll << 31) || mask == nullptr ||
      (int8 && (qscale == nullptr || cscale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(corpus) |
       reinterpret_cast<uintptr_t>(cscale) | reinterpret_cast<uintptr_t>(mask)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  CUtensorMap q_map, x_map;
  if (int rc = hopper::make_rows_map(&q_map, q, batch, row_bytes, queries)) return rc;
  if (int rc = hopper::make_rows_map(&x_map, corpus, n_rows, row_bytes, kLanes)) return rc;
  const void* kernel = int8 ? reinterpret_cast<const void*>(bucket_v2_wgmma_kernel<true>)
                            : reinterpret_cast<const void*>(bucket_v2_wgmma_kernel<false>);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_blocks = static_cast<int>(n_rows / block);
  const dim3 grid((batch + queries - 1) / queries, n_blocks);
  const float* qs = static_cast<const float*>(qscale);
  const float* cs = static_cast<const float*>(cscale);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* ov = static_cast<float*>(out);
  int* op = static_cast<int*>(out_pos);
  if (int8)
    bucket_v2_wgmma_kernel<true><<<grid, kV2Threads, smem, stream>>>(
        q_map, x_map, qs, cs, mk, ov, op, batch, block, n_blocks, n_chunks, queries, stages);
  else
    bucket_v2_wgmma_kernel<false><<<grid, kV2Threads, smem, stream>>>(
        q_map, x_map, qs, cs, mk, ov, op, batch, block, n_blocks, n_chunks, queries, stages);
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

Arm make_arm(const void* q, const void* corpus, const void* qscale, const void* cscale, void* out,
             void* out_pos, int row_bytes, int kind) {
  return Arm{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(corpus),
             static_cast<const float*>(qscale), static_cast<const float*>(cscale),
             static_cast<float*>(out), static_cast<int*>(out_pos), row_bytes, kind};
}

}  // namespace

// Row kinds: 0 = bf16, 1 = int8 codes, 2 = float32.
//
// Per arm a < n_arms: q[a] [batch, d_a] and corpus[a] [n_rows, d_a] of kind
// kind[a], qscale[a] [batch] and cscale[a] [n_rows] float32 for int8 arms,
// out[a] [batch, n_rows/block·128] float32; mask_add [n_rows] float32 or
// null. All contiguous. Returns the CUDA error code of the launch.
extern "C" int section_tables(int n_arms, const void* const* q, const void* const* corpus,
                              const void* const* qscale, const void* const* cscale,
                              void* const* out, const int* row_bytes, const int* kind,
                              const void* mask_add, int batch, long long n_rows, int block,
                              void* stream) {
  if (n_arms < 1 || n_arms > kMaxArms) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  Params prm = make_params(batch, n_rows, block);
  for (int a = 0; a < n_arms; ++a) {
    prm.arm[a] = make_arm(q[a], corpus[a], qscale[a], cscale[a], out[a], nullptr, row_bytes[a],
                          kind[a]);
  }
  prm.mask_add = static_cast<const float*>(mask_add);
  return launch<kSection>(prm, n_arms, static_cast<cudaStream_t>(stream));
}

// q [batch, d], corpus [n_rows, d] of `kind`, qscale [batch] / cscale
// [n_rows] float32 for int8, mask [n_rows] bool; out_val [batch,
// n_rows/block·128] float32 (low 7 bits cleared), out_pos the same shape
// int32 (position in the bucket). int8 and bf16 rows run on wgmma with a
// tile of `queries` (64 or 128) and a ring of `stages` (2-8); q, corpus,
// cscale and mask 16-byte aligned. float32 rows take the FMA tile and ignore
// both. Returns the CUDA error code.
extern "C" int bucket_max_v2(const void* q, const void* corpus, const void* qscale,
                             const void* cscale, const void* mask, void* out_val, void* out_pos,
                             int row_bytes, int kind, int batch, long long n_rows, int block,
                             int queries, int stages, void* stream) {
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (kind == kInt8 || kind == kBf16) {
    return launch_v2_wgmma(q, corpus, qscale, cscale, mask, out_val, out_pos, row_bytes, kind,
                           batch, n_rows, block, queries, stages,
                           static_cast<cudaStream_t>(stream));
  }
  Params prm = make_params(batch, n_rows, block);
  prm.arm[0] = make_arm(q, corpus, qscale, cscale, out_val, out_pos, row_bytes, kind);
  prm.mask_sel = static_cast<const uint8_t*>(mask);
  return launch<kBucketV2>(prm, 1, static_cast<cudaStream_t>(stream));
}

// q [batch, d], corpus [n_rows, d] bf16 (kind 0) or float32 (kind 2), mask
// [n_rows] bool; out_val [batch, n_rows/128] float32 (each bucket's
// maximum, -1e30 where all its rows are masked), out_row the same shape int32
// (global row of the highest lane holding it). `block` (a 128-multiple that
// divides n_rows) only sets the work per CTA. Returns the CUDA error code.
extern "C" int bucket_max_v1(const void* q, const void* corpus, const void* mask, void* out_val,
                             void* out_row, int row_bytes, int kind, int batch, long long n_rows,
                             int block, void* stream) {
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  Params prm = make_params(batch, n_rows, block);
  prm.arm[0] = make_arm(q, corpus, nullptr, nullptr, out_val, out_row, row_bytes, kind);
  prm.mask_sel = static_cast<const uint8_t*>(mask);
  return launch<kBucketV1>(prm, 1, static_cast<cudaStream_t>(stream));
}
