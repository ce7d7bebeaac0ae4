// Bucket tables for the candidate stage, hand-written for Hopper (sm_90a).
//
// Three entry points share one function family:
//
//   section_tables — replaces the TPU kernel
//     `verbatim_rag_tpu/ops/section.py::_make_section_kernel` (pallas_call in
//     `section_bucket_tables`): up to three arms (dense, SPLADE sketch, ...) in
//     one call, one packed table per arm, additive mask;
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
// that holds it. Position p of column block `block` is exactly bucket
// block·B/128 + p, so v1 is a third epilogue of the same walk: after each
// position the tile is reduced across lanes instead of folded into a running
// maximum per lane. The result does not depend on the block size, and nothing
// is packed, so a block may hold more than 128 positions.
//
// Layout: rows are row-major [N, d] (the TPU kernel wants transposed [d, N]
// copies for its MXU; here the corpus rows are B operands as they lie), d·elt
// a multiple of 16 bytes. One CTA owns a tile of queries × the 128 lanes of
// one column block and walks the block's positions. Grid: x = query tiles
// (fastest, so the tiles of one column block run together and share its rows
// in L2), y = column blocks, z = section arms. Two walks:
//   - int8 and bf16 rows: the wgmma walk (`table_walk`, described where it is
//     defined), behind three kernels, one a mode: `section_wgmma_kernel`,
//     `bucket_v2_wgmma_kernel` (both int8 and bf16) and
//     `bucket_v1_wgmma_kernel` (bf16), and their twins for rows past 2944
//     bytes, whose query tile streams (`section_streamed_kernel`,
//     `bucket_v2_streamed_kernel`, `bucket_v1_streamed_kernel`). TMA streams
//     the rows, a producer warp keeps the ring full, wgmma m64n128 takes
//     them from shared memory, and one warpgroup's epilogue runs beside the
//     other's products. A section_tables call launches once for each row
//     kind and layout among its arms.
//   - float32 rows: the FMA walk (`fma_walk_kernel`, one kernel a mode,
//     described where it is defined): a producer warp streams rows and
//     queries by TMA through a counted ring, eight consumer warps hold 128
//     queries × 128 lanes as 8 × 8 tiles a thread, on the CUDA cores.
//
// Bounds on an H100 SXM: at the serving point (B=512, N=1,007,616, dense 384
// + sketch 768 int8) 1.19 T int8 operations (0.60 ms at 1,979 TOP/s) against
// 1.17 GB of rows, scales and mask (0.35 ms at 3.35 TB/s), so operations bound
// it; the float32 arms at the same shape take 0.59 T multiply-adds, 17.7 ms
// at the 67 TFLOP/s CUDA-core rate (operations bound them too). v1 at B=512, N=999,424, bf16: 0.80 ms
// (d=768) / 0.40 ms (d=384) of tensor-core operations against 1.54 / 0.77 GB.
// On the wgmma walk a position is only 3-12 chunks at d = 384-768, so each
// warpgroup's drain and epilogue at every position keep the tensor cores
// from their rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kLanes = 128;        // bucket width: table columns per block
constexpr int kChunk = 128;        // bytes of a row per stage
constexpr int kMaxArms = 3;
constexpr int kPosMask = 0x7F;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr float kNegInf = -1e30f;

enum Kind : int { kBf16 = 0, kInt8 = 1, kF32 = 2 };
enum Mode : int { kSection = 0, kBucketV2 = 1, kBucketV1 = 2 };

// v1's order on (value, lane): the larger value, then the higher lane.
__device__ __forceinline__ void keep_best(float& v, int& l, float ov, int ol) {
  if (ov > v || (ov == v && ol > l)) {
    v = ov;
    l = ol;
  }
}

// ---- the wgmma walk: int8 and bf16 rows, fed by TMA ------------------------------------
//
// One CTA of 288 threads (two consumer warpgroups and one TMA producer warp)
// owns `queries` (128 or 64) queries × the 128 lanes of one column block and
// walks the block's positions p. Two layouts, by the row width:
//   resident (rows of up to kWalkResidentChunks chunks, 2944 bytes): the
//     query tile is loaded once and stays in shared memory as
//     ceil(row_bytes / 128) chunks of [queries][128 B]; the position's 128
//     rows stream through a ring of `stages` 16 KB stages (128 rows × 128
//     bytes, one chunk), each with a full and an empty mbarrier;
//   streamed (wider rows, whose tile would not fit beside a 2-stage ring):
//     a stage holds a chunk of the rows and the same chunk of the queries,
//     [128 rows][128 B] then [queries][128 B] (32 KB at 128 queries), both
//     TMA boxes counted against the stage's full barrier, as the FMA walk
//     streams its float32 queries. The query tile is read again from L2 at
//     every position; the A operand's descriptor is the stage's. A row of
//     any width fits: the ring is counted in whole stages, and TMA fills a
//     ragged last chunk past the row's end with zeros, which add nothing to
//     a dot.
//     On an H100 SXM at 700 W (B=512, N=1,048,576, one int8 arm) the
//     streamed 3072-byte rows took 3.1 ms, 53% of their bound, and the
//     resident 2944-byte ones (64 queries, 2 stages) 9.3 ms.
// Per position the producer also bulk-copies the rows' side data into a side
// slot (4 slots, own barriers), so the epilogue reads it from shared memory:
// c_scale for int8, then the mask (v2, v1: its bytes; section: mask_add as
// float32, none when the call has no mask).
//   queries = 128 (narrow resident rows, and every streamed row): warpgroup
//     w takes queries 64w..64w+63 against every position; both read each
//     stage, which is free after 256 arrivals;
//   queries = 64 (resident rows too wide for a 128-query tile beside a
//     4-deep ring, such as bf16 d = 768): warpgroup 0 walks alone through
//     the whole ring.
//     Splitting the positions between the warpgroups (each through half the
//     ring: a warpgroup must meet its stages in order, as an mbarrier's parity
//     wait cannot tell a phase from the one two later) measured slower:
//     half of a 7-stage ring cannot hide the loads of 12-chunk positions.
// Each position is one accumulator of 64 queries × 128 lanes (wgmma m64n128,
// k32 s8·s8→s32 or k16 bf16→f32, both operands K-major: the queries' and
// rows' bytes are the contraction), issued one chunk (4 k-steps) a commit; a
// stage is released as soon as the products of the next chunk are in
// flight, and ring slots and phases are counted, not divided out (a runtime
// % and / a chunk measured costly). After the drain (wgmma.wait 0) the
// position's epilogue runs on the accumulator:
//   section, v2: scale, pack, mask and fold into a running maximum per
//     (query, lane) held in registers, written once at the end;
//   v1: each thread reduces its 32 lanes of its two queries to (value, lane)
//     in four independent chains a query (one serial chain of 32
//     compare-selects measured 4-8% slower at d = 768 / 384); a query's 128
//     lanes live in one quad (hopper.cuh's accumulator layout), so two
//     shuffle rounds finish the bucket, and the quad's first thread writes
//     it (4-byte stores at a stride of N/128 floats).
// A section call's arms share one grid: blockIdx.z is the arm, each arm has
// its own maps, tile and ring, the grid's x is sized for the narrowest tile
// and a CTA past its arm's batch exits. Measured slower, and so not taken:
// the query tiles of a column block as one cluster; the warpgroups taking
// turns to issue (ping-pong: one waits for the other's whole mainloop); two
// accumulators per warpgroup issuing the next position before the epilogue
// (past 168 registers, so no producer warp: loads issued from inside a
// consumer warpgroup starve the ring).
constexpr int kWalkConsumers = 2 * hopper::kWarpgroup;
constexpr int kWalkThreads = kWalkConsumers + 32;
constexpr int kWalkStageBytes = kLanes * kChunk;  // 128 rows × 128 bytes
constexpr int kWalkSide = 4;                      // positions of side data in flight
constexpr int kWalkMaxStages = 8;
// Rows of up to this many 128-byte chunks (2944 bytes) keep the query tile
// resident (64 queries beside a 2-stage ring); wider rows stream it.
constexpr int kWalkResidentChunks = 23;
// A side slot: c_scale [128] float32 (int8 rows), then the mask: v2 and v1
// its bytes [128], section mask_add [128] float32.
constexpr int kSideBytesV2 = 640;
constexpr int kSideBytesSection = 1024;
static_assert(kSideBytesV2 == kLanes * 4 + kLanes && kSideBytesSection == kLanes * 8,
              "side slot layout");

__host__ __device__ constexpr int side_bytes(int mode) {
  return mode == kSection ? kSideBytesSection : kSideBytesV2;
}

__host__ __device__ constexpr bool walk_streams(int n_chunks) {
  return n_chunks > kWalkResidentChunks;
}

// A ring stage: the rows' chunk, and for a streamed tile the queries' chunk.
__host__ __device__ constexpr int walk_stage_bytes(int queries, int n_chunks) {
  return kWalkStageBytes + (walk_streams(n_chunks) ? queries * kChunk : 0);
}

constexpr int walk_smem_bytes(int mode, int queries, int n_chunks, int stages) {
  return (walk_streams(n_chunks) ? 0 : n_chunks * queries * kChunk) +
         stages * walk_stage_bytes(queries, n_chunks) + kWalkSide * side_bytes(mode) +
         (1 + 2 * stages + 2 * kWalkSide) * 8 + 1024;  // + barriers, + alignment slack
}
static_assert(walk_smem_bytes(kSection, 64, kWalkResidentChunks, 2) <= kMaxSmem &&
                  (kWalkResidentChunks + 1) * 64 * kChunk + 2 * kWalkStageBytes +
                          kWalkSide * kSideBytesV2 + (1 + 4 + 2 * kWalkSide) * 8 + 1024 >
                      kMaxSmem,
              "the widest resident tile: 64 queries beside a 2-stage ring");
static_assert(walk_smem_bytes(kSection, 128, kWalkResidentChunks + 1, 6) <= kMaxSmem,
              "a streamed 128-query tile beside a 6-stage ring");

struct WalkArm {
  CUtensorMap q_map;    // queries [batch, row_bytes] at their pitch: boxes of 128 B × `queries` rows
  CUtensorMap x_map;    // rows [n_rows, row_bytes] at their pitch: boxes of 128 B × 128 rows
  const float* qscale;  // [batch] (int8)
  const float* cscale;  // [n_rows] (int8)
  float* out;           // section, v2: [batch, n_blocks·128]; v1: [batch, n_rows/128]
  int* out_pos;         // v2: position in the bucket; v1: global row (out's shape)
  int n_chunks;         // ceil(row_bytes / 128)
  int queries;          // 128 or 64
  int stages;           // ring depth, 2-8
};

struct WalkParams {
  WalkArm arm[kMaxArms];
  const void* mask;  // v2, v1: [n_rows] bytes; section: mask_add [n_rows] float32 or null
  int batch;
  int block;
  int n_blocks;
};

// kStreamed: the launch's arms all stream their query tile (rows past
// kWalkResidentChunks chunks) or none does; the resident kernels are
// compiled without the streamed layout's code (a runtime choice cost them
// 6-8% on an H100, in an A/B against the resident-only walk).
template <int kMode, bool kInt8, bool kStreamed>
__device__ __forceinline__ void table_walk(const WalkParams& prm) {
  using namespace hopper;
  using Acc = std::conditional_t<kInt8, int, float>;
  constexpr int kSide = side_bytes(kMode);
  constexpr int kMaskBytes = kMode == kSection ? kLanes * 4 : kLanes;
  const WalkArm& arm = prm.arm[kMode == kSection ? blockIdx.z : 0];
  const int queries = arm.queries;
  const int q0 = blockIdx.x * queries;
  if (kMode == kSection && q0 >= prm.batch) return;  // another arm's narrower tile sized the grid
  const int n_chunks = arm.n_chunks;
  const int stages = arm.stages;
  const bool has_mask = kMode != kSection || prm.mask != nullptr;
  constexpr bool streamed = kStreamed;  // the query tile rides in the ring

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base_1024(smem_raw);
  const int q_chunk_bytes = queries * kChunk;
  const int stage_bytes = streamed ? kWalkStageBytes + q_chunk_bytes : kWalkStageBytes;  // 1024-multiples
  uint8_t* q_tile = smem;                                  // resident: chunk c at c · q_chunk_bytes
  uint8_t* ring = smem + (streamed ? 0 : n_chunks * q_chunk_bytes);  // stage s at s · stage_bytes
  uint8_t* side = ring + stages * stage_bytes;             // slot j at j · kSide
  uint64_t* q_full = reinterpret_cast<uint64_t*>(side + kWalkSide * kSide);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + stages;
  uint64_t* side_full = empty + stages;
  uint64_t* side_empty = side_full + kWalkSide;

  const bool split = queries == 128;  // else warpgroup 0 walks alone
  const int n_pos = prm.block / kLanes;
  const long long block_row0 = static_cast<long long>(blockIdx.y) * prm.block;

  if (threadIdx.x == 0) {
    const int consumers = split ? kWalkConsumers : kWarpgroup;  // arrivals that free a slot
    mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    for (int j = 0; j < kWalkSide; ++j) {
      mbar_init(&side_full[j], 1);
      mbar_init(&side_empty[j], consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWalkConsumers) {
    // Producer: the resident query tile, then per position its side data and
    // chunks (a streamed tile's chunk beside each of the rows').
    if (threadIdx.x == kWalkConsumers) {
      if (!streamed) {
        mbar_arrive_expect_tx(q_full, n_chunks * q_chunk_bytes);
        for (int c = 0; c < n_chunks; ++c)
          tma_load_rows(q_tile + c * q_chunk_bytes, &arm.q_map, q_full, c * kChunk, q0);
      }
      const uint8_t* mask = static_cast<const uint8_t*>(prm.mask);
      const uint32_t side_tx = (kInt8 ? kLanes * 4 : 0) + (has_mask ? kMaskBytes : 0);
      int next = 0;  // the ring's next slot, and how many times it has gone round
      uint32_t lap = 0;
      for (int p = 0; p < n_pos; ++p) {
        const long long row0 = block_row0 + static_cast<long long>(p) * kLanes;
        const int j = p % kWalkSide;
        if (p >= kWalkSide) mbar_wait(&side_empty[j], ((p / kWalkSide) - 1) & 1);
        mbar_arrive_expect_tx(&side_full[j], side_tx);
        uint8_t* slot = side + j * kSide;
        if (kInt8) bulk_load(slot, arm.cscale + row0, kLanes * 4, &side_full[j]);
        if (has_mask)
          bulk_load(slot + kLanes * 4, mask + row0 * (kMaskBytes / kLanes), kMaskBytes,
                    &side_full[j]);
        for (int c = 0; c < n_chunks; ++c) {
          const int s = next;
          if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
          uint8_t* stage = ring + s * stage_bytes;
          mbar_arrive_expect_tx(&full[s], stage_bytes);
          tma_load_rows(stage, &arm.x_map, &full[s], c * kChunk, static_cast<int>(row0));
          if (streamed)
            tma_load_rows(stage + kWalkStageBytes, &arm.q_map, &full[s], c * kChunk, q0);
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
      qs[h] = b < prm.batch ? arm.qscale[b] : 0.f;
    }
  }
  Acc acc[64];
  float best[kMode == kBucketV1 ? 1 : 64];  // section, v2: running maxima
#pragma unroll
  for (int x = 0; x < (kMode == kBucketV1 ? 1 : 64); ++x) best[x] = kNegInf;

  if (!streamed) mbar_wait(q_full, 0);
  const uint64_t q_desc = desc_sw128(q_tile + wq * kChunk);
  int next = 0, prev = 0;  // this warpgroup's next stage of its ring, the one before
  uint32_t lap = 0;
  for (int p = 0; p < n_pos; ++p) {
    for (int c = 0; c < n_chunks; ++c) {
      const int s = next;
      mbar_wait(&full[s], lap & 1);
      // A stage is released only after both operands' products are done
      // (the wait below), so a streamed query chunk lives as long as its rows.
      // (The A descriptor comes first, as in the resident-only walk: with
      // the stage's address taken before it, ptxas scheduled the resident
      // kernels' loop head otherwise.)
      const uint64_t a = streamed
                             ? desc_sw128(ring + s * stage_bytes + kWalkStageBytes + wq * kChunk)
                             : q_desc + static_cast<uint64_t>((c * q_chunk_bytes) >> 4);
      const uint64_t x = desc_sw128(ring + s * stage_bytes);
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

    const int j = p % kWalkSide;
    mbar_wait(&side_full[j], (p / kWalkSide) & 1);
    const uint8_t* slot = side + j * kSide;
    {  // Position p's epilogue on the drained accumulator.
      if constexpr (kMode == kBucketV1) {
        // Each thread's 32 lanes of its two queries, then the quad's 128.
        // Within the thread four independent chains per query (n mod 4) meet
        // their lanes in ascending order, so ">=" keeps the highest lane
        // among equals; the chains and the quad merge by keep_best.
        float bv[2][4];
        int bl[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            bv[h][k] = -__int_as_float(0x7f800000);
            bl[h][k] = -1;
          }
        }
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int col = 8 * n + 2 * t;
          const uint32_t m2 = *reinterpret_cast<const uint16_t*>(slot + kLanes * 4 + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = (m2 >> (8 * (e & 1))) & 0xFFu ? static_cast<float>(acc[4 * n + e])
                                                          : kNegInf;
            float& cv = bv[e >> 1][n & 3];
            if (v >= cv) {
              cv = v;
              bl[e >> 1][n & 3] = col + (e & 1);
            }
          }
        }
        const long long bucket = static_cast<long long>(blockIdx.y) * n_pos + p;
        const long long n_buckets = static_cast<long long>(prm.n_blocks) * n_pos;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          keep_best(bv[h][0], bl[h][0], bv[h][1], bl[h][1]);
          keep_best(bv[h][2], bl[h][2], bv[h][3], bl[h][3]);
          keep_best(bv[h][0], bl[h][0], bv[h][2], bl[h][2]);
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv[h][0], o);
            const int ol = __shfl_xor_sync(0xffffffffu, bl[h][0], o);
            keep_best(bv[h][0], bl[h][0], ov, ol);
          }
          const int b = q0 + wq + r + 8 * h;
          if (t == 0 && b < prm.batch) {
            const long long idx = static_cast<long long>(b) * n_buckets + bucket;
            arm.out[idx] = bv[h][0];
            arm.out_pos[idx] = static_cast<int>(bucket * kLanes + bl[h][0]);
          }
        }
      } else {
        // Scale, pack, mask, running maximum (the float operations and order
        // of the plain version, so int8 tables are bit-equal).
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int col = 8 * n + 2 * t;
          float2 c2 = make_float2(0.f, 0.f);
          if constexpr (kInt8) c2 = *reinterpret_cast<const float2*>(slot + col * 4);
          uint32_t m2 = 0;
          float2 a2 = make_float2(0.f, 0.f);
          if constexpr (kMode == kBucketV2)
            m2 = *reinterpret_cast<const uint16_t*>(slot + kLanes * 4 + col);
          else if (has_mask)
            a2 = *reinterpret_cast<const float2*>(slot + kLanes * 4 + col * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * n + e;
            float v;
            if constexpr (kInt8)
              v = __fmul_rn(__fmul_rn(__int2float_rn(acc[x]), qs[e >> 1]), e & 1 ? c2.y : c2.x);
            else
              v = acc[x];
            v = __int_as_float((__float_as_int(v) & ~kPosMask) | p);
            if constexpr (kMode == kBucketV2) {
              // A masked row would fold in -1e30, which best never falls below.
              if ((m2 >> (8 * (e & 1))) & 0xFFu) best[x] = fmaxf(best[x], v);
            } else {
              // No mask adds nothing: -0.0 + 0.0 would turn a packed -0.0 into +0.0.
              if (has_mask) v = __fadd_rn(v, e & 1 ? a2.y : a2.x);
              best[x] = fmaxf(best[x], v);
            }
          }
        }
      }
    }
    mbar_arrive(&side_empty[j]);
  }
  if constexpr (kMode == kBucketV1) return;

  const long long width = static_cast<long long>(prm.n_blocks) * kLanes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = q0 + wq + r + 8 * h;
    if (b >= prm.batch) continue;
    const long long row_base = static_cast<long long>(b) * width + blockIdx.y * kLanes + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const float v0 = best[4 * n + 2 * h];
      const float v1 = best[4 * n + 2 * h + 1];
      if constexpr (kMode == kBucketV2) {
        const int b0 = __float_as_int(v0);
        const int b1 = __float_as_int(v1);
        *reinterpret_cast<float2*>(arm.out + row_base + 8 * n) =
            make_float2(__int_as_float(b0 & ~kPosMask), __int_as_float(b1 & ~kPosMask));
        *reinterpret_cast<int2*>(arm.out_pos + row_base + 8 * n) =
            make_int2(b0 & kPosMask, b1 & kPosMask);
      } else {
        *reinterpret_cast<float2*>(arm.out + row_base + 8 * n) = make_float2(v0, v1);
      }
    }
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kWalkThreads, 1)
section_wgmma_kernel(const __grid_constant__ WalkParams prm) {
  table_walk<kSection, kInt8, false>(prm);
}

template <bool kInt8>
__global__ void __launch_bounds__(kWalkThreads, 1)
bucket_v2_wgmma_kernel(const __grid_constant__ WalkParams prm) {
  table_walk<kBucketV2, kInt8, false>(prm);
}

__global__ void __launch_bounds__(kWalkThreads, 1)
bucket_v1_wgmma_kernel(const __grid_constant__ WalkParams prm) {
  table_walk<kBucketV1, false, false>(prm);
}

// The same three walks with the query tile streamed (rows past 2944 bytes).
template <bool kInt8>
__global__ void __launch_bounds__(kWalkThreads, 1)
section_streamed_kernel(const __grid_constant__ WalkParams prm) {
  table_walk<kSection, kInt8, true>(prm);
}

template <bool kInt8>
__global__ void __launch_bounds__(kWalkThreads, 1)
bucket_v2_streamed_kernel(const __grid_constant__ WalkParams prm) {
  table_walk<kBucketV2, kInt8, true>(prm);
}

__global__ void __launch_bounds__(kWalkThreads, 1)
bucket_v1_streamed_kernel(const __grid_constant__ WalkParams prm) {
  table_walk<kBucketV1, false, true>(prm);
}

template <int kMode, bool kInt8, bool kStreamed>
int start_walk(const WalkParams& prm, dim3 grid, int smem, cudaStream_t stream) {
  void (*kernel)(WalkParams);
  if constexpr (kMode == kSection)
    kernel = kStreamed ? section_streamed_kernel<kInt8> : section_wgmma_kernel<kInt8>;
  else if constexpr (kMode == kBucketV2)
    kernel = kStreamed ? bucket_v2_streamed_kernel<kInt8> : bucket_v2_wgmma_kernel<kInt8>;
  else
    kernel = kStreamed ? bucket_v1_streamed_kernel : bucket_v1_wgmma_kernel;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kWalkThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, bool kInt8>
int start_walk(const WalkParams& prm, dim3 grid, int smem, cudaStream_t stream, bool streamed) {
  return streamed ? start_walk<kMode, kInt8, true>(prm, grid, smem, stream)
                  : start_walk<kMode, kInt8, false>(prm, grid, smem, stream);
}

// One arm of a walk launch as the C entries receive it. A row's width
// (row_bytes) and the distance between rows (q_pitch, x_pitch: multiples of
// 16 bytes, as TMA takes strides) are apart, so rows of any width run; the
// pitches reach the tensor maps only.
struct WalkArgs {
  const void* q;
  const void* corpus;
  const void* qscale;
  const void* cscale;
  void* out;
  void* out_pos;
  int row_bytes;
  long long q_pitch;
  long long x_pitch;
  int queries;
  int stages;
};

template <int kMode>
int launch_walk(const WalkArgs* args, int n_arms, bool int8, const void* mask, int batch,
                long long n_rows, int block, cudaStream_t stream) {
  const bool packed = kMode != kBucketV1;
  if (n_arms < 1 || n_arms > kMaxArms || block <= 0 || block % kLanes != 0 ||
      (packed && block / kLanes > kPosMask + 1) || n_rows % block != 0 ||
      n_rows / block > 65535 || n_rows >= (1ll << 31) ||
      (kMode != kSection && mask == nullptr) || (kMode == kBucketV1 && int8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  WalkParams prm = {};
  int smem = 0;
  int min_queries = 128;
  const bool streamed = walk_streams((args[0].row_bytes + kChunk - 1) / kChunk);
  for (int a = 0; a < n_arms; ++a) {
    const WalkArgs& w = args[a];
    const int n_chunks = (w.row_bytes + kChunk - 1) / kChunk;
    const int bytes = walk_smem_bytes(kMode, w.queries, n_chunks, w.stages);
    if (w.row_bytes <= 0 || (w.queries != 64 && w.queries != 128) ||
        w.stages < 2 || w.stages > kWalkMaxStages || bytes > kMaxSmem ||
        walk_streams(n_chunks) != streamed ||  // one layout a launch
        (int8 && (w.qscale == nullptr || w.cscale == nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if ((reinterpret_cast<uintptr_t>(w.q) | reinterpret_cast<uintptr_t>(w.corpus) |
         reinterpret_cast<uintptr_t>(w.cscale)) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    WalkArm& arm = prm.arm[a];
    if (int rc = hopper::make_rows_map(&arm.q_map, w.q, batch, w.row_bytes, w.q_pitch, w.queries))
      return rc;
    if (int rc = hopper::make_rows_map(&arm.x_map, w.corpus, n_rows, w.row_bytes, w.x_pitch, kLanes))
      return rc;
    arm.qscale = static_cast<const float*>(w.qscale);
    arm.cscale = static_cast<const float*>(w.cscale);
    arm.out = static_cast<float*>(w.out);
    arm.out_pos = static_cast<int*>(w.out_pos);
    arm.n_chunks = n_chunks;
    arm.queries = w.queries;
    arm.stages = w.stages;
    smem = bytes > smem ? bytes : smem;
    min_queries = w.queries < min_queries ? w.queries : min_queries;
  }
  prm.mask = mask;
  prm.batch = batch;
  prm.block = block;
  prm.n_blocks = static_cast<int>(n_rows / block);
  const dim3 grid((batch + min_queries - 1) / min_queries, prm.n_blocks, n_arms);
  if constexpr (kMode == kBucketV1) {
    return start_walk<kMode, false>(prm, grid, smem, stream, streamed);
  } else {
    return int8 ? start_walk<kMode, true>(prm, grid, smem, stream, streamed)
                : start_walk<kMode, false>(prm, grid, smem, stream, streamed);
  }
}

// ---- the FMA walk: float32 rows, fed by TMA --------------------------------------------
//
// float32 dots run on the CUDA cores (FFMA, never TF32), so this walk is bound
// by its FMA issue rate: the H100's 67 TFLOP/s is 128 FMAs a clock an SM. What
// keeps it from that rate is the shared-memory loads that feed each FMA and
// how often a column block's rows are read. One CTA of 288 threads (eight
// consumer warps and one TMA producer warp) owns 128 queries × the 128 lanes
// of one column block and walks the block's positions p:
//   - per position, the producer streams the 128 rows and the 128 queries
//     chunk by chunk (32 floats of each, two 16 KB TMA boxes of a FLOAT32
//     map, 128-byte swizzle) into a ring of kFmaStages 32 KB stages, each with a
//     full and an empty mbarrier, counted, not divided out. The query tile
//     (128 × d floats, 384 KB at d = 768) cannot stay resident, so it streams
//     beside the rows as in a GEMM mainloop; all 512 queries of a batch stay
//     in L2, and a 512-query batch reads each column block 4 times;
//   - consumer thread t holds 8 queries × 8 lanes: queries qg + 16a and lanes
//     lg + 16b (qg = 2·warp + lane / 16, lg = lane % 16), 64 accumulators.
//     Per 16 bytes of k it loads 8 query and 8 row float4s (a warp reads 2
//     queries, broadcast, and 16 consecutive rows, which the swizzle puts in
//     distinct banks) for 256 FMAs: 16 FMAs a load;
//   - after a position's last chunk the accumulators are packed, masked and
//     folded into the running maxima (section, v2), which live in shared
//     memory (64 KB, each thread its own 64 words: 64 accumulators and 64
//     maxima in registers would pass what ptxas gives a 288-thread CTA), or
//     reduced across the 128 lanes (v1: within the thread over its 8 lanes in
//     ascending order, then over the 16 threads of its half-warp by
//     shuffles) and written out. ptxas gives a 288-thread CTA at most 168
//     registers, which the 64 accumulators and their operands take, so the
//     position's mask is read after its chunks, not held across them.
constexpr int kFmaQueries = 128;
constexpr int kFmaConsumers = 256;
constexpr int kFmaThreads = kFmaConsumers + 32;
constexpr int kFmaHalfStage = 128 * kChunk;        // 128 rows (or queries) × 32 floats
constexpr int kFmaStageBytes = 2 * kFmaHalfStage;  // the rows, then the queries
constexpr int kFmaStages = 4;
constexpr int kFmaBestBytes = kFmaQueries * kLanes * 4;  // section, v2: running maxima

constexpr int fma_smem_bytes(int mode) {
  return kFmaStages * kFmaStageBytes + (mode == kBucketV1 ? 0 : kFmaBestBytes) +
         2 * kFmaStages * 8 + 1024;  // + barriers, + alignment slack
}

struct FmaArm {
  CUtensorMap q_map;  // queries [batch, d] float32: boxes of 32 columns × 128 queries
  CUtensorMap x_map;  // rows [n_rows, d] float32: boxes of 32 columns × 128 rows
  float* out;         // section, v2: [batch, n_blocks·128]; v1: [batch, n_rows/128]
  int* out_pos;       // v2: position in the bucket; v1: global row (out's shape)
  int n_chunks;       // ceil(d / 32)
};

struct FmaParams {
  FmaArm arm[kMaxArms];
  const void* mask;  // section: mask_add [n_rows] float32 or null; v2, v1: [n_rows] bytes
  int batch;
  int block;
  int n_blocks;
};

template <int kMode>
__global__ void __launch_bounds__(kFmaThreads, 1)
fma_walk_kernel(const __grid_constant__ FmaParams prm) {
  using namespace hopper;
  const FmaArm& arm = prm.arm[kMode == kSection ? blockIdx.z : 0];
  const int q0 = blockIdx.x * kFmaQueries;
  const int n_chunks = arm.n_chunks;
  const int n_pos = prm.block / kLanes;
  const long long block_row0 = static_cast<long long>(blockIdx.y) * prm.block;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_base_1024(smem_raw);  // stage s at s · kFmaStageBytes
  float* best = reinterpret_cast<float*>(ring + kFmaStages * kFmaStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(best) +
                                               (kMode == kBucketV1 ? 0 : kFmaBestBytes));
  uint64_t* empty = full + kFmaStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFmaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFmaConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFmaConsumers) {
    // Producer: per position, its rows and the queries, one chunk a stage.
    if (threadIdx.x == kFmaConsumers) {
      int next = 0;  // the ring's next slot, and how many times it has gone round
      uint32_t lap = 0;
      for (int p = 0; p < n_pos; ++p) {
        const int row0 = static_cast<int>(block_row0 + static_cast<long long>(p) * kLanes);
        for (int c = 0; c < n_chunks; ++c) {
          const int s = next;
          if (lap > 0) mbar_wait(&empty[s], (lap - 1) & 1);
          uint8_t* stage = ring + s * kFmaStageBytes;
          mbar_arrive_expect_tx(&full[s], kFmaStageBytes);
          tma_load_rows(stage, &arm.x_map, &full[s], c * 32, row0);
          tma_load_rows(stage + kFmaHalfStage, &arm.q_map, &full[s], c * 32, q0);
          if (++next == kFmaStages) {
            next = 0;
            ++lap;
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lg = tid & 15;                      // lanes lg + 16b
  const int qg = (tid >> 5) * 2 + ((tid >> 4) & 1);  // queries qg + 16a
  // Row r's 16-byte piece k sits at piece k ^ (r % 8) of its 128 bytes, and
  // r % 8 is lg % 8 for every row of the thread (qg % 8 for its queries).
  const int x_rows = lg & 7, x_queries = qg & 7;
  const bool has_mask = kMode != kSection || prm.mask != nullptr;
  if constexpr (kMode != kBucketV1) {
#pragma unroll
    for (int x = 0; x < 64; ++x) best[x * kFmaConsumers + tid] = kNegInf;
  }

  int next = 0;
  uint32_t lap = 0;
  for (int p = 0; p < n_pos; ++p) {
    const long long row0 = block_row0 + static_cast<long long>(p) * kLanes;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int s = next;
      mbar_wait(&full[s], lap & 1);
      const uint8_t* rows = ring + s * kFmaStageBytes + lg * kChunk;
      const uint8_t* qs = ring + s * kFmaStageBytes + kFmaHalfStage + qg * kChunk;
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) {
        float4 qv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          qv[a] = *reinterpret_cast<const float4*>(qs + a * 16 * kChunk + ((k ^ x_queries) << 4));
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float4 rv =
              *reinterpret_cast<const float4*>(rows + b * 16 * kChunk + ((k ^ x_rows) << 4));
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            float v = acc[a][b];
            v = fmaf(qv[a].x, rv.x, v);
            v = fmaf(qv[a].y, rv.y, v);
            v = fmaf(qv[a].z, rv.z, v);
            acc[a][b] = fmaf(qv[a].w, rv.w, v);
          }
        }
      }
      mbar_arrive(&empty[s]);
      if (++next == kFmaStages) {
        next = 0;
        ++lap;
      }
    }

    {  // Position p's epilogue: the mask, then the fold (section, v2) or reduction (v1).
      // The position's mask for the thread's 8 rows, read after its chunks: 8
      // registers held across them would pass the register cap.
      float madd[8];  // section: mask_add
      bool live[8];   // v2, v1: the mask
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const long long row = row0 + lg + 16 * b;
        if constexpr (kMode == kSection) {
          madd[b] = has_mask ? __ldg(static_cast<const float*>(prm.mask) + row) : 0.f;
        } else {
          live[b] = __ldg(static_cast<const uint8_t*>(prm.mask) + row) != 0;
        }
      }
      if constexpr (kMode == kBucketV1) {
        const long long bucket = static_cast<long long>(blockIdx.y) * n_pos + p;
        const long long n_buckets = static_cast<long long>(prm.n_blocks) * n_pos;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          // The thread's lanes ascend with b, so ">=" keeps the highest lane
          // among equals; the half-warp's 16 threads merge by keep_best.
          float bv = -__int_as_float(0x7f800000);
          int bl = -1;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const float v = live[b] ? acc[a][b] : kNegInf;
            if (v >= bv) {
              bv = v;
              bl = lg + 16 * b;
            }
          }
#pragma unroll
          for (int o = 1; o < 16; o <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
            keep_best(bv, bl, ov, ol);
          }
          const int bq = q0 + qg + 16 * a;
          if (lg == 0 && bq < prm.batch) {
            const long long idx = static_cast<long long>(bq) * n_buckets + bucket;
            arm.out[idx] = bv;
            arm.out_pos[idx] = static_cast<int>(bucket * kLanes + bl);
          }
        }
      } else {
        // Pack, mask, running maximum (the plain version's float operations).
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            float v = __int_as_float((__float_as_int(acc[a][b]) & ~kPosMask) | p);
            float& m = best[(a * 8 + b) * kFmaConsumers + tid];
            if constexpr (kMode == kBucketV2) {
              // A masked row would fold in -1e30, which the maximum never falls below.
              if (live[b]) m = fmaxf(m, v);
            } else {
              // No mask adds nothing: -0.0 + 0.0 would turn a packed -0.0 into +0.0.
              if (has_mask) v = __fadd_rn(v, madd[b]);
              m = fmaxf(m, v);
            }
          }
        }
      }
    }
  }
  if constexpr (kMode == kBucketV1) return;

  const long long width = static_cast<long long>(prm.n_blocks) * kLanes;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int bq = q0 + qg + 16 * a;
    if (bq >= prm.batch) continue;
    const long long row_base = static_cast<long long>(bq) * width + blockIdx.y * kLanes + lg;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float v = best[(a * 8 + b) * kFmaConsumers + tid];
      if constexpr (kMode == kBucketV2) {
        const int bits = __float_as_int(v);
        arm.out[row_base + 16 * b] = __int_as_float(bits & ~kPosMask);
        arm.out_pos[row_base + 16 * b] = bits & kPosMask;
      } else {
        arm.out[row_base + 16 * b] = v;
      }
    }
  }
}

// One arm of an FMA walk launch as the C entries receive it (the pitches as
// in WalkArgs).
struct FmaArgs {
  const void* q;
  const void* corpus;
  void* out;
  void* out_pos;
  int row_bytes;
  long long q_pitch;
  long long x_pitch;
};

template <int kMode>
int launch_fma(const FmaArgs* args, int n_arms, const void* mask, int batch, long long n_rows,
               int block, cudaStream_t stream) {
  const bool packed = kMode != kBucketV1;
  constexpr int smem = fma_smem_bytes(kMode);
  static_assert(smem <= kMaxSmem, "the FMA walk's ring and maxima pass shared memory");
  if (n_arms < 1 || n_arms > kMaxArms || block <= 0 || block % kLanes != 0 ||
      (packed && block / kLanes > kPosMask + 1) || n_rows % block != 0 ||
      n_rows / block > 65535 || n_rows >= (1ll << 31) || (kMode != kSection && mask == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FmaParams prm = {};
  for (int a = 0; a < n_arms; ++a) {
    const FmaArgs& w = args[a];
    if (w.row_bytes <= 0 || w.row_bytes % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(w.q) | reinterpret_cast<uintptr_t>(w.corpus)) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    FmaArm& arm = prm.arm[a];
    if (int rc = hopper::make_rows_map(&arm.q_map, w.q, batch, w.row_bytes, w.q_pitch, kFmaQueries,
                                       true))
      return rc;
    if (int rc = hopper::make_rows_map(&arm.x_map, w.corpus, n_rows, w.row_bytes, w.x_pitch, kLanes,
                                       true))
      return rc;
    arm.out = static_cast<float*>(w.out);
    arm.out_pos = static_cast<int*>(w.out_pos);
    arm.n_chunks = (w.row_bytes + kChunk - 1) / kChunk;
  }
  prm.mask = mask;
  prm.batch = batch;
  prm.block = block;
  prm.n_blocks = static_cast<int>(n_rows / block);
  const cudaError_t attr = cudaFuncSetAttribute(
      fma_walk_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((batch + kFmaQueries - 1) / kFmaQueries, prm.n_blocks, n_arms);
  fma_walk_kernel<kMode><<<grid, kFmaThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row kinds: 0 = bf16, 1 = int8 codes, 2 = float32.
//
// Arms a < n_arms, all of row kind `kind`: q[a] [batch, d_a] and corpus[a]
// [n_rows, d_a] (rows of row_bytes[a] bytes, any width, starting q_pitch[a]
// and x_pitch[a] bytes apart: multiples of 16), qscale[a] [batch] and
// cscale[a] [n_rows] float32 for int8, out[a] [batch, n_rows/block·128]
// float32; mask_add [n_rows] float32 or null. int8 and bf16 arms run on the
// wgmma walk, each with its tile of queries[a] (64 or 128) and ring of
// stages[a] (2-8), all arms resident or all streamed (rows past 2944 bytes);
// q, corpus, cscale and mask_add 16-byte aligned. float32 arms take the FMA
// walk, whose tile and ring are its own (queries and stages are not read); q
// and corpus 16-byte aligned. Everything but the rows contiguous. Returns
// the CUDA error code of the launch.
extern "C" int section_tables(int n_arms, const void* const* q, const void* const* corpus,
                              const void* const* qscale, const void* const* cscale,
                              void* const* out, const int* row_bytes, const long long* q_pitch,
                              const long long* x_pitch, const int* queries, const int* stages,
                              int kind, const void* mask_add, int batch, long long n_rows,
                              int block, void* stream) {
  if (n_arms < 1 || n_arms > kMaxArms || kind < kBf16 || kind > kF32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (kind == kF32) {
    FmaArgs args[kMaxArms];
    for (int a = 0; a < n_arms; ++a) {
      args[a] = FmaArgs{q[a], corpus[a], out[a], nullptr, row_bytes[a], q_pitch[a], x_pitch[a]};
    }
    return launch_fma<kSection>(args, n_arms, mask_add, batch, n_rows, block,
                                static_cast<cudaStream_t>(stream));
  }
  WalkArgs args[kMaxArms];
  for (int a = 0; a < n_arms; ++a) {
    args[a] = WalkArgs{q[a],       corpus[a],  qscale[a], cscale[a],  out[a],   nullptr,
                       row_bytes[a], q_pitch[a], x_pitch[a], queries[a], stages[a]};
  }
  return launch_walk<kSection>(args, n_arms, kind == kInt8, mask_add, batch, n_rows, block,
                               static_cast<cudaStream_t>(stream));
}

// q [batch, d], corpus [n_rows, d] of `kind` (rows of row_bytes, q_pitch and
// x_pitch bytes apart: multiples of 16), qscale [batch] / cscale
// [n_rows] float32 for int8, mask [n_rows] bool; out_val [batch,
// n_rows/block·128] float32 (low 7 bits cleared), out_pos the same shape
// int32 (position in the bucket). int8 and bf16 rows run on the wgmma walk
// with a tile of `queries` (64 or 128) and a ring of `stages` (2-8); q,
// corpus, cscale and mask 16-byte aligned. float32 rows take the FMA walk
// (`queries` and `stages` not read). Returns the CUDA error code.
extern "C" int bucket_max_v2(const void* q, const void* corpus, const void* qscale,
                             const void* cscale, const void* mask, void* out_val, void* out_pos,
                             int row_bytes, long long q_pitch, long long x_pitch, int kind,
                             int batch, long long n_rows, int block, int queries, int stages,
                             void* stream) {
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (kind == kInt8 || kind == kBf16) {
    const WalkArgs args{q,         corpus,  qscale,  cscale,  out_val, out_pos,
                        row_bytes, q_pitch, x_pitch, queries, stages};
    return launch_walk<kBucketV2>(&args, 1, kind == kInt8, mask, batch, n_rows, block,
                                  static_cast<cudaStream_t>(stream));
  }
  if (kind != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const FmaArgs args{q, corpus, out_val, out_pos, row_bytes, q_pitch, x_pitch};
  return launch_fma<kBucketV2>(&args, 1, mask, batch, n_rows, block,
                               static_cast<cudaStream_t>(stream));
}

// q [batch, d], corpus [n_rows, d] bf16 (kind 0) or float32 (kind 2) (rows
// of row_bytes, q_pitch and x_pitch bytes apart: multiples of 16), mask
// [n_rows] bool; out_val [batch, n_rows/128] float32 (each bucket's
// maximum, -1e30 where all its rows are masked), out_row the same shape int32
// (global row of the highest lane holding it). `block` (a 128-multiple that
// divides n_rows) only sets the work per CTA. bf16 rows run on the wgmma walk
// with a tile of `queries` and a ring of `stages`, q, corpus and mask 16-byte
// aligned; float32 rows take the FMA walk (`queries` and `stages` not read).
// Returns the CUDA error code.
extern "C" int bucket_max_v1(const void* q, const void* corpus, const void* mask, void* out_val,
                             void* out_row, int row_bytes, long long q_pitch, long long x_pitch,
                             int kind, int batch, long long n_rows, int block, int queries,
                             int stages, void* stream) {
  if (batch <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (kind == kBf16) {
    const WalkArgs args{q,         corpus,  nullptr, nullptr, out_val, out_row,
                        row_bytes, q_pitch, x_pitch, queries, stages};
    return launch_walk<kBucketV1>(&args, 1, false, mask, batch, n_rows, block,
                                  static_cast<cudaStream_t>(stream));
  }
  if (kind != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const FmaArgs args{q, corpus, out_val, out_row, row_bytes, q_pitch, x_pitch};
  return launch_fma<kBucketV1>(&args, 1, mask, batch, n_rows, block,
                               static_cast<cudaStream_t>(stream));
}
