// Flash-attention forward for the encoder stack, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of `verbatim_rag_tpu/ops/flash_attention.py`:
//
//   `_flash_kernel` (pallas_call in `_flash_forward`, entries `flash_attention_tpu`
//   and, with the logsumexp output, `flash_attention_tpu_lse`) — entry
//   `flash_attention_fwd` below;
//   `_flash_partial_kernel` (pallas_call in `_flash_partial_impl`, entry
//   `flash_attention_partial`: one ring step of sequence-parallel attention) —
//   entry `flash_attention_partial` below.
//
// The forward computes, per batch row b and head h:
//     o[q] = softmax_k(q·k/sqrt(D) + mask)·v
// with keys k >= lengths[b] masked and, when window >= 0, keys with
// |q - k| > window/2 masked too. A row whose keys are all masked writes 0,
// like the TPU kernel. When `lse` is given ([B, H, S] float32, for training),
// each row also writes its logsumexp m + log(l) over the live keys (scores
// scaled by 1/sqrt(D)), and 0 for a row with no live key; serving passes
// null. The output does not depend on whether lse is written.
//
// The partial entry takes q [B, Sq, H, D] and ONE KV block k, v [B, Sk, H, D]
// of a longer sequence whose first key sits at global position k_offset. A
// key is live when its local index is below Sk and k_offset + index is below
// lengths[b] (global lengths); there is no band. It writes the block's
// UNnormalised numerator Σ p·v ([B, Sq, H, D] float32), the row max m of the
// scaled scores (natural log domain, as the ring's exp(m_run − m_new) merge
// reads it) and the denominator l = Σ p ([B, H, Sq] float32 each). A row with
// no live key in the block writes exactly m = -1e30, l = 0, numer = 0, so the
// merge never meets -inf − -inf.
//
// Inputs and outputs are contiguous, q, k, v in bfloat16 or float32. Both
// entries take head dims D = 64 (ModernBERT's 12 × 64 heads, the extractor)
// and D = 32 (MiniLM's 12 × 32 heads: the dense and SPLADE providers, the
// cross-encoder, and a MiniLM-width highlighter trained or run sequence-
// parallel), each its own instantiation of the same kernels.
// Scores, softmax statistics and accumulators are float32. Any S is taken:
// the ragged edge is masked here, nothing is padded by the caller. Key
// tiles past the live keys, or outside the band on local layers, are never
// loaded, so local layers cost O(S·window) and a dead KV block costs nothing.
//
// Three kernels, each instantiated at both head dims:
//
//   bf16 forward and bf16 partial — wgmma fed by TMA (Hopper's own path to
//          the tensor cores), one body (`wgmma_attention`) for both entries.
//          One CTA per (128-row q tile, b·h): two consumer warpgroups of 64
//          rows and one producer warp. The producer loads the Q tile once and
//          streams 128-key K and V tiles through a ring of shared-memory
//          stages with full/empty mbarriers (TMA, 128-byte swizzle, rows past
//          S zero-filled). Each consumer computes S = Q·Kᵀ (wgmma m64n128,
//          both operands K-major in shared memory), the online softmax in
//          registers (exp2 with log2(e) folded into the scale; row max and sum
//          over the four lanes of a quad), packs P to bf16 straight into the A
//          registers of O += P·V (wgmma m64nD with A from registers and V read
//          MN-major through the descriptor's transpose bit: no Vᵀ copy), and
//          normalises in the epilogue. Length and band masks are evaluated
//          only on tiles that straddle an edge; a warpgroup with no live pair
//          in a tile skips its products; a CTA whose keys are all dead loads
//          nothing. l sums the unrounded P; P is rounded to bf16 for P·V (the
//          plain version rounds the normalised probabilities, so the two
//          differ by a bf16 rounding). The partial keeps the same raw row max
//          and exp2 domain inside and writes m · scale (natural-log domain)
//          and the unnormalised float32 numerator in 8-byte stores.
//          At D = 32 a head row is 64 bytes: the tiles take the 64-byte
//          swizzle (TMA map and descriptors alike), S = Q·Kᵀ takes two k16
//          steps instead of four, and O += P·V is m64n32 with V's 64-byte
//          rows read MN-major; the ring and the softmax are unchanged.
//   f32  — plain FMA on the CUDA cores, 4 threads per q row, p passed to the
//          P·V loop by warp shuffle (forward and partial).
//
// Bound on an H100 SXM: global layers and ring steps are compute-bound
// (4·H·D FLOP per live (q, k) pair: 618 GFLOP at B=3, S=8192, H=12, i.e.
// 0.63 ms at 989 TFLOP/s bf16; one fully live ring step at B=1, Sq=Sk=6144,
// 0.12 ms). At D = 64 the softmax's one exp per pair (16 a clock per SM on
// the multi-function units) weighs as much as the products, which is why
// the exp runs as a single ex2 after one FMA and the masks stay off interior
// tiles. Local layers are memory-bound (q, k, v and o read or written once);
// their 128-key tiles cover the 129-key band of a 64-row warpgroup in two
// tiles. At D = 32 (the providers: B = 64, S = 256, H = 12, global) the
// forward is memory-bound: q, k, v and o are 4·B·S·H·D·2 = 50 MB, 15 µs at
// 3.35 TB/s, against 4·H·D·S²·B = 6.4 GFLOP, 6.5 µs at 989 TFLOP/s; what
// its design does about the bytes is to read each q, k and v row once a
// CTA and write each output row once (the 128-row q tile holds all of a
// 256-key sequence's rows in two CTAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;  // 256
constexpr int kKeysPerThread = kBlockK / kThreadsPerRow;  // 16
constexpr float kNegInf = -1e30f;

// Live keys of batch row b as local indices [0, limit): below seq_k and, for a
// block whose first key sits at global position k_offset, below lengths[b]
// (the forward passes k_offset = 0 and seq_k = S).
__device__ __forceinline__ int key_limit(int length, int k_offset, int seq_k) {
  const int n = length - k_offset;
  return n < 0 ? 0 : (n > seq_k ? seq_k : n);
}

// Key tiles [begin, end) of kTile keys that a q tile of kRows rows starting
// at q_start can see: keys below len and, for window >= 0, within window/2 of
// some row of the tile (q and k share positions whenever window >= 0).
template <int kRows, int kTile>
__device__ __forceinline__ void key_tile_range(int q_start, int len, int window, int* begin,
                                               int* end) {
  int k_lo = 0;
  int k_hi = len;
  if (window >= 0) {
    const int half = window / 2;
    k_lo = q_start - half > 0 ? q_start - half : 0;
    const int hi = q_start + kRows + half;  // exclusive
    k_hi = hi < len ? hi : len;
  }
  *begin = k_lo / kTile;
  *end = k_hi > k_lo ? (k_hi + kTile - 1) / kTile : *begin;
}

// ---- float32: FMA on the CUDA cores ------------------------------------------------

template <bool kPartial, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ out, float* __restrict__ lse, float* __restrict__ m_out,
                 float* __restrict__ l_out, int seq_q, int seq_k, int heads, int window,
                 int k_offset, float scale) {
  constexpr int kChunks = D / (4 * kThreadsPerRow);  // float4 output chunks per thread
  constexpr int kPad = D + 4;                          // K row stride in floats (bank spread)

  __shared__ __align__(16) float k_tile[kBlockK][kPad];
  __shared__ __align__(16) float v_tile[kBlockK][D];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_start = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int lane = tid & 31;
  const int row_lane0 = lane & ~(kThreadsPerRow - 1);
  const int qi = q_start + row;
  const int half = window / 2;

  const int len = key_limit(lengths[b], k_offset, seq_k);

  const long long tok_stride = (long long)heads * D;
  const long long q_base = (long long)b * seq_q * tok_stride + (long long)h * D;
  // The forward's q and k/v share one length, so one base serves both: one
  // 64-bit value live across the key loop instead of two (no spill).
  const long long kv_base =
      kPartial ? (long long)b * seq_k * tok_stride + (long long)h * D : q_base;

  float qr[D];
  if (qi < seq_q) {
    const float* qp = q + q_base + (long long)qi * tok_stride;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qp[d] * scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }

  float acc[4 * kChunks];
#pragma unroll
  for (int i = 0; i < 4 * kChunks; ++i) acc[i] = 0.f;
  float m_run = kNegInf;
  float l_run = 0.f;

  int kt_begin, kt_end;
  key_tile_range<kBlockQ, kBlockK>(q_start, len, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int kk = i / D;
      const int d = i - kk * D;
      const int key = k0 + kk;
      float kv = 0.f, vv = 0.f;
      if (key < seq_k) {
        const long long off = kv_base + (long long)key * tok_stride + d;
        kv = k[off];
        vv = v[off];
      }
      k_tile[kk][d] = kv;
      v_tile[kk][d] = vv;
    }
    __syncthreads();

    // Scores for keys kk = sub + kThreadsPerRow * j.
    float p[kKeysPerThread];
    unsigned valid_bits = 0u;
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int kk = sub + kThreadsPerRow * j;
      const int key = k0 + kk;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&k_tile[kk][d]);
        dot = fmaf(qr[d], kv.x, dot);
        dot = fmaf(qr[d + 1], kv.y, dot);
        dot = fmaf(qr[d + 2], kv.z, dot);
        dot = fmaf(qr[d + 3], kv.w, dot);
      }
      const int dist = qi > key ? qi - key : key - qi;
      const bool ok = key < len && (window < 0 || dist <= half);
      p[j] = ok ? dot : kNegInf;
      valid_bits |= ok ? (1u << j) : 0u;
      tile_max = fmaxf(tile_max, p[j]);
    }
#pragma unroll
    for (int o = 1; o < kThreadsPerRow; o <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));

    const float m_new = fmaxf(m_run, tile_max);
    const float corr = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      p[j] = (valid_bits >> j) & 1u ? expf(p[j] - m_new) : 0.f;
      psum += p[j];
    }
#pragma unroll
    for (int o = 1; o < kThreadsPerRow; o <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l_run = l_run * corr + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < 4 * kChunks; ++i) acc[i] *= corr;

    // acc += p · V over the tile; key kk's p lives in lane row_lane0 + kk % 4.
#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float pk =
          __shfl_sync(0xffffffffu, p[kk / kThreadsPerRow], row_lane0 + kk % kThreadsPerRow);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = (sub + kThreadsPerRow * c) * 4;
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[kk][d]);
        acc[4 * c] = fmaf(pk, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(pk, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pk, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pk, vv.w, acc[4 * c + 3]);
      }
    }
  }

  if (qi < seq_q) {
    // The partial keeps the numerator unnormalised; the forward divides.
    const float denom = kPartial ? 1.f : fmaxf(l_run, 1e-20f);
    float* op = out + q_base + (long long)qi * tok_stride;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = (sub + kThreadsPerRow * c) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) op[d + e] = kPartial ? acc[4 * c + e] : acc[4 * c + e] / denom;
    }
    if (sub == 0) {
      const long long r = (long long)bh * seq_q + qi;
      if constexpr (kPartial) {
        m_out[r] = m_run;
        l_out[r] = l_run;
      } else if (lse != nullptr) {
        lse[r] = l_run > 0.f ? m_run + logf(l_run) : 0.f;
      }
    }
  }
}

// ---- bf16 forward and partial: wgmma fed by TMA -----------------------------------------

constexpr int kFwdRows = 128;  // q rows a CTA: two consumer warpgroups of 64
constexpr int kFwdKeys = 128;  // keys a K/V tile
constexpr int kFwdStages = 2;  // K/V ring depth
constexpr int kFwdConsumers = 2 * hopper::kWarpgroup;
constexpr int kFwdThreads = kFwdConsumers + 32;  // + the TMA producer warp

// Shared memory of the wgmma body at head dim D: the Q tile, the K/V ring,
// then the barriers (D = 64: 16 + 64 KB; D = 32: 8 + 32 KB).
template <int D>
struct FwdSmem {
  static constexpr int kRowBytes = hopper::head_row_bytes<D>();
  static constexpr int kQBytes = kFwdRows * kRowBytes;
  static constexpr int kTileBytes = kFwdKeys * kRowBytes;
  static constexpr int kBarOffset = kQBytes + kFwdStages * 2 * kTileBytes;
  static constexpr int kBytes = kBarOffset + (1 + 2 * kFwdStages) * 8 + 1024;  // + alignment slack
};

// Outputs of the wgmma body: the forward's normalised bf16 rows (and lse on
// request), or the partial's float32 numerator, m and l.
struct FwdOut {
  __nv_bfloat16* out;  // forward: [B, Sq, H, D]
  float* lse;          // forward: [B, H, Sq] or null
  float* numer;        // partial: [B, Sq, H, D]
  float* m;            // partial: [B, H, Sq]
  float* l;            // partial: [B, H, Sq]
};

// One CTA: 128 q rows of one (b, h) against the key tiles that can hold a
// live key of the block [k_offset, k_offset + seq_k) (the forward: the whole
// sequence, k_offset 0, seq_k = seq_q). A CTA whose block holds no live key
// loads nothing and writes its rows' empty state.
template <bool kPartial, int D>
__device__ __forceinline__ void wgmma_attention(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                                const CUtensorMap* v_map,
                                                const int* __restrict__ lengths, FwdOut res,
                                                int seq_q, int seq_k, int heads, int window,
                                                int k_offset, float scale) {
  using namespace hopper;
  using Smem = FwdSmem<D>;
  constexpr int kRowBytes = Smem::kRowBytes;
  constexpr int kFwdQBytes = Smem::kQBytes;
  constexpr int kFwdTileBytes = Smem::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base_1024(smem_raw);
  uint8_t* q_tile = smem;
  uint8_t* kv_tiles = smem + kFwdQBytes;  // stage s: K at 2s, V at 2s + 1 (tiles of kFwdTileBytes)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Smem::kBarOffset);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kFwdStages;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_start = blockIdx.x * kFwdRows;
  const int len = key_limit(lengths[b], k_offset, seq_k);
  int kt_begin, kt_end;
  key_tile_range<kFwdRows, kFwdKeys>(q_start, len, window, &kt_begin, &kt_end);
  const bool any_tile = kt_begin < kt_end;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kFwdConsumers / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFwdConsumers) {
    // Producer warp: one thread loads Q, then keeps the K/V ring full.
    if (threadIdx.x == kFwdConsumers && any_tile) {
      mbar_arrive_expect_tx(q_full, kFwdQBytes);
      tma_load_tile(q_tile, q_map, q_full, h, q_start, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % kFwdStages;
        if (i >= kFwdStages) mbar_wait(&kv_empty[s], (i / kFwdStages - 1) & 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * kFwdTileBytes);
        tma_load_tile(kv_tiles + 2 * s * kFwdTileBytes, k_map, &kv_full[s], h, kt * kFwdKeys, b);
        tma_load_tile(kv_tiles + (2 * s + 1) * kFwdTileBytes, v_map, &kv_full[s], h,
                      kt * kFwdKeys, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows wg_row .. wg_row + 63; this thread rows
  // row0 and row0 + 8 (the accumulator layout, see hopper.cuh).
  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg_row = q_start + wg * 64;
  const int row0 = wg_row + (threadIdx.x % kWarpgroup) / 32 * 16 + g;
  const int row1 = row0 + 8;
  const int half = window / 2;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x·scale) = 2^(x·scale_log2)

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // Running max of the raw scores; l0, l1 sum this thread's columns only (the
  // quad's four partial sums are added in the epilogue).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (any_tile) mbar_wait(q_full, 0);
  const uint64_t q_desc = desc_sw<kRowBytes>(q_tile + wg * 64 * kRowBytes);

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % kFwdStages;
    mbar_wait(&kv_full[s], (i / kFwdStages) & 1);
    const int k0 = kt * kFwdKeys;
    const int k_last = k0 + kFwdKeys - 1;
    if (wg_row < seq_q && any_live(wg_row, k0, k_last, len, window)) {
      const uint8_t* k_tile = kv_tiles + 2 * s * kFwdTileBytes;
      const uint8_t* v_tile = k_tile + kFwdTileBytes;
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n128k16_ss(sc, q_desc + kc * kDescKStep,
                            desc_sw<kRowBytes>(k_tile) + kc * kDescKStep, kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Masks only where the tile crosses the length or the band's edge.
      if (!all_live(wg_row, k0, k_last, len, window)) {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int key = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
          const int row = e & 2 ? row1 : row0;
          const int dist = row > key ? row - key : key - row;
          if (key >= len || (window >= 0 && dist > half)) sc[e] = -INFINITY;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        if (e & 2)
          mx1 = fmaxf(mx1, sc[e]);
        else
          mx0 = fmaxf(mx0, sc[e]);
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // A row with no live key yet keeps m = -inf: subtract 0 there, so no
      // -inf − -inf arises and its P and correction are 0.
      const float base0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
      const float base1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
      const float corr0 = exp2_approx(m0 * scale_log2 - base0);
      const float corr1 = exp2_approx(m1 * scale_log2 - base1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        sc[e] = exp2_approx(fmaf(sc[e], scale_log2, e & 2 ? -base1 : -base0));
        if (e & 2)
          ps1 += sc[e];
        else
          ps0 += sc[e];
      }
      l0 = l0 * corr0 + ps0;
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= e & 2 ? corr1 : corr0;

      // O += P·V: P's bf16 pairs are the A registers, V is read MN-major.
      uint32_t pa[8][4];
      acc_to_a(sc, pa);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      const uint64_t v_desc = desc_sw<kRowBytes>(v_tile);
#pragma unroll
      for (int kc = 0; kc < kFwdKeys / 16; ++kc)
        wgmma_pv<D>(o, pa[kc], v_desc + kc * desc_row_step<kRowBytes>());
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    if ((threadIdx.x & 31) == 0) mbar_arrive(&kv_empty[s]);  // its warpgroup's products are done
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const long long tok_stride = (long long)heads * D;
  const long long base = (long long)b * seq_q * tok_stride + (long long)h * D;
  if constexpr (kPartial) {
    // The unnormalised float32 numerator, 8 bytes a store; m in the scaled
    // natural-log domain, -1e30 (not -inf) for a row with no live key.
    float* np = res.numer + base;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + 2 * t;
      if (row0 < seq_q)
        *reinterpret_cast<float2*>(np + (long long)row0 * tok_stride + d) =
            make_float2(o[4 * j], o[4 * j + 1]);
      if (row1 < seq_q)
        *reinterpret_cast<float2*>(np + (long long)row1 * tok_stride + d) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (t == 0) {  // the quad's four lanes hold the same m and l
      const long long r = (long long)bh * seq_q;
      if (row0 < seq_q) {
        res.m[r + row0] = m0 == -INFINITY ? kNegInf : m0 * scale;
        res.l[r + row0] = l0;
      }
      if (row1 < seq_q) {
        res.m[r + row1] = m1 == -INFINITY ? kNegInf : m1 * scale;
        res.l[r + row1] = l1;
      }
    }
  } else {
    __nv_bfloat16* op = res.out + base;
    const float den0 = fmaxf(l0, 1e-20f);
    const float den1 = fmaxf(l1, 1e-20f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + 2 * t;
      if (row0 < seq_q)
        *reinterpret_cast<__nv_bfloat162*>(op + (long long)row0 * tok_stride + d) =
            __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
      if (row1 < seq_q)
        *reinterpret_cast<__nv_bfloat162*>(op + (long long)row1 * tok_stride + d) =
            __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
    }
    if (res.lse != nullptr && t == 0) {  // the quad's four lanes hold the same m and l
      float* lp = res.lse + (long long)bh * seq_q;
      if (row0 < seq_q) lp[row0] = l0 > 0.f ? m0 * scale + logf(l0) : 0.f;
      if (row1 < seq_q) lp[row1] = l1 > 0.f ? m1 * scale + logf(l1) : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int seq,
                       int heads, int window, float scale) {
  wgmma_attention<false, D>(&q_map, &k_map, &v_map, lengths,
                            FwdOut{out, lse, nullptr, nullptr, nullptr}, seq, seq, heads, window,
                            0, scale);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_partial_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const int* __restrict__ lengths, float* __restrict__ numer,
                           float* __restrict__ m, float* __restrict__ l, int seq_q, int seq_k,
                           int heads, int k_offset, float scale) {
  wgmma_attention<true, D>(&q_map, &k_map, &v_map, lengths,
                           FwdOut{nullptr, nullptr, numer, m, l}, seq_q, seq_k, heads, -1,
                           k_offset, scale);
}

// The bf16 forward (k_offset < 0) or one ring step's partial (k_offset >= 0,
// numer/m/l given): tensor maps over q (seq_q) and k, v (seq_k), then one
// CTA per (128-row q tile, b·h).
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const int* lengths, FwdOut res,
                 int batch, int seq_q, int seq_k, int heads, int window, int k_offset, float scale,
                 cudaStream_t stream) {
  const bool partial = k_offset >= 0;
  constexpr int kSmem = FwdSmem<D>::kBytes;
  // An empty KV block is never loaded (no key is live); its maps span q.
  const void* kv_k = seq_k > 0 ? k : q;
  const void* kv_v = seq_k > 0 ? v : q;
  const int kv_seq = seq_k > 0 ? seq_k : seq_q;
  CUtensorMap q_map, k_map, v_map;
  if (int rc = hopper::make_tile_map<D>(&q_map, q, batch, seq_q, heads, kFwdRows)) return rc;
  if (int rc = hopper::make_tile_map<D>(&k_map, kv_k, batch, kv_seq, heads, kFwdKeys)) return rc;
  if (int rc = hopper::make_tile_map<D>(&v_map, kv_v, batch, kv_seq, heads, kFwdKeys)) return rc;
  const void* kernel = partial ? reinterpret_cast<const void*>(flash_partial_wgmma_kernel<D>)
                               : reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<D>);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq_q + kFwdRows - 1) / kFwdRows, batch * heads);
  if (partial) {
    flash_partial_wgmma_kernel<D><<<grid, kFwdThreads, kSmem, stream>>>(
        q_map, k_map, v_map, lengths, res.numer, res.m, res.l, seq_q, seq_k, heads, k_offset,
        scale);
    return (int)cudaGetLastError();
  }
  flash_fwd_wgmma_kernel<D><<<grid, kFwdThreads, kSmem, stream>>>(
      q_map, k_map, v_map, lengths, res.out, res.lse, seq_q, heads, window, scale);
  return (int)cudaGetLastError();
}

// The forward at head dim D: the wgmma body for bf16, the FMA kernel for
// float32.
template <int D>
int launch_forward(const void* q, const void* k, const void* v, const int* len, void* out,
                   float* lse, int batch, int seq, int heads, int window, int dtype,
                   cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)D);  // 1/8 (D = 64): exact
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, len,
                           FwdOut{static_cast<__nv_bfloat16*>(out), lse, nullptr, nullptr, nullptr},
                           batch, seq, seq, heads, window, -1, scale, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<false, D><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      len, static_cast<float*>(out), lse, nullptr, nullptr, seq, seq, heads, window, 0, scale);
  return (int)cudaGetLastError();
}

// One ring step's partial at head dim D: the wgmma body for bf16, the FMA
// kernel for float32; the scale is the forward's.
template <int D>
int launch_partial(const void* q, const void* k, const void* v, const int* len, float* numer,
                   float* m, float* l, int batch, int seq_q, int seq_k, int heads, int k_offset,
                   int dtype, cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)D);
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, len, FwdOut{nullptr, nullptr, numer, m, l}, batch, seq_q, seq_k,
                           heads, -1, k_offset, scale, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<true, D><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      len, numer, nullptr, m, l, seq_q, seq_k, heads, -1, k_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means global attention.
// lse: [B, H, S] float32 logsumexp output, or null. head_dim must be 32 or 64.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, void* lse, int batch, int seq,
                                   int heads, int head_dim, int window, int dtype, void* stream) {
  if (head_dim != 32 && head_dim != 64) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaSuccess;
  if ((long long)batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_out = static_cast<float*>(lse);
  if (head_dim == 32)
    return launch_forward<32>(q, k, v, len, out, lse_out, batch, seq, heads, window, dtype, s);
  return launch_forward<64>(q, k, v, len, out, lse_out, batch, seq, heads, window, dtype, s);
}

// One KV block's unnormalised contribution: q [B, seq_q, H, D], k and v
// [B, seq_k, H, D] (dtype 0 = float32, 1 = bfloat16), lengths [B] int32 global,
// k_offset >= 0 the global position of the block's first key. Writes numer
// [B, seq_q, H, D] float32, m and l [B, H, seq_q] float32. head_dim must be 32
// or 64. Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_partial(const void* q, const void* k, const void* v,
                                       const void* lengths, void* numer, void* m, void* l,
                                       int batch, int seq_q, int seq_k, int heads, int head_dim,
                                       int k_offset, int dtype, void* stream) {
  if (seq_k < 0 || k_offset < 0 || (head_dim != 32 && head_dim != 64))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || seq_q <= 0 || heads <= 0) return (int)cudaSuccess;
  if ((long long)batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* no = static_cast<float*>(numer);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (head_dim == 32)
    return launch_partial<32>(q, k, v, len, no, mo, lo, batch, seq_q, seq_k, heads, k_offset, dtype, s);
  return launch_partial<64>(q, k, v, len, no, mo, lo, batch, seq_q, seq_k, heads, k_offset, dtype, s);
}
