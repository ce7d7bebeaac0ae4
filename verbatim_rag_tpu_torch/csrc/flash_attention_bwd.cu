// Flash-attention backward (FlashAttention-2) for the encoder stack, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernels `verbatim_rag_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel`
// and `_flash_bwd_dkv_kernel` (the two pallas_calls of `flash_attention_bwd_tpu`).
//
// Computes, per batch row b and head h, with s = q·kᵀ/sqrt(D), the forward's
// logsumexp lse and delta = rowsum(dO ∘ O) (both [B, H, S] float32, given):
//     p  = exp(s − lse)            on live (q, k) pairs, 0 elsewhere
//     ds = p ∘ (dO·vᵀ − delta) / sqrt(D)
//     dq = ds·k,   dk = dsᵀ·q,   dv = pᵀ·dO
// A pair is live when k < lengths[b] and, for window >= 0, |q − k| <= window/2:
// the forward's masks. Query rows past lengths[b] take part like the TPU
// kernel's (their dO is 0 in a train step); a row with no live key gets zero
// gradients. q, k, v, dO and the outputs are [B, S, H, D] contiguous with
// D = 64 (ModernBERT's 12 × 64 heads) or D = 32 (MiniLM's 12 × 32 heads), in
// bfloat16 or float32; every sum is float32 and the outputs are written in
// the inputs' type. Any S is taken: the ragged edge is masked here.
//
// Two kernels, each in two variants (one per input type) and instantiated at
// both head dims, as the TPU kernels split the work: deterministic, no
// atomics, no second pass.
//
//   dq  — one CTA per (q tile, b·h); a loop over the key tiles the tile can
//         see (past the length, or outside the band, never loaded) recomputes
//         S and P from Q, K and lse, computes dP = dO·Vᵀ and dS, and
//         accumulates dq in registers.
//   dkv — one CTA per (key tile, b·h); a loop over the q tiles that can see it
//         (the band is symmetric, so their range is the mirror of the key
//         range) accumulates dk and dv in registers. The q tiles are the
//         reduction, as the TPU kernel's innermost grid axis is.
//
//   bf16 — wgmma fed by TMA. Two warpgroups of 64 rows each (q rows for dq,
//          keys for dk/dv); the CTA's own rows load once and the other
//          side's tiles stream through a 3-stage ring with full/empty
//          mbarriers (TMA, 128-byte swizzle, rows past S zero-filled), started
//          by a producer warp in dq (288 threads) and by thread 0 in dk/dv
//          (256 threads: its four accumulators a thread need more than the
//          168 registers ptxas allows a 288-thread wgmma kernel). dq:
//          S = Q·Kᵀ and dP = dO·Vᵀ (SS wgmma m64n64, both K-major), dS in
//          registers, dQ += dS·K (RS: dS's bf16 pairs are the A registers, K
//          is read MN-major through the descriptor's transpose bit). dk/dv: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (SS),
//          then Pᵀ and dSᵀ in registers and dV += Pᵀ·dO, dK += dSᵀ·Q (RS, dO
//          and Q MN-major; the dV product runs while dSᵀ is computed). A
//          wgmma accumulator gives each warp 16 rows in the mma.sync C layout,
//          which is the A layout of the next product, so P and dS never touch
//          shared memory and no tile is ever transposed. Masks are evaluated
//          only on tiles that straddle the length, the band or S; a
//          warpgroup with no live pair in a tile skips its products. P and dS
//          are rounded to bf16 for the second products.
//          At D = 32 a head row is 64 bytes: the tiles take the 64-byte
//          swizzle (TMA maps and descriptors alike), S and dP (Sᵀ, dPᵀ) stay
//          m64n64 with two k16 steps over D instead of four, and the three
//          products whose N is D (dQ += dS·K, dV += Pᵀ·dO, dK += dSᵀ·Q) are
//          m64n32 with K, dO and Q read MN-major through the 64-byte swizzle,
//          as the forward's P·V at D = 32. Threads, stages and tiles are
//          those of D = 64; the accumulators halve.
//   f32  — plain FMA on the CUDA cores with 32-row tiles in shared memory,
//          4 threads per row, p and ds passed between them by warp shuffle.
//
// Work: the split recomputes S and dP in both kernels, so it does seven
// products of 2·D FLOP per live pair and head (S, dP, dq in one; S, dP, dk,
// dv in the other): 14·D. The least work for the function is five products,
// 10·D, which is what the bound in `chip_smoke.py` counts. Global layers are
// compute-bound (with D = 64 the two exps per pair weigh as much as the
// products; at D = 32 they weigh twice as much against the 10·D products,
// so the multi-function units' exp rate bounds those layers before the
// tensor cores do); local layers are memory-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// Tiles [begin, end) of size kTile holding the keys a q tile [q_start,
// q_start + kRows) can see: keys below len and, for window >= 0, within
// window/2 of some row of the tile.
template <int kRows, int kTile>
__device__ __forceinline__ void key_tile_range(int q_start, int len, int window, int* begin,
                                               int* end) {
  int lo = 0;
  int hi = len;
  if (window >= 0) {
    const int half = window / 2;
    lo = q_start - half > 0 ? q_start - half : 0;
    const int top = q_start + kRows + half;  // exclusive
    hi = top < len ? top : len;
  }
  *begin = lo / kTile;
  *end = hi > lo ? (hi + kTile - 1) / kTile : *begin;
}

// The mirror: tiles of size kTile holding the query rows (below seq) that can
// see a key tile [k_start, k_start + kKeys). Empty when the whole key tile
// lies at or past len.
template <int kKeys, int kTile>
__device__ __forceinline__ void query_tile_range(int k_start, int len, int seq, int window,
                                                 int* begin, int* end) {
  int lo = 0;
  int hi = k_start < len ? seq : 0;
  if (window >= 0 && hi > 0) {
    const int half = window / 2;
    lo = k_start - half > 0 ? k_start - half : 0;
    const int top = k_start + kKeys + half;  // exclusive
    hi = top < seq ? top : seq;
  }
  *begin = lo / kTile;
  *end = hi > lo ? (hi + kTile - 1) / kTile : *begin;
}

__device__ __forceinline__ bool live(int qi, int key, int len, int window) {
  const int dist = qi > key ? qi - key : key - qi;
  return key < len && (window < 0 || dist <= window / 2);
}

// ---- bf16: wgmma fed by TMA -------------------------------------------------------------

constexpr int kBwdConsumers = 2 * hopper::kWarpgroup;  // two warpgroups of 64 rows
constexpr int kBwdThreads = kBwdConsumers + 32;        // + the TMA producer warp
constexpr int kBwdStages = 3;                          // ring depth
constexpr int kOwnRows = 128;   // the CTA's own rows: q rows (dq) or keys (dk/dv)
constexpr int kStreamRows = 64;  // rows of each streamed tile: keys (dq) or q rows (dk/dv)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of both kernels at head dim D: the CTA's own two tiles (Q, dO
// for dq; K, V for dk/dv), a ring of stages of two streamed tiles, then the
// barriers: own tiles loaded, and per stage full and empty (D = 64: 2 × 16 +
// 3 × 2 × 8 KB; D = 32: half).
template <int D>
struct BwdSmem {
  static constexpr int kRowBytes = hopper::head_row_bytes<D>();
  static constexpr int kOwnBytes = kOwnRows * kRowBytes;        // a tensor
  static constexpr int kStreamBytes = kStreamRows * kRowBytes;  // a tensor
  static constexpr int kStagesOffset = 2 * kOwnBytes;           // stage s: 2 tiles at s·2·kStreamBytes
  static constexpr int kBarOffset = kStagesOffset + kBwdStages * 2 * kStreamBytes;
  static constexpr int kBytes = kBarOffset + (1 + 2 * kBwdStages) * 8 + 1024;  // + alignment slack
  uint8_t* base;
  __device__ uint8_t* own(int i) const { return base + i * kOwnBytes; }
  __device__ uint8_t* stream(int s, int i) const {
    return base + kStagesOffset + (2 * s + i) * kStreamBytes;
  }
  __device__ uint64_t* own_full() const { return reinterpret_cast<uint64_t*>(base + kBarOffset); }
  __device__ uint64_t* full(int s) const { return own_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const { return own_full() + 1 + kBwdStages + s; }
};

// Barriers: the own tiles' and each stage's full (one arrival + bytes) and
// each stage's empty (every consumer thread).
template <int D>
__device__ __forceinline__ void init_barriers(const BwdSmem<D>& sm) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(sm.own_full(), 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(sm.full(s), 1);
      hopper::mbar_init(sm.empty(s), kBwdConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// Writes rows r0 and r0 + 8 (below seq) of a [B, S, H, D] bf16 tensor from
// a wgmma m64nD accumulator.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* x, long long base, long long tok_stride,
                                           int r0, int seq, int t, const float (&acc)[D / 2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(x + base + (long long)r0 * tok_stride + d) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < seq)
      *reinterpret_cast<__nv_bfloat162*>(x + base + (long long)(r0 + 8) * tok_stride + d) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dq,
                          int seq, int heads, int window, float scale) {
  using namespace hopper;
  using Smem = BwdSmem<D>;
  constexpr int kRowBytes = Smem::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm{smem_base_1024(smem_raw)};

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_start = blockIdx.x * kOwnRows;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > seq ? seq : len);
  int kt_begin, kt_end;
  key_tile_range<kOwnRows, kStreamRows>(q_start, len, window, &kt_begin, &kt_end);

  init_barriers(sm);

  if (threadIdx.x >= kBwdConsumers) {
    // Producer warp: one thread loads Q and dO, then keeps the K/V ring full.
    if (threadIdx.x == kBwdConsumers) {
      mbar_arrive_expect_tx(sm.own_full(), 2 * Smem::kOwnBytes);
      tma_load_tile(sm.own(0), &q_map, sm.own_full(), h, q_start, b);
      tma_load_tile(sm.own(1), &do_map, sm.own_full(), h, q_start, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % kBwdStages;
        if (i >= kBwdStages) mbar_wait(sm.empty(s), (i / kBwdStages - 1) & 1);
        mbar_arrive_expect_tx(sm.full(s), 2 * Smem::kStreamBytes);
        tma_load_tile(sm.stream(s, 0), &k_map, sm.full(s), h, kt * kStreamRows, b);
        tma_load_tile(sm.stream(s, 1), &v_map, sm.full(s), h, kt * kStreamRows, b);
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg_row = q_start + wg * 64;
  const int row0 = wg_row + (threadIdx.x % kWarpgroup) / 32 * 16 + g;  // and row0 + 8
  const int row1 = row0 + 8;
  const int half = window / 2;
  const float scale_log2 = scale * kLog2e;

  const float* lse_bh = lse + (long long)bh * seq;
  const float* delta_bh = delta + (long long)bh * seq;
  const float lse0 = row0 < seq ? lse_bh[row0] * kLog2e : 0.f;
  const float lse1 = row1 < seq ? lse_bh[row1] * kLog2e : 0.f;
  const float dl0 = row0 < seq ? delta_bh[row0] : 0.f;
  const float dl1 = row1 < seq ? delta_bh[row1] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(sm.own_full(), 0);
  const uint64_t q_desc = desc_sw<kRowBytes>(sm.own(0) + wg * 64 * kRowBytes);
  const uint64_t do_desc = desc_sw<kRowBytes>(sm.own(1) + wg * 64 * kRowBytes);

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % kBwdStages;
    mbar_wait(sm.full(s), (i / kBwdStages) & 1);
    const int k0 = kt * kStreamRows;
    const int k_last = k0 + kStreamRows - 1;
    if (wg_row < seq && hopper::any_live(wg_row, k0, k_last, len, window)) {
      const uint64_t k_desc = desc_sw<kRowBytes>(sm.stream(s, 0));
      const uint64_t v_desc = desc_sw<kRowBytes>(sm.stream(s, 1));
      // S = Q·Kᵀ and dP = dO·Vᵀ.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n64k16_ss(sc, q_desc + kc * kDescKStep, k_desc + kc * kDescKStep, kc);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n64k16_ss(dp, do_desc + kc * kDescKStep, v_desc + kc * kDescKStep, kc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      if (!hopper::all_live(wg_row, k0, k_last, len, window)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
          const int row = e & 2 ? row1 : row0;
          const int dist = row > key ? row - key : key - row;
          if (key >= len || (window >= 0 && dist > half)) sc[e] = -INFINITY;
        }
      }
      // dS = P ∘ (dP − delta)·scale with P = exp(S·scale − lse), into sc.
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = exp2_approx(fmaf(sc[e], scale_log2, e & 2 ? -lse1 : -lse0));
        sc[e] = p * (dp[e] - (e & 2 ? dl1 : dl0)) * scale;
      }

      // dQ += dS·K (m64nD): dS's bf16 pairs are the A registers, K is read
      // MN-major.
      uint32_t da[4][4];
      acc_to_a(sc, da);
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kStreamRows / 16; ++kc)
        wgmma_pv<D>(acc, da[kc], k_desc + kc * desc_row_step<kRowBytes>());
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(sm.empty(s));
  }

  const long long tok_stride = (long long)heads * D;
  store_rows<D>(dq, (long long)b * seq * tok_stride + (long long)h * D, tok_stride, row0, seq, t, acc);
}

// Stage j % kBwdStages of the dk/dv ring gets q tile q0: Q and dO by TMA.
template <int D>
__device__ __forceinline__ void load_q_tile(const BwdSmem<D>& sm, int j, int q0,
                                            const CUtensorMap* q_map, const CUtensorMap* do_map,
                                            int h, int b) {
  using namespace hopper;
  const int s = j % kBwdStages;
  mbar_arrive_expect_tx(sm.full(s), 2 * BwdSmem<D>::kStreamBytes);
  tma_load_tile(sm.stream(s, 0), q_map, sm.full(s), h, q0, b);
  tma_load_tile(sm.stream(s, 1), do_map, sm.full(s), h, q0, b);
}

// Four accumulators a thread (dK, dV, Sᵀ, dPᵀ) need more than the 168
// registers ptxas allows a wgmma kernel of 288 threads, so this kernel has no
// producer warp: 256 threads (up to 255 registers), thread 0 issuing the
// loads. It fills the ring, then after each q tile refills the stage of the
// tile before, which leaves the other warpgroup one tile of slack. Each
// thread reads the lse and delta of its own 16 q columns from global memory
// while the tile's first products run.
template <int D>
__global__ void __launch_bounds__(kBwdConsumers, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int seq, int heads, int window,
                           float scale) {
  using namespace hopper;
  using Smem = BwdSmem<D>;
  constexpr int kRowBytes = Smem::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm{smem_base_1024(smem_raw)};

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k_start = blockIdx.x * kOwnRows;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > seq ? seq : len);
  int qt_begin, qt_end;
  query_tile_range<kOwnRows, kStreamRows>(k_start, len, seq, window, &qt_begin, &qt_end);
  const int n_tiles = qt_end - qt_begin;

  init_barriers(sm);

  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(sm.own_full(), 2 * Smem::kOwnBytes);
    tma_load_tile(sm.own(0), &k_map, sm.own_full(), h, k_start, b);
    tma_load_tile(sm.own(1), &v_map, sm.own_full(), h, k_start, b);
    for (int j = 0; j < kBwdStages && j < n_tiles; ++j)
      load_q_tile(sm, j, (qt_begin + j) * kStreamRows, &q_map, &do_map, h, b);
  }

  const float* lse_bh = lse + (long long)bh * seq;
  const float* delta_bh = delta + (long long)bh * seq;
  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg_key = k_start + wg * 64;
  const int key0 = wg_key + (threadIdx.x % kWarpgroup) / 32 * 16 + g;  // and key0 + 8
  const int key1 = key0 + 8;
  const int half = window / 2;
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(sm.own_full(), 0);
  const uint64_t k_desc = desc_sw<kRowBytes>(sm.own(0) + wg * 64 * kRowBytes);
  const uint64_t v_desc = desc_sw<kRowBytes>(sm.own(1) + wg * 64 * kRowBytes);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kBwdStages;
    mbar_wait(sm.full(s), (i / kBwdStages) & 1);
    const int q0 = (qt_begin + i) * kStreamRows;
    const int q_last = q0 + kStreamRows - 1;
    // The band is symmetric: the q tile's rows against this warpgroup's keys.
    if (any_live(q0, wg_key, wg_key + 63, len, window)) {
      const uint64_t q_desc = desc_sw<kRowBytes>(sm.stream(s, 0));
      const uint64_t do_desc = desc_sw<kRowBytes>(sm.stream(s, 1));
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows are keys, columns q rows.
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n64k16_ss(st, k_desc + kc * kDescKStep, q_desc + kc * kDescKStep, kc);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n64k16_ss(dpt, v_desc + kc * kDescKStep, do_desc + kc * kDescKStep, kc);
      wgmma_commit();
      // While they run: lse·log2(e) and delta of this thread's columns
      // 8j + 2t + c (q rows q0 + that; 0 past seq, where P is masked).
      float lse2[16], dl[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = q0 + 8 * j + 2 * t + c;
          lse2[2 * j + c] = qi < seq ? lse_bh[qi] * kLog2e : 0.f;
          dl[2 * j + c] = qi < seq ? delta_bh[qi] : 0.f;
        }
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      if (q_last >= seq || !all_live(q0, wg_key, wg_key + 63, len, window)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = q0 + (e >> 2) * 8 + 2 * t + (e & 1);
          const int key = e & 2 ? key1 : key0;
          const int dist = qi > key ? qi - key : key - qi;
          if (qi >= seq || key >= len || (window >= 0 && dist > half)) st[e] = -INFINITY;
        }
      }
      // Pᵀ = exp(Sᵀ·scale − lse[q]); element e is column 8(e / 4) + 2t + e % 2.
#pragma unroll
      for (int e = 0; e < 32; ++e)
        st[e] = exp2_approx(fmaf(st[e], scale_log2, -lse2[e / 4 * 2 + (e & 1)]));
      // dV += Pᵀ·dO (m64nD, dO read MN-major), running while dSᵀ is computed.
      uint32_t pa[4][4];
      acc_to_a(st, pa);
      fence_regs(dv_acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kStreamRows / 16; ++kc)
        wgmma_pv<D>(dv_acc, pa[kc], do_desc + kc * desc_row_step<kRowBytes>());
      wgmma_commit();
      // dSᵀ = Pᵀ ∘ (dPᵀ − delta[q])·scale, then dK += dSᵀ·Q (Q read MN-major).
#pragma unroll
      for (int e = 0; e < 32; ++e) dpt[e] = st[e] * (dpt[e] - dl[e / 4 * 2 + (e & 1)]) * scale;
      uint32_t sa[4][4];
      acc_to_a(dpt, sa);
      fence_regs(dk_acc);
      fence_regs(sa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kStreamRows / 16; ++kc)
        wgmma_pv<D>(dk_acc, sa[kc], q_desc + kc * desc_row_step<kRowBytes>());
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    mbar_arrive(sm.empty(s));
    // Thread 0 refills the previous tile's stage once both warpgroups are
    // done with it.
    const int next = i - 1 + kBwdStages;
    if (threadIdx.x == 0 && i >= 1 && next < n_tiles) {
      mbar_wait(sm.empty((i - 1) % kBwdStages), ((i - 1) / kBwdStages) & 1);
      load_q_tile(sm, next, (qt_begin + next) * kStreamRows, &q_map, &do_map, h, b);
    }
  }

  const long long tok_stride = (long long)heads * D;
  const long long base = (long long)b * seq * tok_stride + (long long)h * D;
  store_rows<D>(dk, base, tok_stride, key0, seq, t, dk_acc);
  store_rows<D>(dv, base, tok_stride, key0, seq, t, dv_acc);
}

// The four tile maps of one backward kernel: the CTA's own rows (128) of
// own0, own1 and the streamed rows (64) of str0, str1.
template <int D>
int make_bwd_maps(CUtensorMap (&maps)[4], const void* own0, const void* own1, const void* str0,
                  const void* str1, int batch, int seq, int heads) {
  const void* bases[4] = {own0, own1, str0, str1};
  for (int i = 0; i < 4; ++i)
    if (int rc = hopper::make_tile_map<D>(&maps[i], bases[i], batch, seq, heads,
                                          i < 2 ? kOwnRows : kStreamRows))
      return rc;
  return (int)cudaSuccess;
}

// ---- float32: FMA on the CUDA cores ------------------------------------------------

constexpr int kF32Tile = 32;                         // q rows and keys per tile
constexpr int kF32Sub = 4;                           // threads per row
constexpr int kF32Threads = kF32Tile * kF32Sub;      // 128
constexpr int kF32PerThread = kF32Tile / kF32Sub;    // 8 partners per thread

// Per head dim: float4 output chunks per thread (4 at D = 64, 2 at D = 32)
// and the shared row stride in floats.
template <int D>
constexpr int kF32Chunks = D / (4 * kF32Sub);
template <int D>
constexpr int kF32Pad = D + 4;

// Rows [r_start, r_start + kF32Tile) of two [B, S, H, D] tensors into [row][d]
// tiles; rows past seq are 0.
template <int D>
__device__ __forceinline__ void load_f32_tiles(const float* x, const float* y, long long base,
                                               long long tok_stride, int r_start, int seq,
                                               float (*xs)[kF32Pad<D>], float (*ys)[kF32Pad<D>]) {
  for (int i = threadIdx.x; i < kF32Tile * (D / 4); i += kF32Threads) {
    const int r = i / (D / 4);
    const int d = (i - r * (D / 4)) * 4;
    const int row = r_start + r;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
    if (row < seq) {
      const long long off = base + (long long)row * tok_stride + d;
      xv = *reinterpret_cast<const float4*>(x + off);
      yv = *reinterpret_cast<const float4*>(y + off);
    }
    *reinterpret_cast<float4*>(&xs[r][d]) = xv;
    *reinterpret_cast<float4*>(&ys[r][d]) = yv;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// acc[chunk] += w · row[chunk] over this thread's d chunks.
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[4 * kF32Chunks<D>], float w, const float* row,
                                         int sub) {
#pragma unroll
  for (int c = 0; c < kF32Chunks<D>; ++c) {
    const int d = (sub + kF32Sub * c) * 4;
    const float4 x = *reinterpret_cast<const float4*>(row + d);
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* out, const float (&acc)[4 * kF32Chunks<D>],
                                          int sub) {
#pragma unroll
  for (int c = 0; c < kF32Chunks<D>; ++c) {
    const int d = (sub + kF32Sub * c) * 4;
    *reinterpret_cast<float4*>(out + d) =
        make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ lengths, float* __restrict__ dq, int seq,
                        int heads, int window, float scale) {
  __shared__ __align__(16) float q_s[kF32Tile][kF32Pad<D>];
  __shared__ __align__(16) float do_s[kF32Tile][kF32Pad<D>];
  __shared__ __align__(16) float k_s[kF32Tile][kF32Pad<D>];
  __shared__ __align__(16) float v_s[kF32Tile][kF32Pad<D>];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_start = blockIdx.x * kF32Tile;
  const int row = threadIdx.x / kF32Sub;
  const int sub = threadIdx.x % kF32Sub;
  const int lane0 = (threadIdx.x & 31) & ~(kF32Sub - 1);
  const int qi = q_start + row;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > seq ? seq : len);

  const long long tok_stride = (long long)heads * D;
  const long long base = (long long)b * seq * tok_stride + (long long)h * D;
  const float lse_r = qi < seq ? lse[(long long)bh * seq + qi] : 0.f;
  const float delta_r = qi < seq ? delta[(long long)bh * seq + qi] : 0.f;

  load_f32_tiles<D>(q, dout, base, tok_stride, q_start, seq, q_s, do_s);

  float acc[4 * kF32Chunks<D>];
#pragma unroll
  for (int i = 0; i < 4 * kF32Chunks<D>; ++i) acc[i] = 0.f;

  int kt_begin, kt_end;
  key_tile_range<kF32Tile, kF32Tile>(q_start, len, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();  // the previous tile has been consumed (and Q, dO stored)
    load_f32_tiles<D>(k, v, base, tok_stride, k0, seq, k_s, v_s);
    __syncthreads();

    // ds for keys kk = sub + kF32Sub·j.
    float ds[kF32PerThread];
#pragma unroll
    for (int j = 0; j < kF32PerThread; ++j) {
      const int kk = sub + kF32Sub * j;
      const float s = dot_rows<D>(q_s[row], k_s[kk]);
      const float dp = dot_rows<D>(do_s[row], v_s[kk]);
      const float p = live(qi, k0 + kk, len, window) ? expf(s * scale - lse_r) : 0.f;
      ds[j] = p * (dp - delta_r) * scale;
    }
    // dq += Σ_kk ds[kk] · K[kk]; key kk's ds lives in lane lane0 + kk % kF32Sub.
#pragma unroll
    for (int kk = 0; kk < kF32Tile; ++kk) {
      const float w = __shfl_sync(0xffffffffu, ds[kk / kF32Sub], lane0 + kk % kF32Sub);
      axpy_row<D>(acc, w, k_s[kk], sub);
    }
  }
  if (qi < seq) store_row<D>(dq + base + (long long)qi * tok_stride, acc, sub);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ lengths, float* __restrict__ dk,
                         float* __restrict__ dv, int seq, int heads, int window, float scale) {
  __shared__ __align__(16) float k_s[kF32Tile][kF32Pad<D>];
  __shared__ __align__(16) float v_s[kF32Tile][kF32Pad<D>];
  __shared__ __align__(16) float q_s[kF32Tile][kF32Pad<D>];
  __shared__ __align__(16) float do_s[kF32Tile][kF32Pad<D>];
  __shared__ float lse_s[kF32Tile];
  __shared__ float delta_s[kF32Tile];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k_start = blockIdx.x * kF32Tile;
  const int row = threadIdx.x / kF32Sub;
  const int sub = threadIdx.x % kF32Sub;
  const int lane0 = (threadIdx.x & 31) & ~(kF32Sub - 1);
  const int key = k_start + row;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > seq ? seq : len);

  const long long tok_stride = (long long)heads * D;
  const long long base = (long long)b * seq * tok_stride + (long long)h * D;
  const float* lse_bh = lse + (long long)bh * seq;
  const float* delta_bh = delta + (long long)bh * seq;

  load_f32_tiles<D>(k, v, base, tok_stride, k_start, seq, k_s, v_s);

  float dk_acc[4 * kF32Chunks<D>], dv_acc[4 * kF32Chunks<D>];
#pragma unroll
  for (int i = 0; i < 4 * kF32Chunks<D>; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  int qt_begin, qt_end;
  query_tile_range<kF32Tile, kF32Tile>(k_start, len, seq, window, &qt_begin, &qt_end);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kF32Tile;
    __syncthreads();  // the previous tile has been consumed (and K, V stored)
    load_f32_tiles<D>(q, dout, base, tok_stride, q0, seq, q_s, do_s);
    for (int i = threadIdx.x; i < kF32Tile; i += kF32Threads) {
      lse_s[i] = q0 + i < seq ? lse_bh[q0 + i] : 0.f;
      delta_s[i] = q0 + i < seq ? delta_bh[q0 + i] : 0.f;
    }
    __syncthreads();

    // p and ds for q rows qq = sub + kF32Sub·j.
    float p[kF32PerThread], ds[kF32PerThread];
#pragma unroll
    for (int j = 0; j < kF32PerThread; ++j) {
      const int qq = sub + kF32Sub * j;
      const int qi = q0 + qq;
      const float s = dot_rows<D>(k_s[row], q_s[qq]);
      const float dp = dot_rows<D>(v_s[row], do_s[qq]);
      p[j] = qi < seq && live(qi, key, len, window) ? expf(s * scale - lse_s[qq]) : 0.f;
      ds[j] = p[j] * (dp - delta_s[qq]) * scale;
    }
#pragma unroll
    for (int qq = 0; qq < kF32Tile; ++qq) {
      const int src = lane0 + qq % kF32Sub;
      axpy_row<D>(dv_acc, __shfl_sync(0xffffffffu, p[qq / kF32Sub], src), do_s[qq], sub);
      axpy_row<D>(dk_acc, __shfl_sync(0xffffffffu, ds[qq / kF32Sub], src), q_s[qq], sub);
    }
  }
  if (key < seq) {
    store_row<D>(dk + base + (long long)key * tok_stride, dk_acc, sub);
    store_row<D>(dv + base + (long long)key * tok_stride, dv_acc, sub);
  }
}

int check_shape(int batch, int seq, int heads, int head_dim) {
  if (head_dim != 32 && head_dim != 64) return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSuccess;
}

// 1/sqrt(D): 1/8 at D = 64 (exact); at D = 32 the float the forward scales
// by (`flash_attention.cu::launch_forward`), so p = exp(s − lse) reads the
// lse the forward wrote on its own scale.
template <int D>
float head_scale() {
  return 1.0f / sqrtf((float)D);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* len, void* dq, int batch, int seq, int heads,
              int window, int dtype, cudaStream_t s) {
  const float scale = head_scale<D>();
  if (dtype == 0) {
    const dim3 grid((seq + kF32Tile - 1) / kF32Tile, batch * heads);
    flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, len, static_cast<float*>(dq), seq, heads,
        window, scale);
  } else if (dtype == 1) {
    constexpr int kSmem = BwdSmem<D>::kBytes;
    CUtensorMap maps[4];
    if (int rc = make_bwd_maps<D>(maps, q, dout, k, v, batch, seq, heads)) return rc;
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((seq + kOwnRows - 1) / kOwnRows, batch * heads);
    flash_bwd_dq_wgmma_kernel<D><<<grid, kBwdThreads, kSmem, s>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta, len, static_cast<__nv_bfloat16*>(dq), seq,
        heads, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* len, void* dk, void* dv, int batch, int seq,
               int heads, int window, int dtype, cudaStream_t s) {
  const float scale = head_scale<D>();
  if (dtype == 0) {
    const dim3 grid((seq + kF32Tile - 1) / kF32Tile, batch * heads);
    flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, len, static_cast<float*>(dk),
        static_cast<float*>(dv), seq, heads, window, scale);
  } else if (dtype == 1) {
    constexpr int kSmem = BwdSmem<D>::kBytes;
    CUtensorMap maps[4];
    if (int rc = make_bwd_maps<D>(maps, k, v, q, dout, batch, seq, heads)) return rc;
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((seq + kOwnRows - 1) / kOwnRows, batch * heads);
    flash_bwd_dkv_wgmma_kernel<D><<<grid, kBwdConsumers, kSmem, s>>>(
        maps[0], maps[1], maps[2], maps[3], lse, delta, len, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), seq, heads, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs share it).
// lse, delta: [B, H, S] float32. window < 0 means global attention. head_dim
// must be 32 or 64. Each returns the CUDA error code of its launch (0 on
// success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* lengths, void* dq,
                            int batch, int seq, int heads, int head_dim, int window, int dtype,
                            void* stream) {
  if (int rc = check_shape(batch, seq, heads, head_dim)) return rc;
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (head_dim == 32)
    return launch_dq<32>(q, k, v, dout, l, dl, len, dq, batch, seq, heads, window, dtype, s);
  return launch_dq<64>(q, k, v, dout, l, dl, len, dq, batch, seq, heads, window, dtype, s);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* lengths, void* dk,
                             void* dv, int batch, int seq, int heads, int head_dim, int window,
                             int dtype, void* stream) {
  if (int rc = check_shape(batch, seq, heads, head_dim)) return rc;
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (head_dim == 32)
    return launch_dkv<32>(q, k, v, dout, l, dl, len, dk, dv, batch, seq, heads, window, dtype, s);
  return launch_dkv<64>(q, k, v, dout, l, dl, len, dk, dv, batch, seq, heads, window, dtype, s);
}
