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
// D = 64, in bfloat16 or float32; every sum is float32 and the outputs are
// written in the inputs' type. Any S is taken: the ragged edge is masked here.
//
// Two kernels, each in two variants (one per input type):
//
//   dq  — one thread block per (q tile, b·h); a loop over the key tiles the
//         tile can see (past the length, or outside the band, never loaded)
//         recomputes S and P from Q, K and lse, computes dP = dO·Vᵀ, and
//         accumulates dq in registers.
//   dkv — one thread block per (key tile, b·h); a loop over the q tiles that
//         can see it (the band is symmetric, so their range is the mirror of
//         the key range) accumulates dk and dv in registers. The q tiles are
//         the reduction, as the TPU kernel's innermost grid axis is: no
//         atomics, no second pass.
//
//   bf16 — tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate),
//          4 warps of 16 rows. The dkv kernel computes Sᵀ = K·Qᵀ and
//          dPᵀ = V·dOᵀ directly (K and V rows are the A operands), so Pᵀ and
//          dSᵀ land in registers in exactly the layout of the A fragments of
//          Pᵀ·dO and dSᵀ·Q, as P does in the forward; the dq kernel reuses dS
//          the same way for dS·K. Each B operand that contracts over rows
//          (K for dq, Q and dO for dkv) is also kept transposed in shared
//          memory, so every fragment is one 32-bit load. P and dS are rounded
//          to bf16 for the second products.
//   f32  — plain FMA on the CUDA cores with 32-row tiles in shared memory,
//          4 threads per row, p and ds passed between them by warp shuffle.
//
// Bound on an H100 SXM: global layers are compute-bound (10·D FLOP per live
// pair and head: S recomputed twice, dP twice, dq, dk and dv once each in
// the TPU kernels' split; about 2.5× the forward); local layers are
// memory-bound. Like the forward, both kernels load their tiles
// synchronously and use mma.sync, not wgmma; pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;  // head dim: ModernBERT's 12 × 64 heads

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

// ---- bf16: tensor cores through mma.sync -------------------------------------------

constexpr int kTile = 64;             // q rows and keys per tile
constexpr int kMmaThreads = 128;      // 4 warps × 16 rows
constexpr int kStride = D + 8;        // [row][d] tiles: bf16 per shared row (bank spread)
constexpr int kTStride = kTile + 8;   // [d][row] tiles

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ unsigned load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// A fragments (16 rows × D) of rows r0 and r0 + 8 of a [B, S, H, D] tensor; 0 past seq.
__device__ __forceinline__ void load_a_rows(const __nv_bfloat16* x, long long base,
                                            long long tok_stride, int r0, int seq, int t,
                                            unsigned (&a)[D / 16][4]) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int d = kc * 16 + 2 * t;
    const __nv_bfloat16* p0 = x + base + (long long)r0 * tok_stride + d;
    const __nv_bfloat16* p1 = x + base + (long long)r1 * tok_stride + d;
    a[kc][0] = r0 < seq ? load_u32(p0) : 0u;
    a[kc][1] = r1 < seq ? load_u32(p1) : 0u;
    a[kc][2] = r0 < seq ? load_u32(p0 + 8) : 0u;
    a[kc][3] = r1 < seq ? load_u32(p1 + 8) : 0u;
  }
}

// Rows [r_start, r_start + kTile) of two [B, S, H, D] tensors into shared
// memory: x as [row][d] (and, when xt is given, also as [d][row]), y as
// [row][d] (and yt as [d][row]); rows past seq are 0.
__device__ __forceinline__ void load_tiles(const __nv_bfloat16* x, const __nv_bfloat16* y,
                                           long long base, long long tok_stride, int r_start,
                                           int seq, __nv_bfloat16* xs, __nv_bfloat16* ys,
                                           __nv_bfloat16* xt, __nv_bfloat16* yt) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const int row = r_start + r;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = make_uint4(0u, 0u, 0u, 0u);
    if (row < seq) {
      const long long off = base + (long long)row * tok_stride + c;
      xv = *reinterpret_cast<const uint4*>(x + off);
      yv = *reinterpret_cast<const uint4*>(y + off);
    }
    *reinterpret_cast<uint4*>(&xs[r * kStride + c]) = xv;
    *reinterpret_cast<uint4*>(&ys[r * kStride + c]) = yv;
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
    const __nv_bfloat16* ye = reinterpret_cast<const __nv_bfloat16*>(&yv);
    if (xt != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) xt[(c + e) * kTStride + r] = xe[e];
    }
    if (yt != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) yt[(c + e) * kTStride + r] = ye[e];
    }
  }
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16×16, row-major): reg0 (g, 2t..2t+1), reg1 (g+8, 2t..), reg2 (g, 2t+8..),
//                         reg3 (g+8, 2t+8..)
//   B (16×8, k × n):      reg0 (k = 2t..2t+1, n = g), reg1 (k = 2t+8..2t+9, n = g)
//   C (16×8, f32):        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// so the C tiles of n-tiles 2kc and 2kc+1 are, packed to bf16, the A fragment
// of k-step kc of the next product.
__device__ __forceinline__ void c_to_a(const float (&lo)[4], const float (&hi)[4],
                                       unsigned (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ lengths, __nv_bfloat16* __restrict__ dq, int seq,
                        int heads, int window, float scale) {
  constexpr int kNT = kTile / 8;  // n-tiles of S (keys) and of dq (d)
  constexpr int kKS = kTile / 16;  // k-steps of dS·K (keys)

  __shared__ __align__(16) __nv_bfloat16 k_tile[kTile * kStride];    // [key][d]
  __shared__ __align__(16) __nv_bfloat16 v_tile[kTile * kStride];    // [key][d]
  __shared__ __align__(16) __nv_bfloat16 kt_tile[D * kTStride];      // [d][key]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_start = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q_start + (threadIdx.x / 32) * 16 + g;
  const int row1 = row0 + 8;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > seq ? seq : len);

  const long long tok_stride = (long long)heads * D;
  const long long base = (long long)b * seq * tok_stride + (long long)h * D;
  const float* lse_bh = lse + (long long)bh * seq;
  const float* delta_bh = delta + (long long)bh * seq;

  unsigned qa[D / 16][4], da[D / 16][4];
  load_a_rows(q, base, tok_stride, row0, seq, t, qa);
  load_a_rows(dout, base, tok_stride, row0, seq, t, da);
  const float lse0 = row0 < seq ? lse_bh[row0] : 0.f, lse1 = row1 < seq ? lse_bh[row1] : 0.f;
  const float dl0 = row0 < seq ? delta_bh[row0] : 0.f, dl1 = row1 < seq ? delta_bh[row1] : 0.f;

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int kt_begin, kt_end;
  key_tile_range<kTile, kTile>(q_start, len, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile has been consumed
    load_tiles(k, v, base, tok_stride, k0, seq, k_tile, v_tile, kt_tile, nullptr);
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ, 8 n-tiles of 8 keys each.
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int off = (j * 8 + g) * kStride + kc * 16 + 2 * t;
        mma_bf16(s[j], qa[kc], load_u32(&k_tile[off]), load_u32(&k_tile[off + 8]));
        mma_bf16(dp[j], da[kc], load_u32(&v_tile[off]), load_u32(&v_tile[off + 8]));
      }
    }

    // dS = P ∘ (dP − delta)·scale with P = exp(S·scale − lse) on live pairs; into s.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool top = e < 2;
        const float p = live(top ? row0 : row1, key, len, window)
                            ? expf(s[j][e] * scale - (top ? lse0 : lse1))
                            : 0.f;
        s[j][e] = p * (dp[j][e] - (top ? dl0 : dl1)) * scale;
      }
    }

    // dQ += dS·K: dS's accumulators are the A fragments, K comes from [d][key].
#pragma unroll
    for (int kc = 0; kc < kKS; ++kc) {
      unsigned sa[4];
      c_to_a(s[2 * kc], s[2 * kc + 1], sa);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int off = (j * 8 + g) * kTStride + kc * 16 + 2 * t;
        mma_bf16(acc[j], sa, load_u32(&kt_tile[off]), load_u32(&kt_tile[off + 8]));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int d = j * 8 + 2 * t;
    if (row0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (long long)row0 * tok_stride + d) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (row1 < seq)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (long long)row1 * tok_stride + d) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int seq,
                         int heads, int window, float scale) {
  constexpr int kNT = kTile / 8;   // n-tiles of Sᵀ (q rows) and of dk, dv (d)
  constexpr int kKS = kTile / 16;  // k-steps of Pᵀ·dO and dSᵀ·Q (q rows)

  __shared__ __align__(16) __nv_bfloat16 q_tile[kTile * kStride];   // [q][d]
  __shared__ __align__(16) __nv_bfloat16 do_tile[kTile * kStride];  // [q][d]
  __shared__ __align__(16) __nv_bfloat16 qt_tile[D * kTStride];     // [d][q]
  __shared__ __align__(16) __nv_bfloat16 dot_tile[D * kTStride];    // [d][q]
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k_start = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = k_start + (threadIdx.x / 32) * 16 + g;  // this thread's keys: key0, key0 + 8
  const int key1 = key0 + 8;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > seq ? seq : len);

  const long long tok_stride = (long long)heads * D;
  const long long base = (long long)b * seq * tok_stride + (long long)h * D;
  const float* lse_bh = lse + (long long)bh * seq;
  const float* delta_bh = delta + (long long)bh * seq;

  unsigned ka[D / 16][4], va[D / 16][4];
  load_a_rows(k, base, tok_stride, key0, seq, t, ka);
  load_a_rows(v, base, tok_stride, key0, seq, t, va);

  float dk_acc[kNT][4], dv_acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  int qt_begin, qt_end;
  query_tile_range<kTile, kTile>(k_start, len, seq, window, &qt_begin, &qt_end);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile has been consumed
    load_tiles(q, dout, base, tok_stride, q0, seq, q_tile, do_tile, qt_tile, dot_tile);
    for (int i = threadIdx.x; i < kTile; i += kMmaThreads) {
      const int qi = q0 + i;
      lse_tile[i] = qi < seq ? lse_bh[qi] : 0.f;
      delta_tile[i] = qi < seq ? delta_bh[qi] : 0.f;
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows are this warp's 16 keys, n-tiles 8 q rows.
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const int off = (j * 8 + g) * kStride + kc * 16 + 2 * t;
        mma_bf16(s[j], ka[kc], load_u32(&q_tile[off]), load_u32(&q_tile[off + 8]));
        mma_bf16(dp[j], va[kc], load_u32(&do_tile[off]), load_u32(&do_tile[off + 8]));
      }
    }

    // Pᵀ into s, dSᵀ into dp.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int qi = q0 + col;
        const bool ok = qi < seq && live(qi, e < 2 ? key0 : key1, len, window);
        const float p = ok ? expf(s[j][e] * scale - lse_tile[col]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_tile[col]) * scale;
      }
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q; dO and Q come from their [d][q] copies.
#pragma unroll
    for (int kc = 0; kc < kKS; ++kc) {
      unsigned pa[4], sa[4];
      c_to_a(s[2 * kc], s[2 * kc + 1], pa);
      c_to_a(dp[2 * kc], dp[2 * kc + 1], sa);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int off = (j * 8 + g) * kTStride + kc * 16 + 2 * t;
        mma_bf16(dv_acc[j], pa, load_u32(&dot_tile[off]), load_u32(&dot_tile[off + 8]));
        mma_bf16(dk_acc[j], sa, load_u32(&qt_tile[off]), load_u32(&qt_tile[off + 8]));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int d = j * 8 + 2 * t;
    if (key0 < seq) {
      const long long off = base + (long long)key0 * tok_stride + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dk_acc[j][0], dk_acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[j][0], dv_acc[j][1]);
    }
    if (key1 < seq) {
      const long long off = base + (long long)key1 * tok_stride + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dk_acc[j][2], dk_acc[j][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

// ---- float32: FMA on the CUDA cores ------------------------------------------------

constexpr int kF32Tile = 32;                         // q rows and keys per tile
constexpr int kF32Sub = 4;                           // threads per row
constexpr int kF32Threads = kF32Tile * kF32Sub;      // 128
constexpr int kF32PerThread = kF32Tile / kF32Sub;    // 8 partners per thread
constexpr int kF32Chunks = D / (4 * kF32Sub);        // 4 float4 output chunks per thread
constexpr int kF32Pad = D + 4;                       // shared row stride in floats

// Rows [r_start, r_start + kF32Tile) of two [B, S, H, D] tensors into [row][d]
// tiles; rows past seq are 0.
__device__ __forceinline__ void load_f32_tiles(const float* x, const float* y, long long base,
                                               long long tok_stride, int r_start, int seq,
                                               float (*xs)[kF32Pad], float (*ys)[kF32Pad]) {
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
__device__ __forceinline__ void axpy_row(float (&acc)[4 * kF32Chunks], float w, const float* row,
                                         int sub) {
#pragma unroll
  for (int c = 0; c < kF32Chunks; ++c) {
    const int d = (sub + kF32Sub * c) * 4;
    const float4 x = *reinterpret_cast<const float4*>(row + d);
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

__device__ __forceinline__ void store_row(float* out, const float (&acc)[4 * kF32Chunks],
                                          int sub) {
#pragma unroll
  for (int c = 0; c < kF32Chunks; ++c) {
    const int d = (sub + kF32Sub * c) * 4;
    *reinterpret_cast<float4*>(out + d) =
        make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
  }
}

__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ lengths, float* __restrict__ dq, int seq,
                        int heads, int window, float scale) {
  __shared__ __align__(16) float q_s[kF32Tile][kF32Pad];
  __shared__ __align__(16) float do_s[kF32Tile][kF32Pad];
  __shared__ __align__(16) float k_s[kF32Tile][kF32Pad];
  __shared__ __align__(16) float v_s[kF32Tile][kF32Pad];

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

  load_f32_tiles(q, dout, base, tok_stride, q_start, seq, q_s, do_s);

  float acc[4 * kF32Chunks];
#pragma unroll
  for (int i = 0; i < 4 * kF32Chunks; ++i) acc[i] = 0.f;

  int kt_begin, kt_end;
  key_tile_range<kF32Tile, kF32Tile>(q_start, len, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();  // the previous tile has been consumed (and Q, dO stored)
    load_f32_tiles(k, v, base, tok_stride, k0, seq, k_s, v_s);
    __syncthreads();

    // ds for keys kk = sub + kF32Sub·j.
    float ds[kF32PerThread];
#pragma unroll
    for (int j = 0; j < kF32PerThread; ++j) {
      const int kk = sub + kF32Sub * j;
      const float s = dot_rows(q_s[row], k_s[kk]);
      const float dp = dot_rows(do_s[row], v_s[kk]);
      const float p = live(qi, k0 + kk, len, window) ? expf(s * scale - lse_r) : 0.f;
      ds[j] = p * (dp - delta_r) * scale;
    }
    // dq += Σ_kk ds[kk] · K[kk]; key kk's ds lives in lane lane0 + kk % kF32Sub.
#pragma unroll
    for (int kk = 0; kk < kF32Tile; ++kk) {
      const float w = __shfl_sync(0xffffffffu, ds[kk / kF32Sub], lane0 + kk % kF32Sub);
      axpy_row(acc, w, k_s[kk], sub);
    }
  }
  if (qi < seq) store_row(dq + base + (long long)qi * tok_stride, acc, sub);
}

__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ lengths, float* __restrict__ dk,
                         float* __restrict__ dv, int seq, int heads, int window, float scale) {
  __shared__ __align__(16) float k_s[kF32Tile][kF32Pad];
  __shared__ __align__(16) float v_s[kF32Tile][kF32Pad];
  __shared__ __align__(16) float q_s[kF32Tile][kF32Pad];
  __shared__ __align__(16) float do_s[kF32Tile][kF32Pad];
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

  load_f32_tiles(k, v, base, tok_stride, k_start, seq, k_s, v_s);

  float dk_acc[4 * kF32Chunks], dv_acc[4 * kF32Chunks];
#pragma unroll
  for (int i = 0; i < 4 * kF32Chunks; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  int qt_begin, qt_end;
  query_tile_range<kF32Tile, kF32Tile>(k_start, len, seq, window, &qt_begin, &qt_end);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kF32Tile;
    __syncthreads();  // the previous tile has been consumed (and K, V stored)
    load_f32_tiles(q, dout, base, tok_stride, q0, seq, q_s, do_s);
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
      const float s = dot_rows(k_s[row], q_s[qq]);
      const float dp = dot_rows(v_s[row], do_s[qq]);
      p[j] = qi < seq && live(qi, key, len, window) ? expf(s * scale - lse_s[qq]) : 0.f;
      ds[j] = p[j] * (dp - delta_s[qq]) * scale;
    }
#pragma unroll
    for (int qq = 0; qq < kF32Tile; ++qq) {
      const int src = lane0 + qq % kF32Sub;
      axpy_row(dv_acc, __shfl_sync(0xffffffffu, p[qq / kF32Sub], src), do_s[qq], sub);
      axpy_row(dk_acc, __shfl_sync(0xffffffffu, ds[qq / kF32Sub], src), q_s[qq], sub);
    }
  }
  if (key < seq) {
    store_row(dk + base + (long long)key * tok_stride, dk_acc, sub);
    store_row(dv + base + (long long)key * tok_stride, dv_acc, sub);
  }
}

int check_shape(int batch, int seq, int heads, int head_dim) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs share it).
// lse, delta: [B, H, S] float32. window < 0 means global attention. head_dim
// must be 64. Each returns the CUDA error code of its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* lengths, void* dq,
                            int batch, int seq, int heads, int head_dim, int window, int dtype,
                            void* stream) {
  if (int rc = check_shape(batch, seq, heads, head_dim)) return rc;
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaSuccess;
  const float scale = 1.0f / sqrtf((float)D);  // 1/8: exact
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    const dim3 grid((seq + kF32Tile - 1) / kF32Tile, batch * heads);
    flash_bwd_dq_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, dl, len, static_cast<float*>(dq), seq, heads, window,
        scale);
  } else if (dtype == 1) {
    const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
    flash_bwd_dq_mma_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l, dl,
        len, static_cast<__nv_bfloat16*>(dq), seq, heads, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* lengths, void* dk,
                             void* dv, int batch, int seq, int heads, int head_dim, int window,
                             int dtype, void* stream) {
  if (int rc = check_shape(batch, seq, heads, head_dim)) return rc;
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaSuccess;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    const dim3 grid((seq + kF32Tile - 1) / kF32Tile, batch * heads);
    flash_bwd_dkv_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, dl, len, static_cast<float*>(dk),
        static_cast<float*>(dv), seq, heads, window, scale);
  } else if (dtype == 1) {
    const dim3 grid((seq + kTile - 1) / kTile, batch * heads);
    flash_bwd_dkv_mma_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), l, dl,
        len, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), seq, heads,
        window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
