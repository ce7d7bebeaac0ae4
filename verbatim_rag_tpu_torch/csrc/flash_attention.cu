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
// Inputs and outputs are contiguous with D = 64, q, k, v in bfloat16 or
// float32; scores, softmax statistics and accumulators are float32. Any S is
// taken: the ragged edge is masked here, nothing is padded by the caller. Key
// tiles past the live keys, or outside the band on local layers, are never
// loaded, so local layers cost O(S·window) and a dead KV block costs nothing.
//
// Three kernels:
//
//   bf16 forward — wgmma fed by TMA (Hopper's own path to the tensor cores).
//          One CTA per (128-row q tile, b·h): two consumer warpgroups of 64
//          rows and one producer warp. The producer loads the Q tile once and
//          streams 128-key K and V tiles through a ring of shared-memory
//          stages with full/empty mbarriers (TMA, 128-byte swizzle, rows past
//          S zero-filled). Each consumer computes S = Q·Kᵀ (wgmma m64n128,
//          both operands K-major in shared memory), the online softmax in
//          registers (exp2 with log2(e) folded into the scale; row max and sum
//          over the four lanes of a quad), packs P to bf16 straight into the A
//          registers of O += P·V (wgmma m64n64 with A from registers and V read
//          MN-major through the descriptor's transpose bit: no Vᵀ copy), and
//          normalises in the epilogue. Length and band masks are evaluated
//          only on tiles that straddle an edge; a warpgroup with no live pair
//          in a tile skips its products. l sums the unrounded P; P is rounded
//          to bf16 for P·V (the plain version rounds the normalised
//          probabilities, so the two differ by a bf16 rounding).
//   bf16 partial — tensor cores through mma.sync m16n8k16, 4 warps of 16 q
//          rows, 64-key tiles loaded synchronously with V stored transposed;
//          P stays in registers (FlashAttention-2's register reuse) and is
//          kept unrounded in l.
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
// tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;  // head dim: ModernBERT's 12 × 64 heads
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

template <bool kPartial>
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

// ---- bf16 partial: tensor cores through mma.sync --------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;  // 16 q rows per warp
constexpr int kSmemPad = 8;                  // bf16 padding per shared row (bank spread)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16×16, row-major): reg0 (g, 2t..2t+1), reg1 (g+8, 2t..), reg2 (g, 2t+8..),
//                         reg3 (g+8, 2t+8..)
//   B (16×8, k × n):      reg0 (k = 2t..2t+1, n = g), reg1 (k = 2t+8..2t+9, n = g)
//   C (16×8, f32):        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// Writes the float32 numerator [B, Sq, H, D] and m, l [B, H, Sq].
__global__ void __launch_bounds__(kMmaThreads)
flash_partial_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                         float* __restrict__ numer, float* __restrict__ m_out,
                         float* __restrict__ l_out, int seq_q, int seq_k, int heads,
                         int k_offset, float scale) {
  constexpr int kDSteps = D / 16;        // k-steps of Q·Kᵀ
  constexpr int kDTiles = D / 8;         // n-tiles of O
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of S
  constexpr int kKeySteps = kBlockK / 16;  // k-steps of P·V
  constexpr int kKStride = D + kSmemPad;
  constexpr int kVStride = kBlockK + kSmemPad;

  __shared__ __align__(16) __nv_bfloat16 k_tile[kBlockK * kKStride];  // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt_tile[D * kVStride];       // [d][key]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_start = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q_start + (tid / 32) * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const int len = key_limit(lengths[b], k_offset, seq_k);

  const long long tok_stride = (long long)heads * D;
  const long long q_base = (long long)b * seq_q * tok_stride + (long long)h * D;
  const long long kv_base = (long long)b * seq_k * tok_stride + (long long)h * D;

  unsigned qa[kDSteps][4];
#pragma unroll
  for (int kc = 0; kc < kDSteps; ++kc) {
    const int d = kc * 16 + 2 * t;
    const __nv_bfloat16* q0 = q + q_base + (long long)row0 * tok_stride + d;
    const __nv_bfloat16* q1 = q + q_base + (long long)row1 * tok_stride + d;
    qa[kc][0] = row0 < seq_q ? load_u32(q0) : 0u;
    qa[kc][1] = row1 < seq_q ? load_u32(q1) : 0u;
    qa[kc][2] = row0 < seq_q ? load_u32(q0 + 8) : 0u;
    qa[kc][3] = row1 < seq_q ? load_u32(q1 + 8) : 0u;
  }

  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // No band: every key tile below the block's live keys.
  const int kt_end = (len + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile has been consumed
    constexpr int kChunks = D / 8;  // 16-byte chunks per key row
    for (int i = tid; i < kBlockK * kChunks; i += kMmaThreads) {
      const int kk = i / kChunks;
      const int c = (i - kk * kChunks) * 8;
      const int key = k0 + kk;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < seq_k) {
        const long long off = kv_base + (long long)key * tok_stride + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&k_tile[kk * kKStride + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_tile[(c + e) * kVStride + kk] = ve[e];
    }
    __syncthreads();

    // S = Q·Kᵀ: 8 n-tiles of 8 keys.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDSteps; ++kc) {
        const __nv_bfloat16* kp = &k_tile[(j * 8 + g) * kKStride + kc * 16 + 2 * t];
        mma_bf16(s[j], qa[kc], load_u32(kp), load_u32(kp + 8));
      }
    }

    // Scale, mask, row max (each row's 64 scores live in the 4 lanes of a quad).
    unsigned valid = 0u;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + j * 8 + 2 * t + (e & 1) < len;
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        valid |= ok ? (1u << (j * 4 + e)) : 0u;
        if (e < 2)
          mx0 = fmaxf(mx0, s[j][e]);
        else
          mx1 = fmaxf(mx1, s[j][e]);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float new0 = fmaxf(m0, mx0);
    const float new1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - new0);
    const float corr1 = expf(m1 - new1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m_row = e < 2 ? new0 : new1;
        s[j][e] = (valid >> (j * 4 + e)) & 1u ? expf(s[j][e] - m_row) : 0.f;
        if (e < 2)
          ps0 += s[j][e];
        else
          ps1 += s[j][e];
      }
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o_);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o_);
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
    m0 = new0;
    m1 = new1;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      o[j][0] *= corr0;
      o[j][1] *= corr0;
      o[j][2] *= corr1;
      o[j][3] *= corr1;
    }

    // O += P·V: P's A fragments are S's accumulators of n-tiles 2kc, 2kc+1.
#pragma unroll
    for (int kc = 0; kc < kKeySteps; ++kc) {
      const unsigned pa[4] = {
          hopper::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          hopper::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          hopper::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          hopper::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        const __nv_bfloat16* vp = &vt_tile[(j * 8 + g) * kVStride + kc * 16 + 2 * t];
        mma_bf16(o[j], pa, load_u32(vp), load_u32(vp + 8));
      }
    }
  }

  // Unnormalised float32 numerator, and the row's m and l.
  float* np = numer + q_base;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int d = j * 8 + 2 * t;
    if (row0 < seq_q)
      *reinterpret_cast<float2*>(np + (long long)row0 * tok_stride + d) =
          make_float2(o[j][0], o[j][1]);
    if (row1 < seq_q)
      *reinterpret_cast<float2*>(np + (long long)row1 * tok_stride + d) =
          make_float2(o[j][2], o[j][3]);
  }
  if (t == 0) {  // the quad's four lanes hold the same m and l
    const long long r = (long long)bh * seq_q;
    if (row0 < seq_q) {
      m_out[r + row0] = m0;
      l_out[r + row0] = l0;
    }
    if (row1 < seq_q) {
      m_out[r + row1] = m1;
      l_out[r + row1] = l1;
    }
  }
}

// ---- bf16 forward: wgmma fed by TMA ----------------------------------------------------

constexpr int kFwdRows = 128;  // q rows a CTA: two consumer warpgroups of 64
constexpr int kFwdKeys = 128;  // keys a K/V tile
constexpr int kFwdStages = 2;  // K/V ring depth
constexpr int kFwdConsumers = 2 * hopper::kWarpgroup;
constexpr int kFwdThreads = kFwdConsumers + 32;  // + the TMA producer warp
constexpr int kFwdQBytes = kFwdRows * hopper::kRowBytes;
constexpr int kFwdTileBytes = kFwdKeys * hopper::kRowBytes;
constexpr int kFwdBarOffset = kFwdQBytes + kFwdStages * 2 * kFwdTileBytes;
constexpr int kFwdSmem = kFwdBarOffset + (1 + 2 * kFwdStages) * 8 + 1024;  // + alignment slack

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int seq,
                       int heads, int window, float scale) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_base_1024(smem_raw);
  uint8_t* q_tile = smem;
  uint8_t* kv_tiles = smem + kFwdQBytes;  // stage s: K at 2s, V at 2s + 1 (tiles of kFwdTileBytes)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kFwdBarOffset);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kFwdStages;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_start = blockIdx.x * kFwdRows;
  const int len = key_limit(lengths[b], 0, seq);
  int kt_begin, kt_end;
  key_tile_range<kFwdRows, kFwdKeys>(q_start, len, window, &kt_begin, &kt_end);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kFwdConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFwdConsumers) {
    // Producer warp: one thread loads Q, then keeps the K/V ring full.
    if (threadIdx.x == kFwdConsumers) {
      mbar_arrive_expect_tx(q_full, kFwdQBytes);
      tma_load_tile(q_tile, &q_map, q_full, h, q_start, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % kFwdStages;
        if (i >= kFwdStages) mbar_wait(&kv_empty[s], (i / kFwdStages - 1) & 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * kFwdTileBytes);
        tma_load_tile(kv_tiles + 2 * s * kFwdTileBytes, &k_map, &kv_full[s], h, kt * kFwdKeys, b);
        tma_load_tile(kv_tiles + (2 * s + 1) * kFwdTileBytes, &v_map, &kv_full[s], h,
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

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // Running max of the raw scores; l0, l1 sum this thread's columns only (the
  // quad's four partial sums are added in the epilogue).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  const uint64_t q_desc = desc_sw128(q_tile + wg * 64 * kRowBytes);

  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % kFwdStages;
    mbar_wait(&kv_full[s], (i / kFwdStages) & 1);
    const int k0 = kt * kFwdKeys;
    const int k_last = k0 + kFwdKeys - 1;
    if (wg_row < seq && any_live(wg_row, k0, k_last, len, window)) {
      const uint8_t* k_tile = kv_tiles + 2 * s * kFwdTileBytes;
      const uint8_t* v_tile = k_tile + kFwdTileBytes;
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_m64n128k16_ss(sc, q_desc + kc * kDescKStep, desc_sw128(k_tile) + kc * kDescKStep,
                            kc);
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
      for (int e = 0; e < 32; ++e) o[e] *= e & 2 ? corr1 : corr0;

      // O += P·V: P's bf16 pairs are the A registers, V is read MN-major.
      uint32_t pa[8][4];
      acc_to_a(sc, pa);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      const uint64_t v_desc = desc_sw128(v_tile);
#pragma unroll
      for (int kc = 0; kc < kFwdKeys / 16; ++kc)
        wgmma_m64n64k16_rs(o, pa[kc], v_desc + kc * kDescRowStep);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    mbar_arrive(&kv_empty[s]);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const long long tok_stride = (long long)heads * D;
  __nv_bfloat16* op = out + (long long)b * seq * tok_stride + (long long)h * D;
  const float den0 = fmaxf(l0, 1e-20f);
  const float den1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (row0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)row0 * tok_stride + d) =
          __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
    if (row1 < seq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)row1 * tok_stride + d) =
          __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
  }
  if (lse != nullptr && t == 0) {  // the quad's four lanes hold the same m and l
    float* lp = lse + (long long)bh * seq;
    if (row0 < seq) lp[row0] = l0 > 0.f ? m0 * scale + logf(l0) : 0.f;
    if (row1 < seq) lp[row1] = l1 > 0.f ? m1 * scale + logf(l1) : 0.f;
  }
}

int launch_fwd_bf16(const void* q, const void* k, const void* v, const int* lengths, void* out,
                    float* lse, int batch, int seq, int heads, int window, float scale,
                    cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (int rc = hopper::make_tile_map(&q_map, q, batch, seq, heads, kFwdRows)) return rc;
  if (int rc = hopper::make_tile_map(&k_map, k, batch, seq, heads, kFwdKeys)) return rc;
  if (int rc = hopper::make_tile_map(&v_map, v, batch, seq, heads, kFwdKeys)) return rc;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + kFwdRows - 1) / kFwdRows, batch * heads);
  flash_fwd_wgmma_kernel<<<grid, kFwdThreads, kFwdSmem, stream>>>(
      q_map, k_map, v_map, lengths, static_cast<__nv_bfloat16*>(out), lse, seq, heads, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means global attention.
// lse: [B, H, S] float32 logsumexp output, or null. head_dim must be 64.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* lengths, void* out, void* lse, int batch, int seq,
                                   int heads, int head_dim, int window, int dtype, void* stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || seq <= 0 || heads <= 0) return (int)cudaSuccess;
  if ((long long)batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)D);  // 1/8: exact
  float* lse_out = static_cast<float*>(lse);
  if (dtype == 1)
    return launch_fwd_bf16(q, k, v, len, out, lse_out, batch, seq, heads, window, scale, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      len, static_cast<float*>(out), lse_out, nullptr, nullptr, seq, seq, heads, window, 0, scale);
  return (int)cudaGetLastError();
}

// One KV block's unnormalised contribution: q [B, seq_q, H, D], k and v
// [B, seq_k, H, D] (dtype 0 = float32, 1 = bfloat16), lengths [B] int32 global,
// k_offset >= 0 the global position of the block's first key. Writes numer
// [B, seq_q, H, D] float32, m and l [B, H, seq_q] float32. head_dim must be 64.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_partial(const void* q, const void* k, const void* v,
                                       const void* lengths, void* numer, void* m, void* l,
                                       int batch, int seq_q, int seq_k, int heads, int head_dim,
                                       int k_offset, int dtype, void* stream) {
  if (seq_k < 0 || k_offset < 0 || head_dim != D) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || seq_q <= 0 || heads <= 0) return (int)cudaSuccess;
  if ((long long)batch * heads > 65535) return (int)cudaErrorInvalidConfiguration;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  const float scale = 1.0f / sqrtf((float)D);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (dtype == 0) {
    flash_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), len, static_cast<float*>(numer), nullptr, mo, lo, seq_q,
        seq_k, heads, -1, k_offset, scale);
  } else if (dtype == 1) {
    flash_partial_mma_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), len, static_cast<float*>(numer), mo, lo, seq_q,
        seq_k, heads, k_offset, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
