// Exact sparse rescore with the forward-index row gather fused in, for Hopper (sm_90a).
//
// Replaces the TPU kernel `verbatim_rag_tpu/ops/rescore.py::_rescore_kernel`
// (pallas_call in `rescore_pallas`, entry `exact_rescore_device_pallas`). The
// TPU path gathers sp_ids[cand_rows] and sp_w[cand_rows] in XLA first and
// hands the kernel [B, C, m] copies; here the kernel reads the rows straight
// from the [N, m] forward index, so the gathered copies never exist.
//
// Computes, for query b and candidate c with row r = cand_rows[b, c]:
//     out[b, c] = sum_s sum_j [sp_ids[r, s] == q_ids[b, j]] * sp_w[r, s] * q_w[b, j]
// and out[b, c] = -1e30 where r < 0 (no candidate) or r >= N.
// Pad slots carry id 0 and weight 0 on both sides, so they add nothing.
// The forward index holds int32 or int16 ids and float32 or float16 weights
// (the store's sparse_ids_dtype / sparse_weight_dtype); each slot is widened
// in registers (an id as a non-negative int, a weight with one cvt.f32.f16), as
// the JAX path widens its gathered copies. Queries are int32 / float32.
//
// Design:
//   - one block of 8 warps per (query b, tile of 32 candidates); each warp
//     owns 4 candidates;
//   - the query's ids and weights sit in shared memory (staged in chunks of
//     1024 terms, so any qm is taken);
//   - for one candidate the 32 lanes stride its m slots (coalesced reads of
//     the row), compare each slot id with every query term, and the
//     per-lane sums are reduced with warp shuffles.
//
// Bound on an H100 SXM at the serving point (B=512, C=256, m=128, qm=32): the
// gathered rows are 512·256·128·8 B = 134 MB with int32/float32 slots (40 us
// at 3.35 TB/s) and 67 MB with int16/float16 slots (20 us); the compare loop
// is 0.54 G compare-selects, far below the card's integer rate. So the kernel
// is bound by the bytes of the rows it reads.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCandsPerWarp = 4;
constexpr int kCandsPerBlock = kWarps * kCandsPerWarp;  // 32
constexpr int kQueryChunk = 1024;
constexpr float kNegInf = -1e30f;

// Weights arrive as float32 or as float16 bits (uint16_t), widened with one
// cvt (exact: every float16 is a float32).
__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(uint16_t w) {
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(w));
  return f;
}

template <typename Id, typename W>
__global__ void __launch_bounds__(kWarps * 32)
rescore_kernel(const int* __restrict__ cand_rows, const Id* __restrict__ sp_ids,
               const W* __restrict__ sp_w, const int* __restrict__ q_ids,
               const float* __restrict__ q_w, float* __restrict__ out, int cands,
               long long n_rows, int m, int qm) {
  __shared__ int q_id_s[kQueryChunk];
  __shared__ float q_w_s[kQueryChunk];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int c_base = blockIdx.x * kCandsPerBlock + warp * kCandsPerWarp;

  int rows[kCandsPerWarp];  // -1: no candidate
  float acc[kCandsPerWarp];
#pragma unroll
  for (int t = 0; t < kCandsPerWarp; ++t) {
    const int c = c_base + t;
    const int r = c < cands ? cand_rows[(long long)b * cands + c] : -1;
    rows[t] = r >= 0 && r < n_rows ? r : -1;
    acc[t] = 0.f;
  }

  for (int j0 = 0; j0 < qm; j0 += kQueryChunk) {
    const int nq = qm - j0 < kQueryChunk ? qm - j0 : kQueryChunk;
    __syncthreads();
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      q_id_s[i] = q_ids[(long long)b * qm + j0 + i];
      q_w_s[i] = q_w[(long long)b * qm + j0 + i];
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kCandsPerWarp; ++t) {
      if (rows[t] < 0) continue;  // uniform across the warp
      const long long base = static_cast<long long>(rows[t]) * m;
      const Id* ids_row = sp_ids + base;
      const W* w_row = sp_w + base;
      for (int s = lane; s < m; s += 32) {
        const int id = static_cast<int>(ids_row[s]);
        const float w = widen(w_row[s]);
        float hit = 0.f;
        for (int j = 0; j < nq; ++j) hit += q_id_s[j] == id ? w * q_w_s[j] : 0.f;
        acc[t] += hit;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kCandsPerWarp; ++t) {
    float s = acc[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int c = c_base + t;
    if (lane == 0 && c < cands) out[(long long)b * cands + c] = rows[t] < 0 ? kNegInf : s;
  }
}

template <typename Id, typename W>
int launch(const void* cand_rows, const void* sp_ids, const void* sp_w, const void* q_ids,
           const void* q_w, void* out, int batch, int cands, long long n_rows, int m, int qm,
           cudaStream_t stream) {
  const dim3 grid((cands + kCandsPerBlock - 1) / kCandsPerBlock, batch);
  rescore_kernel<Id, W><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int*>(cand_rows), static_cast<const Id*>(sp_ids),
      static_cast<const W*>(sp_w), static_cast<const int*>(q_ids), static_cast<const float*>(q_w),
      static_cast<float*>(out), cands, n_rows, m, qm);
  return (int)cudaGetLastError();
}

}  // namespace

// cand_rows, q_ids int32; q_w float32; out float32; sp_ids int32 (ids_bytes
// 4) or int16 (2); sp_w float32 (w_bytes 4) or float16 (2, read as its bits).
// All contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sparse_rescore(const void* cand_rows, const void* sp_ids, const void* sp_w,
                              const void* q_ids, const void* q_w, void* out, int batch, int cands,
                              long long n_rows, int m, int qm, int ids_bytes, int w_bytes,
                              void* stream) {
  if (batch <= 0 || cands <= 0) return (int)cudaSuccess;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  auto st = static_cast<cudaStream_t>(stream);
  // One instance per (id type, weight type), picked by the tag values' types.
  const auto run = [&](auto id_tag, auto w_tag) {
    return launch<decltype(id_tag), decltype(w_tag)>(cand_rows, sp_ids, sp_w, q_ids, q_w, out,
                                                     batch, cands, n_rows, m, qm, st);
  };
  if (ids_bytes == 4 && w_bytes == 4) return run(int{}, float{});
  if (ids_bytes == 4 && w_bytes == 2) return run(int{}, uint16_t{});
  if (ids_bytes == 2 && w_bytes == 4) return run(int16_t{}, float{});
  if (ids_bytes == 2 && w_bytes == 2) return run(int16_t{}, uint16_t{});
  return (int)cudaErrorInvalidValue;
}
