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
//
// Design:
//   - one block of 8 warps per (query b, tile of 32 candidates); each warp
//     owns 4 candidates;
//   - the query's ids and weights sit in shared memory (staged in chunks of
//     1024 terms, so any qm is taken);
//   - for one candidate the 32 lanes stride its m slots (coalesced 4-byte
//     reads of the row), compare each slot id with every query term, and the
//     per-lane sums are reduced with warp shuffles.
//
// Bound on an H100 SXM at the serving point (B=512, C=256, m=128, qm=32): the
// gathered rows are 512·256·128·8 B = 134 MB, 40 us at 3.35 TB/s; the compare
// loop is 0.54 G compare-selects, far below the card's integer rate. So the
// kernel is bound by the bytes of the rows it reads.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCandsPerWarp = 4;
constexpr int kCandsPerBlock = kWarps * kCandsPerWarp;  // 32
constexpr int kQueryChunk = 1024;
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kWarps * 32)
rescore_kernel(const int* __restrict__ cand_rows, const int* __restrict__ sp_ids,
               const float* __restrict__ sp_w, const int* __restrict__ q_ids,
               const float* __restrict__ q_w, float* __restrict__ out, int cands,
               long long n_rows, int m, int qm) {
  __shared__ int q_id_s[kQueryChunk];
  __shared__ float q_w_s[kQueryChunk];

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int c_base = blockIdx.x * kCandsPerBlock + warp * kCandsPerWarp;

  long long rows[kCandsPerWarp];
  float acc[kCandsPerWarp];
#pragma unroll
  for (int t = 0; t < kCandsPerWarp; ++t) {
    const int c = c_base + t;
    rows[t] = c < cands ? (long long)cand_rows[(long long)b * cands + c] : -1;
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
      const long long r = rows[t];
      if (r < 0 || r >= n_rows) continue;  // uniform across the warp
      const int* ids_row = sp_ids + r * m;
      const float* w_row = sp_w + r * m;
      for (int s = lane; s < m; s += 32) {
        const int id = ids_row[s];
        const float w = w_row[s];
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
    if (lane == 0 && c < cands) {
      const long long r = rows[t];
      out[(long long)b * cands + c] = (r < 0 || r >= n_rows) ? kNegInf : s;
    }
  }
}

}  // namespace

// All index arrays int32, all weights float32, all contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sparse_rescore(const void* cand_rows, const void* sp_ids, const void* sp_w,
                              const void* q_ids, const void* q_w, void* out, int batch, int cands,
                              long long n_rows, int m, int qm, void* stream) {
  if (batch <= 0 || cands <= 0) return (int)cudaSuccess;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((cands + kCandsPerBlock - 1) / kCandsPerBlock, batch);
  rescore_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand_rows), static_cast<const int*>(sp_ids),
      static_cast<const float*>(sp_w), static_cast<const int*>(q_ids),
      static_cast<const float*>(q_w), static_cast<float*>(out), cands, n_rows, m, qm);
  return (int)cudaGetLastError();
}
