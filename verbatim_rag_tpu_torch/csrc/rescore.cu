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
// Every (slot, term) pair that matches adds its product, so duplicate ids in
// a row or in a query, and a query term of id 0, count as in the plain version.
// The forward index holds int32 or int16 ids and float32 or float16 weights
// (the store's sparse_ids_dtype / sparse_weight_dtype); each slot is widened
// in registers (an id as an int, a weight with one cvt.f32.f16), as the JAX
// path widens its gathered copies. Queries are int32 / float32.
//
// Bound on an H100 SXM at the serving point (B=512, C=256, m=128, qm=32): the
// gathered rows are 512·256·128·8 B = 134 MB with int32/float32 slots (40 us
// at 3.35 TB/s) and 67 MB with int16/float16 slots (20 us). The TPU kernel
// compares every slot with every query term, which suits a wide vector unit;
// on an SM that is 2·qm shared loads a slot and held the previous design at
// ≈ 0.15 ms whatever the slot width. So here a slot is looked up, not
// compared:
//   - one block of 8 warps per (query b, tile of kTile = 64 candidates): the
//     fastest of 32, 64, 128 and 256 at the serving point on an H100
//     (`scripts/torch_table_ab.py --decompose` builds the others, and the
//     variants named below, from this source). With every row in L2 the
//     kernel still takes most of its time: the table build and the lookups'
//     chains of dependent shared loads hold it, not the bytes. So the block
//     is held to 32 registers, which lets 8 blocks (64 warps, the most) share
//     an SM to hide those chains; at 40 registers 6 blocks fit and the kernel
//     is slower. Unrolling deeper, more slots a lane in flight, or probing a
//     warp's slots in lock-step rounds measured slower too: their registers
//     cost blocks an SM;
//   - the block builds a hash table of the query's terms in shared memory:
//     open addressing with linear probes, a power of two of at least 8·qm
//     entries, each entry (id, first term index) in 8 bytes, so one 64-bit
//     shared load answers a probe. A warp's lookups wait for its slowest
//     lane's probes, so the table is kept sparse. Terms with the same id are
//     chained in ascending term order through (q_w[j], next[j]) pairs, so
//     each one contributes. Queries of more than kQueryChunk terms are taken
//     a chunk at a time, the partial sums kept in shared memory;
//   - lane l takes slots l, l + 32, ... of a row: every load of the warp is
//     one coalesced 128-byte (int32, float32) or 64-byte (int16, float16)
//     piece, for any m and any alignment, and a warp issues the loads of
//     kUnroll candidates' slots before it looks any up. A lane past the row's
//     end loads its last slot again and does not look it up, so no load waits
//     on a per-lane condition (predicated loads scheduled worse). A warp's lookups go
//     over the row in ranges of 32 slots, so a range of pads (weight 0, the
//     slots past a row's terms) is skipped by the whole warp: a weight of 0
//     adds exactly 0 when every query weight is finite, which the block
//     checks, and otherwise every slot is looked up as the plain version
//     multiplies it;
//   - each lane sums its slots' products, and the warp reduces them with
//     shuffles.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 2;          // candidates a warp loads before it looks up
constexpr int kSlots = 2;           // slots a lane loads of each row per pass
constexpr int kQueryChunk = 256;    // query terms a table holds
constexpr int kMaxTable = 8 * kQueryChunk;
constexpr int kTile = 64;           // candidates a block takes
constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // an entry's term index when it is free
constexpr float kNegInf = -1e30f;

// Weights arrive as float32 or as float16 bits (uint16_t), widened with one
// cvt (exact: every float16 is a float32).
__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(uint16_t w) {
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(w));
  return f;
}

__device__ __forceinline__ uint32_t slot_of(int id, int shift) {
  return (static_cast<uint32_t>(id) * 2654435761u) >> shift;
}

// Sum of w · q_w[j] over the query terms j of the table whose id is `id`,
// in ascending j.
__device__ __forceinline__ float lookup(const uint2* table, const float2* qinfo, uint32_t mask,
                                        int shift, int id, float w) {
  float s = 0.f;
  uint32_t h = slot_of(id, shift);
  while (true) {
    const uint2 e = table[h];
    if (e.y == kEmpty) break;
    if (static_cast<int>(e.x) == id) {
      int j = static_cast<int>(e.y);
      do {
        const float2 qj = qinfo[j];
        s += w * qj.x;
        j = __float_as_int(qj.y);
      } while (j >= 0);
      break;
    }
    h = (h + 1) & mask;
  }
  return s;
}

template <typename Id, typename W>
__global__ void __launch_bounds__(kThreads, 8)
rescore_kernel(const int* __restrict__ cand_rows, const Id* __restrict__ sp_ids,
               const W* __restrict__ sp_w, const int* __restrict__ q_ids,
               const float* __restrict__ q_w, float* __restrict__ out, int cands,
               long long n_rows, int m, int qm) {
  __shared__ uint2 table[kMaxTable];      // (id, first term index) or (-, kEmpty)
  __shared__ float2 qinfo[kQueryChunk];   // (q_w[j], next term of the same id or -1)
  __shared__ int q_id_s[kQueryChunk];
  __shared__ float part[kTile];           // partial sums over the query chunks

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int c_begin = blockIdx.x * kTile;
  const int c_end = min(c_begin + kTile, cands);
  const int* cand_b = cand_rows + static_cast<long long>(b) * cands;
  const int* q_id_b = q_ids + static_cast<long long>(b) * qm;
  const float* q_w_b = q_w + static_cast<long long>(b) * qm;

  for (int i = threadIdx.x; i < c_end - c_begin; i += kThreads) part[i] = 0.f;

  for (int j0 = 0; j0 < qm; j0 += kQueryChunk) {
    const int nq = min(qm - j0, kQueryChunk);
    int log2 = 3;  // table entries: the least power of two ≥ 8·nq
    while ((1 << log2) < 8 * nq) ++log2;
    const uint32_t mask = (1u << log2) - 1;
    const int shift = 32 - log2;

    __syncthreads();  // the previous chunk's lookups are done
    for (int i = threadIdx.x; i <= static_cast<int>(mask); i += kThreads)
      table[i] = make_uint2(0u, kEmpty);
    __syncthreads();
    bool finite = true;  // this thread's terms' weights
    for (int j = threadIdx.x; j < nq; j += kThreads) {
      const int id = q_id_b[j0 + j];
      const float qw = q_w_b[j0 + j];
      finite = finite && isfinite(qw);
      q_id_s[j] = id;
      qinfo[j] = make_float2(qw, __int_as_float(-1));
      // Claim a free entry for the id, or keep the lowest term index of an
      // entry that already holds it.
      uint32_t h = slot_of(id, shift);
      unsigned long long* entries = reinterpret_cast<unsigned long long*>(table);
      const unsigned long long mine =
          (static_cast<unsigned long long>(j) << 32) | static_cast<uint32_t>(id);
      while (true) {
        const unsigned long long free_entry = static_cast<unsigned long long>(kEmpty) << 32;
        const unsigned long long old = atomicCAS(&entries[h], free_entry, mine);
        if (old == free_entry) break;
        if (static_cast<int>(static_cast<uint32_t>(old)) == id) {
          atomicMin(reinterpret_cast<unsigned int*>(&entries[h]) + 1, static_cast<unsigned>(j));
          break;
        }
        h = (h + 1) & mask;
      }
    }
    // A slot of weight 0 adds exactly 0 unless a query weight is inf or NaN.
    const bool skip_zero = __syncthreads_and(finite);
    // Chain the terms of each id in ascending order: a term that is not the
    // first of its id links itself behind the nearest earlier term of the id.
    for (int j = threadIdx.x; j < nq; j += kThreads) {
      const int id = q_id_s[j];
      uint32_t h = slot_of(id, shift);
      while (static_cast<int>(table[h].x) != id || table[h].y == kEmpty) h = (h + 1) & mask;
      const int first = static_cast<int>(table[h].y);
      if (first == j) continue;
      int prev = j - 1;
      while (q_id_s[prev] != id) --prev;
      qinfo[prev].y = __int_as_float(j);
    }
    __syncthreads();

    // Warp w takes candidates c_begin + w + kWarps·i, kUnroll at a time.
    for (int c0 = c_begin + warp; c0 < c_end; c0 += kWarps * kUnroll) {
      long long rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kWarps;
        const int r = c < c_end ? cand_b[c] : -1;
        rows[u] = r >= 0 && r < n_rows ? r : -1;
      }
      float acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
      for (int s0 = lane; s0 < m; s0 += 32 * kSlots) {
        int id[kUnroll][kSlots];
        float w[kUnroll][kSlots];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            const int s = min(s0 + 32 * i, m - 1);
            const bool live = rows[u] >= 0;  // uniform across the warp
            id[u][i] = live ? static_cast<int>(__ldg(sp_ids + rows[u] * m + s)) : 0;
            w[u][i] = live ? widen(__ldg(sp_w + rows[u] * m + s)) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rows[u] < 0) continue;  // uniform across the warp
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            if (s0 + 32 * i < m && (w[u][i] != 0.f || !skip_zero))
              acc[u] += lookup(table, qinfo, mask, shift, id[u][i], w[u][i]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float s = acc[u];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const int c = c0 + u * kWarps;
        if (lane == 0 && c < c_end) part[c - c_begin] += s;  // one warp owns each candidate
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c_end - c_begin; i += kThreads) {
    const int r = cand_b[c_begin + i];
    out[static_cast<long long>(b) * cands + c_begin + i] = r >= 0 && r < n_rows ? part[i] : kNegInf;
  }
}

template <typename Id, typename W>
int launch(const void* cand_rows, const void* sp_ids, const void* sp_w, const void* q_ids,
           const void* q_w, void* out, int batch, int cands, long long n_rows, int m, int qm,
           cudaStream_t stream) {
  const dim3 grid((cands + kTile - 1) / kTile, batch);
  rescore_kernel<Id, W><<<grid, kThreads, 0, stream>>>(
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
