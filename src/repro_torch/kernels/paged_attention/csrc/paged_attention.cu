// Paged flash-decode for Hopper: one query token per row against a
// page-table KV pool, with an fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_fwd, body _paged_kernel) and computes what it
// computes: GQA decode attention where row b reads its pages in order
// from table[b], positions >= lens[b] (and, with a window, positions
// <= lens[b] - 1 - window) are masked with the same finite NEG_INF,
// optional softcap cap * tanh(s / cap), and a lens[b] == 0 row writes
// zeros (the running sum is floored at 1e-30).
//
// Bound: memory.  A call must read the live pages of K and V,
// sum_b ceil(len_b / page) * page * Hkv * D * 2 * sizeof(T) bytes, and
// does about 4 * Hq * D flops per live token, far below the card's
// flops-per-byte ridge.  At qwen3-0.6b's paged decode (B 8, Hkv 8, D
// 128, page 16, lens <= 161, bf16) that is 4.1 MB: 1.23 us at 3.35 TB/s
// (chip_smoke.py phase 2 prints it).  So the design reads each live page
// once and puts enough blocks and bytes in flight to fill the card.
//
// Design.  The Pallas grid (B, Hq, pages) walks one row's pages in order
// on one core for each query head.  Here one thread-block cluster per
// (kv head, row) splits the row over ``splits`` blocks (grid (splits,
// Hkv, B), cluster dims (splits, 1, 1), launched with cudaLaunchKernelEx)
// and serves all G = Hq / Hkv query heads of the kv head, so each page is
// read once.  The body is attn::decode_split
// (include/attention_common.cuh), shared with the dense decode kernel,
// with two differences:
// - the row is cut by its attended range, not by its slots
//   (SplitOver::kAttended).  The pool's rows have S = maxp * page slots
//   (2,816 at the main path's 176 pages) but hold at most 161 tokens; a
//   cut of the slots would put every live token in the first block.  So
//   each block reads lens[b] and takes an equal share of [max(0, len -
//   window), min(len, S)).  splits = min(8, ceil(S / 32)) comes from the
//   wrapper, from shapes alone: reading lens back to the host would cost
//   a sync per layer.
// - a token's K/V row is found through the page table: token t lies at
//   page table[b][t / page], slot t % page.  Before the split the block
//   copies the first kTableCache entries of its row of the table into
//   shared memory, and lens[b] with them, in one round of loads, so each
//   token's page lookup is a shared-memory read; entries past kTableCache
//   (maxp > 256) are read from device memory.
// Still one launch per call, with no scratch in device memory.
//
// C interface (bound with ctypes): paged_attention_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16.  The
// pointers must be 16-byte aligned, D a multiple of 8, D <= 256 and 1 <=
// splits <= 8 (the wrapper checks all of it).
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTableCache = 256;  // page ids of a row kept in shared memory

// where row b's tokens lie: token t at slot t % page of page
// table[b][t / page]; the first kTableCache page ids come from shared
// memory
struct PagedTokens {
  const int* tab_s;  // [min(maxp, kTableCache)]: this row's first page ids
  const int* table;  // [maxp]: this row's page ids
  int page;
  size_t tok_stride;  // Hkv * D
  size_t head;        // h * D
  __device__ size_t at(int t) const {
    const int p = t / page;
    const int id = p < kTableCache ? tab_s[p] : __ldg(table + p);
    return ((size_t)id * page + (t - p * page)) * tok_stride + head;
  }
};

template <typename T, int GT, int CPT>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,        // [B, Hq, D]
                          const T* __restrict__ k_pool,   // [P, page, Hkv, D]
                          const T* __restrict__ v_pool,   // [P, page, Hkv, D]
                          const int* __restrict__ table,  // [B, maxp]
                          const int* __restrict__ lens,   // [B]
                          T* __restrict__ out,            // [B, Hq, D]
                          int Hkv, int G, int D, int page, int maxp,
                          float scale, int window, float softcap) {
  __shared__ int tab_s[kTableCache];
  __shared__ int len_s;
  const int h = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // row
  const int* row = table + (size_t)b * maxp;
  // lens[b] and the row's page ids in one round of loads
  if (threadIdx.x == 0) len_s = lens[b];
  for (int i = threadIdx.x; i < min(maxp, kTableCache); i += kThreads)
    tab_s[i] = row[i];
  __syncthreads();
  // the G query heads of kv head h are contiguous: heads h*G .. h*G+G-1
  const size_t head0 = ((size_t)b * Hkv + h) * G;
  const PagedTokens src{tab_s, row, page, (size_t)Hkv * D, (size_t)h * D};
  attn::decode_split<T, GT, CPT, attn::SplitOver::kAttended>(
      q + head0 * D, k_pool, v_pool, src, out + head0 * D, &len_s,
      &len_s, maxp * page, G, D, scale, window, softcap);
}

template <typename T, int GT, int CPT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lens, void* out, int B,
                   int Hq, int Hkv, int D, int page, int maxp, float scale,
                   int window, float softcap, int splits,
                   cudaStream_t stream) {
  // at most 41 KB (GT 8, D 256) beside the 1 KB of static page ids:
  // under the 48 KB a launch may take without raising the limit
  const size_t smem = sizeof(float) * attn::split_smem_floats(GT, D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_decode_split_kernel<T, GT, CPT>, static_cast<const T*>(q),
      static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(table), static_cast<const int*>(lens),
      static_cast<T*>(out), Hkv, Hq / Hkv, D, page, maxp, scale, window,
      softcap);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// GT: the heads one block holds at a time (G rounded up to 1, 2, 4 or 8;
// a larger G takes several passes); CPT: 16-byte chunks per thread (2 only
// for an fp32 row of more than 32 chunks, D > 128)
template <typename T, int CPT>
cudaError_t by_heads(const void* q, const void* k_pool, const void* v_pool,
                     const void* table, const void* lens, void* out, int B,
                     int Hq, int Hkv, int D, int page, int maxp, float scale,
                     int window, float softcap, int splits,
                     cudaStream_t st) {
  const int G = Hq / Hkv;
  if (G == 1)
    return launch<T, 1, CPT>(q, k_pool, v_pool, table, lens, out, B, Hq, Hkv,
                             D, page, maxp, scale, window, softcap, splits,
                             st);
  if (G == 2)
    return launch<T, 2, CPT>(q, k_pool, v_pool, table, lens, out, B, Hq, Hkv,
                             D, page, maxp, scale, window, softcap, splits,
                             st);
  if (G <= 4)
    return launch<T, 4, CPT>(q, k_pool, v_pool, table, lens, out, B, Hq, Hkv,
                             D, page, maxp, scale, window, softcap, splits,
                             st);
  return launch<T, 8, CPT>(q, k_pool, v_pool, table, lens, out, B, Hq, Hkv,
                           D, page, maxp, scale, window, softcap, splits, st);
}

}  // namespace

extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* table,
                                   const void* lens, void* out, int B,
                                   int Hq, int Hkv, int D, int page, int maxp,
                                   float scale, int window, float softcap,
                                   int splits, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (D > 256 || splits < 1 || splits > 8) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D / 4 > 32)
      return by_heads<float, 2>(q, k_pool, v_pool, table, lens, out, B, Hq,
                                Hkv, D, page, maxp, scale, window, softcap,
                                splits, st);
    return by_heads<float, 1>(q, k_pool, v_pool, table, lens, out, B, Hq, Hkv,
                              D, page, maxp, scale, window, softcap, splits,
                              st);
  }
  if (dtype == 1)
    return by_heads<__nv_bfloat16, 1>(q, k_pool, v_pool, table, lens, out, B,
                                      Hq, Hkv, D, page, maxp, scale, window,
                                      softcap, splits, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
