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
// flops-per-byte ridge.  The design therefore reads each page once: one
// thread block per (kv head, row) serves all G = Hq / Hkv query heads of
// that kv head (the Pallas grid (B, Hq, pages) fetches every page G
// times).  The block looks its page ids up itself (no scalar prefetch)
// and skips pages past the length or wholly below the window.  The block
// body is attn::decode_block (include/attention_common.cuh), shared with
// the dense decode kernel: each page is staged in shared memory as fp32
// with 16-byte loads; a warp per (head, token) computes the scores, a
// warp per head updates (m, l), and the block updates acc[G, D].  This
// first version is simple and
// leaves most of the card idle at serving shapes (B * Hkv blocks, pages
// walked one after another); a cp.async/TMA page ring and a split over
// pages with a log-sum-exp merge are the known next steps.
//
// C interface (bound with ctypes): paged_attention_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16.  The
// pointers must be 16-byte aligned and D a multiple of 8 (the wrapper
// checks both).
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;

// where row b's tokens lie: chunk c is the page table[b][c] of the pool
struct PagedSrc {
  const int* table;  // [maxp]: this row's page ids
  int maxp, chunk, Hkv, D, h;
  __device__ int count(int len) const {
    return min((max(len, 0) + chunk - 1) / chunk, maxp);
  }
  __device__ size_t base(int c) const {  // (page, 0, h, 0)
    return ((size_t)table[c] * chunk * Hkv + h) * D;
  }
  __device__ int rows(int) const { return chunk; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // [B, Hq, D]
                    const T* __restrict__ k_pool,   // [P, page, Hkv, D]
                    const T* __restrict__ v_pool,   // [P, page, Hkv, D]
                    const int* __restrict__ table,  // [B, maxp]
                    const int* __restrict__ lens,   // [B]
                    T* __restrict__ out,            // [B, Hq, D]
                    int Hkv, int G, int D, int page, int maxp, float scale,
                    int window, float softcap) {
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // row
  // the G query heads of kv head h are contiguous: heads h*G .. h*G+G-1
  const size_t head0 = (size_t)b * Hkv * G + (size_t)h * G;
  const PagedSrc src{table + (size_t)b * maxp, maxp, page, Hkv, D, h};
  attn::decode_block<T, kThreads>(q + head0 * D, k_pool, v_pool, src,
                                  (size_t)Hkv * D, out + head0 * D, lens[b],
                                  G, D, scale, window, softcap);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lens, void* out, int B,
                   int Hq, int Hkv, int D, int page, int maxp, float scale,
                   int window, float softcap, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * attn::decode_smem_floats(G, D, page);
  auto kern = paged_decode_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out), Hkv, G, D, page,
      maxp, scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* table,
                                   const void* lens, void* out, int B,
                                   int Hq, int Hkv, int D, int page, int maxp,
                                   float scale, int window, float softcap,
                                   int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, lens, out, B, Hq, Hkv, D,
                         page, maxp, scale, window, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lens, out, B, Hq,
                                 Hkv, D, page, maxp, scale, window, softcap,
                                 st);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
