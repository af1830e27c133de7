// Dense flash-decode for Hopper: one query token per row against a
// contiguous [B, S, Hkv, D] KV cache, with an fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_fwd, body _decode_kernel) and computes what it
// computes: GQA decode attention where row b attends positions < lens[b]
// (and, with a window, only positions > lens[b] - 1 - window), masked
// with the same finite NEG_INF, optional softcap cap * tanh(s / cap),
// and a lens[b] == 0 row writes zeros (the running sum is floored at
// 1e-30).
//
// Bound: memory.  A call must read the live K and V rows, sum_b lens[b]
// * Hkv * D * 2 * sizeof(T) bytes, and does about 4 * Hq * D flops per
// live token, far below the card's flops-per-byte ridge.  The design
// reads each live row once: one thread block per (kv head, row) serves
// all G = Hq / Hkv query heads of that kv head (the Pallas grid (B, Hq,
// chunks) fetches every chunk G times), and walks the cache in chunks of
// kChunk tokens up to lens[b], skipping chunks wholly below the window.
// The cache is not padded to the chunk: the last chunk's rows past S
// are zero-filled in shared memory and never read (the JAX wrapper pads
// the whole cache with jnp.pad, a copy per layer per step).  The block
// body is attn::decode_block (include/attention_common.cuh), shared with
// the paged kernel.  Like it, this first version leaves most of the card
// idle at serving shapes (B * Hkv blocks, chunks walked in turn); a split
// over the cache with a log-sum-exp merge is the known next step.
//
// C interface (bound with ctypes): decode_attention_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16.  The
// pointers must be 16-byte aligned, D a multiple of 8 and lens[b] <= S
// (the wrapper checks what it can without reading lens back).
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // kernel.py CHUNK mirrors it

// where row b's tokens lie: chunk c is tokens [c * chunk, (c + 1) * chunk)
// of the row, of which the ones below S exist
struct DenseSrc {
  size_t row0;  // element offset of (b, 0, h, 0)
  int S, chunk, Hkv, D;
  __device__ int count(int len) const {
    return (min(max(len, 0), S) + chunk - 1) / chunk;
  }
  __device__ size_t base(int c) const {
    return row0 + (size_t)c * chunk * Hkv * D;
  }
  __device__ int rows(int c) const { return min(chunk, S - c * chunk); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q,       // [B, Hq, D]
                    const T* __restrict__ k,       // [B, S, Hkv, D]
                    const T* __restrict__ v,       // [B, S, Hkv, D]
                    const int* __restrict__ lens,  // [B]
                    T* __restrict__ out,           // [B, Hq, D]
                    int S, int Hkv, int G, int D, float scale, int window,
                    float softcap) {
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // row
  // the G query heads of kv head h are contiguous: heads h*G .. h*G+G-1
  const size_t head0 = (size_t)b * Hkv * G + (size_t)h * G;
  const DenseSrc src{((size_t)b * S * Hkv + h) * D, S, kChunk, Hkv, D};
  attn::decode_block<T, kThreads>(q + head0 * D, k, v, src, (size_t)Hkv * D,
                                  out + head0 * D, lens[b], G, D, scale,
                                  window, softcap);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, void* out, int B, int S, int Hq,
                   int Hkv, int D, float scale, int window, float softcap,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * attn::decode_smem_floats(G, D, kChunk);
  auto kern = dense_decode_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(out), S, Hkv, G, D, scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lens,
                                    void* out, int B, int S, int Hq, int Hkv,
                                    int D, float scale, int window,
                                    float softcap, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lens, out, B, S, Hq, Hkv, D, scale, window,
                         softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lens, out, B, S, Hq, Hkv, D, scale,
                                 window, softcap, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
