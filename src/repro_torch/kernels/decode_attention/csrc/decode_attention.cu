// Dense flash-decode for Hopper: one query token per row against a
// contiguous [B, S, Hkv, D] KV cache, with an fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_fwd, body _decode_kernel) and computes what it
// computes: GQA decode attention where row b attends positions < lens[b]
// (and, with a window, only positions > ends[b] - 1 - window), masked
// with the same finite NEG_INF, optional softcap cap * tanh(s / cap),
// and a lens[b] == 0 row writes zeros (the running sum is floored at
// 1e-30).  Optionally it also writes each head's log-sum-exp, fp32 [B,
// Hq]: log of the sum of exp of the scaled, soft-capped logits over the
// attended slots, -inf where the row attends none (lens[b] == 0, or a
// window that ends before the row's first slot).  The sharded serving
// steps call it on one rank's range of a sequence-split cache, where both
// happen, and merge the ranks' partials by these values.
//
// Bound: memory.  A call must read the live K and V rows, sum_b lens[b]
// * Hkv * D * 2 * sizeof(T) bytes, and does about 4 * Hq * D flops per
// live token, far below the card's flops-per-byte ridge.  At qwen3-0.6b's
// decode (B 8, S 161, lens 145, Hkv 8, D 128, bf16) that is 4.82 MB with
// q and the output: 1.44 us at 3.35 TB/s (chip_smoke.py phase 5 prints
// it per served shape).  So the design reads each live row once and puts
// enough blocks and bytes in flight to fill the card.
//
// Design.  The Pallas grid (B, Hq, chunks) walks one row's chunks in
// order on one core for each query head.  Here one thread-block cluster
// per (kv head, row) splits the row's S token slots over ``splits``
// blocks (grid (splits, Hkv, B), cluster dims (splits, 1, 1), launched
// with cudaLaunchKernelEx); splits = min(8, ceil(S / 32)) comes from the
// wrapper and depends on S alone, because reading lens back to the host
// would cost a sync per layer.  That is 8 * 8 * 6 = 384 blocks for qwen3
// (S 161), 192 for qwen3-moe (Hkv 4) and 1,536 for zamba2 (Hkv 32),
// where one block per (kv head, row) gave 64, 32 and 256.  Each block
// reads its tokens' K and V rows straight from device memory with 16-byte
// loads into registers (no staging in shared memory) and computes the
// fp32 partial (m, l, acc[G, D]) for all G query heads of its kv head, so
// every K/V byte is read once; the cluster merges the partials through
// distributed shared memory with a log-sum-exp rescale, each block
// writes its slice of the [G, D] output, and a last cluster barrier keeps
// each block's shared memory alive until its peers have read it.  Still
// one launch per call, with no scratch in device memory.  The cache is
// not padded (the JAX wrapper pads it with jnp.pad, a copy per layer per
// step).  The body is attn::decode_split (include/attention_common.cuh)
// cutting the row's S slots (SplitOver::kSlots), so the first pass's
// loads are issued before lens[b] is read; the paged kernel runs the same
// body over each row's attended range instead.
//
// C interface (bound with ctypes): decode_attention_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16; lse is null
// or the fp32 [B, Hq] output.  The pointers must be 16-byte aligned, D a
// multiple of 8, D <= 256, 0 <= lens[b] <= S and 1 <= splits <= 8 (the
// wrapper checks what it can without reading lens back).  ends[b] is the
// query's position + 1, from which the window is measured: lens[b]
// itself, except where the model's decode write was clamped onto the
// cache's last slot (the query past S - 1, as
// jax.lax.dynamic_update_slice clamps its start), and then lens[b] = S
// and ends[b] > S, as JAX's plain attention sees that step.  On a rank's
// range of a sequence-split cache both are shifted by the range's first
// slot, so ends[b] may be <= 0 or > S there.
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;

// a row's tokens lie tok_stride elements apart from (b, 0, h, 0)
struct DenseTokens {
  size_t row0;
  size_t tok_stride;
  __device__ size_t at(int t) const { return row0 + (size_t)t * tok_stride; }
};

template <typename T, int GT, int CPT>
__global__ void __launch_bounds__(kThreads)
dense_decode_split_kernel(const T* __restrict__ q,       // [B, Hq, D]
                          const T* __restrict__ k,       // [B, S, Hkv, D]
                          const T* __restrict__ v,       // [B, S, Hkv, D]
                          const int* __restrict__ lens,  // [B]
                          const int* __restrict__ ends,  // [B]
                          T* __restrict__ out,           // [B, Hq, D]
                          float* __restrict__ lse,       // [B, Hq] or null
                          int S, int Hkv, int G, int D, float scale,
                          int window, float softcap) {
  const int h = blockIdx.y;  // kv head
  const int b = blockIdx.z;  // row
  // the G query heads of kv head h are contiguous: heads h*G .. h*G+G-1
  const size_t head0 = ((size_t)b * Hkv + h) * G;
  const DenseTokens src{((size_t)b * S * Hkv + h) * D, (size_t)Hkv * D};
  attn::decode_split<T, GT, CPT, attn::SplitOver::kSlots>(
      q + head0 * D, k, v, src, out + head0 * D, lens + b, ends + b, S, G,
      D, scale, window, softcap, lse == nullptr ? nullptr : lse + head0);
}

template <typename T, int GT, int CPT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, const void* ends, void* out, void* lse,
                   int B, int S, int Hq, int Hkv, int D, float scale,
                   int window, float softcap, int splits,
                   cudaStream_t stream) {
  // at most 41 KB (GT 8, D 256): under the 48 KB a launch may take
  // without raising the limit
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
      &cfg, dense_decode_split_kernel<T, GT, CPT>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lens), static_cast<const int*>(ends),
      static_cast<T*>(out), static_cast<float*>(lse), S, Hkv, Hq / Hkv, D,
      scale, window, softcap);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// GT: the heads one block holds at a time (G rounded up to 1, 2, 4 or 8;
// a larger G takes several passes); CPT: 16-byte chunks per thread (2 only
// for an fp32 row of more than 32 chunks, D > 128)
template <typename T, int CPT>
cudaError_t by_heads(const void* q, const void* k, const void* v,
                     const void* lens, const void* ends, void* out,
                     void* lse, int B, int S, int Hq, int Hkv, int D,
                     float scale, int window, float softcap, int splits,
                     cudaStream_t st) {
  const int G = Hq / Hkv;
  if (G == 1)
    return launch<T, 1, CPT>(q, k, v, lens, ends, out, lse, B, S, Hq, Hkv,
                             D, scale, window, softcap, splits, st);
  if (G == 2)
    return launch<T, 2, CPT>(q, k, v, lens, ends, out, lse, B, S, Hq, Hkv,
                             D, scale, window, softcap, splits, st);
  if (G <= 4)
    return launch<T, 4, CPT>(q, k, v, lens, ends, out, lse, B, S, Hq, Hkv,
                             D, scale, window, softcap, splits, st);
  return launch<T, 8, CPT>(q, k, v, lens, ends, out, lse, B, S, Hq, Hkv, D,
                           scale, window, softcap, splits, st);
}

}  // namespace

// lse: null, or an fp32 [B, Hq] array for each head's log-sum-exp
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lens,
                                    const void* ends, void* out, void* lse,
                                    int B, int S, int Hq, int Hkv, int D,
                                    float scale, int window,
                                    float softcap, int splits, int dtype,
                                    void* stream) {
  if (B == 0) return cudaSuccess;
  if (D > 256 || splits < 1 || splits > 8) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D / 4 > 32)
      return by_heads<float, 2>(q, k, v, lens, ends, out, lse, B, S, Hq,
                                Hkv, D, scale, window, softcap, splits, st);
    return by_heads<float, 1>(q, k, v, lens, ends, out, lse, B, S, Hq, Hkv,
                              D, scale, window, softcap, splits, st);
  }
  if (dtype == 1)
    return by_heads<__nv_bfloat16, 1>(q, k, v, lens, ends, out, lse, B, S,
                                      Hq, Hkv, D, scale, window, softcap,
                                      splits, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
