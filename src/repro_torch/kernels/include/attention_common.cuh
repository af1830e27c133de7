// Device code shared by the kernels of the port: the masking constant,
// fp32/bf16 conversions (which the RMSNorm kernel uses too), 16-byte
// loads, and the one-query-token decode body that the paged kernel
// (paged_attention.cu) and the dense decode kernel (decode_attention.cu)
// both run.  ``kernels/build.py``
// hashes this header into every library's name, so an edit here rebuilds
// every kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

// the JAX package's finite mask value, -0.7 * f32max: a fully masked row
// stays finite (exp(0) = 1 per entry) instead of turning into NaN
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T (16-byte aligned) -> 16 / sizeof(T) floats in r[]
__device__ __forceinline__ void unpack16(const float* src, float* r) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* src, float* r) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    r[2 * i] = f.x;
    r[2 * i + 1] = f.y;
  }
}

// 16 bytes of T -> 16 / sizeof(T) floats in shared memory (16-byte
// aligned), or zeros when ``valid`` is false (nothing is read then)
template <typename T>
__device__ __forceinline__ void load16_or_zero(const T* src, float* dst,
                                               bool valid) {
  constexpr int kVec = 16 / sizeof(T);
  float r[kVec];
  if (valid) {
    unpack16(src, r);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) r[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < kVec; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(r[e], r[e + 1], r[e + 2], r[e + 3]);
}

// Dynamic shared memory of one decode block (floats): fp32 K and V
// chunks, q and acc for the G heads, the G x chunk scores and (m, l,
// alpha).
__host__ __device__ inline size_t decode_smem_floats(int G, int D,
                                                     int chunk) {
  return (size_t)2 * chunk * D + 2 * G * D + G * chunk + 3 * G;
}

// One query token of one row against that row's K/V, for the G query
// heads of one kv head, walked in chunks of ``Src::chunk`` tokens.
//
// Src tells where the row's tokens lie:
//   int count(int len)  chunks to walk for ``len`` valid tokens
//   size_t base(int c)  element offset of (first token of chunk c, kv
//                       head, d = 0) in the K and V arrays
//   int rows(int c)     tokens of chunk c that exist in memory (the rest
//                       of the chunk is zero-filled, never read)
//   int chunk           tokens per chunk
// Consecutive tokens of a chunk are ``tok_stride`` elements apart.
//
// Masks positions >= len and, with a window, positions <= len - 1 -
// window; skips whole chunks below the window (a test that is the same
// for every thread, so the barriers stay uniform).  Online softmax in
// fp32 with the finite kNegInf, softcap cap * tanh(s / cap) before the
// mask, and the running sum floored at 1e-30, so len == 0 writes zeros.
template <typename T, int kThreads, typename Src>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ qb,  // [G, D]: the G heads of this kv head
    const T* __restrict__ k, const T* __restrict__ v, const Src& src,
    size_t tok_stride, T* __restrict__ ob,  // [G, D]
    int len, int G, int D, float scale, int window, float softcap) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWarps = kThreads / 32;
  const int chunk = src.chunk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* k_s = smem;              // [chunk, D]
  float* v_s = k_s + chunk * D;   // [chunk, D]
  float* q_s = v_s + chunk * D;   // [G, D]
  float* acc = q_s + G * D;       // [G, D]
  float* s_s = acc + G * D;       // [G, chunk]: scores, then probabilities
  float* m_s = s_s + G * chunk;   // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* a_s = l_s + G;           // [G] rescale factor for this chunk

  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int n_chunks = src.count(len);
  for (int c = 0; c < n_chunks; ++c) {
    const int k_start = c * chunk;
    // the whole chunk lies below the window: nothing in it is attended
    if (window > 0 && k_start + chunk - 1 <= len - 1 - window) continue;
    const size_t base = src.base(c);
    const int rows = src.rows(c);

    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid * kVec; i < chunk * D; i += kThreads * kVec) {
      const int t = i / D;
      const size_t off = base + (size_t)t * tok_stride + (i - t * D);
      load16_or_zero(k + off, k_s + i, t < rows);
      load16_or_zero(v + off, v_s + i, t < rows);
    }
    __syncthreads();

    // scores: one warp per (head, token), lanes across D
    for (int j = warp; j < G * chunk; j += kWarps) {
      const int g = j / chunk;
      const int t = j - g * chunk;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[g * D + d] * k_s[t * D + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        float s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int pos = k_start + t;
        bool ok = pos < len;
        if (window > 0) ok = ok && pos > len - 1 - window;
        s_s[j] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, lanes across the chunk
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * chunk;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = lane; t < chunk; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int t = lane; t < chunk; t += 32) {
        const float p = expf(sg[t] - mx);
        sg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = mx;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = s_s + g * chunk;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < chunk; ++t) a += pg[t] * v_s[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads)
    store(ob + i, acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

}  // namespace attn
