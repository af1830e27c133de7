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
// and skips pages past the length or wholly below the window.  Each page
// is staged in shared memory as fp32 with 16-byte loads; a warp per
// (head, token) computes the scores, one thread per head updates (m, l),
// and the block updates acc[G, D].  This first version is simple and
// leaves most of the card idle at serving shapes (B * Hkv blocks, pages
// walked one after another); a cp.async/TMA page ring and a split over
// pages with a log-sum-exp merge are the known next steps.
//
// C interface (bound with ctypes): paged_attention_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16.  The
// pointers must be 16-byte aligned and D a multiple of 8 (the wrapper
// checks both).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T from device memory -> 16 / sizeof(T) floats in shared
// memory (both 16-byte aligned).
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float4 lo, hi;
  float2 f = __bfloat1622float2(h[0]);
  lo.x = f.x; lo.y = f.y;
  f = __bfloat1622float2(h[1]);
  lo.z = f.x; lo.w = f.y;
  f = __bfloat1622float2(h[2]);
  hi.x = f.x; hi.y = f.y;
  f = __bfloat1622float2(h[3]);
  hi.z = f.x; hi.w = f.y;
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

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
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // row
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lens[b];

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* k_s = smem;              // [page, D]
  float* v_s = k_s + page * D;    // [page, D]
  float* q_s = v_s + page * D;    // [G, D]
  float* acc = q_s + G * D;       // [G, D]
  float* s_s = acc + G * D;       // [G, page]: scores, then probabilities
  float* m_s = s_s + G * page;    // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* a_s = l_s + G;           // [G] rescale factor for this page

  // the G query heads of kv head h are contiguous: heads h*G .. h*G+G-1
  const size_t head0 = (size_t)b * Hkv * G + (size_t)h * G;
  const T* qb = q + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int n_pages = min((max(len, 0) + page - 1) / page, maxp);
  for (int ip = 0; ip < n_pages; ++ip) {
    const int k_start = ip * page;
    // the whole page lies below the window: nothing in it is attended
    // (the same for every thread, so the barriers below stay uniform)
    if (window > 0 && k_start + page - 1 <= len - 1 - window) continue;
    const size_t pid = (size_t)table[(size_t)b * maxp + ip];
    const size_t base = (pid * page * Hkv + h) * D;  // (pid, 0, h, 0)

    __syncthreads();  // the previous page's readers are done
    for (int i = tid * kVec; i < page * D; i += kThreads * kVec) {
      const int t = i / D;
      const size_t off = base + (size_t)t * Hkv * D + (i - t * D);
      load16(k_pool + off, k_s + i);
      load16(v_pool + off, v_s + i);
    }
    __syncthreads();

    // scores: one warp per (head, token), lanes across D
    for (int j = warp; j < G * page; j += kWarps) {
      const int g = j / page;
      const int t = j - g * page;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[g * D + d] * k_s[t * D + d];
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

    // online softmax: one thread per query head
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, s_s[g * page + t]);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(s_s[g * page + t] - mx);
        s_s[g * page + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - mx);
      a_s[g] = alpha;
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < page; ++t) a += s_s[g * page + t] * v_s[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + head0 * D;
  for (int i = tid; i < G * D; i += kThreads)
    store(ob + i, acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lens, void* out, int B,
                   int Hq, int Hkv, int D, int page, int maxp, float scale,
                   int window, float softcap, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)2 * page * D + 2 * G * D + G * page + 3 * G);
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
