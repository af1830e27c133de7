// RMSNorm for Hopper: out = x * rsqrt(mean(x^2) + eps) * w per row, in
// fp32, cast to x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_fwd, body _rms_kernel) and computes what it computes, which is
// also the JAX package's models/layers.py::rms_norm: the mean of squares
// in fp32, rsqrt, (x * inv) * w in fp32, one rounding to x's dtype.
//
// Bound: memory.  A call must read x and w once and write out once, and
// does about 4 flops per element.  The design reads each row with 16-byte
// loads in two passes: the first sums the squares in fp32 (warp shuffles,
// then shared memory across the warps of a block), the second reads the
// row again (from L1/L2: a row is at most a few KB) with w and writes the
// output.  A row of d <= 1024 is one warp's work (four rows per block of
// 128 threads, so the qk-norm's 128-wide rows keep the card busy); a
// longer row is one block of 256 threads.  The Pallas wrapper pads the
// rows to its block; here a row is a warp or a block, so nothing is
// padded.  Rows are read through a row stride, so a 2-D view of a larger
// tensor is taken as it is; the output is contiguous.  Where d, the
// stride or a pointer does not allow 16-byte loads, the same kernel runs
// with one element per load.
//
// C interface (bound with ctypes): rmsnorm_fwd returns the cudaError_t of
// the launch; dtype 0 = float32, 1 = bfloat16, for x (and out) and w
// separately; vec = 1 takes 16-byte loads, which the launcher allows
// only where d, the row stride and every pointer are aligned for them
// (kernel.py ``vectorized``), else one element per load.
#include "attention_common.cuh"

namespace {

constexpr int kWarpRowMaxD = 1024;  // kernel.py WARP_ROW_MAX_D mirrors it
constexpr int kWarpModeThreads = 128;
constexpr int kBlockModeThreads = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N elements of T at p (aligned to the whole vector) in one load
template <int N, typename T>
__device__ __forceinline__ Vec<T, N> load(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

// kRowThreads threads per row (32: a warp; else the whole block), kVec
// elements of x per load
template <typename T, typename W, int kVec, int kThreads, int kRowThreads>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, long long x_stride,
               const W* __restrict__ w, T* __restrict__ out, int rows,
               int d, float eps) {
  constexpr int kRowsPerBlock = kThreads / kRowThreads;
  constexpr int kWarps = kRowThreads / 32;
  const int t = threadIdx.x % kRowThreads;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kRowThreads;
  // with one row per warp, a warp past the last row leaves as a whole
  // (only warp shuffles follow); with one row per block, every row exists
  if (row >= rows) return;
  const T* xr = x + row * x_stride;
  T* outr = out + row * (long long)d;
  const int nv = d / kVec;

  float ss = 0.f;
  for (int i = t; i < nv; i += kRowThreads) {
    const Vec<T, kVec> a = load<kVec>(xr + i * kVec);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float f = attn::to_f32(a.v[k]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (kWarps > 1) {
    __shared__ float part[kWarps];
    __shared__ float total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float s = lane < kWarps ? part[lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) total = s;
    }
    __syncthreads();
    ss = total;
  }
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int i = t; i < nv; i += kRowThreads) {
    const Vec<T, kVec> a = load<kVec>(xr + i * kVec);
    const Vec<W, kVec> b = load<kVec>(w + i * kVec);
    Vec<T, kVec> o;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float y = attn::to_f32(a.v[k]) * inv;  // (x * inv) * w, as
      attn::store(&o.v[k], y * attn::to_f32(b.v[k]));  // the reference
    }
    *reinterpret_cast<Vec<T, kVec>*>(outr + i * kVec) = o;
  }
}

template <typename T, typename W, int kVec>
cudaError_t launch_vec(const void* x, long long x_stride, const void* w,
                       void* out, int rows, int d, float eps,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  if (d <= kWarpRowMaxD) {
    constexpr int kRows = kWarpModeThreads / 32;
    rmsnorm_kernel<T, W, kVec, kWarpModeThreads, 32>
        <<<(rows + kRows - 1) / kRows, kWarpModeThreads, 0, stream>>>(
            xp, x_stride, wp, op, rows, d, eps);
  } else {
    rmsnorm_kernel<T, W, kVec, kBlockModeThreads, kBlockModeThreads>
        <<<rows, kBlockModeThreads, 0, stream>>>(xp, x_stride, wp, op, rows,
                                                 d, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(const void* x, long long x_stride, const void* w,
                   void* out, int rows, int d, float eps, int vec,
                   cudaStream_t stream) {
  if (vec)
    return launch_vec<T, W, 16 / sizeof(T)>(x, x_stride, w, out, rows, d,
                                            eps, stream);
  return launch_vec<T, W, 1>(x, x_stride, w, out, rows, d, eps, stream);
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, long long x_stride, const void* w,
                           void* out, int rows, int d, float eps,
                           int x_dtype, int w_dtype, int vec, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (d < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, x_stride, w, out, rows, d, eps, vec, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, x_stride, w, out, rows, d, eps,
                                        vec, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, x_stride, w, out, rows, d, eps,
                                        vec, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, x_stride, w, out, rows, d,
                                                eps, vec, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
