// Mamba2 SSD (state-space duality) chunked scan for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_fwd, body _ssd_kernel) together with the parts of its
// wrapper ops.py that a GPU does better in the kernel, and computes what
// src/repro/models/ssm.py::ssd_chunked computes.  For one (row b, head h)
// the sequence is cut into chunks of Q steps; with cum the in-chunk
// cumulative sum of the log decay a (a <= 0) and the carried state
// S[P][N] (fp32):
//
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xb[j]   (intra)
//         + exp(cum_i) (C_i . S[p])                             (inter)
//   S'    = S exp(cum_last) + sum_j exp(cum_last - cum_j) xb[j] (x) B_j
//
// Bound.  A call must read xb, a, the grouped B and C and the initial
// state (when one is given) and write y and the final state once.  It does about
// 2 Q^2/2 (N + P) + 4 Q N P operations per (b, h, chunk): at the serving
// shapes (Q = N = 128, P = 64) ~100 per byte moved, below the bf16
// tensor-core ridge (~295), so the bytes set the bound.  This first
// version computes in fp32 on the CUDA cores (no tensor cores), so it is
// bound by its own fp32 arithmetic and shared-memory loads, several
// times above that bound; wgmma for the Q x Q x N and Q x P x N products
// is the known next step.
//
// Design.  The Pallas grid (B, H, chunks) runs its chunk axis in order on
// one core and keeps the P x N state in VMEM scratch.  On Hopper blocks
// run in parallel, so the chunk loop moves inside one thread block per
// (head h, row b), and the state stays in shared memory across it and is
// written out once after the last chunk.  Per chunk the block stages B
// and xb as fp32 (B rows padded to N + 1 floats so column walks are free
// of bank conflicts), takes the cumsum of a with one warp, then walks the
// chunk's query rows in tiles of kRows: it stages the tile's C rows,
// computes the masked, decayed scores C_i . B_j exp(cum_i - cum_j) for
// j <= i only (exp is never taken above the diagonal), and forms y from
// the scores, xb and the state read before this chunk's update.  Last it
// updates the state.  All sums are fp32; y is cast to xb's type once, at
// the store.  What the JAX wrapper does around its kernel is done here:
// B and C are read through the group index g = h / (H / G) (no repeat to
// heads), a ragged last chunk is masked (rows t >= S load a = 0, xb = 0,
// which leaves the state unchanged, so no padding of S), and an initial
// state, when given, is the state the first chunk starts from (the JAX
// wrapper folds it in after its kernel, adding C . s0 to a y already cast
// to xb's type; with a zero initial state, the only one serving passes,
// the two agree exactly).  Inputs are read through their batch and
// sequence strides (the model's B and C are views into one projection),
// so the wrapper copies nothing.
//
// C interface (bound with ctypes): ssd_scan_fwd returns the cudaError_t
// of the launch; dtype 0 = float32, 1 = bfloat16 (xb, B, C and y), a and
// both states are float32.  s0 may be null (a zero initial state).  The
// wrapper checks shapes, types, strides and the shared-memory limit, and
// passes the block's shared-memory bytes (kernel.py::smem_bytes, which
// sizes the layout at the top of ssd_scan_kernel).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 32;  // query rows per score tile (kernel.py ROWS)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element strides of an input's batch and sequence axes; the axes after
// them are contiguous
struct Strides {
  long long b, s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xb,     // [B, S, H, P]
                const float* __restrict__ a,  // [B, S, H]
                const T* __restrict__ Bm,     // [B, S, G, N]
                const T* __restrict__ Cm,     // [B, S, G, N]
                const float* __restrict__ s0, // [B, H, P, N] or null
                T* __restrict__ y,            // [B, S, H, P], contiguous
                float* __restrict__ s_out,    // [B, H, P, N], contiguous
                Strides xs, Strides as, Strides bs, Strides cs, int S, int H,
                int G, int P, int N, int Q) {
  const int h = blockIdx.x;  // head
  const int b = blockIdx.y;  // row
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int NP = N + 1;

  // shared memory, in floats: state [P][N+1], B [Q][N+1], xb [Q][P],
  // C rows [kRows][N+1], scores [kRows][Q], cum [Q], decay [Q]
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // [P][N+1]
  float* b_s = st + (size_t)P * NP;             // [Q][N+1]
  float* x_s = b_s + (size_t)Q * NP;            // [Q][P]
  float* c_s = x_s + (size_t)Q * P;             // [kRows][N+1]
  float* sc = c_s + (size_t)kRows * NP;         // [kRows][Q]
  float* cum = sc + (size_t)kRows * Q;          // [Q]
  float* w = cum + Q;                           // [Q]

  const size_t head = (size_t)b * H + h;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    st[p * NP + n] = s0 ? s0[head * P * N + e] : 0.f;
  }
  const T* xb_b = xb + b * xs.b + (size_t)h * P;
  const float* a_b = a + b * as.b + h;
  const T* B_b = Bm + b * bs.b + (size_t)g * N;
  const T* C_b = Cm + b * cs.b + (size_t)g * N;
  T* y_b = y + ((size_t)b * S * H + h) * P;
  const size_t ys = (size_t)H * P;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int rows = min(Q, S - t0);  // steps of this chunk below S
    for (int j = tid; j < Q; j += kThreads)
      cum[j] = j < rows ? a_b[(t0 + j) * as.s] : 0.f;
    for (int e = tid; e < Q * N; e += kThreads) {
      const int j = e / N, n = e - j * N;
      b_s[j * NP + n] = j < rows ? to_f32(B_b[(t0 + j) * bs.s + n]) : 0.f;
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, p = e - j * P;
      x_s[e] = j < rows ? to_f32(xb_b[(t0 + j) * xs.s + p]) : 0.f;
    }
    __syncthreads();
    // inclusive cumsum of the log decay: warp 0, 32 steps at a time
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int j = base + tid;
        float v = j < Q ? cum[j] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (j < Q) cum[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    // read only by the state update, behind the row tiles' barriers
    for (int j = tid; j < Q; j += kThreads) w[j] = expf(cum_last - cum[j]);

    for (int i0 = 0; i0 < rows; i0 += kRows) {
      const int nr = min(kRows, rows - i0);  // query rows of this tile
      const int nj = i0 + nr;                // keys j <= the last row
      for (int e = tid; e < nr * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        c_s[r * NP + n] = to_f32(C_b[(t0 + i0 + r) * cs.s + n]);
      }
      __syncthreads();
      // scores: (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
      for (int e = tid; e < nr * nj; e += kThreads) {
        const int r = e / nj, j = e - r * nj;
        const int i = i0 + r;
        float s = 0.f;
        if (j <= i) {
          const float* ci = c_s + r * NP;
          const float* bj = b_s + j * NP;
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot = fmaf(ci[n], bj[n], dot);
          s = dot * expf(cum[i] - cum[j]);
        }
        sc[r * Q + j] = s;
      }
      __syncthreads();
      // y = scores . xb + exp(cum_i) C_i . state
      for (int e = tid; e < nr * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        const int i = i0 + r;
        const float* si = sc + r * Q;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(si[j], x_s[j * P + p], intra);
        const float* ci = c_s + r * NP;
        const float* sp = st + p * NP;
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(ci[n], sp[n], inter);
        store(y_b + (size_t)(t0 + i) * ys + p, intra + inter * expf(cum[i]));
      }
      __syncthreads();
    }
    // state update: S exp(cum_last) + sum_j exp(cum_last - cum_j) xb_j B_j
    const float decay = expf(cum_last);
    for (int e = tid; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      float acc = 0.f;
      for (int j = 0; j < rows; ++j)
        acc = fmaf(x_s[j * P + p] * w[j], b_s[j * NP + n], acc);
      st[p * NP + n] = st[p * NP + n] * decay + acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    s_out[head * P * N + e] = st[p * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* xb, const void* a, const void* Bm,
                   const void* Cm, const void* s0, void* y, void* s_out,
                   const long long* strides, int B, int S, int H, int G,
                   int P, int N, int Q, int smem, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const Strides xs{strides[0], strides[1]}, as{strides[2], strides[3]},
      bs{strides[4], strides[5]}, cs{strides[6], strides[7]};
  const dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xb), static_cast<const float*>(a),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_out), xs, as, bs, cs, S, H, G, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_fwd(const void* xb, const void* a, const void* Bm,
                            const void* Cm, const void* s0, void* y,
                            void* s_out, const long long* strides, int B,
                            int S, int H, int G, int P, int N, int chunk,
                            int dtype, int smem, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xb, a, Bm, Cm, s0, y, s_out, strides, B, S, H, G, P,
                         N, chunk, smem, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xb, a, Bm, Cm, s0, y, s_out, strides, B, S,
                                 H, G, P, N, chunk, smem, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
