// Flash-attention prefill for Hopper: blockwise attention of S queries
// against S keys with an fp32 online softmax, causal or not.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _flash_kernel) and computes what it
// computes: GQA attention (query head h reads kv head h / G), keys at or
// past seq_len masked, causal (k_pos <= q_pos) and sliding-window (k_pos
// > q_pos - window) masks, all with the same finite NEG_INF, optional
// softcap cap * tanh(s / cap) before the mask, and the running sum
// floored at 1e-30 at the end.
//
// Bound: at the serving shapes, memory.  A call reads q, k and v once
// and writes o once, and does 4 * D flops per (query, key) pair that the
// masks keep: at S = 128 that is about 40 flops per byte, below the
// card's ridge (~295 in bf16), so the bytes set the bound; at long S the
// flops do.  This first version computes in fp32 on the CUDA cores (no
// tensor cores) and is simple rather than fast.
//
// Design.  The Pallas grid (B, Hq, q_blocks, kv_blocks) runs in order on
// one core and carries (acc, m, l) in VMEM across the kv steps.  On
// Hopper blocks run in parallel, so the kv loop moves inside the block:
// one thread block per (q tile of BQ rows, query head, row b), heaviest
// (last) q tiles first.  The loop runs from the window's lower edge
// max(0, q_start - window + 1) to the causal edge min(S, q_start + BQ):
// the Pallas block skip (kernel.py:71-82) written as loop bounds.  Q and
// each K tile are staged in shared memory as fp32, transposed ([D][rows
// + 1], conflict-free column reads), V as [BK][D]; the BQ x BK score tile
// and the BQ x D accumulator live in registers, 16 x 16 threads each
// owning BQ/16 rows and strided columns; a row's max and sum reduce over
// the 16 lanes that own it.  The kernel reads [B, S, H, D] (the model's
// layout) or [B, H, S, D] through its strides and masks the ragged tail
// itself, so the wrapper neither transposes nor pads (the JAX wrapper
// does both, for the TPU's tiling).  Tensor cores (wgmma), TMA and a
// pipelined K/V ring are the known next steps.
//
// C interface (bound with ctypes): flash_attention_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16.  Strides
// are in elements; the last dim is contiguous, rows 16-byte aligned and
// D a multiple of 8, D <= 256 (the wrapper checks all of it).
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16

// shared memory of one block (floats): qT [D][BQ+1], kT [D][BK+1],
// v [BK][D], p [BQ][BK+1]
__host__ __device__ inline size_t flash_smem_floats(int BQ, int BK, int D) {
  return (size_t)D * (BQ + 1) + (size_t)D * (BK + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1);
}

struct Strides {
  long long b, s, h;
};

template <typename T, int BQ, int BK, int MAXD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 Strides qs, Strides ks, Strides vs, Strides os, int S,
                 int G, int D, float scale, int causal, int window,
                 float softcap) {
  constexpr int RQ = BQ / 16;    // score / acc rows per thread
  constexpr int RK = BK / 16;    // score columns per thread
  constexpr int RD = MAXD / 16;  // acc columns per thread
  constexpr int kVec = 16 / sizeof(T);

  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;  // query head
  const int b = blockIdx.z;  // row
  const int hk = h / G;      // its kv head
  const int tid = threadIdx.x;
  const int tr = tid >> 4;   // rows tr + 16 * i
  const int tc = tid & 15;   // columns tc + 16 * j

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* v_s = smem;                 // [BK][D] (16-byte aligned rows)
  float* qT = v_s + BK * D;          // [D][BQ + 1]
  float* kT = qT + D * (BQ + 1);     // [D][BK + 1]
  float* p_s = kT + D * (BK + 1);    // [BQ][BK + 1]

  const int nvec = D / kVec;  // 16-byte vectors per row
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // Q tile, transposed; rows past S are zeros
  for (int i = tid; i < BQ * nvec; i += kThreads) {
    const int r = i / nvec;
    const int d0 = (i - r * nvec) * kVec;
    float x[kVec];
    if (q_start + r < S) {
      attn::unpack16(qb + (long long)(q_start + r) * qs.s + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qT[(d0 + e) * (BQ + 1) + r] = x[e];
  }

  float acc[RQ][RD];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  const int k_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const int k_hi = causal ? min(S, q_start + BQ) : S;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * nvec; i += kThreads) {
      const int c = i / nvec;
      const int d0 = (i - c * nvec) * kVec;
      const bool ok = k0 + c < S;
      float x[kVec];
      if (ok) {
        attn::unpack16(kb + (long long)(k0 + c) * ks.s + d0, x);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) kT[(d0 + e) * (BK + 1) + c] = x[e];
      attn::load16_or_zero(vb + (long long)(k0 + c) * vs.s + d0,
                           v_s + c * D + d0, ok);
    }
    __syncthreads();

    // scores s = q . k for this thread's rows and columns
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], bk[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qT[d * (BQ + 1) + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < RK; ++j) bk[j] = kT[d * (BK + 1) + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // scale, softcap, mask; online softmax over the tile's columns
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = tr + 16 * i;
      const int q_pos = q_start + r;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int k_pos = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = k_pos < S;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && k_pos > q_pos - window;
        x = ok ? x : attn::kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 lanes tc = 0..15 of a half-warp own row r together
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - mx);
        p_s[r * (BK + 1) + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P @ V
    const int kn = min(BK, S - k0);
#pragma unroll 2
    for (int c = 0; c < kn; ++c) {
      float p[RQ], vv[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = p_s[(tr + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const int d = tc + 16 * j;
        vv[j] = d < D ? v_s[c * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q_pos = q_start + tr + 16 * i;
    if (q_pos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tc + 16 * j;
      if (d < D)
        attn::store(ob + (long long)q_pos * os.s + d, acc[i][j] / den);
    }
  }
}

template <typename T, int BQ, int BK, int MAXD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Strides& qs, const Strides& ks, const Strides& vs,
                   const Strides& os, int B, int S, int Hq, int Hkv, int D,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * flash_smem_floats(BQ, BK, D);
  auto kern = flash_fwd_kernel<T, BQ, BK, MAXD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, S,
      Hq / Hkv, D, scale, causal, window, softcap);
  return cudaGetLastError();
}

// D <= 128: 64-row q tiles against 32-key tiles (75 KB of shared memory at
// D = 128, so three blocks fit on an SM); D <= 256: 32 x 32 tiles
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const Strides& qs, const Strides& ks, const Strides& vs,
                     const Strides& os, int B, int S, int Hq, int Hkv, int D,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t st) {
  if (D <= 128)
    return launch<T, 64, 32, 128>(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv,
                                  D, scale, causal, window, softcap, st);
  return launch<T, 32, 32, 256>(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv,
                                D, scale, causal, window, softcap, st);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* strides,  // [12]
                                   int B, int S, int Hq, int Hkv, int D,
                                   float scale, int causal, int window,
                                   float softcap, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (D > 256) return cudaErrorInvalidValue;
  // (b, s, h) strides of q, k, v and out, in that order
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv, D,
                           scale, causal, window, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, qs, ks, vs, os, B, S, Hq,
                                   Hkv, D, scale, causal, window, softcap, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
