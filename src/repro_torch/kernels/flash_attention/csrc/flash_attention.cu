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
// masks keep.  At qwen3-0.6b's prefill (B 8, S 128, Hq 16, Hkv 8, D 128,
// causal) that is 12.58 MB and 0.541 GFLOP: 3.76 us of bytes at 3.35 TB/s
// and 0.55 us of bf16 tensor-core flops at 989 TFLOP/s, so the bytes set
// the bound (chip_smoke.py phase 5 prints it per served shape; the same
// flops on the CUDA cores in fp32 take at least 8.1 us, which is why the
// bf16 route runs on the tensor cores).
//
// Two routes, one per dtype, with the same grid: one thread block per (q
// tile, query head, row b), heaviest (last) q tiles first.  The Pallas
// grid (B, Hq, q_blocks, kv_blocks) runs in order on one core and carries
// (acc, m, l) in VMEM across the kv steps; on Hopper blocks run in
// parallel, so the kv loop moves inside the block.  The loop runs from
// the window's lower edge max(0, q_start - window + 1) to the causal edge
// min(S, q_start + rows): the Pallas block skip (kernel.py:71-82) written
// as loop bounds.  Both read [B, S, H, D] (the model's layout) or [B, H,
// S, D] through their strides and mask the ragged tail themselves, so the
// wrapper neither transposes nor pads (the JAX wrapper does both, for the
// TPU's tiling).
//
// bf16: tensor cores (flash_fwd_wgmma_kernel).  One warpgroup (128
// threads) per 64-row q tile.  Q is copied once into shared memory; K and
// V tiles of 64 keys go through a two-stage ring filled with cp.async, so
// the next tile's copy runs under this tile's products.  Every tile is
// stored as 128-byte swizzled panels of 64 columns ([rows][64] bf16, the
// 16-byte chunk c of row r at chunk c ^ (r % 8)), the layout wgmma's
// 128B-swizzle descriptors read without bank conflicts; a D that is a
// multiple of 8 but not of 16 is zero-filled to 16, and keys past S are
// zero-filled.  S = Q K^T is wgmma m64n64k16 with both operands from
// shared memory, K-major ([keys][D] is already K-major for B).  Scale,
// softcap and the masks are applied to the fp32 accumulator fragment,
// then the online softmax: a row's max reduces over the 4 lanes that hold
// it, its sum stays per lane until the end.  P is rounded to bf16 in
// registers, where the accumulator fragment of S is already the A
// fragment of O += P V (m64n64k16 per 64-column panel of V), and V is
// read as B through the descriptor's transpose bit, since it is stored
// [keys][D].  O accumulates in fp32 registers and is divided by max(l,
// 1e-30) at the end.  One deliberate difference: the Pallas kernel
// multiplies an fp32 P by V; this route rounds P to bf16 first (held to
// the bf16 tolerance, 2e-2).
//
// f32: CUDA cores (flash_fwd_kernel), kept so the f32 route stays within
// 2e-5 of the plain version (TF32 would not).  Q and each K tile are
// staged in shared memory as fp32, transposed ([D][rows + 1]), V as
// [BK][D]; the BQ x BK score tile and the BQ x D accumulator live in
// registers, 16 x 16 threads each owning BQ/16 rows and strided columns.
//
// C interface (bound with ctypes): flash_attention_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16.  Strides
// are in elements; the last dim is contiguous, rows 16-byte aligned and
// D a multiple of 8, D <= 256 (the wrapper checks all of it).
#include <cstdint>

#include "attention_common.cuh"
#include "wgmma.cuh"

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

// f32, D <= 128: 64-row q tiles against 32-key tiles (75 KB of shared
// memory at D = 128, so three blocks fit on an SM); D <= 256: 32 x 32
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


// --- bf16: the tensor-core route ---------------------------------------------

// the tensor-core helpers (cp.async, swizzled panels, wgmma) come from
// include/wgmma.cuh, shared with the SSD scan's bf16 route
namespace tc {

using namespace wg;

constexpr int kRows = 64;              // q rows per block (wgmma M)
constexpr int kKeys = 64;              // keys per K/V tile (wgmma N of S)
constexpr int kThreads = 128;          // one warpgroup
constexpr int kPanelBytes = 64 * 128;  // 64 rows of one 128-byte panel

// dynamic shared memory for head dim D: 1024 bytes of slack to align the
// swizzle atoms, then Q and two stages of (K, V), each ceil(D / 64) panels
__host__ __device__ inline size_t smem_bytes(int D) {
  return 1024 + (size_t)5 * ((D + 63) / 64) * kPanelBytes;
}

// NP panels of 64 columns: D <= 64 * NP
template <int NP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os, int S,
                       int G, int D, float scale, int causal, int window,
                       float softcap) {
  constexpr uint32_t kTile = NP * kPanelBytes;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;  // query head
  const int b = blockIdx.z;  // row
  const int hk = h / G;      // its kv head
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D16 = (D + 15) & ~15;
  const int ksteps = D16 / 16;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  // stage s holds K at q_s + kTile (1 + 2 s) and V at q_s + kTile (2 + 2 s)

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  const int k_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const int k_hi = causal ? min(S, q_start + kRows) : S;
  const int n_tiles = (k_hi - k_lo + kKeys - 1) / kKeys;  // >= 1

  // groups 0 (Q and tile 0) and 1 (tile 1, or empty) in flight
  load_tile<kRows, kThreads>(q_s, qb, qs.s, q_start, S, D, D16);
  load_tile<kRows, kThreads>(q_s + kTile, kb, ks.s, k_lo, S, D, D16);
  load_tile<kRows, kThreads>(q_s + 2 * kTile, vb, vs.s, k_lo, S, D,
                             D16);
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile<kRows, kThreads>(q_s + 3 * kTile, kb, ks.s, k_lo + kKeys, S,
                               D, D16);
    load_tile<kRows, kThreads>(q_s + 4 * kTile, vb, vs.s, k_lo + kKeys, S,
                               D, D16);
  }
  cp_async_commit();

  // the accumulator fragment: this thread holds rows r0 and r0 + 8 of the
  // tile (d[4i], d[4i+1] and d[4i+2], d[4i+3]) at columns 8i + 2(lane % 4)
  // and the next one
  const int r0 = q_start + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {attn::kNegInf, attn::kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kKeys;
    const uint32_t k_s = q_s + kTile * (1 + 2 * (t & 1));
    const uint32_t v_s = k_s + kTile;
    cp_async_wait_1();  // tile t has landed (tile t + 1 may be in flight)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T over D16 / 16 steps of 16 columns
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
      wgmma_ss(s, desc(q_s + off, 16, 1024), desc(k_s + off, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // scale, softcap, mask; the new row max over the 4 lanes of a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + ((i >> 1) & 1) * 8;
      const int key = k0 + 8 * (i >> 2) + c0 + (i & 1);
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      bool ok = key < S;
      if (causal) ok = ok && key <= row;
      if (window > 0) ok = ok && key > row - window;
      x = ok ? x : attn::kNegInf;
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f((s[i] - mx[r]) * kLog2e);
      l[r] += s[i];
    }
    // the S fragment of keys 16 kk .. 16 kk + 15 is the A fragment of
    // step kk of P V
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O = O * alpha + P V, one 64-column panel of V at a time
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] *= alpha[(i >> 1) & 1];
      pin(o[p]);
    }
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[p], pa[kk],
                 desc(v_s + p * kPanelBytes + kk * 2048, 1024, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) pin(o[p]);

    __syncthreads();  // every warp is done reading this stage
    if (t + 2 < n_tiles) {
      load_tile<kRows, kThreads>(k_s, kb, ks.s, k0 + 2 * kKeys, S, D, D16);
      load_tile<kRows, kThreads>(v_s, vb, vs.s, k0 + 2 * kKeys, S, D, D16);
    }
    cp_async_commit();
  }

  bf16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + ((i >> 1) & 1) * 8;
      const int col = p * 64 + 8 * (i >> 2) + c0;
      if (row < S && col < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * os.s + col) =
            __floats2bfloat162_rn(o[p][i] * l[(i >> 1) & 1],
                                  o[p][i + 1] * l[(i >> 1) & 1]);
    }
}

template <int NP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Strides& qs, const Strides& ks, const Strides& vs,
                   const Strides& os, int B, int S, int Hq, int Hkv, int D,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kern = flash_fwd_wgmma_kernel<NP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kRows - 1) / kRows, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), qs, ks, vs, os,
      S, Hq / Hkv, D, scale, causal, window, softcap);
  return cudaGetLastError();
}

// one instantiation per count of 64-column panels
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const Strides& qs, const Strides& ks, const Strides& vs,
                     const Strides& os, int B, int S, int Hq, int Hkv, int D,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t st) {
  switch ((D + 63) / 64) {
    case 1:
      return launch<1>(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv, D, scale,
                       causal, window, softcap, st);
    case 2:
      return launch<2>(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv, D, scale,
                       causal, window, softcap, st);
    case 3:
      return launch<3>(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv, D, scale,
                       causal, window, softcap, st);
    default:
      return launch<4>(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv, D, scale,
                       causal, window, softcap, st);
  }
}

}  // namespace tc

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
    return tc::dispatch(q, k, v, out, qs, ks, vs, os, B, S, Hq, Hkv, D, scale,
                        causal, window, softcap, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
