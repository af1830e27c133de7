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
// state (when one is given) and write y and the final state once.  It
// does about 2 Q^2/2 (N + P) + 4 Q N P operations per (b, h, chunk): at
// the serving shapes (Q = N = 128, P = 64) ~100 per byte moved, below the
// bf16 tensor-core ridge (~295), so the bytes set the bound (chip_smoke.py
// phase 8 prints it per served launch).
//
// Both routes run one thread block per (head h, row b) with the chunk
// loop inside it: the Pallas grid (B, H, chunks) runs its chunk axis in
// order on one core and keeps the P x N state in VMEM scratch, while on
// Hopper blocks run in parallel.  The state stays on chip across the loop
// and is written out once after the last chunk.  What the JAX wrapper
// does around its kernel is done here: B and C are read through the group
// index g = h / (H / G) (no repeat to heads), a ragged last chunk is
// masked (rows t >= S load a = 0, xb = 0, which leaves the state
// unchanged, so no padding of S), and an initial state, when given, is
// the state the first chunk starts from (the JAX wrapper folds it in
// after its kernel, adding C . s0 to a y already cast to xb's type; with
// a zero initial state, the only one serving passes, the two agree
// exactly).  Inputs are read through their batch and sequence strides
// (the model's B and C are views into one projection), so the wrapper
// copies nothing.
//
// bf16: tensor cores (ssd_scan_wgmma_kernel), for chunk <= 128, P <= 64
// and N <= 128 (both served launches; kernel.py::route is the rule).  Two
// warpgroups, each owning 64 of the chunk's 128 tile rows.  Per chunk, C
// and B ([128][N rounded up to 64 or 128]) and xb ([128][64]) arrive as
// bf16 tiles of 128-byte swizzled panels (include/wgmma.cuh) through a
// two-stage cp.async ring, so the next chunk's copy runs under this
// chunk's products; rows past the chunk and columns past N or P are
// zero-filled, so every product is a whole number of wgmma m64n64k16
// steps.  Per warpgroup:
//   (d) y = exp(cum_i) C Stateᵀ, C and a bf16 copy of the state (written
//       to shared memory at the start of the chunk) both K-major;
//   (a) s = C Bᵀ for each 64-column tile at or left of the diagonal
//       (tiles wholly above it are skipped), both K-major;
//   (b) L = s exp(cum_i - cum_j) for j <= i, else 0, in the accumulator
//       registers, rounded to bf16: the fragment is already the register
//       A operand of
//   (c) y += L xb, xb read MN-major (the transpose bit);
//   (e) State = State exp(cum_last) + (xb exp(cum_last - cum_j))ᵀ B, M =
//       P, K = the chunk's rows, both operands MN-major; the scaled xb is
//       a bf16 copy in shared memory.  The fp32 state lives in the
//       wgmma accumulator registers for the whole loop: warpgroup t holds
//       its columns [64 t, 64 t + 64), 32 registers a thread.
// Deliberate differences from the Pallas kernel, which computes in fp32:
// L, the scaled xb and the state's copy for (d) are rounded to bf16 for
// the tensor cores (held to the JAX package's bf16 SSD tolerance, 5e-2;
// the state itself accumulates in fp32).  Where B, C or xb rows are not
// 16-byte aligned (N or P not a multiple of 8), the tiles are filled by
// plain loads and stores instead of cp.async.
//
// f32, and bf16 outside that rule: CUDA cores (ssd_scan_kernel), all sums
// in fp32, the state in shared memory.  Per chunk the block stages B and
// xb as fp32 (B rows padded to N + 1 floats so column walks are free of
// bank conflicts), takes the cumsum of a with one warp, then walks the
// chunk's query rows in tiles of kRows: it stages the tile's C rows,
// computes the masked, decayed scores C_i . B_j exp(cum_i - cum_j) for
// j <= i only (exp is never taken above the diagonal), and forms y from
// the scores, xb and the state read before this chunk's update.  Last it
// updates the state.  y is cast to xb's type once, at the store.
//
// C interface (bound with ctypes): ssd_scan_fwd returns the cudaError_t
// of the launch; dtype 0 = float32, 1 = bfloat16 (xb, B, C and y), a and
// both states are float32; route 1 takes the tensor cores (bf16 only),
// vec 1 lets it fill its tiles with 16-byte cp.async.  s0 may be null (a
// zero initial state).  The wrapper checks shapes, types, strides and the
// shared-memory limit, and passes the route, vec and the block's
// shared-memory bytes (kernel.py::smem_bytes, which sizes the layouts at
// the top of both kernels).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

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


// --- bf16: the tensor-core route ---------------------------------------------

namespace tc {

using namespace wg;

constexpr int kQ = 128;        // tile rows: the chunk, zero-filled to 128
constexpr int kThreads = 256;  // two warpgroups, 64 tile rows each
constexpr int kPanel = kQ * 128;  // bytes of one 64-column panel of a tile

// rows [0, rows) and columns [0, cols) of a slice (row stride ld) into the
// kQ-row swizzled panels at dst (gdst: the same bytes, generic), zero-
// filled to kQ rows and colsp columns; by cp.async where vec, else by
// plain loads and stores
__device__ __forceinline__ void load_rows(uint32_t dst, uint8_t* gdst,
                                          const bf16* src, long long ld,
                                          int rows, int cols, int colsp,
                                          bool vec) {
  if (vec) {
    load_tile<kQ, kThreads>(dst, src, ld, 0, rows, cols, colsp);
    return;
  }
  for (int i = threadIdx.x; i < kQ * colsp; i += kThreads) {
    const int r = i / colsp;
    const int c = i - r * colsp;
    const bf16 x = r < rows && c < cols ? src[r * ld + c]
                                        : __float2bfloat16(0.f);
    *reinterpret_cast<bf16*>(gdst + swizzled<kQ>(r, c >> 3) + (c & 7) * 2) =
        x;
  }
}

// dynamic shared memory for N rounded up to Np (64 or 128): 1024 bytes
// of slack to align the swizzle atoms; two stages of (C [kQ][Np], B
// [kQ][Np], xb [kQ][64]); the scaled xb [kQ][64]; the state's bf16 copy
// [64][Np]; a and its cumsum, kQ floats each
__host__ __device__ inline size_t smem_bytes(int Np) {
  return 1024 + 2 * ((size_t)2 * kQ * Np * 2 + kPanel) + kPanel +
         (size_t)64 * Np * 2 + 2 * kQ * 4;
}

// NT state tiles of 64 columns: N <= 64 NT
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_wgmma_kernel(const bf16* __restrict__ xb,    // [B, S, H, P]
                      const float* __restrict__ a,    // [B, S, H]
                      const bf16* __restrict__ Bm,    // [B, S, G, N]
                      const bf16* __restrict__ Cm,    // [B, S, G, N]
                      const float* __restrict__ s0,   // [B, H, P, N] or null
                      bf16* __restrict__ y,           // [B, S, H, P]
                      float* __restrict__ s_out,      // [B, H, P, N]
                      Strides xs, Strides as, Strides bs, Strides cs, int S,
                      int H, int G, int P, int N, int Q, int vec) {
  constexpr int Np = 64 * NT;
  constexpr uint32_t kCB = NT * kPanel;         // a C or B tile
  constexpr uint32_t kStage = 2 * kCB + kPanel;  // C, B, xb
  constexpr int kSteps = Np / 16;               // k steps over N
  const int h = blockIdx.x;  // head
  const int b = blockIdx.y;  // row
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int wgi = tid >> 7;  // warpgroup: tile rows 64 wgi .. 64 wgi + 63
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t xw_s = base + 2 * kStage;  // xb exp(cum_last - cum_j)
  const uint32_t st_s = xw_s + kPanel;      // the state in bf16, [64][Np]
  float* a_s =
      reinterpret_cast<float*>(gbase + (st_s - base) + 64 * Np * 2);
  float* cum = a_s + kQ;  // in log2 units

  const size_t head = (size_t)b * H + h;
  const bf16* xb_b = xb + b * xs.b + (size_t)h * P;
  const float* a_b = a + b * as.b + h;
  const bf16* B_b = Bm + b * bs.b + (size_t)g * N;
  const bf16* C_b = Cm + b * cs.b + (size_t)g * N;
  bf16* y_b = y + ((size_t)b * S * H + h) * P;
  const size_t ys = (size_t)H * P;
  const int n_chunks = (S + Q - 1) / Q;

  auto load_chunk = [&](int c) {
    const int t0 = c * Q;
    const int rows = min(Q, S - t0);
    const uint32_t st = base + (c & 1) * kStage;
    uint8_t* gst = gbase + (c & 1) * kStage;
    load_rows(st, gst, C_b + t0 * cs.s, cs.s, rows, N, Np, vec);
    load_rows(st + kCB, gst + kCB, B_b + t0 * bs.s, bs.s, rows, N, Np, vec);
    load_rows(st + 2 * kCB, gst + 2 * kCB, xb_b + t0 * xs.s, xs.s, rows, P,
              64, vec);
  };

  // this warpgroup's state tile (columns 64 wgi .. 64 wgi + 63, if
  // wgi < NT) in the accumulator fragment: rows p, columns n
  const bool has_tile = wgi < NT;
  float st[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int p = frag_row(i, warp, lane);
    const int n = 64 * wgi + frag_col(i, lane);
    st[i] = has_tile && s0 != nullptr && p < P && n < N
                ? s0[(head * P + p) * N + n]
                : 0.f;
  }

  // groups 0 (chunk 0) and 1 (chunk 1, or empty) in flight
  load_chunk(0);
  cp_async_commit();
  if (n_chunks > 1) load_chunk(1);
  cp_async_commit();
  float a_cur = tid < min(Q, S) ? a_b[tid * as.s] : 0.f;  // a of row tid

  const int r_lo = 64 * wgi + frag_row(0, warp, lane);  // this thread's
  const int r_hi = r_lo + 8;                            // two tile rows
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int rows = min(Q, S - t0);
    const uint32_t c_s = base + (c & 1) * kStage;
    const uint32_t b_s = c_s + kCB;
    const uint32_t x_s = b_s + kCB;
    const uint8_t* gx = gbase + (c & 1) * kStage + 2 * kCB;
    if (tid < kQ) a_s[tid] = a_cur;
    // the state before this chunk, in bf16, for the inter-chunk term
    if (has_tile) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int p = frag_row(i, warp, lane);
        const int n = 64 * wgi + frag_col(i, lane);
        *reinterpret_cast<uint32_t*>(gbase + (st_s - base) +
                                     swizzled<64>(p, n >> 3) + (n & 7) * 2) =
            pack_bf16(st[i], st[i + 1]);
      }
    }
    cp_async_wait_1();  // chunk c has landed (chunk c + 1 may be in flight)
    fence_proxy_async();
    __syncthreads();

    // inclusive cumsum of the log decay, in log2 units: warp 0
    if (tid < 32) {
      float carry = 0.f;
      for (int j0 = 0; j0 < kQ; j0 += 32) {
        float v = a_s[j0 + tid];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        cum[j0 + tid] = v * kLog2e;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    // a of the next chunk, loaded under this chunk's products
    if (tid < kQ) {
      const int t = t0 + Q + tid;
      a_cur = c + 1 < n_chunks && tid < Q && t < S ? a_b[t * as.s] : 0.f;
    }
    __syncthreads();
    const float cl = cum[kQ - 1];  // rows past the chunk have a = 0

    // xb exp(cum_last - cum_j), for the state update
    for (int i = tid; i < kQ * 8; i += kThreads) {
      const int r = i >> 3;
      const uint32_t off = swizzled<kQ>(r, i & 7);
      uint4 v = *reinterpret_cast<const uint4*>(gx + off);
      const float wj = exp2f(cl - cum[r]);
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hv[e]);
        hv[e] = __floats2bfloat162_rn(f.x * wj, f.y * wj);
      }
      *reinterpret_cast<uint4*>(gbase + (xw_s - base) + off) = v;
    }
    fence_proxy_async();

    if (64 * wgi < rows) {  // this warpgroup's rows hold steps of the chunk
      const uint32_t c_rows = c_s + wgi * 64 * 128;
      // (d) y = C State^T, then each row times exp(cum_i)
      float yacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
      pin(yacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_ss(yacc, desc(c_rows + (kk >> 2) * kPanel + (kk & 3) * 32, 16,
                            1024),
                 desc(st_s + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(yacc);
      const float e_lo = exp2f(cum[r_lo]);
      const float e_hi = exp2f(cum[r_hi]);
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] *= (i >> 1) & 1 ? e_hi : e_lo;

      // (a)-(c) per 64-column tile of scores at or left of the diagonal
      for (int ct = 0; ct <= wgi; ++ct) {
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        pin(s);
        pin(yacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint32_t off = (kk >> 2) * kPanel + (kk & 3) * 32;
          wgmma_ss(s, desc(c_rows + off, 16, 1024),
                   desc(b_s + ct * 64 * 128 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = (i >> 1) & 1 ? r_hi : r_lo;
          const int col = 64 * ct + frag_col(i, lane);
          s[i] = col <= row ? s[i] * exp2f(cum[row] - cum[col]) : 0.f;
        }
        // the fragment of columns 16 kk .. 16 kk + 15 is the A fragment of
        // step kk of L xb
        uint32_t la[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            la[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(yacc, la[kk],
                   desc(x_s + (64 * ct + 16 * kk) * 128, 1024, 1024));
        wgmma_commit();
        wgmma_wait_all();
        pin(yacc);
      }

      // y rows below the chunk's end, columns below P
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = (i >> 1) & 1 ? r_hi : r_lo;
        const int col = frag_col(i, lane);
        if (row >= rows) continue;
        bf16* dst = y_b + (size_t)(t0 + row) * ys + col;
        if (P % 2 == 0) {
          if (col < P)
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(yacc[i], yacc[i + 1]);
        } else {
          if (col < P) dst[0] = __float2bfloat16(yacc[i]);
          if (col + 1 < P) dst[1] = __float2bfloat16(yacc[i + 1]);
        }
      }
    }
    __syncthreads();  // every thread's scaled xb is written

    // (e) State = State exp(cum_last) + (xb exp(cum_last - cum_j))^T B
    if (has_tile) {
      const float decay = exp2f(cl);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] *= decay;
      pin(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wgmma_ss<1, 1>(st, desc(xw_s + kk * 16 * 128, 1024, 1024),
                       desc(b_s + wgi * kPanel + kk * 16 * 128, 1024, 1024),
                       1);
      wgmma_commit();
      wgmma_wait_all();
      pin(st);
    }
    __syncthreads();  // every warp is done reading this stage
    if (c + 2 < n_chunks) load_chunk(c + 2);
    cp_async_commit();
  }

  if (has_tile) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = frag_row(i, warp, lane);
      const int n = 64 * wgi + frag_col(i, lane);
      if (p < P && n < N) s_out[(head * P + p) * N + n] = st[i];
    }
  }
}

template <int NT>
cudaError_t launch(const void* xb, const void* a, const void* Bm,
                   const void* Cm, const void* s0, void* y, void* s_out,
                   const long long* strides, int B, int S, int H, int G,
                   int P, int N, int Q, int vec, int smem,
                   cudaStream_t stream) {
  auto kern = ssd_scan_wgmma_kernel<NT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const Strides xs{strides[0], strides[1]}, as{strides[2], strides[3]},
      bs{strides[4], strides[5]}, cs{strides[6], strides[7]};
  const dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(xb), static_cast<const float*>(a),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<const float*>(s0), static_cast<bf16*>(y),
      static_cast<float*>(s_out), xs, as, bs, cs, S, H, G, P, N, Q, vec);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int ssd_scan_fwd(const void* xb, const void* a, const void* Bm,
                            const void* Cm, const void* s0, void* y,
                            void* s_out, const long long* strides, int B,
                            int S, int H, int G, int P, int N, int chunk,
                            int dtype, int route, int vec, int smem,
                            void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // route 1, the tensor cores: bf16, chunk <= 128, P <= 64, N <= 128
  if (route == 1) {
    if (dtype != 1 || chunk > tc::kQ || P > 64 || N > 128)
      return cudaErrorInvalidValue;
    if (N <= 64)
      return tc::launch<1>(xb, a, Bm, Cm, s0, y, s_out, strides, B, S, H, G,
                           P, N, chunk, vec, smem, st);
    return tc::launch<2>(xb, a, Bm, Cm, s0, y, s_out, strides, B, S, H, G, P,
                         N, chunk, vec, smem, st);
  }
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
