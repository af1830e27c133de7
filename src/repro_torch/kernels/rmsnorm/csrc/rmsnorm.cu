// RMSNorm for Hopper, and the three fusions that take over its neighbours:
//
//   rmsnorm_fwd        out = norm(x) * w
//   add_rmsnorm_fwd    r = T(x + delta) written out; out = norm(r) * w
//   gated_rmsnorm_fwd  out = norm(T(y * T(silu(z)))) * w
//   qk_norm_rope_fwd   per head of q and k: T(norm(x) * w) (when weights
//                      are given), then the rotary rotation at its position
//
// and the gated norm of a row whose columns lie on several ranks (Mamba2
// under tensor parallelism: each rank holds its heads' columns of
// d_inner), in two launches with the sum over the ranks between them,
// done by the caller:
//
//   gated_rmsnorm_sumsq   ss = the row's fp32 sum of squares of
//                         T(y * T(silu(z))) over this rank's columns
//   gated_rmsnorm_scale   given S, ss summed over the ranks, and the whole
//                         width D: out = T(v * rsqrt(S / D + eps) * w)
//
// where norm(v) = v * rsqrt(mean(v^2) + eps) in fp32, T is x's dtype and
// T(.) one rounding to it; and the backward of each (rmsnorm_bwd,
// add_rmsnorm_bwd, gated_rmsnorm_bwd, qk_norm_rope_bwd, and the split
// gated norm's gated_rmsnorm_dot and gated_rmsnorm_scale_bwd; see "the
// backward" below), which carry the gradient of the training path.  The
// JAX package has no Pallas backward: it trains through the plain norm
// (models/layers.py::rms_norm) under jax.grad.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_fwd, body _rms_kernel) and computes what it computes, which is
// also the JAX package's models/layers.py::rms_norm: the mean of squares
// in fp32, rsqrt, (x * inv) * w in fp32, one rounding to x's dtype.  The
// fused entry points add the work on either side of a norm that the model
// would otherwise launch on its own: the residual add before a pre-norm,
// Mamba2's gate before its norm, and RoPE after the qk-norm
// (kernels/rmsnorm/ref.py::apply_rope).
//
// Bound: memory, and at the decode shapes the launch itself.  A call must
// read its inputs and w once and write its outputs once, and does a few
// flops per element (RoPE: a cos and a sin per pair).  A standalone norm
// at [8, 1024] moves 33 KB, 0.01 us at the memory rate, and no launch
// takes less than about 1.5 us; so the design takes over the neighbours'
// launches instead of shaving the norm's own time.
//
// Design.  Every entry point runs the same sum of squares in the same
// order, rmsnorm_fwd's tree: a row's d values in groups of kVec (16 bytes
// of T when d is a multiple of it, else 1), thread t of the row's threads
// summing groups t, t + kRowThreads, ... with explicit fmas from 0, then
// the warp's xor butterfly (16, 8, 4, 2, 1), then, in a block, the warps'
// sums in the same butterfly over lanes 0 .. warps - 1.  The grouping
// depends on d and T only; whether a group is one 16-byte load or kVec
// loads of one element (a row stride or pointer that breaks the vector)
// does not change the values or their order.  So a fused variant's norm
// is bit-identical to rmsnorm_fwd of the tensor the unfused path would
// have materialised (r, the gated product, or the qk-norm's input).  A
// row of d <= 512 (a head of q or k) is one warp's work (four rows per
// block of 128 threads), a longer row one block of 256 threads: a decode
// step's norms are 8 rows, and a warp would walk a 1,024-wide row in four
// dependent steps where a block takes one (1.8 against 3.1 us at [8,
// 1024] on an H100, chip_smoke.py phase 12).  The split follows d alone,
// so the fused variants and rmsnorm_fwd always agree on it.
//
// The forward's design.  rmsnorm_fwd and add_rmsnorm_fwd (norm_kernel)
// take their row's values from a policy (PlainRow, AddRow) that the
// reduction and the write-out both call: the second pass reads the row
// again (from L1/L2: a row is a few KB).  The other two hold their values
// in registers instead, in layouts that keep rmsnorm_fwd's tree; a
// thread or lane that rmsnorm_fwd would give no group adds an exact zero
// (a sum of squares is never -0), so leaving it out changes no bit:
// * gated_norm_kernel (gated_rmsnorm_fwd, gated_rmsnorm_sumsq,
//   gated_rmsnorm_scale; plan gated_plan): thread t holds the gated
//   values T(y * T(silu(z))) of its groups t, t + V, ... (V = 32 or 256,
//   rmsnorm_fwd's threads of the row), so the gate (expf and an IEEE
//   divide) is computed once per element; the row's threads stop at the
//   last warp that holds a group (192 at d 1,536 in bf16).  The grid is
//   persistent over rows (no more blocks than the card holds at once, at
//   most 64 registers a thread).  Where a block walks kGatedRingRows
//   rows or more, the next row's y and z come through a two-stage
//   cp.async ring and w is loaded once per block into shared memory as
//   fp32 (each thread its own groups: no barrier); elsewhere the ring's
//   shared memory would cost blocks and buy nothing (d 5,120 at 1,024
//   rows, d 1,536 at 2,048), and each write-out reads w through L1.  A
//   row of more than V * kGatedGroups groups is walked in chunks, the
//   gate computed again for the write-out.
// * qk_norm_rope_kernel (plan rope_fwd_plan): a head of n <= 32 groups
//   takes P = 2^ceil(log2 n) lanes, lane t its group t, one 16-byte load:
//   the head's sum is the fma chain of group t, then the butterfly over
//   its P lanes, which is rmsnorm_fwd's warp tree with the exact zeros of
//   lanes n .. 31 left out.  RoPE pairs element i with i + D / 2, group
//   t with group t +- n / 2 (no group straddles the halves where D / 2 is
//   a multiple of kVec), whose lane hands its normed values over by
//   shuffle.  A warp takes a token's (cos, sin) once into shared memory,
//   holds wq and wk at its lanes' groups, and walks the token's heads,
//   32 / P at a time, one a lane (two a lane, or the next chunk's loads
//   issued ahead, were slower on an H100); where tokens are few a
//   token's heads are spread over `split` warps so that about
//   kRopeFwdFill warps run.  A launch of at most kRopeFwdFill (token,
//   head) rows (a decode step's), a head of more than 32 groups, or one
//   whose groups straddle the halves keeps a warp per (token, head)
//   (qk_norm_rope_kernel_per_head), rmsnorm_fwd's own layout: at decode
//   the token layout's longer chain of work a warp (cos and sin, then
//   its heads) took 3.7 us on an H100 where a warp a row takes 2.5.

// Bit-exact against the eager PyTorch sequence each fusion replaces:
// every operation torch runs in its own launch is done here with the
// rounding intrinsics (__fadd_rn, __fmul_rn, __fsub_rn, __fdiv_rn), so
// nvcc contracts nothing into an fma that eager torch does not have;
// silu is z / (1 + expf(-z)) with full-precision expf, as torch's is; the
// RoPE angle is float(pos) * inv_freq[i] with the inverse frequencies
// computed on the card by the same torch ops as apply_rope's, and cos and
// sin are full precision; each value torch would round to T between two
// launches is rounded here at the same point (round_to).
//
// C interface (bound with ctypes): every entry point returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16, for x (and
// every other activation, and the outputs) and w separately; vec = 1
// takes 16-byte loads, which the launcher allows only where d, every row
// stride and every pointer are aligned for them (kernel.py
// ``vectorized``).  Rows are read through their row stride; every output
// is contiguous.
#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarpRowMaxD = 512;  // kernel.py WARP_ROW_MAX_D mirrors it
constexpr int kWarpModeThreads = 128;
constexpr int kBlockModeThreads = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// f as torch holds it after a launch writes it in T
template <typename T>
__device__ __forceinline__ float round_to(float f) {
  T t;
  attn::store(&t, f);
  return attn::to_f32(t);
}

// kVec values of T at p as floats: one 16-byte load when kVecLoad (p
// aligned to the whole vector), else kVec loads of one element
template <int kVec, bool kVecLoad, typename T>
__device__ __forceinline__ void load_group(const T* p, float (&v)[kVec]) {
  if constexpr (kVecLoad) {
    const Vec<T, kVec> a = *reinterpret_cast<const Vec<T, kVec>*>(p);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = attn::to_f32(a.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = attn::to_f32(p[k]);
  }
}

template <int kVec, bool kVecLoad, typename T>
__device__ __forceinline__ void store_group(T* p, const float (&v)[kVec]) {
  if constexpr (kVecLoad) {
    Vec<T, kVec> o;
#pragma unroll
    for (int k = 0; k < kVec; ++k) attn::store(&o.v[k], v[k]);
    *reinterpret_cast<Vec<T, kVec>*>(p) = o;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) attn::store(p + k, v[k]);
  }
}

// kVec values of T at p as they lie in memory: one 16-byte load when
// kVecLoad, else kVec loads of one element
template <int kVec, bool kVecLoad, typename T>
__device__ __forceinline__ void load_raw(const T* p, Vec<T, kVec>& v) {
  if constexpr (kVecLoad) {
    v = *reinterpret_cast<const Vec<T, kVec>*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v.v[k] = p[k];
  }
}

// kVec values of w at element e as floats; w is float or, with w_bf16,
// bfloat16 (a runtime choice: one instantiation serves both)
template <int kVec, bool kVecLoad>
__device__ __forceinline__ void load_w(const void* w, bool w_bf16, int e,
                                       float (&v)[kVec]) {
  if (w_bf16) {
    Vec<__nv_bfloat16, kVec> r;
    load_raw<kVec, kVecLoad>(static_cast<const __nv_bfloat16*>(w) + e, r);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = attn::to_f32(r.v[k]);
  } else {
    Vec<float, kVec> r;
    load_raw<kVec, kVecLoad>(static_cast<const float*>(w) + e, r);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = r.v[k];
  }
}

// Mamba2's gate at one element: (T(silu(z)), 1 + exp(-z)), torch's F.silu
// (z / (1 + exp(-z)) in fp32, rounded to T)
template <typename T>
__device__ __forceinline__ float2 gate(float z) {
  const float e = __fadd_rn(1.f, expf(-z));
  return make_float2(round_to<T>(__fdiv_rn(z, e)), e);
}

// T(y * T(silu(z))): the gated norm's input, torch's mul of y and F.silu
template <typename T>
__device__ __forceinline__ float gated_value(float y, float z) {
  return round_to<T>(__fmul_rn(y, gate<T>(z).x));
}

// the least l with 2^l >= n
inline int log2_ceil(long long n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

inline int clamp_blocks(long long need, int cap) {
  return (int)(need < 1 ? 1 : need < cap ? need : cap);
}

// --- the row's values: first() in the reduction pass, again() in the
// write-out pass; both give the same values --------------------------------

template <typename T, int kVec, bool kVecLoad>
struct PlainRow {
  const T* x;
  __device__ __forceinline__ void again(int g, float (&v)[kVec]) const {
    load_group<kVec, kVecLoad>(x + g * kVec, v);
  }
  __device__ __forceinline__ void first(int g, float (&v)[kVec]) const {
    again(g, v);
  }
};

// r = T(x + delta): torch's add, one launch, then the norm of r
template <typename T, int kVec, bool kVecLoad>
struct AddRow {
  const T* x;
  const T* delta;
  T* r;
  __device__ __forceinline__ void again(int g, float (&v)[kVec]) const {
    float a[kVec], b[kVec];
    load_group<kVec, kVecLoad>(x + g * kVec, a);
    load_group<kVec, kVecLoad>(delta + g * kVec, b);
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = round_to<T>(__fadd_rn(a[k], b[k]));
  }
  __device__ __forceinline__ void first(int g, float (&v)[kVec]) const {
    again(g, v);
    store_group<kVec, kVecLoad>(r + g * kVec, v);
  }
};

// The one reduction: the sum of v^2 over the row, kRowThreads threads
// per row (32: a warp; else the whole block).  Thread t sums groups t,
// t + kRowThreads, ... in that order.
template <int kVec, int kRowThreads, class Row>
__device__ __forceinline__ float row_sumsq(const Row& row, int d) {
  constexpr int kWarps = kRowThreads / 32;
  const int t = threadIdx.x % kRowThreads;
  float ss = 0.f;
  for (int g = t; g < d / kVec; g += kRowThreads) {
    float v[kVec];
    row.first(g, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) ss = __fmaf_rn(v[k], v[k], ss);
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
  return ss;
}

// rsqrt(mean(v^2) + eps) of the row
template <int kVec, int kRowThreads, class Row>
__device__ __forceinline__ float inv_rms(const Row& row, int d, float eps) {
  return rsqrtf(row_sumsq<kVec, kRowThreads>(row, d) / (float)d + eps);
}

// --- rmsnorm_fwd and add_rmsnorm_fwd --------------------------------------

// kGatedSumSq writes the row's sum of squares of the gated values (the
// reduction every entry point runs, stopped before its rsqrt); kGatedScale
// writes the gated norm at a given sum over the whole row (S, D)
enum class Op { kNorm, kAdd, kGated, kGatedSumSq, kGatedScale };

struct RowArgs {
  const void* a;  // x (kNorm, kAdd) or y (the gated ops)
  long long a_stride;
  const void* b;  // delta (kAdd) or z (the gated ops); unused by kNorm
  long long b_stride;
  const void* w;
  void* out;
  void* r;  // kAdd: the residual x + delta
  int rows, d;
  float eps;
  float* ss_out = nullptr;      // kGatedSumSq: [rows]
  const float* ss = nullptr;    // kGatedScale: [rows], the whole rows' sums
  int d_total = 0;              // kGatedScale: the whole rows' width
  int w_bf16 = 0;               // the gated row kernel: w is bfloat16
};

template <Op kOp, typename T, typename W, int kVec, bool kVecLoad,
          int kThreads, int kRowThreads>
__global__ void __launch_bounds__(kThreads) norm_kernel(const RowArgs args) {
  constexpr int kRowsPerBlock = kThreads / kRowThreads;
  const int t = threadIdx.x % kRowThreads;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kRowThreads;
  // with one row per warp, a warp past the last row leaves as a whole
  // (only warp shuffles follow); with one row per block, every row exists
  if (row >= args.rows) return;
  const int d = args.d;
  const T* a = static_cast<const T*>(args.a) + row * args.a_stride;
  const W* w = static_cast<const W*>(args.w);
  T* outr = static_cast<T*>(args.out) + row * (long long)d;

  auto run = [&](const auto& values) {
    const float inv = inv_rms<kVec, kRowThreads>(values, d, args.eps);
    for (int g = t; g < d / kVec; g += kRowThreads) {
      float v[kVec], wv[kVec];
      values.again(g, v);
      load_group<kVec, kVecLoad>(w + g * kVec, wv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)  // (x * inv) * w, as the reference
        v[k] = __fmul_rn(__fmul_rn(v[k], inv), wv[k]);
      store_group<kVec, kVecLoad>(outr + g * kVec, v);
    }
  };
  if constexpr (kOp == Op::kNorm) {
    run(PlainRow<T, kVec, kVecLoad>{a});
  } else {
    const T* b = static_cast<const T*>(args.b) + row * args.b_stride;
    T* r = static_cast<T*>(args.r) + row * (long long)d;
    run(AddRow<T, kVec, kVecLoad>{a, b, r});
  }
}

template <Op kOp, typename T, typename W, int kVec, bool kVecLoad>
cudaError_t launch_mode(const RowArgs& a, cudaStream_t stream) {
  if (a.d <= kWarpRowMaxD) {
    constexpr int kRows = kWarpModeThreads / 32;
    norm_kernel<kOp, T, W, kVec, kVecLoad, kWarpModeThreads, 32>
        <<<(a.rows + kRows - 1) / kRows, kWarpModeThreads, 0, stream>>>(a);
  } else {
    constexpr int kThreads = kBlockModeThreads;
    norm_kernel<kOp, T, W, kVec, kVecLoad, kThreads, kThreads>
        <<<a.rows, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// the grouping follows d alone; vec only picks the loads
template <Op kOp, typename T, typename W>
cudaError_t launch_grouped(const RowArgs& a, int vec, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (a.d % kV != 0) return launch_mode<kOp, T, W, 1, false>(a, stream);
  if (vec) return launch_mode<kOp, T, W, kV, true>(a, stream);
  return launch_mode<kOp, T, W, kV, false>(a, stream);
}

template <Op kOp>
int launch_rows(const RowArgs& a, int x_dtype, int w_dtype, int vec,
                void* stream) {
  if (a.rows == 0) return cudaSuccess;
  if (a.d < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_grouped<kOp, float, float>(a, vec, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_grouped<kOp, float, __nv_bfloat16>(a, vec, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_grouped<kOp, __nv_bfloat16, float>(a, vec, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_grouped<kOp, __nv_bfloat16, __nv_bfloat16>(a, vec, st);
  return cudaErrorInvalidValue;
}

// --- gated_rmsnorm_fwd, and the split gated norm's gated_rmsnorm_sumsq and
// gated_rmsnorm_scale: the gated row kernel (plan gated_plan, kernel.py
// ``gated_plan``; see "the forward's design" above) ----------------------

constexpr int kGatedGroups = 4;         // kernel.py GATED_GROUPS
constexpr int kGatedMaxBlocks = 1056;  // kernel.py GATED_MAX_BLOCKS
constexpr int kGatedBlocksPerSm = 4;   // the register cap: 64 a thread
constexpr int kGatedRingRows = 3;      // kernel.py GATED_RING_ROWS

struct GatedPlan {
  int vec;          // values of a group (rmsnorm_fwd's grouping)
  int log_v;        // rmsnorm_fwd's threads of a row: V = 1 << log_v
  int row_threads;  // the threads that hold a row's groups, at most V
  int slots;        // rows a block holds at once
  int threads;      // of a block
  int groups;       // of a thread: groups t, t + V, ...
  bool stream;      // groups > kGatedGroups: chunks, the gate computed twice
  int blocks;
};

// kernel.py gated_plan mirrors it
inline GatedPlan gated_plan(int rows, int d, int itemsize) {
  GatedPlan p;
  const int kv = 16 / itemsize;
  p.vec = d % kv == 0 ? kv : 1;
  const int n = d / p.vec;
  p.log_v = d <= kWarpRowMaxD ? 5 : log2_ceil(kBlockModeThreads);
  const int v = 1 << p.log_v;
  p.groups = (n + v - 1) / v;
  p.stream = p.groups > kGatedGroups;
  // in block mode a warp of rmsnorm_fwd's that would hold no group adds an
  // exact zero to the row's sum: it is left out
  p.row_threads = n < v ? (n + 31) / 32 * 32 : v;
  p.slots = v == 32 ? kWarpModeThreads / 32 : 1;
  p.threads = p.slots * p.row_threads;
  p.blocks = clamp_blocks(((long long)rows + p.slots - 1) / p.slots,
                          kGatedMaxBlocks);
  return p;
}

// A row's values T(y * T(silu(z))) at thread t's groups t, t + V, ...
// (rmsnorm_fwd's order), computed once and held in registers from the sum
// to the write-out; rows walked by a persistent grid (block b's slot s:
// rows (b + k * blocks) * slots + s); kRing (16-byte loads, a walk of
// kGatedRingRows rows or more): the next row's y and z copied ahead
// through a two-stage cp.async ring.
// kStream: more than kGatedGroups groups a thread, walked in chunks of
// V * kGatedGroups groups and the gate computed again for the write-out.
// w lies in shared memory where the ring runs (a block walks its rows);
// elsewhere each write-out reads it through L1, as a copy ahead of a
// walk of one or two rows cost more than it saved (gated_rmsnorm_scale
// at one of two ranks' mamba2 prefill, 10.2 against 9.6 us on an H100).
template <Op kOp, bool kRing>
constexpr bool kSharedW = kRing && kOp != Op::kGatedSumSq;

template <Op kOp, typename T, int kVec, bool kVecLoad, int kJ, bool kStream,
          bool kRing>
__global__ void __launch_bounds__(kBlockModeThreads, kGatedBlocksPerSm)
gated_norm_kernel(const RowArgs args, const int log_v, const int row_threads,
                  const int groups) {
  constexpr int G = kJ;  // register slots: the groups, or kGatedGroups
  // the ring, [2][2][groups][threads] x 16 bytes: y and z of the next row
  // in flight while this one computes (each thread copies and reads only
  // its own groups, so no barrier guards it); then w [d] as fp32
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float red[2][kBlockModeThreads / 32];
  const int V = 1 << log_v;
  const int slot = threadIdx.x / row_threads;
  const int t = threadIdx.x - slot * row_threads;
  const int slots = blockDim.x / row_threads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = args.d, n = d / kVec;
  const int J = kStream ? G : groups;
  const int chunks = kStream ? (n + G * V - 1) / (G * V) : 1;
  const bool w_bf16 = args.w_bf16 != 0;

  float* ws = reinterpret_cast<float*>(
      ring + (kRing ? 2 * 2 * J * 16 * (int)blockDim.x : 0));
  auto ring_at = [&](int stage, int arr, int j) {
    return ring + ((((stage * 2 + arr) * J + j) * (int)blockDim.x +
                    (int)threadIdx.x) << 4);
  };
  // start the copies of row r's groups into stage (none past the rows)
  auto prefetch = [&](long long r, int stage) {
    if (r < args.rows) {
      const T* y = static_cast<const T*>(args.a) + r * args.a_stride;
      const T* z = static_cast<const T*>(args.b) + r * args.b_stride;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = t + j * V;
        if (j >= J || g >= n) continue;
        wg::cp_async16(wg::smem_addr(ring_at(stage, 0, j)), y + g * kVec,
                       true);
        wg::cp_async16(wg::smem_addr(ring_at(stage, 1, j)), z + g * kVec,
                       true);
      }
    }
    wg::cp_async_commit();
  };
  const long long step = (long long)gridDim.x * slots;
  if constexpr (kRing) prefetch((long long)blockIdx.x * slots + slot, 0);
  // w at this thread's groups into shared memory, once: each thread reads
  // back only what it wrote (without the ring, each write-out reads w)
  if constexpr (kSharedW<kOp, kRing>) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = t + j * V;
      if (j >= J || g >= n) continue;
      float wv[kVec];
      load_w<kVec, kVecLoad>(args.w, w_bf16, g * kVec, wv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) ws[g * kVec + k] = wv[k];
    }
  }

  int it = 0;
  for (long long base = (long long)blockIdx.x * slots; base < args.rows;
       base += step, ++it) {
    const long long row = base + slot;
    const bool live = row < args.rows;
    if constexpr (kRing) {
      prefetch(row + step, (it + 1) & 1);
      wg::cp_async_wait_1();  // this row's copies have landed
    }
    const T* y = static_cast<const T*>(args.a) + row * args.a_stride;
    const T* z = static_cast<const T*>(args.b) + row * args.b_stride;
    // the gated values of chunk c, and the fp32 fmas of their squares
    Vec<T, kVec> v[G];
    auto gated = [&](int c, float& ss) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = c * G * V + t + j * V;
        if (!live || j >= J || g >= n) continue;
        Vec<T, kVec> yr, zr;
        if constexpr (kRing) {
          yr = *reinterpret_cast<const Vec<T, kVec>*>(ring_at(it & 1, 0, j));
          zr = *reinterpret_cast<const Vec<T, kVec>*>(ring_at(it & 1, 1, j));
        } else {
          load_raw<kVec, kVecLoad>(y + g * kVec, yr);
          load_raw<kVec, kVecLoad>(z + g * kVec, zr);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float gv =
              gated_value<T>(attn::to_f32(yr.v[k]), attn::to_f32(zr.v[k]));
          attn::store(&v[j].v[k], gv);  // exact: gv is in T
          ss = __fmaf_rn(gv, gv, ss);
        }
      }
    };

    // kGatedScale: the whole row's sum, read before the row's values
    const float s_row = kOp == Op::kGatedScale && live ? args.ss[row] : 0.f;
    float ss = 0.f, inv = 0.f;
    if constexpr (!(kOp == Op::kGatedScale && kStream))
      for (int c = 0; c < chunks; ++c) gated(c, ss);
    if constexpr (kOp == Op::kGatedScale) {
      inv = rsqrtf(s_row / (float)args.d_total + args.eps);
    } else {
      // row_sumsq's tree: the warp's butterfly, then the row's warps in
      // order (the block's, each warp adding them alike; a double buffer,
      // one barrier a row)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (row_threads > 32) {
        float* part = red[it & 1];
        if (lane == 0) part[warp] = ss;
        __syncthreads();
        float s = lane < (row_threads >> 5) ? part[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        ss = s;
      }
      if constexpr (kOp == Op::kGatedSumSq) {
        if (live && t == 0) args.ss_out[row] = ss;
        continue;
      }
      inv = rsqrtf(ss / (float)d + args.eps);
    }

    T* outr = static_cast<T*>(args.out) + row * (long long)d;
    for (int c = 0; c < chunks; ++c) {
      float unused = 0.f;
      if constexpr (kStream) gated(c, unused);  // the chunk again
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = c * G * V + t + j * V;
        if (!live || j >= J || g >= n) continue;
        float wv[kVec], o[kVec];
        if constexpr (kSharedW<kOp, kRing>) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) wv[k] = ws[g * kVec + k];
        } else {
          load_w<kVec, kVecLoad>(args.w, w_bf16, g * kVec, wv);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k)  // (x * inv) * w, as the reference
          o[k] = __fmul_rn(__fmul_rn(attn::to_f32(v[j].v[k]), inv), wv[k]);
        store_group<kVec, kVecLoad>(outr + g * kVec, o);
      }
    }
  }
}

// the card's resident blocks of `kernel` at `threads` and `smem` bytes,
// after the opt-in above 48 KB of shared memory
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, int* out) {
  constexpr size_t kStatic = sizeof(float) * 2 * (kBlockModeThreads / 32);
  cudaError_t err;
  if (smem + kStatic > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <Op kOp, typename T, int kVec, bool kVecLoad, int kJ, bool kStream,
          bool kRing>
cudaError_t launch_gated_kernel(const RowArgs& a, const GatedPlan& p,
                                cudaStream_t stream) {
  auto kernel = gated_norm_kernel<kOp, T, kVec, kVecLoad, kJ, kStream, kRing>;
  // the ring (2 stages of y and z, 16 bytes a group) and w as fp32
  const size_t smem =
      (kRing ? (size_t)2 * 2 * p.groups * 16 * p.threads : 0) +
      (kSharedW<kOp, kRing> ? sizeof(float) * a.d : 0);
  // persistent: no more blocks than the card holds at once (a block past
  // them would start its rows only when a first one ends)
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, p.threads, smem, &resident);
  if (err != cudaSuccess) return err;
  kernel<<<clamp_blocks(p.blocks, resident), p.threads, smem, stream>>>(
      a, p.log_v, p.row_threads, p.groups);
  return cudaGetLastError();
}

// the ring where a block walks at least kGatedRingRows rows (it costs
// shared memory, so blocks, and pays only over a walk)
template <Op kOp, typename T, int kVec, int kJ>
cudaError_t launch_gated_vec(const RowArgs& a, const GatedPlan& p,
                             cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = resident_blocks(
      gated_norm_kernel<kOp, T, kVec, true, kJ, false, false>, p.threads,
      0, &resident);
  if (err != cudaSuccess) return err;
  const long long walk = ((long long)a.rows + p.slots - 1) / p.slots;
  if (walk >= (long long)kGatedRingRows * clamp_blocks(p.blocks, resident))
    return launch_gated_kernel<kOp, T, kVec, true, kJ, false, true>(a, p,
                                                                    stream);
  return launch_gated_kernel<kOp, T, kVec, true, kJ, false, false>(a, p,
                                                                   stream);
}

// with 16-byte loads a thread's register slots are the plan's groups
// exactly (fewer registers, more rows in flight); else kGatedGroups
template <Op kOp, typename T, int kVec, bool kVecLoad>
cudaError_t launch_gated_plan(const RowArgs& a, const GatedPlan& p,
                              cudaStream_t stream) {
  constexpr int G = kGatedGroups;
  if (p.stream)
    return launch_gated_kernel<kOp, T, kVec, kVecLoad, G, true, false>(
        a, p, stream);
  if constexpr (kVecLoad) {
    static_assert(kGatedGroups == 4, "one instantiation a group count");
    switch (p.groups) {
      case 1: return launch_gated_vec<kOp, T, kVec, 1>(a, p, stream);
      case 2: return launch_gated_vec<kOp, T, kVec, 2>(a, p, stream);
      case 3: return launch_gated_vec<kOp, T, kVec, 3>(a, p, stream);
      default: return launch_gated_vec<kOp, T, kVec, 4>(a, p, stream);
    }
  }
  return launch_gated_kernel<kOp, T, kVec, kVecLoad, G, false, false>(
      a, p, stream);
}

// the grouping follows d alone; vec only picks the loads
template <Op kOp, typename T>
cudaError_t launch_gated_rows(const RowArgs& a, int vec, cudaStream_t stream) {
  const GatedPlan p = gated_plan(a.rows, a.d, sizeof(T));
  constexpr int kV = 16 / sizeof(T);
  if (p.vec == 1) return launch_gated_plan<kOp, T, 1, false>(a, p, stream);
  if (vec) return launch_gated_plan<kOp, T, kV, true>(a, p, stream);
  return launch_gated_plan<kOp, T, kV, false>(a, p, stream);
}

template <Op kOp>
int launch_gated(RowArgs a, int x_dtype, int w_dtype, int vec, void* stream) {
  if (a.rows == 0) return cudaSuccess;
  if (a.d < 1 || (w_dtype != 0 && w_dtype != 1)) return cudaErrorInvalidValue;
  a.w_bf16 = w_dtype == 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_gated_rows<kOp, float>(a, vec, st);
  if (x_dtype == 1) return launch_gated_rows<kOp, __nv_bfloat16>(a, vec, st);
  return cudaErrorInvalidValue;
}

// --- qk_norm_rope_fwd (plan rope_fwd_plan, kernel.py ``rope_fwd_plan``) ---

struct RopeArgs {
  const void* q;  // [B, S, Hq, D], element strides (sb, ss, sh), d contiguous
  long long q_sb, q_ss, q_sh;
  const void* k;  // [B, S, Hkv, D]
  long long k_sb, k_ss, k_sh;
  const void* wq;  // [D] each, or both null: RoPE only
  const void* wk;
  const void* pos;  // int32 or int64, read at b * p_sb + s * p_ss
  long long p_sb, p_ss;
  int pos64;
  const float* inv_freq;  // [D / 2]
  void* q_out;            // contiguous [B, S, Hq, D] and [B, S, Hkv, D]
  void* k_out;
  int B, S, Hq, Hkv, D;
  float eps;
  int w_bf16 = 0;  // the token layout: wq and wk are bfloat16, else float
};

constexpr int kRopeFwdWarps = 4;    // kernel.py ROPE_FWD_WARPS
constexpr int kRopeFwdFill = 4224;  // kernel.py ROPE_FWD_FILL

struct RopeFwdPlan {
  bool token;  // the token layout; else a warp per (token, head)
  int vec;     // values of a group: rmsnorm_fwd's grouping at D
  int log_p;   // lanes of a head: P = 1 << log_p
  int split;   // warps a token's heads are spread over
  long long blocks;
};

// kernel.py rope_fwd_plan mirrors it
inline RopeFwdPlan rope_fwd_plan(long long tokens, int heads, int D,
                                 int itemsize) {
  RopeFwdPlan p;
  const int kv = 16 / itemsize;
  p.vec = D % kv == 0 ? kv : 1;
  const int n = D / p.vec;  // groups of a head
  // a group a lane, and no group across the two halves; a launch of
  // fewer (token, head) rows than kRopeFwdFill keeps a warp a row
  p.token = n <= 32 && (D / 2) % p.vec == 0 && tokens * heads > kRopeFwdFill;
  if (!p.token) {
    p.log_p = 5;
    p.split = 1;
    p.blocks = (tokens * heads + kRopeFwdWarps - 1) / kRopeFwdWarps;
    return p;
  }
  p.log_p = log2_ceil(n);
  const int per = 32 >> p.log_p;  // heads a warp takes at once
  const int chunks = (heads + per - 1) / per;
  const long long want = (kRopeFwdFill + tokens - 1) / tokens;
  const int iters = want >= chunks ? 1 : (int)((chunks + want - 1) / want);
  p.split = (chunks + iters - 1) / iters;
  p.blocks = (tokens * p.split + kRopeFwdWarps - 1) / kRopeFwdWarps;
  return p;
}

// v moved from lane src, 32 bits a shuffle
template <typename V>
__device__ __forceinline__ V shfl_vec(const V& v, int src) {
  constexpr int kWords = (int)((sizeof(V) + 3) / 4);
  unsigned int w[kWords] = {};
  memcpy(w, &v, sizeof(V));
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = __shfl_sync(0xffffffffu, w[i], src);
  V r;
  memcpy(&r, w, sizeof(V));
  return r;
}

// The token layout: a warp per (token, part); part p of the token's
// `split` warps takes its heads' chunks p, p + split, ... of 32 / P
// heads.  Lane t of a head's P lanes holds the
// head's group t (rmsnorm_fwd's group, in its order), lanes past the n
// groups nothing; the group's partner across the halves (t +- n / 2)
// comes by shuffle.  The token's (cos, sin) once into shared memory,
// w at the lane's group once, each head read once.
template <typename T, int kVec, bool kVecLoad>
__global__ void __launch_bounds__(kRopeFwdWarps * 32)
qk_norm_rope_kernel(const RopeArgs a, const int log_p, const int split) {
  __shared__ float2 cs_all[kRopeFwdWarps][16 * kVec];  // half <= 16 groups
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tokens = (long long)a.B * a.S;
  const long long item = (long long)blockIdx.x * kRopeFwdWarps + warp;
  if (item >= tokens * split) return;  // the whole warp
  const long long tok = item / split;
  const int part = (int)(item - tok * split);
  const int s = (int)(tok % a.S), b = (int)(tok / a.S);
  const int P = 1 << log_p, t = lane & (P - 1), sub = lane >> log_p;
  const int D = a.D, half = D / 2, n = D / kVec, nh = n / 2;
  const int Hq = a.Hq, H = a.Hq + a.Hkv, per = 32 >> log_p;
  const bool norm = a.wq != nullptr, held = t < n, first = t < nh;
  const int src = (lane & ~(P - 1)) | (first ? t + nh : t - nh);
  const int i0 = (first ? t : t - nh) * kVec;  // the group's pairs

  float wq[kVec] = {}, wk[kVec] = {};
  if (norm && held) {
    load_w<kVec, kVecLoad>(a.wq, a.w_bf16 != 0, t * kVec, wq);
    load_w<kVec, kVecLoad>(a.wk, a.w_bf16 != 0, t * kVec, wk);
  }
  const long long pi = b * a.p_sb + s * a.p_ss;
  const float p = a.pos64 ? (float)static_cast<const long long*>(a.pos)[pi]
                          : (float)static_cast<const int*>(a.pos)[pi];
  float2* cs = cs_all[warp];
  for (int i = lane; i < half; i += 32) {
    const float ang = __fmul_rn(p, a.inv_freq[i]);
    cs[i] = make_float2(cosf(ang), sinf(ang));
  }
  __syncwarp();
  float cv[kVec], sv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float2 c = held ? cs[i0 + k] : make_float2(0.f, 0.f);
    cv[k] = c.x;
    sv[k] = c.y;
  }

  // chunks part, part + split, ... of the token's heads, `per` a chunk:
  // head ch * per + sub on this lane's sub-warp
  const int chunks = (H + per - 1) / per;
  for (int ch = part; ch < chunks; ch += split) {
    const int h = ch * per + sub;
    const bool live = held && h < H, is_q = h < Hq;
    const int hh = is_q ? h : h - Hq;
    float v[kVec] = {};  // the head's group t (zeros where it holds none)
    if (live) {
      const T* x = static_cast<const T*>(is_q ? a.q : a.k) +
                   (is_q ? b * a.q_sb + s * a.q_ss + hh * a.q_sh
                         : b * a.k_sb + s * a.k_ss + hh * a.k_sh);
      Vec<T, kVec> xr;
      load_raw<kVec, kVecLoad>(x + t * kVec, xr);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = attn::to_f32(xr.v[k]);
    }
    if (norm) {  // rmsnorm_fwd's output, in T
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < kVec; ++k) ss = __fmaf_rn(v[k], v[k], ss);
      for (int o = P >> 1; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(ss / (float)D + a.eps);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        v[k] = round_to<T>(
            __fmul_rn(__fmul_rn(v[k], inv), is_q ? wq[k] : wk[k]));
    }
    Vec<T, kVec> mine;
#pragma unroll
    for (int k = 0; k < kVec; ++k) attn::store(&mine.v[k], v[k]);  // exact
    const Vec<T, kVec> other = shfl_vec(mine, src);
    float o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float y = attn::to_f32(other.v[k]);
      o[k] = first ? __fsub_rn(__fmul_rn(v[k], cv[k]), __fmul_rn(y, sv[k]))
                   : __fadd_rn(__fmul_rn(v[k], cv[k]), __fmul_rn(y, sv[k]));
    }
    if (live) {
      const long long rr = tok * (is_q ? Hq : a.Hkv) + hh;
      T* out = static_cast<T*>(is_q ? a.q_out : a.k_out) + rr * D;
      store_group<kVec, kVecLoad>(out + t * kVec, o);
    }
  }
}

// the other layout, for a head whose groups do not fit it: one warp per
// (token, head) row of q, then of k, as rmsnorm_fwd runs the row
template <typename T, typename W, int kVec>
__global__ void __launch_bounds__(kWarpModeThreads)
qk_norm_rope_kernel_per_head(const RopeArgs a) {
  constexpr int kRowsPerBlock = kWarpModeThreads / 32;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const long long q_rows = (long long)a.B * a.S * a.Hq;
  if (row >= q_rows + (long long)a.B * a.S * a.Hkv) return;  // whole warp
  const bool is_q = row < q_rows;
  const long long rr = is_q ? row : row - q_rows;
  const int H = is_q ? a.Hq : a.Hkv;
  const int h = (int)(rr % H);
  const long long bs = rr / H;
  const int s = (int)(bs % a.S), b = (int)(bs / a.S);
  const T* x = static_cast<const T*>(is_q ? a.q : a.k) +
               (is_q ? b * a.q_sb + s * a.q_ss + h * a.q_sh
                     : b * a.k_sb + s * a.k_ss + h * a.k_sh);
  const W* w = static_cast<const W*>(is_q ? a.wq : a.wk);
  T* out = static_cast<T*>(is_q ? a.q_out : a.k_out) + rr * a.D;

  float inv = 0.f;
  if (w != nullptr)  // the same for the whole warp
    inv = inv_rms<kVec, 32>(PlainRow<T, kVec, false>{x}, a.D, a.eps);
  const long long pi = b * a.p_sb + s * a.p_ss;
  const float p = a.pos64 ? (float)static_cast<const long long*>(a.pos)[pi]
                          : (float)static_cast<const int*>(a.pos)[pi];
  const int half = a.D / 2;
  for (int i = lane; i < half; i += 32) {
    float x1 = attn::to_f32(x[i]), x2 = attn::to_f32(x[i + half]);
    if (w != nullptr) {  // rmsnorm_fwd's output, in T
      x1 = round_to<T>(__fmul_rn(__fmul_rn(x1, inv), attn::to_f32(w[i])));
      x2 = round_to<T>(
          __fmul_rn(__fmul_rn(x2, inv), attn::to_f32(w[i + half])));
    }
    const float ang = __fmul_rn(p, a.inv_freq[i]);
    const float c = cosf(ang), sn = sinf(ang);
    attn::store(out + i, __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    attn::store(out + i + half,
                __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
  }
}

template <typename T, typename W>
cudaError_t launch_rope(RopeArgs a, int vec, cudaStream_t stream) {
  const RopeFwdPlan p =
      rope_fwd_plan((long long)a.B * a.S, a.Hq + a.Hkv, a.D, sizeof(T));
  const unsigned grid = (unsigned)p.blocks;
  constexpr int kThreads = kRopeFwdWarps * 32, kV = 16 / sizeof(T);
  if (!p.token) {
    if (p.vec == 1)
      qk_norm_rope_kernel_per_head<T, W, 1><<<grid, kThreads, 0, stream>>>(a);
    else
      qk_norm_rope_kernel_per_head<T, W, kV><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  a.w_bf16 = sizeof(W) == 2;
  if (p.vec == 1)
    qk_norm_rope_kernel<T, 1, false>
        <<<grid, kThreads, 0, stream>>>(a, p.log_p, p.split);
  else if (vec)
    qk_norm_rope_kernel<T, kV, true>
        <<<grid, kThreads, 0, stream>>>(a, p.log_p, p.split);
  else
    qk_norm_rope_kernel<T, kV, false>
        <<<grid, kThreads, 0, stream>>>(a, p.log_p, p.split);
  return cudaGetLastError();
}

// --- the backward ----------------------------------------------------------
//
// One backward per entry point.  Each recomputes its row's rstd =
// rsqrt(mean(v^2) + eps) in fp32 from the forward's normed input v (x, r,
// or the gated product, rebuilt from y and z as the forward builds it) and,
// with g = dy * w and c = rstd^2 * sum(g * v) / d,
//
//   dv = rstd * (g - v * c)   (= rstd * (g - xhat * mean(g * xhat)))
//   dw = sum over rows of dy * v * rstd
//
// all in fp32, dv cast to x's dtype and dw to w's.  Where the unfused
// sequence holds a gradient in T between two ops (the norm's input in the
// add and in the gate, the normed q and k before RoPE), it is rounded to
// T at the same point (round_to), so a fused backward computes what
// autograd of the unfused ops computes, up to fp32 sums taken in another
// order.  Silu and RoPE stay full precision (expf, __fdiv_rn, cosf and
// sinf of __fmul_rn(p, inv_freq[i]), as the forward computes them).
//
// The split gated norm's backward takes the whole rows' sums from the
// caller: S (the forward's summed sum of squares) and P = sum(g * v) over
// every rank's columns (gated_rmsnorm_dot writes this rank's partial,
// the caller sums it over the ranks); gated_rmsnorm_scale_bwd then runs
// the gated row kernel with rstd = rsqrt(S / D + eps) and c = rstd^2 * P
// / D, dw of this rank's columns of w.
//
// Bound: memory.  A call must read dy, the forward's inputs and w once,
// and write the input gradients and dw once: rmsnorm_bwd at qwen3-0.6b's
// train launch ([8192, 1024] bf16) moves 50 MB, 15 us at 3.35 TB/s, and
// does ~10 fp32 operations an element (RoPE's backward ~18, the gate's
// ~22), far below the card's rate.  So the design keeps bytes in flight:
// every value is loaded once, 16 bytes a load where the layout allows.
//
// The row kernel (norm_bwd_kernel; its plan, row_plan, is a function of
// rows, d and T alone, mirrored by kernel.py ``row_plan``):
// * A row's values are grouped as the forward groups them (kVec: 16 bytes
//   of T where d is a multiple of it, else 1; ``vec`` only picks whether a
//   group is one 16-byte load), and thread t of the row's R threads owns
//   groups t, t + R, ..., at most kBwdGroups of them (16 values of a bf16
//   row): R is the least power of two that allows it, 64 threads at
//   qwen3's d 1,024 in bf16, 256 at mamba2's d_inner 3,072, 512 at
//   pixtral's 5,120.  The thread loads its columns of w once, and of each
//   row dy and the forward's input(s), and keeps them in registers from
//   the two sums to the write-out; the gate (T(silu(z)), silu'(z)) is
//   computed once per element.  Two groups a thread, not four: with four
//   (a warp a row at d 1,024) the kernels took 166-254 registers, two
//   blocks an SM, and the gated one stalled on its expf and divides (PR
//   25's measurements, PERF.md).
// * With 16-byte loads a row's inputs come through a two-stage ring in
//   shared memory: each thread starts the cp.async copies of its groups
//   of its slot's next row before it computes this one, so the loads of
//   one row overlap the arithmetic of the last (rmsnorm_bwd at qwen3's
//   train launch 29.5 -> 24.9 us, the gated one 51.7 -> 48.1 us; PR 25's
//   measurements, PERF.md).
// * The two sums: each thread's groups in order (fmaf), a butterfly of
//   shuffles over the row's lanes (every lane ends with the same bits),
//   and for R > 32 the row's warps in order through shared memory, one
//   barrier a row (a double buffer).
// * A block of max(R, 128) threads holds 128 / R row slots (R < 32: rows
//   share a warp).  The grid is at most kBwdPartials blocks (four of 128
//   threads per SM of the H100); block b's slot s takes rows (b + k *
//   blocks) * slots + s, k = 0, 1, ...
// * dw stays in registers: each thread sums dy * v * rstd of its own
//   columns over its rows; the block adds its slots in slot order into
//   one fp32 partial row, and sum_partials_kernel adds the blocks'
//   partial rows, 32 columns a block: warp k adds rows k, k + 32, ... in
//   order, then warp 0 the 32 warps' sums in order.  No atomics: the
//   order is fixed by the plan, and two calls on the same inputs give
//   the same bits.
// * A row wider than 512 threads' registers hold (d > 8,192 in bf16,
//   > 4,096 in f32, > 1,024 without the vector) is walked in chunks of
//   512 * kBwdGroups groups, read twice (the second pass from L2), and
//   its dw summed in the block's partial row in place, each column by the
//   one thread that owns it.
//
// qk_norm_rope_bwd_kernel (plan rope_plan, kernel.py ``rope_plan``): a
// warp takes one token at a time and computes its D / 2 (cos, sin) pairs
// once, into shared memory, for all of its Hq + Hkv heads.  A head is L
// lanes' work (L the least power of two that gives a lane at most
// kRopeBwdPairs pairs (i, i + D / 2), 8 lanes at D 128 in bf16), so a
// warp takes 32 / L heads at once; each lane holds its pairs' dout, x,
// wq and wk in registers and its dwq and dwk sums over every head and
// token it walks.  The dw rows are summed across the warp's head groups
// by a butterfly, across the block's warps in warp order, and across the
// blocks (at most kRopeBwdPartials: three of 128 threads per SM, as its
// ~168 registers allow) by sum_partials_kernel.

constexpr int kBwdGroups = 2;           // kernel.py BWD_GROUPS
constexpr int kBwdMaxRowThreads = 512;  // kernel.py BWD_MAX_ROW_THREADS
constexpr int kBwdBlockThreads = 128;   // kernel.py BWD_BLOCK_THREADS
constexpr int kBwdPartials = 528;       // kernel.py BWD_PARTIALS
constexpr int kRopeBwdPairs = 8;        // kernel.py ROPE_BWD_PAIRS
constexpr int kRopeBwdWarps = 4;        // kernel.py ROPE_BWD_WARPS
constexpr int kRopeBwdPartials = 396;   // kernel.py ROPE_BWD_PARTIALS
constexpr int kSumWarps = 32;           // sum_partials_kernel's row split

struct RowPlan {
  int vec;     // values of a group
  int log_r;   // threads of a row: R = 1 << log_r
  int threads, slots, blocks;
  bool stream;  // chunks: the row is wider than R * kBwdGroups groups
};

// kernel.py row_plan mirrors it
inline RowPlan row_plan(int rows, int d, int itemsize) {
  RowPlan p;
  const int kv = 16 / itemsize;
  p.vec = d % kv == 0 ? kv : 1;
  const int per = (d / p.vec + kBwdGroups - 1) / kBwdGroups;
  p.stream = per > kBwdMaxRowThreads;
  p.log_r = log2_ceil(p.stream ? kBwdMaxRowThreads : per);
  const int r = 1 << p.log_r;
  p.threads = r > kBwdBlockThreads ? r : kBwdBlockThreads;
  p.slots = p.threads / r;
  p.blocks = clamp_blocks(((long long)rows + p.slots - 1) / p.slots,
                          kBwdPartials);
  return p;
}

struct RopePlan {
  int vec;     // pairs of a group
  int log_l;   // lanes of a head: L = 1 << log_l
  int blocks;  // of kRopeBwdWarps warps, a token each at a time
};

// kernel.py rope_plan mirrors it
inline RopePlan rope_plan(long long tokens, int D, int itemsize) {
  RopePlan p;
  const int kv = 16 / itemsize, half = D / 2;
  p.vec = half % kv == 0 ? kv : 1;
  const int per_lane = kRopeBwdPairs / p.vec;  // groups a lane holds
  p.log_l = log2_ceil((half / p.vec + per_lane - 1) / per_lane);
  p.blocks = clamp_blocks((tokens + kRopeBwdWarps - 1) / kRopeBwdWarps,
                          kRopeBwdPartials);
  return p;
}

// the sums of a and of b over the row's kRowThreads threads (a warp, or
// the whole block; gated_dot_kernel's reduction)
template <int kRowThreads>
__device__ __forceinline__ float2 row_sum2(float a, float b) {
  constexpr int kWarps = kRowThreads / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (kWarps > 1) {
    __shared__ float2 part[kWarps];
    __shared__ float2 total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = make_float2(a, b);
    __syncthreads();
    if (warp == 0) {
      float2 s = lane < kWarps ? part[lane] : make_float2(0.f, 0.f);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
        s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      }
      if (lane == 0) total = s;
    }
    __syncthreads();
    return total;
  }
  return make_float2(a, b);
}

// the sums of a and of b over a row of R threads (a power of two): a
// butterfly of shuffles inside the warp, then, for R > 32, the row's
// warps in order through buf (this row's half of a double buffer; every
// thread of the block calls it, the same number of times)
__device__ __forceinline__ float2 row_sums(float a, float b, int R,
                                           float2* buf) {
  for (int o = (R < 32 ? R : 32) >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (R <= 32) return make_float2(a, b);
  const int warp = threadIdx.x >> 5, nw = R >> 5, first = warp & ~(nw - 1);
  if ((threadIdx.x & 31) == 0) buf[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = buf[first];
  for (int k = 1; k < nw; ++k) {
    s.x += buf[first + k].x;
    s.y += buf[first + k].y;
  }
  return s;
}

struct RowBwdArgs {
  const void* dy;  // the gradient of out, [rows, d]
  long long dy_stride;
  const void* a;  // x (kNorm), r (kAdd), y (kGated)
  long long a_stride;
  const void* b;  // dr (kAdd; null: none), z (kGated); unused by kNorm
  long long b_stride;
  const void* w;
  void* da;  // dx (kNorm); the gradient of x and of delta (kAdd); dy (kGated)
  void* db;  // dz (kGated)
  float* partial;  // [gridDim.x, d]
  int rows, d;
  float eps;
  const float* ss = nullptr;   // kGatedScale: [rows], S
  const float* dot = nullptr;  // kGatedScale: [rows], P
  int d_total = 0;             // kGatedScale: D
  int w_bf16 = 0;              // the row kernel: w is bfloat16, else float
};

// kThreads: 128 (R <= 128), or kBwdMaxRowThreads for a block of R = 256
// or 512 threads (one row slot); kStream: the chunked walk
template <Op kOp, typename T, int kVec, bool kVecLoad, int kThreads,
          bool kStream>
__global__ void __launch_bounds__(kThreads)
norm_bwd_kernel(const RowBwdArgs args, const int log_r) {
  constexpr int G = kBwdGroups;
  constexpr bool kGate = kOp == Op::kGated || kOp == Op::kGatedScale;
  // with 16-byte loads, a row's inputs come through a two-stage ring in
  // shared memory, [2][kArrays][G][threads] x 16 bytes: the next row's
  // copies (cp.async) are in flight while this row computes; each thread
  // copies and reads only its own groups, so no barrier guards the ring
  constexpr bool kPrefetch = kVecLoad && !kStream;
  constexpr int kArrays = kOp == Op::kNorm ? 2 : 3;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float2 red[2][kThreads / 32];
  const int R = 1 << log_r, slots = blockDim.x >> log_r;
  const int t = threadIdx.x & (R - 1), slot = threadIdx.x >> log_r;
  const int d = args.d, n = d / kVec;
  const int chunks = kStream ? (n + G * R - 1) / (G * R) : 1;
  const void* w = args.w;
  const bool w_bf16 = args.w_bf16 != 0;
  float* part = args.partial + (long long)blockIdx.x * d;

  // w at this thread's groups (loaded once, or per chunk when kStream),
  // and the dw sums of its columns (kStream: in part)
  float wr[G][kVec], dw[G][kVec];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) dw[j][k] = 0.f;
    const int g = t + j * R;
    if (!kStream && g < n) load_w<kVec, kVecLoad>(w, w_bf16, g * kVec, wr[j]);
  }
  if constexpr (kStream) {
    for (int i = threadIdx.x; i < d; i += blockDim.x) part[i] = 0.f;
    __syncthreads();
  }

  auto ring_at = [&](int stage, int arr, int j) {
    return ring + ((((stage * kArrays + arr) * G + j) * (int)blockDim.x +
                    (int)threadIdx.x) << 4);
  };
  // start the copies of row r's groups into stage (none past the rows)
  auto prefetch = [&](long long r, int stage) {
    if (r < args.rows) {
      const T* dy = static_cast<const T*>(args.dy) + r * args.dy_stride;
      const T* a = static_cast<const T*>(args.a) + r * args.a_stride;
      const T* b = args.b == nullptr
                       ? nullptr
                       : static_cast<const T*>(args.b) + r * args.b_stride;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = t + j * R;
        if (g >= n) continue;
        wg::cp_async16(wg::smem_addr(ring_at(stage, 0, j)), dy + g * kVec,
                       true);
        wg::cp_async16(wg::smem_addr(ring_at(stage, 1, j)), a + g * kVec,
                       true);
        if (kArrays == 3 && b != nullptr)
          wg::cp_async16(wg::smem_addr(ring_at(stage, 2, j)), b + g * kVec,
                         true);
      }
    }
    wg::cp_async_commit();
  };
  const long long step = (long long)gridDim.x * slots;
  if constexpr (kPrefetch) prefetch((long long)blockIdx.x * slots + slot, 0);

  int it = 0;
  for (long long base = (long long)blockIdx.x * slots; base < args.rows;
       base += step, ++it) {
    const long long row = base + slot;
    const bool live = row < args.rows;
    if constexpr (kPrefetch) {
      prefetch(row + step, (it + 1) & 1);
      wg::cp_async_wait_1();  // this row's copies have landed
    }
    const T* dy = static_cast<const T*>(args.dy) + row * args.dy_stride;
    const T* a = static_cast<const T*>(args.a) + row * args.a_stride;
    const T* b = args.b == nullptr
                     ? nullptr
                     : static_cast<const T*>(args.b) + row * args.b_stride;
    // the row's values at this thread's groups: dy, a, and b (kAdd: dr,
    // 0 without it; gated: T(silu(z)), with silu'(z) in q)
    Vec<T, kVec> dyr[G], ar[G], br[G];
    float q[kGate ? G : 1][kVec];
    auto load = [&](int c) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = c * G * R + t + j * R;
        if (!live || g >= n) continue;
        using V = Vec<T, kVec>;
        auto get = [&](int arr, const T* p, V& v) {
          if constexpr (kPrefetch)
            v = *reinterpret_cast<const V*>(ring_at(it & 1, arr, j));
          else
            load_raw<kVec, kVecLoad>(p + g * kVec, v);
        };
        get(0, dy, dyr[j]);
        get(1, a, ar[j]);
        if constexpr (kStream)
          load_w<kVec, kVecLoad>(w, w_bf16, g * kVec, wr[j]);
        if constexpr (kOp == Op::kAdd) {
          if (b != nullptr) {
            get(2, b, br[j]);
          } else {
#pragma unroll
            for (int k = 0; k < kVec; ++k) attn::store(&br[j].v[k], 0.f);
          }
        }
        if constexpr (kGate) {
          get(2, b, br[j]);
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float z = attn::to_f32(br[j].v[k]);
            const float2 se = gate<T>(z);  // (T(silu(z)), 1 + exp(-z))
            const float sig = 1.f / se.y;  // silu'(z) = s (1 + z (1 - s))
            q[j][k] = sig * (1.f + z * (1.f - sig));
            attn::store(&br[j].v[k], se.x);  // exact: se.x is in T
          }
        }
      }
    };
    // the forward's normed input at (j, k)
    auto value = [&](int j, int k) -> float {
      if constexpr (kGate)
        return round_to<T>(
            __fmul_rn(attn::to_f32(ar[j].v[k]), attn::to_f32(br[j].v[k])));
      else
        return attn::to_f32(ar[j].v[k]);
    };

    float rstd = 0.f, cc = 0.f;
    if constexpr (kOp == Op::kGatedScale) {
      load(0);
      if (live) {
        const float nd = (float)args.d_total;
        rstd = rsqrtf(args.ss[row] / nd + args.eps);
        cc = rstd * rstd * args.dot[row] / nd;
      }
    } else {
      float ss = 0.f, gv = 0.f;
      for (int c = 0; c < chunks; ++c) {
        load(c);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int g = c * G * R + t + j * R;
          if (!live || g >= n) continue;
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float v = value(j, k);
            const float gw = attn::to_f32(dyr[j].v[k]) * wr[j][k];
            ss = fmaf(v, v, ss);
            gv = fmaf(gw, v, gv);
          }
        }
      }
      const float2 sums = row_sums(ss, gv, R, red[it & 1]);
      rstd = rsqrtf(sums.x / (float)d + args.eps);
      cc = rstd * rstd * sums.y / (float)d;
    }

    T* da = static_cast<T*>(args.da) + row * (long long)d;
    T* dz = kGate ? static_cast<T*>(args.db) + row * (long long)d : nullptr;
    for (int c = 0; c < chunks; ++c) {
      if constexpr (kStream) load(c);  // the row read again
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = c * G * R + t + j * R;
        if (!live || g >= n) continue;
        float o[kVec], oz[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float v = value(j, k), gy = attn::to_f32(dyr[j].v[k]);
          const float dv = rstd * (gy * wr[j][k] - v * cc);
          const float dwk = gy * (v * rstd);
          if constexpr (kStream)
            part[g * kVec + k] += dwk;
          else
            dw[j][k] += dwk;
          if constexpr (kOp == Op::kNorm) {
            o[k] = dv;
          } else if constexpr (kOp == Op::kAdd) {
            // the norm's input gradient in T, then torch's add of dr
            o[k] = round_to<T>(dv) + attn::to_f32(br[j].v[k]);
          } else {
            const float dg = round_to<T>(dv);
            o[k] = dg * attn::to_f32(br[j].v[k]);
            const float ds = round_to<T>(dg * attn::to_f32(ar[j].v[k]));
            oz[k] = ds * q[j][k];
          }
        }
        store_group<kVec, kVecLoad>(da + g * kVec, o);
        if constexpr (kGate) store_group<kVec, kVecLoad>(dz + g * kVec, oz);
      }
    }
  }
  if constexpr (kStream) return;

  // the block's partial row of dw: its slots' sums in slot order
  if constexpr (kThreads == kBwdBlockThreads) {
    if (slots > 1) {  // slots * d <= kThreads * G * kVec
      __shared__ float acc[kThreads * G * kVec];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = t + j * R;
        if (g >= n) continue;
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[slot * d + g * kVec + k] = dw[j][k];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < d; i += kThreads) {
        float s = acc[i];
        for (int k = 1; k < slots; ++k) s += acc[k * d + i];
        part[i] = s;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + j * R;
    if (g >= n) continue;
#pragma unroll
    for (int k = 0; k < kVec; ++k) part[g * kVec + k] = dw[j][k];
  }
}

// gated_rmsnorm_dot: dot[row] = sum over the row's d columns of
// (dy * w) * v, v = T(y * T(silu(z))) as the forward builds it; a warp
// per row up to d 512, a block above
template <typename T, typename W, int kThreads, int kRowThreads>
__global__ void __launch_bounds__(kThreads)
gated_dot_kernel(const RowBwdArgs args, float* dot) {
  constexpr int kRowsPerBlock = kThreads / kRowThreads;
  const int t = threadIdx.x % kRowThreads;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kRowThreads;
  if (row >= args.rows) return;  // a whole warp, or a whole block
  const int d = args.d;
  const T* dy = static_cast<const T*>(args.dy) + row * args.dy_stride;
  const T* y = static_cast<const T*>(args.a) + row * args.a_stride;
  const T* z = static_cast<const T*>(args.b) + row * args.b_stride;
  const W* w = static_cast<const W*>(args.w);
  float gv = 0.f;
  for (int i = t; i < d; i += kRowThreads) {
    const float s = gate<T>(attn::to_f32(z[i])).x;
    const float v = round_to<T>(__fmul_rn(attn::to_f32(y[i]), s));
    gv = fmaf(attn::to_f32(dy[i]) * attn::to_f32(w[i]), v, gv);
  }
  gv = row_sum2<kRowThreads>(gv, 0.f).x;
  if (t == 0) dot[row] = gv;
}

template <typename T, typename W>
cudaError_t launch_dot(const RowBwdArgs& a, float* dot, cudaStream_t stream) {
  if (a.d <= kWarpRowMaxD) {
    constexpr int kRows = kWarpModeThreads / 32;
    gated_dot_kernel<T, W, kWarpModeThreads, 32>
        <<<(a.rows + kRows - 1) / kRows, kWarpModeThreads, 0, stream>>>(a,
                                                                        dot);
  } else {
    gated_dot_kernel<T, W, kBlockModeThreads, kBlockModeThreads>
        <<<a.rows, kBlockModeThreads, 0, stream>>>(a, dot);
  }
  return cudaGetLastError();
}

// out[i] = the sum of partial[b, i] over b = 0 .. nb - 1 in a fixed
// order: a block takes 32 columns, warp k adds rows k, k + kSumWarps, ...
// in order, then warp 0 adds the warps' sums in warp order
template <typename W>
__global__ void __launch_bounds__(kSumWarps * 32)
sum_partials_kernel(const float* partial, int nb, int n, W* out) {
  __shared__ float part[kSumWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int b = warp; b < nb; b += kSumWarps)
      s += partial[(long long)b * n + i];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < n) {
    float total = part[0][lane];
    for (int k = 1; k < kSumWarps; ++k) total += part[k][lane];
    attn::store(out + i, total);
  }
}

template <typename W>
cudaError_t launch_sum(const float* partial, int nb, int n, void* out,
                       cudaStream_t stream) {
  sum_partials_kernel<W><<<(n + 31) / 32, kSumWarps * 32, 0, stream>>>(
      partial, nb, n, static_cast<W*>(out));
  return cudaGetLastError();
}

template <Op kOp, typename T, int kVec, bool kVecLoad, int kThreads,
          bool kStream>
cudaError_t launch_row_kernel(const RowBwdArgs& a, const RowPlan& p,
                              cudaStream_t stream) {
  auto kernel = norm_bwd_kernel<kOp, T, kVec, kVecLoad, kThreads, kStream>;
  // the prefetch ring: 2 stages of 2 or 3 arrays of kBwdGroups 16-byte
  // groups a thread (up to 96 KB a block: with the static arrays, above
  // 48 KB needs the opt-in)
  constexpr size_t kRingBytes = kVecLoad && !kStream
                                    ? (size_t)2 * (kOp == Op::kNorm ? 2 : 3) *
                                          kBwdGroups * 16
                                    : 0;
  const size_t ring = kRingBytes * p.threads;
  if (ring) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring);
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.blocks, p.threads, ring, stream>>>(a, p.log_r);
  return cudaGetLastError();
}

template <Op kOp, typename T, int kVec, bool kVecLoad>
cudaError_t launch_row_plan(const RowBwdArgs& a, const RowPlan& p,
                            cudaStream_t stream) {
  if (p.stream)
    return launch_row_kernel<kOp, T, kVec, kVecLoad, kBwdMaxRowThreads,
                             true>(a, p, stream);
  if (p.threads == kBwdBlockThreads)
    return launch_row_kernel<kOp, T, kVec, kVecLoad, kBwdBlockThreads,
                             false>(a, p, stream);
  return launch_row_kernel<kOp, T, kVec, kVecLoad, kBwdMaxRowThreads, false>(
      a, p, stream);
}

// nb must be the plan's blocks (the launcher sized ``partial`` by it)
template <Op kOp, typename T, typename W>
cudaError_t launch_bwd_rows(RowBwdArgs a, int nb, int vec, void* dw,
                            cudaStream_t stream) {
  const RowPlan p = row_plan(a.rows, a.d, sizeof(T));
  if (nb != p.blocks) return cudaErrorInvalidValue;
  a.w_bf16 = sizeof(W) == 2;
  constexpr int kV = 16 / sizeof(T);
  cudaError_t err;
  if (p.vec == 1)
    err = launch_row_plan<kOp, T, 1, false>(a, p, stream);
  else if (vec)
    err = launch_row_plan<kOp, T, kV, true>(a, p, stream);
  else
    err = launch_row_plan<kOp, T, kV, false>(a, p, stream);
  if (err != cudaSuccess) return err;
  return launch_sum<W>(a.partial, nb, a.d, dw, stream);
}

template <Op kOp>
int launch_bwd(const RowBwdArgs& a, int nb, int vec, void* dw, int x_dtype,
               int w_dtype, void* stream) {
  if (a.rows == 0) return cudaSuccess;
  if (a.d < 1 || nb < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd_rows<kOp, float, float>(a, nb, vec, dw, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd_rows<kOp, float, __nv_bfloat16>(a, nb, vec, dw, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd_rows<kOp, __nv_bfloat16, float>(a, nb, vec, dw, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd_rows<kOp, __nv_bfloat16, __nv_bfloat16>(a, nb, vec, dw,
                                                              st);
  return cudaErrorInvalidValue;
}

// --- qk_norm_rope_bwd ------------------------------------------------------

struct RopeBwdArgs {
  const void* dq;  // contiguous [B, S, Hq, D]: the gradient of q'
  const void* dk;  // contiguous [B, S, Hkv, D]: the gradient of k'
  const void* q;   // the forward's inputs, element strides as in RopeArgs
  long long q_sb, q_ss, q_sh;
  const void* k;
  long long k_sb, k_ss, k_sh;
  const void* wq;  // [D] each, or both null: RoPE only
  const void* wk;
  const void* pos;
  long long p_sb, p_ss;
  int pos64;
  const float* inv_freq;  // [D / 2]
  void* dq_out;           // contiguous [B, S, Hq, D] and [B, S, Hkv, D]
  void* dk_out;
  float* partial;  // [gridDim.x, 2, D]: dwq then dwk (null without weights)
  int B, S, Hq, Hkv, D;
  float eps;
  int w_bf16 = 0;  // wq and wk are bfloat16, else float
};

// a warp per token: its (cos, sin) once, then its q heads and k heads,
// 32 / L at a time, L lanes a head (see "the backward" above): RoPE's
// transpose (the rotation by the negative angle), then, with weights,
// the norm's backward; dwq and dwk in registers over every head
template <typename T, int kVec, bool kVecLoad>
__global__ void __launch_bounds__(kRopeBwdWarps * 32)
qk_norm_rope_bwd_kernel(const RopeBwdArgs a, const int log_l) {
  constexpr int G = kRopeBwdPairs / kVec;  // groups of kVec pairs a lane holds
  constexpr int kThreads = kRopeBwdWarps * 32;
  // each warp's (cos, sin) [D / 2] in the loop; the warps' dw rows
  // [kRopeBwdWarps, 2, D] after it
  __shared__ __align__(16) float smem[kRopeBwdWarps * 2 * kWarpRowMaxD];
  const int L = 1 << log_l, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & (L - 1), sub = lane >> log_l, nsub = 32 >> log_l;
  const bool norm = a.wq != nullptr;  // the same for the whole grid
  const int D = a.D, half = D / 2, ng = half / kVec, H = a.Hq + a.Hkv;
  const long long tokens = (long long)a.B * a.S;
  float2* cs = reinterpret_cast<float2*>(smem) + warp * (kWarpRowMaxD / 2);

  // wq and wk at this lane's pairs (i, i + D / 2), and their dw sums
  float wq1[G][kVec], wq2[G][kVec], wk1[G][kVec], wk2[G][kVec];
  float dq1[G][kVec], dq2[G][kVec], dk1[G][kVec], dk2[G][kVec];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) dq1[j][k] = dq2[j][k] = dk1[j][k] =
        dk2[j][k] = 0.f;
    const int g = t + j * L;
    if (!norm || g >= ng) continue;
    const bool wb = a.w_bf16 != 0;
    load_w<kVec, kVecLoad>(a.wq, wb, g * kVec, wq1[j]);
    load_w<kVec, kVecLoad>(a.wq, wb, half + g * kVec, wq2[j]);
    load_w<kVec, kVecLoad>(a.wk, wb, g * kVec, wk1[j]);
    load_w<kVec, kVecLoad>(a.wk, wb, half + g * kVec, wk2[j]);
  }

  for (long long tok = (long long)blockIdx.x * kRopeBwdWarps + warp;
       tok < tokens; tok += (long long)gridDim.x * kRopeBwdWarps) {
    const int s = (int)(tok % a.S), b = (int)(tok / a.S);
    const long long pi = b * a.p_sb + s * a.p_ss;
    const float p = a.pos64 ? (float)static_cast<const long long*>(a.pos)[pi]
                            : (float)static_cast<const int*>(a.pos)[pi];
    __syncwarp();  // the previous token's (cos, sin) are read
    for (int i = lane; i < half; i += 32) {
      const float ang = __fmul_rn(p, a.inv_freq[i]);
      cs[i] = make_float2(cosf(ang), sinf(ang));
    }
    __syncwarp();
    float cv[G][kVec], sv[G][kVec];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = t + j * L;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float2 v = g < ng ? cs[g * kVec + k] : make_float2(0.f, 0.f);
        cv[j][k] = v.x;
        sv[j][k] = v.y;
      }
    }
    for (int h0 = 0; h0 < H; h0 += nsub) {
      const int h = h0 + sub;
      const bool live = h < H, is_q = h < a.Hq;
      const int hh = is_q ? h : h - a.Hq;
      const T* x = static_cast<const T*>(is_q ? a.q : a.k) +
                   (is_q ? b * a.q_sb + s * a.q_ss + hh * a.q_sh
                         : b * a.k_sb + s * a.k_ss + hh * a.k_sh);
      const long long rr = tok * (is_q ? a.Hq : a.Hkv) + hh;
      const T* dout = static_cast<const T*>(is_q ? a.dq : a.dk) + rr * D;
      T* dx = static_cast<T*>(is_q ? a.dq_out : a.dk_out) + rr * D;
      Vec<T, kVec> x1r[G], x2r[G];
      float n1[G][kVec], n2[G][kVec];
      float ss = 0.f, gv = 0.f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = t + j * L;
        if (!live || g >= ng) continue;
        Vec<T, kVec> d1r, d2r;
        load_raw<kVec, kVecLoad>(dout + g * kVec, d1r);
        load_raw<kVec, kVecLoad>(dout + half + g * kVec, d2r);
        if (norm) {
          load_raw<kVec, kVecLoad>(x + g * kVec, x1r[j]);
          load_raw<kVec, kVecLoad>(x + half + g * kVec, x2r[j]);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float d1 = attn::to_f32(d1r.v[k]), d2 = attn::to_f32(d2r.v[k]);
          const float c = cv[j][k], sn = sv[j][k];
          n1[j][k] = d1 * c + d2 * sn;
          n2[j][k] = d2 * c - d1 * sn;
          if (!norm) continue;
          n1[j][k] = round_to<T>(n1[j][k]);  // the normed head's gradient
          n2[j][k] = round_to<T>(n2[j][k]);  // in T
          const float x1 = attn::to_f32(x1r[j].v[k]);
          const float x2 = attn::to_f32(x2r[j].v[k]);
          const float w1 = is_q ? wq1[j][k] : wk1[j][k];
          const float w2 = is_q ? wq2[j][k] : wk2[j][k];
          ss = fmaf(x1, x1, fmaf(x2, x2, ss));
          gv = fmaf(n1[j][k] * w1, x1, fmaf(n2[j][k] * w2, x2, gv));
        }
        if (!norm) {
          store_group<kVec, kVecLoad>(dx + g * kVec, n1[j]);
          store_group<kVec, kVecLoad>(dx + half + g * kVec, n2[j]);
        }
      }
      if (!norm) continue;
      for (int o = L >> 1; o > 0; o >>= 1) {  // the head's L lanes
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        gv += __shfl_xor_sync(0xffffffffu, gv, o);
      }
      const float rstd = rsqrtf(ss / (float)D + a.eps);
      const float c = rstd * rstd * gv / (float)D;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = t + j * L;
        if (!live || g >= ng) continue;
        float o1[kVec], o2[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float x1 = attn::to_f32(x1r[j].v[k]);
          const float x2 = attn::to_f32(x2r[j].v[k]);
          const float w1 = is_q ? wq1[j][k] : wk1[j][k];
          const float w2 = is_q ? wq2[j][k] : wk2[j][k];
          o1[k] = rstd * (n1[j][k] * w1 - x1 * c);
          o2[k] = rstd * (n2[j][k] * w2 - x2 * c);
          const float e1 = n1[j][k] * (x1 * rstd);
          const float e2 = n2[j][k] * (x2 * rstd);
          if (is_q) {
            dq1[j][k] += e1;
            dq2[j][k] += e2;
          } else {
            dk1[j][k] += e1;
            dk2[j][k] += e2;
          }
        }
        store_group<kVec, kVecLoad>(dx + g * kVec, o1);
        store_group<kVec, kVecLoad>(dx + half + g * kVec, o2);
      }
    }
  }
  if (!norm) return;

  // the warp's head groups hold the same columns: a butterfly over them
  // (lanes t, t + L, ...), then the block's warps in order
  __syncthreads();  // every warp is done with its (cos, sin)
  float* acc = smem;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + j * L;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v[4] = {dq1[j][k], dq2[j][k], dk1[j][k], dk2[j][k]};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        for (int o = L; o < 32; o <<= 1)
          v[m] += __shfl_xor_sync(0xffffffffu, v[m], o);
      if (sub == 0 && g < ng) {
        float* row = acc + warp * 2 * D + g * kVec + k;
        row[0] = v[0];
        row[half] = v[1];
        row[D] = v[2];
        row[D + half] = v[3];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * D; i += kThreads) {
    float s = acc[i];
    for (int k = 1; k < kRopeBwdWarps; ++k) s += acc[k * 2 * D + i];
    a.partial[(long long)blockIdx.x * 2 * D + i] = s;
  }
}

template <typename T, int kVec, bool kVecLoad>
cudaError_t launch_rope_plan(const RopeBwdArgs& a, const RopePlan& p,
                             cudaStream_t stream) {
  qk_norm_rope_bwd_kernel<T, kVec, kVecLoad>
      <<<p.blocks, kRopeBwdWarps * 32, 0, stream>>>(a, p.log_l);
  return cudaGetLastError();
}

// nb must be the plan's blocks (the launcher sized ``partial`` by it)
template <typename T, typename W>
cudaError_t launch_rope_bwd(RopeBwdArgs a, int nb, int vec, void* dw,
                            cudaStream_t stream) {
  const RopePlan p = rope_plan((long long)a.B * a.S, a.D, sizeof(T));
  if (nb != p.blocks) return cudaErrorInvalidValue;
  a.w_bf16 = sizeof(W) == 2;
  constexpr int kV = 16 / sizeof(T);
  cudaError_t err;
  if (p.vec == 1)
    err = launch_rope_plan<T, 1, false>(a, p, stream);
  else if (vec)
    err = launch_rope_plan<T, kV, true>(a, p, stream);
  else
    err = launch_rope_plan<T, kV, false>(a, p, stream);
  if (err != cudaSuccess || a.wq == nullptr) return err;
  return launch_sum<W>(a.partial, nb, 2 * a.D, dw, stream);
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, long long x_stride, const void* w,
                           void* out, int rows, int d, float eps,
                           int x_dtype, int w_dtype, int vec, void* stream) {
  const RowArgs a{x, x_stride, nullptr, 0, w, out, nullptr, rows, d, eps};
  return launch_rows<Op::kNorm>(a, x_dtype, w_dtype, vec, stream);
}

extern "C" int add_rmsnorm_fwd(const void* x, long long x_stride,
                               const void* delta, long long delta_stride,
                               const void* w, void* out, void* r, int rows,
                               int d, float eps, int x_dtype, int w_dtype,
                               int vec, void* stream) {
  const RowArgs a{x, x_stride, delta, delta_stride, w, out, r, rows, d, eps};
  return launch_rows<Op::kAdd>(a, x_dtype, w_dtype, vec, stream);
}

extern "C" int gated_rmsnorm_fwd(const void* y, long long y_stride,
                                 const void* z, long long z_stride,
                                 const void* w, void* out, int rows, int d,
                                 float eps, int x_dtype, int w_dtype, int vec,
                                 void* stream) {
  const RowArgs a{y, y_stride, z, z_stride, w, out, nullptr, rows, d, eps};
  return launch_gated<Op::kGated>(a, x_dtype, w_dtype, vec, stream);
}

// the split gated norm's forward: the row's partial sum of squares into
// ss [rows] (fp32), then, given the sums over the ranks, the norm
extern "C" int gated_rmsnorm_sumsq(const void* y, long long y_stride,
                                   const void* z, long long z_stride,
                                   float* ss, int rows, int d, int x_dtype,
                                   int vec, void* stream) {
  RowArgs a{y, y_stride, z, z_stride, nullptr, nullptr, nullptr, rows, d,
            0.f};
  a.ss_out = ss;
  // w is not read
  return launch_gated<Op::kGatedSumSq>(a, x_dtype, 0, vec, stream);
}

extern "C" int gated_rmsnorm_scale(const void* y, long long y_stride,
                                   const void* z, long long z_stride,
                                   const void* w, const float* ss, void* out,
                                   int rows, int d, int d_total, float eps,
                                   int x_dtype, int w_dtype, int vec,
                                   void* stream) {
  if (d_total < d) return cudaErrorInvalidValue;
  RowArgs a{y, y_stride, z, z_stride, w, out, nullptr, rows, d, eps};
  a.ss = ss;
  a.d_total = d_total;
  return launch_gated<Op::kGatedScale>(a, x_dtype, w_dtype, vec, stream);
}

extern "C" int qk_norm_rope_fwd(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* wq, const void* wk, const void* pos, long long p_sb,
    long long p_ss, int pos64, const float* inv_freq, void* q_out,
    void* k_out, int B, int S, int Hq, int Hkv, int D, float eps,
    int x_dtype, int w_dtype, int vec, void* stream) {
  if ((long long)B * S * (Hq + Hkv) == 0) return cudaSuccess;
  if (D < 2 || D % 2 != 0 || D > kWarpRowMaxD) return cudaErrorInvalidValue;
  const RopeArgs a{q,     q_sb,  q_ss,     q_sh,  k,     k_sb,
                   k_ss,  k_sh,  wq,       wk,    pos,   p_sb,
                   p_ss,  pos64, inv_freq, q_out, k_out, B,
                   S,     Hq,    Hkv,      D,     eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_rope<float, float>(a, vec, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_rope<float, __nv_bfloat16>(a, vec, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_rope<__nv_bfloat16, float>(a, vec, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_rope<__nv_bfloat16, __nv_bfloat16>(a, vec, st);
  return cudaErrorInvalidValue;
}

// The backward entry points: each launches its row kernel and then, for
// dw, sum_partials_kernel over the nb partial rows in ``partial`` (fp32,
// [nb, d]; qk_norm_rope_bwd: [nb, 2, D], dw then [2, D] = (dwq, dwk)); nb
// must be the plan's blocks (row_plan, rope_plan; kernel.py mirrors
// them), else cudaErrorInvalidValue.  vec = 1 takes 16-byte loads and
// stores where the plan groups by them (kernel.py ``vectorized``).
// Every incoming gradient and every output is read or written through a
// row stride or contiguous as the comments say; dtypes as the forward's.

extern "C" int rmsnorm_bwd(const void* dy, long long dy_stride, const void* x,
                           long long x_stride, const void* w, void* dx,
                           void* dw, float* partial, int nb, int vec,
                           int rows, int d, float eps, int x_dtype,
                           int w_dtype, void* stream) {
  const RowBwdArgs a{dy, dy_stride, x,  x_stride, nullptr, 0,    w,
                     dx, nullptr,   partial, rows, d,       eps};
  return launch_bwd<Op::kNorm>(a, nb, vec, dw, x_dtype, w_dtype, stream);
}

// dr may be null (r's gradient is then 0); dx is the gradient of both x
// and delta
extern "C" int add_rmsnorm_bwd(const void* dh, long long dh_stride,
                               const void* dr, long long dr_stride,
                               const void* r, long long r_stride,
                               const void* w, void* dx, void* dw,
                               float* partial, int nb, int vec, int rows,
                               int d, float eps, int x_dtype, int w_dtype,
                               void* stream) {
  const RowBwdArgs a{dh, dh_stride, r,  r_stride, dr,   dr_stride, w,
                     dx, nullptr,   partial, rows, d,    eps};
  return launch_bwd<Op::kAdd>(a, nb, vec, dw, x_dtype, w_dtype, stream);
}

extern "C" int gated_rmsnorm_bwd(const void* dout, long long dout_stride,
                                 const void* y, long long y_stride,
                                 const void* z, long long z_stride,
                                 const void* w, void* dy, void* dz, void* dw,
                                 float* partial, int nb, int vec, int rows,
                                 int d, float eps, int x_dtype, int w_dtype,
                                 void* stream) {
  const RowBwdArgs a{dout, dout_stride, y,  y_stride, z,    z_stride, w,
                     dy,   dz,          partial, rows, d,  eps};
  return launch_bwd<Op::kGated>(a, nb, vec, dw, x_dtype, w_dtype, stream);
}

// the split gated norm's backward: this rank's partial of sum(dout * w *
// v) per row into dot [rows] (fp32); then, given S and the summed P, dy,
// dz and dw of this rank's columns
extern "C" int gated_rmsnorm_dot(const void* dout, long long dout_stride,
                                 const void* y, long long y_stride,
                                 const void* z, long long z_stride,
                                 const void* w, float* dot, int rows, int d,
                                 int x_dtype, int w_dtype, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (d < 1) return cudaErrorInvalidValue;
  const RowBwdArgs a{dout,    dout_stride, y,    y_stride, z,  z_stride, w,
                     nullptr, nullptr,     nullptr, rows,  d,  0.f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) return launch_dot<float, float>(a, dot, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_dot<float, __nv_bfloat16>(a, dot, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_dot<__nv_bfloat16, float>(a, dot, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_dot<__nv_bfloat16, __nv_bfloat16>(a, dot, st);
  return cudaErrorInvalidValue;
}

extern "C" int gated_rmsnorm_scale_bwd(
    const void* dout, long long dout_stride, const void* y,
    long long y_stride, const void* z, long long z_stride, const void* w,
    const float* ss, const float* dot, void* dy, void* dz, void* dw,
    float* partial, int nb, int vec, int rows, int d, int d_total,
    float eps, int x_dtype, int w_dtype, void* stream) {
  if (d_total < d) return cudaErrorInvalidValue;
  RowBwdArgs a{dout, dout_stride, y,  y_stride, z,    z_stride, w,
               dy,   dz,          partial, rows, d,  eps};
  a.ss = ss;
  a.dot = dot;
  a.d_total = d_total;
  return launch_bwd<Op::kGatedScale>(a, nb, vec, dw, x_dtype, w_dtype,
                                     stream);
}

extern "C" int qk_norm_rope_bwd(
    const void* dq, const void* dk, const void* q, long long q_sb,
    long long q_ss, long long q_sh, const void* k, long long k_sb,
    long long k_ss, long long k_sh, const void* wq, const void* wk,
    const void* pos, long long p_sb, long long p_ss, int pos64,
    const float* inv_freq, void* dq_out, void* dk_out, float* partial,
    void* dw, int nb, int vec, int B, int S, int Hq, int Hkv, int D,
    float eps, int x_dtype, int w_dtype, void* stream) {
  if ((long long)B * S * (Hq + Hkv) == 0) return cudaSuccess;
  if (D < 2 || D % 2 != 0 || D > kWarpRowMaxD || nb < 1)
    return cudaErrorInvalidValue;
  const RopeBwdArgs a{dq,   dk,   q,     q_sb,   q_ss,     q_sh,   k,
                      k_sb, k_ss, k_sh,  wq,     wk,       pos,    p_sb,
                      p_ss, pos64, inv_freq, dq_out, dk_out, partial, B,
                      S,    Hq,   Hkv,   D,      eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_rope_bwd<float, float>(a, nb, vec, dw, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_rope_bwd<float, __nv_bfloat16>(a, nb, vec, dw, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_rope_bwd<__nv_bfloat16, float>(a, nb, vec, dw, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_rope_bwd<__nv_bfloat16, __nv_bfloat16>(a, nb, vec, dw, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
