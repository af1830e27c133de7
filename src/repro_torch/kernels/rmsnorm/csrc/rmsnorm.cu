// RMSNorm for Hopper, and the three fusions that take over its neighbours:
//
//   rmsnorm_fwd        out = norm(x) * w
//   add_rmsnorm_fwd    r = T(x + delta) written out; out = norm(r) * w
//   gated_rmsnorm_fwd  out = norm(T(y * T(silu(z)))) * w
//   qk_norm_rope_fwd   per head of q and k: T(norm(x) * w) (when weights
//                      are given), then the rotary rotation at its position
//
// where norm(v) = v * rsqrt(mean(v^2) + eps) in fp32, T is x's dtype and
// T(.) one rounding to it; and the backward of each (rmsnorm_bwd,
// add_rmsnorm_bwd, gated_rmsnorm_bwd, qk_norm_rope_bwd; see "the
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
// Design.  Every entry point runs the same sum of squares (inv_rms) in the
// same order: a row's d values in groups of kVec (16 bytes of T when d is a
// multiple of it, else 1), thread t of the row's threads summing groups t,
// t + kRowThreads, ... with explicit fmas, then warp shuffles, then shared
// memory across the warps of a block.  The grouping depends on d and T
// only; whether a group is one 16-byte load or kVec loads of one element
// (a row stride or pointer that breaks the vector) does not change the
// values or their order.  So a fused variant's norm is bit-identical to
// rmsnorm_fwd of the tensor the unfused path would have materialised (r,
// the gated product, or the qk-norm's input).  A row of d <= 512 (a head
// of q or k) is one warp's work (four rows per block of 128 threads), a
// longer row one block of 256 threads: a decode step's norms are 8 rows,
// and a warp would walk a 1,024-wide row in four dependent steps where a
// block takes one (1.8 against 3.1 us at [8, 1024] on an H100,
// chip_smoke.py phase 12).  The split follows d
// alone, so the fused variants and rmsnorm_fwd always agree on it.  The
// row's values come from a policy (PlainRow, AddRow,
// GatedRow) that the reduction and the write-out both call: the second
// pass recomputes them from the inputs (from L1/L2: a row is a few KB)
// rather than reading back what the first pass wrote.
//
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

// T(y * T(silu(z))): torch's F.silu (z / (1 + exp(-z)) in fp32, rounded
// to T), then its mul (rounded to T), then the norm of the product
template <typename T, int kVec, bool kVecLoad>
struct GatedRow {
  const T* y;
  const T* z;
  __device__ __forceinline__ void again(int g, float (&v)[kVec]) const {
    float a[kVec], b[kVec];
    load_group<kVec, kVecLoad>(y + g * kVec, a);
    load_group<kVec, kVecLoad>(z + g * kVec, b);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float e = __fadd_rn(1.f, expf(-b[k]));
      const float s = round_to<T>(__fdiv_rn(b[k], e));
      v[k] = round_to<T>(__fmul_rn(a[k], s));
    }
  }
  __device__ __forceinline__ void first(int g, float (&v)[kVec]) const {
    again(g, v);
  }
};

// The one reduction: rsqrt(mean(v^2) + eps) of the row, kRowThreads
// threads per row (32: a warp; else the whole block).  Thread t sums
// groups t, t + kRowThreads, ... in that order.
template <int kVec, int kRowThreads, class Row>
__device__ __forceinline__ float inv_rms(const Row& row, int d, float eps) {
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
  return rsqrtf(ss / (float)d + eps);
}

// --- rmsnorm_fwd, add_rmsnorm_fwd, gated_rmsnorm_fwd -----------------------

enum class Op { kNorm, kAdd, kGated };

struct RowArgs {
  const void* a;  // x (kNorm, kAdd) or y (kGated)
  long long a_stride;
  const void* b;  // delta (kAdd) or z (kGated); unused by kNorm
  long long b_stride;
  const void* w;
  void* out;
  void* r;  // kAdd: the residual x + delta
  int rows, d;
  float eps;
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
  const T* b = static_cast<const T*>(args.b) + row * args.b_stride;
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
  } else if constexpr (kOp == Op::kAdd) {
    T* r = static_cast<T*>(args.r) + row * (long long)d;
    run(AddRow<T, kVec, kVecLoad>{a, b, r});
  } else {
    run(GatedRow<T, kVec, kVecLoad>{a, b});
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

// --- qk_norm_rope_fwd ------------------------------------------------------

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
};

// one warp per (token, head) row of q, then of k; D <= kWarpRowMaxD
template <typename T, typename W, int kVec>
__global__ void __launch_bounds__(kWarpModeThreads)
qk_norm_rope_kernel(const RopeArgs a) {
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
cudaError_t launch_rope(const RopeArgs& a, cudaStream_t stream) {
  constexpr int kRows = kWarpModeThreads / 32;
  const long long rows = (long long)a.B * a.S * (a.Hq + a.Hkv);
  const unsigned grid = (unsigned)((rows + kRows - 1) / kRows);
  constexpr int kV = 16 / sizeof(T);
  if (a.D % kV == 0)
    qk_norm_rope_kernel<T, W, kV><<<grid, kWarpModeThreads, 0, stream>>>(a);
  else
    qk_norm_rope_kernel<T, W, 1><<<grid, kWarpModeThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// --- the backward ----------------------------------------------------------
//
// One backward per entry point.  Each recomputes its row's rstd =
// rsqrt(mean(v^2) + eps) in fp32 from the forward's normed input v (x, r,
// or the gated product, rebuilt from y and z as GatedRow builds it) and,
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
// order.
//
// dw is deterministic, with no atomics: block b walks rows b * R + s,
// (b + nb) * R + s, ... (R row slots per block, s its slot: a warp per
// row up to d 512, a block above, as in the forward), each slot summing
// its rows' dy * xhat into its own fp32 row of shared memory; the block
// then sums its R rows in order into partial[b, :], and a second launch
// (sum_partials_kernel) sums partial[0 .. nb) in order, a thread per
// column.  nb comes from the launcher (kernel.py ``partials``: the row
// count alone decides it).  Two calls on the same inputs give the same
// bits.
//
// Bound: memory.  A call must read dy, the forward's inputs and w once,
// and write the input gradients and dw once.  This first version reads a
// row's inputs twice (the sums, then the write-out, the second pass from
// L1/L2) and one element per load; speed is later work.

// the sums of a and of b over the row's kRowThreads threads (a warp, or
// the whole block)
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

// Mamba2's gate at one element as GatedRow computes it: (T(silu(z)),
// 1 + exp(-z))
template <typename T>
__device__ __forceinline__ float2 gate(float z) {
  const float e = __fadd_rn(1.f, expf(-z));
  return make_float2(round_to<T>(__fdiv_rn(z, e)), e);
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
};

template <Op kOp, typename T, typename W, int kThreads, int kRowThreads>
__global__ void __launch_bounds__(kThreads)
norm_bwd_kernel(const RowBwdArgs args) {
  constexpr int kSlots = kThreads / kRowThreads;
  extern __shared__ float acc[];  // [kSlots, d]: each slot's dw sums
  const int t = threadIdx.x % kRowThreads, slot = threadIdx.x / kRowThreads;
  const int d = args.d;
  float* mine = acc + slot * d;
  for (int i = t; i < d; i += kRowThreads) mine[i] = 0.f;
  const W* w = static_cast<const W*>(args.w);
  // every row slot walks its rows; in block mode the whole block walks
  // them together (row_sum2 synchronises it), in warp mode each warp on
  // its own (row_sum2 stays inside the warp)
  for (long long row = (long long)blockIdx.x * kSlots + slot; row < args.rows;
       row += (long long)gridDim.x * kSlots) {
    const T* dy = static_cast<const T*>(args.dy) + row * args.dy_stride;
    const T* a = static_cast<const T*>(args.a) + row * args.a_stride;
    const T* b = args.b == nullptr
                     ? nullptr
                     : static_cast<const T*>(args.b) + row * args.b_stride;
    // the forward's normed input at i
    auto value = [&](int i) -> float {
      if constexpr (kOp == Op::kGated) {
        const float s = gate<T>(attn::to_f32(b[i])).x;
        return round_to<T>(__fmul_rn(attn::to_f32(a[i]), s));
      } else {
        return attn::to_f32(a[i]);
      }
    };
    float ss = 0.f, gv = 0.f;
    for (int i = t; i < d; i += kRowThreads) {
      const float v = value(i);
      const float g = attn::to_f32(dy[i]) * attn::to_f32(w[i]);
      ss = fmaf(v, v, ss);
      gv = fmaf(g, v, gv);
    }
    const float2 sums = row_sum2<kRowThreads>(ss, gv);
    const float rstd = rsqrtf(sums.x / (float)d + args.eps);
    const float c = rstd * rstd * sums.y / (float)d;
    T* da = static_cast<T*>(args.da) + row * (long long)d;
    for (int i = t; i < d; i += kRowThreads) {
      const float v = value(i), g_out = attn::to_f32(dy[i]);
      const float dv = rstd * (g_out * attn::to_f32(w[i]) - v * c);
      mine[i] += g_out * (v * rstd);
      if constexpr (kOp == Op::kNorm) {
        attn::store(da + i, dv);
      } else if constexpr (kOp == Op::kAdd) {
        // the norm's input gradient in T, then torch's add of dr
        const float dr = b == nullptr ? 0.f : attn::to_f32(b[i]);
        attn::store(da + i, round_to<T>(dv) + dr);
      } else {
        const float y = attn::to_f32(a[i]), z = attn::to_f32(b[i]);
        const float2 se = gate<T>(z);  // (T(silu(z)), 1 + exp(-z))
        const float dg = round_to<T>(dv);
        attn::store(da + i, dg * se.x);
        const float ds = round_to<T>(dg * y);
        const float sig = 1.f / se.y;  // silu'(z) = s (1 + z (1 - s))
        T* dz = static_cast<T*>(args.db) + row * (long long)d;
        attn::store(dz + i, ds * (sig * (1.f + z * (1.f - sig))));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float s = 0.f;
    for (int k = 0; k < kSlots; ++k) s += acc[k * d + i];
    args.partial[(long long)blockIdx.x * d + i] = s;
  }
}

// out[i] = the sum of partial[b, i] over b = 0 .. nb - 1, in that order
template <typename W>
__global__ void sum_partials_kernel(const float* partial, int nb, int n,
                                    W* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += partial[(long long)b * n + i];
  attn::store(out + i, s);
}

template <typename W>
cudaError_t launch_sum(const float* partial, int nb, int n, void* out,
                       cudaStream_t stream) {
  sum_partials_kernel<W><<<(n + 255) / 256, 256, 0, stream>>>(
      partial, nb, n, static_cast<W*>(out));
  return cudaGetLastError();
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <Op kOp, typename T, typename W>
cudaError_t launch_bwd_rows(const RowBwdArgs& a, int nb, void* dw,
                            cudaStream_t stream) {
  cudaError_t err;
  if (a.d <= kWarpRowMaxD) {
    constexpr int kSlots = kWarpModeThreads / 32;
    auto kernel = norm_bwd_kernel<kOp, T, W, kWarpModeThreads, 32>;
    const size_t smem = sizeof(float) * kSlots * a.d;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<nb, kWarpModeThreads, smem, stream>>>(a);
  } else {
    auto kernel =
        norm_bwd_kernel<kOp, T, W, kBlockModeThreads, kBlockModeThreads>;
    const size_t smem = sizeof(float) * a.d;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<nb, kBlockModeThreads, smem, stream>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum<W>(a.partial, nb, a.d, dw, stream);
}

template <Op kOp>
int launch_bwd(const RowBwdArgs& a, int nb, void* dw, int x_dtype,
               int w_dtype, void* stream) {
  if (a.rows == 0) return cudaSuccess;
  if (a.d < 1 || nb < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd_rows<kOp, float, float>(a, nb, dw, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd_rows<kOp, float, __nv_bfloat16>(a, nb, dw, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd_rows<kOp, __nv_bfloat16, float>(a, nb, dw, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd_rows<kOp, __nv_bfloat16, __nv_bfloat16>(a, nb, dw, st);
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
};

// pairs (i, i + D / 2) per lane of a row of D <= kWarpRowMaxD
constexpr int kRopePairs = kWarpRowMaxD / 2 / 32;

// one warp per (token, head) row of q, then of k: RoPE's transpose (the
// rotation by the negative angle), then, with weights, the norm's
// backward; dwq and dwk sum over every (token, head)
template <typename T, typename W>
__global__ void __launch_bounds__(kWarpModeThreads)
qk_norm_rope_bwd_kernel(const RopeBwdArgs a) {
  constexpr int kSlots = kWarpModeThreads / 32;
  extern __shared__ float acc[];  // [2, kSlots, D]: q's then k's dw sums
  const int lane = threadIdx.x & 31, slot = threadIdx.x >> 5;
  const bool norm = a.wq != nullptr;  // the same for the whole grid
  const int D = a.D, half = D / 2;
  if (norm)
    for (int i = lane; i < D; i += 32)
      acc[slot * D + i] = acc[(kSlots + slot) * D + i] = 0.f;
  const long long q_rows = (long long)a.B * a.S * a.Hq;
  const long long rows = q_rows + (long long)a.B * a.S * a.Hkv;
  for (long long row = (long long)blockIdx.x * kSlots + slot; row < rows;
       row += (long long)gridDim.x * kSlots) {
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
    const T* dout = static_cast<const T*>(is_q ? a.dq : a.dk) + rr * D;
    T* dx = static_cast<T*>(is_q ? a.dq_out : a.dk_out) + rr * D;
    const long long pi = b * a.p_sb + s * a.p_ss;
    const float p = a.pos64 ? (float)static_cast<const long long*>(a.pos)[pi]
                            : (float)static_cast<const int*>(a.pos)[pi];
    float dn1[kRopePairs], dn2[kRopePairs];
    float ss = 0.f, gv = 0.f;
#pragma unroll
    for (int j = 0; j < kRopePairs; ++j) {
      const int i = lane + 32 * j;
      dn1[j] = dn2[j] = 0.f;
      if (i >= half) continue;
      const float ang = __fmul_rn(p, a.inv_freq[i]);
      const float c = cosf(ang), sn = sinf(ang);
      const float d1 = attn::to_f32(dout[i]);
      const float d2 = attn::to_f32(dout[i + half]);
      const float n1 = d1 * c + d2 * sn, n2 = d2 * c - d1 * sn;
      if (!norm) {
        attn::store(dx + i, n1);
        attn::store(dx + i + half, n2);
        continue;
      }
      dn1[j] = round_to<T>(n1);  // the gradient of the normed head, in T
      dn2[j] = round_to<T>(n2);
      const float x1 = attn::to_f32(x[i]), x2 = attn::to_f32(x[i + half]);
      ss = fmaf(x1, x1, fmaf(x2, x2, ss));
      gv = fmaf(dn1[j] * attn::to_f32(w[i]), x1,
                fmaf(dn2[j] * attn::to_f32(w[i + half]), x2, gv));
    }
    if (!norm) continue;
    const float2 sums = row_sum2<32>(ss, gv);
    const float rstd = rsqrtf(sums.x / (float)D + a.eps);
    const float c = rstd * rstd * sums.y / (float)D;
    float* mine = acc + ((is_q ? 0 : kSlots) + slot) * D;
#pragma unroll
    for (int j = 0; j < kRopePairs; ++j) {
      const int i = lane + 32 * j;
      if (i >= half) continue;
      const float x1 = attn::to_f32(x[i]), x2 = attn::to_f32(x[i + half]);
      attn::store(dx + i, rstd * (dn1[j] * attn::to_f32(w[i]) - x1 * c));
      attn::store(dx + i + half,
                  rstd * (dn2[j] * attn::to_f32(w[i + half]) - x2 * c));
      mine[i] += dn1[j] * (x1 * rstd);
      mine[i + half] += dn2[j] * (x2 * rstd);
    }
  }
  if (!norm) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * D; i += kWarpModeThreads) {
    const int which = i / D, col = i % D;
    float s = 0.f;
    for (int k = 0; k < kSlots; ++k) s += acc[(which * kSlots + k) * D + col];
    a.partial[(long long)blockIdx.x * 2 * D + i] = s;
  }
}

template <typename T, typename W>
cudaError_t launch_rope_bwd(const RopeBwdArgs& a, int nb, void* dw,
                            cudaStream_t stream) {
  constexpr int kSlots = kWarpModeThreads / 32;
  const size_t smem = a.wq == nullptr ? 0 : sizeof(float) * 2 * kSlots * a.D;
  qk_norm_rope_bwd_kernel<T, W><<<nb, kWarpModeThreads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
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
  return launch_rows<Op::kGated>(a, x_dtype, w_dtype, vec, stream);
}

extern "C" int qk_norm_rope_fwd(
    const void* q, long long q_sb, long long q_ss, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* wq, const void* wk, const void* pos, long long p_sb,
    long long p_ss, int pos64, const float* inv_freq, void* q_out,
    void* k_out, int B, int S, int Hq, int Hkv, int D, float eps,
    int x_dtype, int w_dtype, void* stream) {
  if ((long long)B * S * (Hq + Hkv) == 0) return cudaSuccess;
  if (D < 2 || D % 2 != 0 || D > kWarpRowMaxD) return cudaErrorInvalidValue;
  const RopeArgs a{q,     q_sb,  q_ss,     q_sh,  k,     k_sb,
                   k_ss,  k_sh,  wq,       wk,    pos,   p_sb,
                   p_ss,  pos64, inv_freq, q_out, k_out, B,
                   S,     Hq,    Hkv,      D,     eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0) return launch_rope<float, float>(a, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_rope<float, __nv_bfloat16>(a, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_rope<__nv_bfloat16, float>(a, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_rope<__nv_bfloat16, __nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

// The backward entry points: each launches its row kernel and then, for
// dw, sum_partials_kernel over the nb partial rows in ``partial`` (fp32,
// [nb, d]; qk_norm_rope_bwd: [nb, 2, D], dw then [2, D] = (dwq, dwk)).
// Every incoming gradient and every output is read or written through a
// row stride or contiguous as the comments say; dtypes as the forward's.

extern "C" int rmsnorm_bwd(const void* dy, long long dy_stride, const void* x,
                           long long x_stride, const void* w, void* dx,
                           void* dw, float* partial, int nb, int rows, int d,
                           float eps, int x_dtype, int w_dtype, void* stream) {
  const RowBwdArgs a{dy, dy_stride, x,  x_stride, nullptr, 0,    w,
                     dx, nullptr,   partial, rows, d,       eps};
  return launch_bwd<Op::kNorm>(a, nb, dw, x_dtype, w_dtype, stream);
}

// dr may be null (r's gradient is then 0); dx is the gradient of both x
// and delta
extern "C" int add_rmsnorm_bwd(const void* dh, long long dh_stride,
                               const void* dr, long long dr_stride,
                               const void* r, long long r_stride,
                               const void* w, void* dx, void* dw,
                               float* partial, int nb, int rows, int d,
                               float eps, int x_dtype, int w_dtype,
                               void* stream) {
  const RowBwdArgs a{dh, dh_stride, r,  r_stride, dr,   dr_stride, w,
                     dx, nullptr,   partial, rows, d,    eps};
  return launch_bwd<Op::kAdd>(a, nb, dw, x_dtype, w_dtype, stream);
}

extern "C" int gated_rmsnorm_bwd(const void* dout, long long dout_stride,
                                 const void* y, long long y_stride,
                                 const void* z, long long z_stride,
                                 const void* w, void* dy, void* dz, void* dw,
                                 float* partial, int nb, int rows, int d,
                                 float eps, int x_dtype, int w_dtype,
                                 void* stream) {
  const RowBwdArgs a{dout, dout_stride, y,  y_stride, z,    z_stride, w,
                     dy,   dz,          partial, rows, d,  eps};
  return launch_bwd<Op::kGated>(a, nb, dw, x_dtype, w_dtype, stream);
}

extern "C" int qk_norm_rope_bwd(
    const void* dq, const void* dk, const void* q, long long q_sb,
    long long q_ss, long long q_sh, const void* k, long long k_sb,
    long long k_ss, long long k_sh, const void* wq, const void* wk,
    const void* pos, long long p_sb, long long p_ss, int pos64,
    const float* inv_freq, void* dq_out, void* dk_out, float* partial,
    void* dw, int nb, int B, int S, int Hq, int Hkv, int D, float eps,
    int x_dtype, int w_dtype, void* stream) {
  if ((long long)B * S * (Hq + Hkv) == 0) return cudaSuccess;
  if (D < 2 || D % 2 != 0 || D > kWarpRowMaxD || nb < 1)
    return cudaErrorInvalidValue;
  const RopeBwdArgs a{dq,   dk,   q,     q_sb,   q_ss,     q_sh,   k,
                      k_sb, k_ss, k_sh,  wq,     wk,       pos,    p_sb,
                      p_ss, pos64, inv_freq, dq_out, dk_out, partial, B,
                      S,    Hq,   Hkv,   D,      eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_rope_bwd<float, float>(a, nb, dw, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_rope_bwd<float, __nv_bfloat16>(a, nb, dw, st);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_rope_bwd<__nv_bfloat16, float>(a, nb, dw, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_rope_bwd<__nv_bfloat16, __nv_bfloat16>(a, nb, dw, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
