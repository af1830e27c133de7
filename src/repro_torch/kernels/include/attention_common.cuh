// Device code shared by the kernels of the port: the masking constant,
// fp32/bf16 conversions (which the RMSNorm kernel uses too), 16-byte
// loads, and the one-query-token decode body decode_split, a split of a
// row over the blocks of a thread-block cluster that the dense decode
// kernel (decode_attention.cu) and the paged decode kernel
// (paged_attention.cu) both run, each with its own token layout (Src)
// and its own way of cutting the row (SplitOver).  ``kernels/build.py``
// hashes every header into every library's name, so an edit here
// rebuilds every kernel.
#pragma once

#include <cooperative_groups.h>
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

// --- the split decode --------------------------------------------------------
//
// One query token of one row against that row's K/V, for the G query
// heads of one kv head, with the row split over the blocks of one
// thread-block cluster (cluster dims (splits, 1, 1)).  Block r of the
// cluster computes the fp32 partial (m, l, acc[G, D]) of its tokens for
// all G heads, so every K/V byte is read once.  The cluster then merges
// the partials through distributed shared memory with a log-sum-exp
// rescale, and each block writes its slice of the [G, D] output.  Heads
// are taken GT at a time (GT >= G unless G > 8).
//
// How the row is cut (SplitOver):
//   kSlots     the S token slots: block r takes [r * c, (r + 1) * c), c =
//              ceil(S / splits).  Its first pass of loads depends on S
//              and r only, so it is issued before len is read and the two
//              loads overlap.  Right where the slots are about as many as
//              the live tokens (the dense cache).
//   kAttended  the row's attended range [lo, hi), hi = min(len, S), lo =
//              window > 0 ? max(0, len - window) : 0: block r takes [lo +
//              r * c, min(lo + (r + 1) * c, hi)), c = ceil((hi - lo) /
//              splits).  The loads wait for len, but every block holds an
//              equal share of the live tokens however many slots the row
//              has (the paged pool, whose S = maxp * page is far above
//              any row's length).
//
// The window is measured from end = *endp, the query's position + 1,
// which kSlots reads apart from len and which is len itself for
// kAttended: a dense cache whose decode write was clamped onto its last
// slot (the query's position past S - 1, as jax.lax.dynamic_update_slice
// clamps it) has every slot valid, len = S, and end > S.
//
// Src tells where the row's tokens lie:
//   size_t at(int t)  element offset of (token t, kv head, d = 0) in the
//                     K and V arrays
//
// Within a block, each token's row of D elements is read by tpt threads
// (a power of two; CPT 16-byte chunks each) straight into registers, kept
// there as raw 16-byte words until used, and the block's 128 / tpt thread
// groups walk the block's tokens kU at a time.  A token at or past
// min(len, S), or at or below len - 1 - window, adds nothing (p = 0), so
// a split wholly outside the attended range keeps the partial (kNegInf,
// 0, 0) and a len == 0 row writes zeros; the barriers stay uniform
// because every block walks the same code.  Softcap cap * tanh(s / cap)
// comes before the mask.  The thread groups of a warp merge by shuffles,
// the 4 warps through shared memory (one barrier), and each output of
// the cluster merge reads all blocks' partials at once.

enum class SplitOver { kSlots, kAttended };

// threads that read one token row of D elements of T, CPT chunks each
__device__ __forceinline__ int split_threads_per_token(int D, int elem_bytes,
                                                       int cpt) {
  const int chunks = D * elem_bytes / 16;
  int tpt = 1;
  while (tpt * cpt < chunks) tpt <<= 1;
  return tpt;
}

// dynamic shared memory of one split block (floats): the 4 warps'
// partial (acc, m, l), then the block's partial (acc, m, l), which the
// cluster reads
__host__ __device__ inline size_t split_smem_floats(int GT, int D) {
  return (size_t)4 * GT * D + 2 * 4 * GT + GT * D + 2 * GT;
}

// 16 raw bytes of T -> 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void unpack_raw(const uint4& raw, float* r) {
  if constexpr (sizeof(T) == 4) {
    r[0] = __uint_as_float(raw.x);
    r[1] = __uint_as_float(raw.y);
    r[2] = __uint_as_float(raw.z);
    r[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      r[2 * i] = f.x;
      r[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int GT, int CPT, SplitOver kOver, typename Src>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ qb,  // [G, D]: the G heads of this kv head
    const T* __restrict__ k, const T* __restrict__ v, const Src& src,
    T* __restrict__ ob,  // [G, D]
    const int* __restrict__ lenp, const int* __restrict__ endp, int S,
    int G, int D, float scale, int window, float softcap) {
  namespace cg = cooperative_groups;
  constexpr int kThreads = 128;
  constexpr int kWarps = kThreads / 32;
  constexpr int kMaxSplits = 8;  // the portable cluster size
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kU = 2;  // tokens per thread group per pass
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int nc = D / kVec;  // 16-byte chunks per token row
  const int tpt = split_threads_per_token(D, sizeof(T), CPT);
  const int groups = kThreads / tpt;
  const int step = groups * kU;    // tokens per pass
  const int gl = tid & (tpt - 1);  // lane in the token's thread group
  const int gi = tid / tpt;        // thread group

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* part = smem;                   // [kWarps, GT, D] warp partial acc
  float* gm = part + kWarps * GT * D;   // [kWarps, GT] warp partial max
  float* gs = gm + kWarps * GT;         // [kWarps, GT] warp partial sum
  float* bacc = gs + kWarps * GT;       // [GT, D] block partial acc
  float* bm = bacc + GT * D;            // [GT] block partial max
  float* bl = bm + GT;                  // [GT] block partial sum

  int t0, t_end, len, end;  // this block's tokens [t0, t_end), set below

  // one pass's K/V words: token base + gi + groups * u, clamped into the
  // block's tokens (a chunk past the row reads chunk 0: its q is zero and
  // its acc never written)
  uint4 kr[kU][CPT], vr[kU][CPT];
  auto load_pass = [&](int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + gi + groups * u;
      const size_t row = src.at(t < t_end ? t : t0);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = gl + tpt * j;
        const size_t off = row + (size_t)(c < nc ? c : 0) * kVec;
        kr[u][j] = *reinterpret_cast<const uint4*>(k + off);
        vr[u][j] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
  };
  if constexpr (kOver == SplitOver::kSlots) {
    const int chunk = (S + splits - 1) / splits;
    t0 = rank * chunk;
    t_end = min(t0 + chunk, S);
    if (t0 < t_end) load_pass(t0);  // before len is read
    len = *lenp;
    end = *endp;
  } else {
    len = *lenp;
    end = len;
    const int row_hi = min(max(len, 0), S);
    const int row_lo = window > 0 ? max(0, len - window) : 0;
    const int chunk = (max(row_hi - row_lo, 0) + splits - 1) / splits;
    t0 = row_lo + rank * chunk;
    t_end = min(t0 + chunk, row_hi);
    if (t0 < t_end) load_pass(t0);
  }
  const int hi = min(t_end, max(len, 0));  // attended: [lo, hi)
  const int lo = max(t0, window > 0 ? end - window : 0);

  for (int h0 = 0; h0 < G; h0 += GT) {  // heads h0 .. h0 + GT - 1
    float qr[GT][CPT][kVec], acc[GT][CPT][kVec], m[GT], l[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = gl + tpt * j;
        if (h0 + g < G && c < nc) {
          unpack16(qb + (size_t)(h0 + g) * D + c * kVec, qr[g][j]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) qr[g][j][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][j][e] = 0.f;
      }
    }

    // passes from t0 up to hi; the first one's words are loaded already
    // (a later head tile loads them again)
    for (int base = t0; base < hi; base += step) {
      if (base + step <= lo) continue;  // wholly below the window
      if (base != t0 || h0 != 0) load_pass(base);
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = base + gi + groups * u;
        ok[u] = t >= lo && t < hi;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float x[kU];
        float mb = m[g];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            float kf[kVec];
            unpack_raw<T>(kr[u][j], kf);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              dot = fmaf(qr[g][j][e], kf[e], dot);
          }
          for (int o = tpt >> 1; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          float s = dot * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          x[u] = ok[u] ? s : kNegInf;
          mb = fmaxf(mb, x[u]);
        }
        const float alpha = expf(m[g] - mb);
        float p[kU];
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          p[u] = ok[u] ? expf(x[u] - mb) : 0.f;
          sum += p[u];
        }
        m[g] = mb;
        l[g] = l[g] * alpha + sum;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][j][e] *= alpha;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            float vf[kVec];
            unpack_raw<T>(vr[u][j], vf);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[g][j][e] = fmaf(p[u], vf[e], acc[g][j][e]);
          }
        }
      }
    }

    // merge the thread groups of each warp by shuffles (log-sum-exp);
    // then lanes 0 .. tpt - 1 hold the warp's partial
    for (int off = tpt; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lw = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float a = expf(m[g] - mn);
        const float b = expf(mo - mn);
        m[g] = mn;
        l[g] = l[g] * a + lw * b;
#pragma unroll
        for (int j = 0; j < CPT; ++j)
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j][e], off);
            acc[g][j][e] = acc[g][j][e] * a + ao * b;
          }
      }
    }
    const int warp = tid >> 5;
    if ((tid & 31) < tpt) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = gl + tpt * j;
          if (c < nc) {
            float4* dst = reinterpret_cast<float4*>(
                part + (warp * GT + g) * D + c * kVec);
#pragma unroll
            for (int e = 0; e < kVec; e += 4)
              dst[e / 4] = make_float4(acc[g][j][e], acc[g][j][e + 1],
                                       acc[g][j][e + 2], acc[g][j][e + 3]);
          }
        }
        if (gl == 0) {
          gm[warp * GT + g] = m[g];
          gs[warp * GT + g] = l[g];
        }
      }
    }
    __syncthreads();
    // the block's partial: each output merges the 4 warps' partials
    for (int o = tid; o < GT * D; o += kThreads) {
      const int g = o / D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, gm[w * GT + g]);
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(gm[w * GT + g] - mx);
        a = fmaf(part[(w * GT + g) * D + (o - g * D)], wt, a);
        sum = fmaf(gs[w * GT + g], wt, sum);
      }
      bacc[o] = a;
      if (o == g * D) {
        bm[g] = mx;
        bl[g] = sum;
      }
    }
    cluster.sync();  // every block's partial is written and visible

    // merge the cluster's partials: this block writes its slice of [GT,
    // D], each output reading every block's (max, sum, acc) at once
    const int per = (GT * D + splits - 1) / splits;
    const int o_end = min(GT * D, (rank + 1) * per);
    for (int o = rank * per + tid; o < o_end; o += kThreads) {
      const int g = o / D;
      float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < splits) {
          pm[r] = *cluster.map_shared_rank(bm + g, r);
          pl[r] = *cluster.map_shared_rank(bl + g, r);
          pa[r] = *cluster.map_shared_rank(bacc + o, r);
        }
      }
      float mx = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (r < splits) mx = fmaxf(mx, pm[r]);
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < splits) {
          const float wt = expf(pm[r] - mx);
          a = fmaf(pa[r], wt, a);
          sum = fmaf(pl[r], wt, sum);
        }
      }
      if (h0 + g < G) store(ob + (size_t)h0 * D + o, a / fmaxf(sum, 1e-30f));
    }
    cluster.sync();  // the peers are done reading this block's partial
  }
}

}  // namespace attn
