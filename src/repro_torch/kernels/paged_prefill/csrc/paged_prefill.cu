// Paged prefill attention for Hopper: the chunk call of paged serving.
// Each row's chunk of C queries attends causally to that row's own live
// K/V pages, read in place through its page table, with an fp32 online
// softmax.
//
// It computes what the plain chunk path computes (the page gather, then
// models/attention.py::attention with q_positions = start + i, kv_len):
// query i of row b sits at position start[b] + i and attends key j where
// j <= start[b] + i and j < kv_lens[b] (and j < maxp * page, the table's
// slots); the scores are scaled, then softcapped (cap * tanh(s / cap))
// where a cap is given, then masked with the same finite NEG_INF.  A row
// with kv_lens == 0 (a row that is not prefilling: start 0, chunk length
// 0) writes zeros, as the decode kernels do; the plain path averages such
// a row uniformly, and nobody reads it.  The JAX package's chunk path is
// plain XLA (no Pallas kernel), so this kernel has no TPU counterpart.
//
// Bound: at the chat cell's chunk call, memory.  A call must read each
// prefilling row's live K and V pages once, q once, and write o once;
// 4 * D operations per (query head, attended key) pair.  Nothing is
// gathered into a dense tensor and no logits tensor is written: the
// plain path copies every row's whole table (maxp * page slots) and
// writes fp32 logits over all of them.
//
// Grid: one block per (tile of query rows, kv head, row b), the tiles of
// the latest positions first.  The G query heads that share a kv head are
// packed along the tile's rows: tile row r is (position r / G, head r %
// G), so each K/V tile is loaded once for all G heads, and the causal edge
// rises with r.  A tile's rows at positions i_first .. i_last attend keys
// [0, min(kv_len, start + i_last + 1)); keys below min(kv_len, start +
// i_first + 1) are attended by every row of the tile, so only the tiles
// past that edge (the last one or two) test the mask.  Keys at or past
// the tile's end are zero-filled in shared memory, not only masked, so a
// stale or padded slot never reaches P V.
//
// bf16: tensor cores (paged_prefill_wgmma_kernel), the flash prefill
// kernel's design (flash_attention.cu, helpers in include/wgmma.cuh).
// One warpgroup per 64-row tile; Q copied once into shared memory; K and
// V tiles of 64 keys through a two-stage cp.async ring, each key's row of
// D elements fetched at pool[table[b, j / page], j % page, hk] (16-byte
// chunks); 128-byte swizzled panels; S = Q K^T and O += P V on wgmma
// m64n64k16 with fp32 accumulators; P rounded to bf16 in registers
// before P V (as the flash kernel does, held to the bf16 tolerance); O
// divided by max(l, 1e-30) at the end.  A D that is a multiple of 8 but
// not of 16 is zero-filled to 16.
//
// f32: CUDA cores (paged_prefill_f32_kernel), the flash kernel's f32
// route with the same packed rows and paged loads, so the f32 route stays
// within 2e-5 of the plain version (TF32 would not).  It is not built
// for speed.
//
// C interface (bound with ctypes): paged_prefill_fwd returns the
// cudaError_t of the launch; dtype 0 = float32, 1 = bfloat16.  q and out
// are read and written through their (b, s, h) strides in elements (the
// last dim contiguous, rows 16-byte aligned); the pools are contiguous
// [P, page, Hkv, D]; table is [B, maxp] int32; start is read at
// start[b * start_stride]; kv_lens is [B] int32.  D is a multiple of 8,
// at most 256 (the wrapper checks all of it).
#include <cstdint>

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* table;
  const int* start;
  const int* kv_lens;
  long long qb, qs, qh;  // q strides (elements)
  long long ob, os, oh;  // out strides
  long long start_stride;
  int C, G, Hkv, D, page, maxp;
  float scale, softcap;
};

// the tile's view of row b and kv head hk: the packed rows, the keys they
// attend, and where each row's query starts
struct Tile {
  int row0;      // first packed row (position row0 / G)
  int rows;      // C * G packed rows of (b, hk)
  int kv_len;    // min(kv_lens[b], maxp * page)
  int start;     // position of the chunk's first query
  int kv_end;    // keys the tile reads: [0, kv_end)
  int unmasked;  // keys every row of the tile attends: [0, unmasked)
};

__device__ __forceinline__ Tile tile_of(const Args& a, int row0, int nrows,
                                        int b) {
  Tile t;
  t.row0 = row0;
  t.rows = a.C * a.G;
  t.kv_len = min(a.kv_lens[b], a.maxp * a.page);
  t.start = a.start[b * a.start_stride];
  const int i_last = min(a.C - 1, (row0 + nrows - 1) / a.G);
  t.kv_end = min(t.kv_len, t.start + i_last + 1);
  t.unmasked = min(t.kv_len, t.start + row0 / a.G + 1);
  return t;
}

// keys [0, lim) of packed row R: min(kv_len, its position + 1); a row past
// the chunk takes the last position's (it is never written)
__device__ __forceinline__ int row_limit(const Args& a, const Tile& t,
                                         int R) {
  return min(t.kv_len, t.start + min(R / a.G, a.C - 1) + 1);
}

// element offset of packed row R (position R / G, head R % G of the kv
// head's group) in a [B, C, Hq, D] tensor already offset to (b, hk * G)
__device__ __forceinline__ long long row_offset(int R, int G, long long s,
                                                long long h) {
  return (long long)(R / G) * s + (long long)(R % G) * h;
}

// element offset of key j of kv head hk in a [P, page, Hkv, D] pool
__device__ __forceinline__ long long key_offset(const Args& a,
                                                const int* trow, int j,
                                                int hk) {
  const int pid = __ldg(trow + j / a.page);
  return (((long long)pid * a.page + j % a.page) * a.Hkv + hk) * a.D;
}

// zeros into the tile's rows of the output (a row with kv_len == 0)
template <typename T>
__device__ __forceinline__ void zero_rows(T* ob, const Args& a, int row0,
                                          int nrows, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = a.D / kVec;
  const int rows = a.C * a.G;
  for (int i = threadIdx.x; i < nrows * nvec; i += nthreads) {
    const int r = i / nvec;
    const int R = row0 + r;
    if (R < rows)
      *reinterpret_cast<uint4*>(ob + row_offset(R, a.G, a.os, a.oh) +
                                (i - r * nvec) * kVec) = make_uint4(0, 0, 0, 0);
  }
}

// --- f32: the CUDA-core route -------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;  // 16 x 16

// shared memory of one block (floats): qT [D][BQ+1], kT [D][BK+1],
// v [BK][D], p [BQ][BK+1]
__host__ __device__ inline size_t smem_floats(int BQ, int BK, int D) {
  return (size_t)D * (BQ + 1) + (size_t)D * (BK + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1);
}

template <int BQ, int BK, int MAXD>
__global__ void __launch_bounds__(kThreads)
paged_prefill_f32_kernel(Args a) {
  constexpr int RQ = BQ / 16;    // score / acc rows per thread
  constexpr int RK = BK / 16;    // score columns per thread
  constexpr int RD = MAXD / 16;  // acc columns per thread
  constexpr int kVec = 4;

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const Tile tl = tile_of(a, (gridDim.x - 1 - blockIdx.x) * BQ, BQ, b);
  const int D = a.D;
  float* ob = static_cast<float*>(a.out) + b * a.ob +
              (long long)hk * a.G * a.oh;
  if (tl.kv_len <= 0) {
    zero_rows(ob, a, tl.row0, BQ, kThreads);
    return;
  }
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 * i
  const int tc = tid & 15;  // columns tc + 16 * j

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* v_s = smem;              // [BK][D] (16-byte aligned rows)
  float* qT = v_s + BK * D;       // [D][BQ + 1]
  float* kT = qT + D * (BQ + 1);  // [D][BK + 1]
  float* p_s = kT + D * (BK + 1);  // [BQ][BK + 1]

  const int nvec = D / kVec;
  const float* qb = static_cast<const float*>(a.q) + b * a.qb +
                    (long long)hk * a.G * a.qh;
  const float* kpool = static_cast<const float*>(a.k);
  const float* vpool = static_cast<const float*>(a.v);
  const int* trow = a.table + (long long)b * a.maxp;

  // Q tile, transposed; rows past the chunk are zeros
  for (int i = tid; i < BQ * nvec; i += kThreads) {
    const int r = i / nvec;
    const int d0 = (i - r * nvec) * kVec;
    const int R = tl.row0 + r;
    float x[kVec];
    if (R < tl.rows) {
      attn::unpack16(qb + row_offset(R, a.G, a.qs, a.qh) + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qT[(d0 + e) * (BQ + 1) + r] = x[e];
  }

  float acc[RQ][RD];
  float m[RQ], l[RQ];
  int lim[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = attn::kNegInf;
    l[i] = 0.f;
    lim[i] = row_limit(a, tl, tl.row0 + tr + 16 * i);
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < tl.kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * nvec; i += kThreads) {
      const int c = i / nvec;
      const int d0 = (i - c * nvec) * kVec;
      const bool ok = k0 + c < tl.kv_end;
      const long long off = ok ? key_offset(a, trow, k0 + c, hk) + d0 : 0;
      float x[kVec];
      if (ok) {
        attn::unpack16(kpool + off, x);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) kT[(d0 + e) * (BK + 1) + c] = x[e];
      attn::load16_or_zero(vpool + off, v_s + c * D + d0, ok);
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RQ], kb[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qa[i] = qT[d * (BQ + 1) + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < RK; ++j) kb[j] = kT[d * (BK + 1) + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    // scale, softcap, mask; online softmax over the tile's columns
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = tr + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        x = k0 + tc + 16 * j < lim[i] ? x : attn::kNegInf;
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
    const int kn = min(BK, tl.kv_end - k0);
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

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int R = tl.row0 + tr + 16 * i;
    if (R >= tl.rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = ob + row_offset(R, a.G, a.os, a.oh);
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tc + 16 * j;
      if (d < D) orow[d] = acc[i][j] / den;
    }
  }
}

template <int BQ, int BK, int MAXD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(BQ, BK, a.D);
  auto kern = paged_prefill_f32_kernel<BQ, BK, MAXD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.C * a.G + BQ - 1) / BQ, a.Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// D <= 128: 64 packed rows against 32-key tiles; D <= 256: 32 x 32
cudaError_t dispatch(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 128) return launch<64, 32, 128>(a, B, st);
  return launch<32, 32, 256>(a, B, st);
}

}  // namespace f32

// --- bf16: the tensor-core route ---------------------------------------------

namespace tc {

using namespace wg;

constexpr int kRows = 64;              // packed rows per block (wgmma M)
constexpr int kKeys = 64;              // keys per K/V tile (wgmma N of S)
constexpr int kThreads = 128;          // one warpgroup
constexpr int kPanelBytes = 64 * 128;  // 64 rows of one 128-byte panel

// dynamic shared memory for head dim D: 1024 bytes of slack to align the
// swizzle atoms, then Q and two stages of (K, V), each ceil(D / 64) panels
__host__ __device__ inline size_t smem_bytes(int D) {
  return 1024 + (size_t)5 * ((D + 63) / 64) * kPanelBytes;
}

// the tile's packed Q rows into swizzled panels; rows past the chunk and
// columns in [D, D16) zero-filled
__device__ __forceinline__ void load_q(uint32_t dst, const bf16* qb,
                                       const Args& a, const Tile& t,
                                       int D16) {
  const int nc = D16 / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kRows * nc; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    const int R = t.row0 + r;
    const bool ok = R < t.rows && c * 8 < a.D;
    cp_async16(dst + swizzled<kRows>(r, c),
               ok ? qb + row_offset(R, a.G, a.qs, a.qh) + c * 8 : qb, ok);
  }
}

// keys [k0, k0 + kKeys) of kv head hk into the K and V panels at dk and
// dv, each key's row read through the row's page table; keys at or past
// kv_end and columns in [D, D16) zero-filled
__device__ __forceinline__ void load_kv(uint32_t dk, uint32_t dv,
                                        const bf16* kpool, const bf16* vpool,
                                        const int* trow, const Args& a,
                                        int hk, int k0, int kv_end, int D16) {
  const int nc = D16 / 8;
  for (int i = threadIdx.x; i < kKeys * nc; i += kThreads) {
    const int r = i / nc;
    const int c = i - r * nc;
    const bool ok = k0 + r < kv_end && c * 8 < a.D;
    const long long off = ok ? key_offset(a, trow, k0 + r, hk) + c * 8 : 0;
    const uint32_t at = swizzled<kKeys>(r, c);
    cp_async16(dk + at, kpool + off, ok);
    cp_async16(dv + at, vpool + off, ok);
  }
}

// NP panels of 64 columns: D <= 64 * NP
template <int NP>
__global__ void __launch_bounds__(kThreads)
paged_prefill_wgmma_kernel(Args a) {
  constexpr uint32_t kTile = NP * kPanelBytes;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const Tile tl = tile_of(a, (gridDim.x - 1 - blockIdx.x) * kRows, kRows, b);
  bf16* ob = static_cast<bf16*>(a.out) + b * a.ob + (long long)hk * a.G * a.oh;
  if (tl.kv_len <= 0) {
    zero_rows(ob, a, tl.row0, kRows, kThreads);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D16 = (a.D + 15) & ~15;
  const int ksteps = D16 / 16;
  const int n_tiles = (tl.kv_end + kKeys - 1) / kKeys;  // >= 1

  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  // stage s holds K at q_s + kTile (1 + 2 s) and V at q_s + kTile (2 + 2 s)

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qb +
                   (long long)hk * a.G * a.qh;
  const bf16* kpool = static_cast<const bf16*>(a.k);
  const bf16* vpool = static_cast<const bf16*>(a.v);
  const int* trow = a.table + (long long)b * a.maxp;

  // groups 0 (Q and tile 0) and 1 (tile 1, or empty) in flight
  load_q(q_s, qb, a, tl, D16);
  load_kv(q_s + kTile, q_s + 2 * kTile, kpool, vpool, trow, a, hk, 0,
          tl.kv_end, D16);
  cp_async_commit();
  if (n_tiles > 1)
    load_kv(q_s + 3 * kTile, q_s + 4 * kTile, kpool, vpool, trow, a, hk,
            kKeys, tl.kv_end, D16);
  cp_async_commit();

  // the accumulator fragment: this thread holds tile rows rr0 and rr0 + 8
  // (d[4i], d[4i+1] and d[4i+2], d[4i+3]) at columns 8i + 2(lane % 4) and
  // the next one; lim[r]: the keys each of the two rows attends
  const int rr0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int lim[2] = {row_limit(a, tl, tl.row0 + rr0),
                      row_limit(a, tl, tl.row0 + rr0 + 8)};
  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m[2] = {attn::kNegInf, attn::kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of each row's sum

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    const uint32_t k_s = q_s + kTile * (1 + 2 * (t & 1));
    const uint32_t v_s = k_s + kTile;
    cp_async_wait_1();  // tile t has landed (tile t + 1 may be in flight)
    fence_proxy_async();
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

    // scale, softcap, and the mask where a row of the tile stops inside
    // these keys; the new row max over the 4 lanes of a row
    const bool masked = k0 + kKeys > tl.unmasked;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = s[i] * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      if (masked && k0 + 8 * (i >> 2) + c0 + (i & 1) >= lim[r])
        x = attn::kNegInf;
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
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
    if (t + 2 < n_tiles)
      load_kv(k_s, v_s, kpool, vpool, trow, a, hk, k0 + 2 * kKeys, tl.kv_end,
              D16);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = tl.row0 + rr0 + 8 * r;
    if (R >= tl.rows) continue;
    bf16* orow = ob + row_offset(R, a.G, a.os, a.oh);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 2 * r; i < 32; i += 4) {
        const int col = p * 64 + 8 * (i >> 2) + c0;
        if (col < a.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[p][i] * l[r], o[p][i + 1] * l[r]);
      }
  }
}

template <int NP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  auto kern = paged_prefill_wgmma_kernel<NP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.C * a.G + kRows - 1) / kRows, a.Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// one instantiation per count of 64-column panels
cudaError_t dispatch(const Args& a, int B, cudaStream_t st) {
  switch ((a.D + 63) / 64) {
    case 1:
      return launch<1>(a, B, st);
    case 2:
      return launch<2>(a, B, st);
    case 3:
      return launch<3>(a, B, st);
    default:
      return launch<4>(a, B, st);
  }
}

}  // namespace tc

}  // namespace

extern "C" int paged_prefill_fwd(const void* q, const void* k_pool,
                                 const void* v_pool, const int* table,
                                 const int* start, const int* kv_lens,
                                 void* out,
                                 const long long* strides,  // [7]
                                 int B, int C, int Hq, int Hkv, int D,
                                 int page, int maxp, float scale,
                                 float softcap, int dtype, void* stream) {
  if (B == 0 || C == 0) return cudaSuccess;
  if (D > 256 || D % 8 || Hkv <= 0 || Hq % Hkv || page <= 0)
    return cudaErrorInvalidValue;
  // (b, s, h) strides of q, then of out, then start's
  const Args a{q,          k_pool,     v_pool,     out,
               table,      start,      kv_lens,    strides[0],
               strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], C,          Hq / Hkv,
               Hkv,        D,          page,       maxp,
               scale,      softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32::dispatch(a, B, st);
  if (dtype == 1) return tc::dispatch(a, B, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
