// Kernel A: causal GQA prefill attention for one (padded) prompt batch.
//
// Replaces crowdllama_tpu/ops/pallas/flash.py flash_prefill_attention
// (_prefill_kernel).  Same function: q [B, T, H, DH], head-major k/v
// [B, Hkv, T, DH], all bf16 (entry flash_prefill, DH 64, 80, 96, 128 or
// 256) or all fp32 (flash_prefill_f32, DH 64, 128 or 256); the mask is
// kpos <= qpos from `positions` [B, T] plus an optional kv_valid [B, T]
// padding mask, softcap and a sliding window (<= 0 disables); fp32 online
// softmax; out [B, T, H, DH].
//
// Bound on the H100: operations for the prompts the engine prefills.  The
// causal work is 4 * H * DH * T(T+1)/2 flops against 2 * T * (H + Hkv) *
// DH * 2 bytes of q/k/v/out: ~240 flop/byte at T = 512 for TinyLlama (H 32,
// Hkv 4, DH 64), ~205 for Llama-3-8B (H 32, Hkv 8, DH 128), just under the
// card's ~295 flop/byte balance point (989 TF/s bf16 over 3.35 TB/s), and
// growing linearly with T.  Design: the tensor-core tile of
// attention_common.cuh (tc_attend: mma.sync products, a three-stage
// cp.async ring of key tiles, P kept in registers), over contiguous key
// rows.  One block per (query block of 128 / G queries, kv head, batch
// row): all G query heads of a kv head share every staged K/V tile, and any
// G up to 8 fits (a G that does not divide 128 pads the block's rows).
// Each block stops its key walk at its query block's causal end (the
// upper triangle is never read or computed, the TPU kernel's causal_rows
// tile skip): the caller guarantees positions[b, t] <= t (arange, or
// arange clamped at plen-1 with kv_valid masking the padding).  Positions
// and valid flags of each key tile are staged beside it (PosMask), and a
// tile is masked only where it holds a key some live row of the thread's
// does not see: an invalid key, a position past the row's, or one the
// window drops.
//
// fp32 (entry flash_prefill_f32: q/k/v and out fp32, the distillation
// trainer's fp32 teacher and student).  The same causal flops against
// twice the bytes: bound by operations, 0.0161 ms at the 67 TF/s of fp32
// FMAs for TinyLlama's 512-token prompt, 0.0065 ms at the 165 TF/s that
// three TF32 products a product leave of the tensor cores' 495.  A single
// TF32 product rounds each operand to 11 significant bits, further than
// the plain fp32 version does; three of them (3xTF32) keep fp32's
// accuracy: each operand x is split into hi = tf32(x) and lo = x - hi
// (truncated to TF32 by the mma), and a product is hi*hi + hi*lo + lo*hi
// in fp32 (the lo*lo term and lo's truncation are below 2^-20 of it).
// Design (prefill_tf_kernel): one block of 4 warps per (64 queries, query
// head, batch row), 16 query rows a warp, the longest key walk launched
// first; Q's tile stays in shared memory and key tiles of 32 K and V
// rows stream through a two-stage cp.async ring beside their positions
// and valid flags; S = Q K^T and O += P V are mma.sync.m16n8k8 TF32 (fp32
// accumulate), each operand split as its fragment is loaded, the small
// terms first; the online softmax runs on the S fragments (row max and sum
// by quad shuffles) and P stays in registers as the A operand of P V.  A
// fragment's k index tq stands for dim (or key) 2 tq and tq + 4 for 2 tq +
// 1, so Q and K fragments are 8-byte loads and an S accumulator pair is a
// P fragment as it is; the rows are padded (K and Q by 8 floats, V by 4)
// so no fragment load has a bank conflict.  A tile is masked only where a
// key is invalid, past a row's position or under a window; the key walk
// stops at the query block's causal end, as the bf16 kernel's does.
// At Dh 256 a warp's O alone would be 128 fp32 registers a thread (16
// rows x 256 columns over 32 lanes), before S, the split fragments and the
// softmax state: the block takes 8 warps, a pair for each 16 rows, and each
// warp of a pair keeps half of O's columns (64 registers, as at Dh 128).
// Both warps of a pair compute the same S = Q K^T and the same online
// softmax (the same inputs in the same order, so the same P), and each
// multiplies P by its half of V: the pair does 1.5x the products of one
// warp holding all of O, for no exchange through shared memory and no
// barrier of its own, and every output element is summed in the order it
// is at Dh 64 and 128.  Shared memory: Q's tile and two 32-key stages,
// 202,256 B, one block a SM.

#include <cstring>

#include "attention_common.cuh"

namespace {

using namespace cla;

// Key 16 g + r of one (batch row, kv head) plane: row plane + 16 g + r of
// k/v viewed as [B * Hkv * T, DH].  Keys past T re-read key T - 1 (never
// past the plane); PosMask marks them invalid.
struct ContigRows {
  size_t plane;
  int T;
  __device__ __forceinline__ size_t operator()(int g, int r) const {
    return plane + min(g * TC_GROUP + r, T - 1);
  }
};

template <int DH>
constexpr size_t prefill_smem_bytes() {
  return tc_smem_bytes<__nv_bfloat16, DH>() + PosMask<tc_tile<DH>()>::smem_bytes();
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ positions,
                     const unsigned char* __restrict__ kv_valid,
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv,
                     float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TILE = tc_tile<DH>();
  const int G = H / Hkv;
  const int qb = TC_ROWS / G;
  const int q0 = blockIdx.x * qb, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * T;

  unsigned char* ms = smem + tc_smem_bytes<__nv_bfloat16, DH>();
  const PosMask<TILE> mask{positions + row0 + q0,
                           positions + row0,
                           kv_valid ? kv_valid + row0 : nullptr,
                           T,
                           window,
                           reinterpret_cast<int*>(ms),
                           ms + (size_t)TC_STAGES * TILE * 4,
                           reinterpret_cast<int*>(ms + (size_t)TC_STAGES * TILE * 5)};
  const int n_queries = T - q0;
  const size_t first = ((row0 + q0) * H + (size_t)h * G) * DH;
  tc_attend<__nv_bfloat16, DH>(smem, q + first, out + first, (size_t)H * DH, G, n_queries,
                               n_queries, k, v, nullptr, nullptr,
                               ContigRows{((size_t)b * Hkv + h) * T, T},
                               (T + TC_GROUP - 1) / TC_GROUP, 0, min(T, q0 + qb), mask,
                               scale, softcap);
}

template <int DH>
int launch_prefill(const void* q, const void* k, const void* v, const int* positions,
                   const unsigned char* kv_valid, void* out, int B, int T, int H, int Hkv,
                   float scale, float softcap, int window, void* stream) {
  static unsigned opted = 0;
  const cudaError_t err = allow_smem(flash_prefill_kernel<DH>, prefill_smem_bytes<DH>(), opted);
  if (err != cudaSuccess) return (int)err;
  const int qb = TC_ROWS / (H / Hkv);
  dim3 grid((T + qb - 1) / qb, Hkv, B);
  flash_prefill_kernel<DH><<<grid, TC_THREADS, prefill_smem_bytes<DH>(), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, positions,
      kv_valid, (__nv_bfloat16*)out, T, H, Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32

constexpr int TF_Q = 64;          // query rows of a block (one query head), 16 a warp
constexpr int TF_K = 32;          // keys of a tile
constexpr int TF_STAGES = 2;
constexpr int TF_INFO = 2 * TF_K + 2;  // a stage's key positions, flags, max, all-valid

// Warps that share a block's 16-row group, each holding DH / tf_cols of
// O's columns: 1, or 2 at Dh 256; the block's threads.
template <int DH>
__host__ __device__ constexpr int tf_cols() { return DH > 128 ? 2 : 1; }
template <int DH>
__host__ __device__ constexpr int tf_threads() { return 128 * tf_cols<DH>(); }

// fp32 row strides: Q and K rows padded by 8 floats, V rows by 4, so the
// fragment loads (Q, K: 8 bytes at row gq, column 2 tq; V: 4 bytes at row
// 2 tq (+1), column gq) fall on distinct banks.
template <int DH>
__host__ __device__ constexpr int tf_krow() { return DH + 8; }
template <int DH>
__host__ __device__ constexpr int tf_vrow() { return DH + 4; }

// Q [TF_Q][krow], then TF_STAGES stages of K [TF_K][krow] and V
// [TF_K][vrow], then each stage's key positions and valid flags [TF_K]
// int32 each, its largest position and whether all its keys are valid.
template <int DH>
__host__ __device__ constexpr size_t tf_smem_bytes() {
  return ((size_t)TF_Q * tf_krow<DH>() + (size_t)TF_STAGES * TF_K * (tf_krow<DH>() + tf_vrow<DH>())) * 4 +
         (size_t)TF_STAGES * TF_INFO * 4;
}

// x = hi + lo for the tensor cores' TF32 products: hi is x rounded to
// TF32's 10 mantissa bits, to nearest with ties away from zero (the
// rounding of cvt.rna.tf32.f32, here as integer operations at full rate);
// lo = x - hi is exact in fp32 and goes to the mma as it is, which reads
// a TF32 operand's top 19 bits (lo truncated toward zero, an error below
// 2^-20 of x).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 accumulate.  Not
// volatile: a pure function of its operands, so the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split for 3xTF32.
struct Tf32Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ Tf32Frag(float a0, float a1, float a2, float a3) {
    tf32_split(a0, hi[0], lo[0]);
    tf32_split(a1, hi[1], lo[1]);
    tf32_split(a2, hi[2], lo[2]);
    tf32_split(a3, hi[3], lo[3]);
  }
};

// d[n] += a * b[n] in 3xTF32 for N column tiles: every tile's lo*hi, then
// every hi*lo, then every hi*hi (the small terms first; N independent
// accumulators between two products of one chain).
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const Tf32Frag& a, const float (&b)[N][2]) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    tf32_split(b[n][0], bh[n][0], bl[n][0]);
    tf32_split(b[n][1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(d[n], a.lo, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(d[n], a.hi, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_1688_tf32(d[n], a.hi, bh[n][0], bh[n][1]);
}

template <int DH>
__global__ void __launch_bounds__(tf_threads<DH>())
prefill_tf_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ positions,
                    const unsigned char* __restrict__ kv_valid, float* __restrict__ out, int T,
                    int H, int Hkv, float scale, float softcap, int window) {
  constexpr int KROW = tf_krow<DH>(), VROW = tf_vrow<DH>();
  constexpr int TF_THREADS = tf_threads<DH>();
  constexpr int OC = DH / tf_cols<DH>();  // O's columns a warp holds
  extern __shared__ __align__(16) unsigned char smem[];
  float* const Qs = reinterpret_cast<float*>(smem);
  float* const ring = Qs + TF_Q * KROW;  // stage st: K at st * (KROW + VROW) * TF_K, then V
  int* const kinfo = reinterpret_cast<int*>(ring + TF_STAGES * TF_K * (KROW + VROW));
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32 % 4, c0 = tid / 128 * OC;  // row group; first O column
  const int gq = lane / 4, tq = lane % 4;
  // The longest key walks first: the last query block is block 0.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TF_Q, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * T;
  const size_t plane = ((size_t)b * Hkv + h / (H / Hkv)) * T;

  // Q's tile (rows past T read row T - 1: their outputs are never stored).
#pragma unroll
  for (int c = tid; c < TF_Q * (DH / 4); c += TF_THREADS) {
    const int r = c / (DH / 4), col = c % (DH / 4) * 4;
    cp_async16(Qs + r * KROW + col, q + ((row0 + min(q0 + r, T - 1)) * H + h) * DH + col);
  }
  // Key tile n into stage st: K and V rows (past T: row T - 1, masked),
  // then their positions and valid flags (plain stores, ordered before use
  // by the ring's barrier) and, from warp 0, the tile's largest position
  // and whether every key is valid.
  auto issue = [&](int n, int st) {
    float* ks = ring + st * TF_K * (KROW + VROW);
    float* vs = ks + TF_K * KROW;
#pragma unroll
    for (int c = tid; c < TF_K * (DH / 4); c += TF_THREADS) {
      const int r = c / (DH / 4), col = c % (DH / 4) * 4;
      const size_t row = (plane + min(n * TF_K + r, T - 1)) * DH + col;
      cp_async16(ks + r * KROW + col, k + row);
      cp_async16(vs + r * VROW + col, v + row);
    }
    if (tid < TF_K) {  // warp 0 (TF_K is a warp)
      const int key = n * TF_K + tid;
      const int p = key < T ? positions[row0 + key] : 0;
      const bool ok = key < T && (!kv_valid || kv_valid[row0 + key]);
      kinfo[st * TF_INFO + tid] = p;
      kinfo[st * TF_INFO + TF_K + tid] = ok;
      const int mx = __reduce_max_sync(0xffffffffu, p), all = __all_sync(0xffffffffu, ok);
      if (tid == 0) {
        kinfo[st * TF_INFO + 2 * TF_K] = mx;
        kinfo[st * TF_INFO + 2 * TF_K + 1] = all;
      }
    }
  };

  // This thread's fragment rows: warp * 16 + gq and that + 8; a row past T
  // sees no key.
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + gq + 8 * i;
    qp[i] = r < T ? positions[row0 + r] : -1;
  }
  // The warp's lowest row position: a tile whose keys are all valid and
  // at or below it, with no window, needs no mask (a row past T, -1,
  // makes every tile masked, which leaves its unstored row at zero).
  const int qmin = __reduce_min_sync(0xffffffffu, min(qp[0], qp[1]));
  float o[OC / 8][4];
#pragma unroll
  for (int dt = 0; dt < OC / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  const int kend = min(T, q0 + TF_Q);  // the causal end (positions[t] <= t)
  const int ntiles = (kend + TF_K - 1) / TF_K;
  issue(0, 0);
  cp_async_commit();
  const float* qa = Qs + (warp * 16 + gq) * KROW + 2 * tq;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % TF_STAGES;
    cp_async_wait<0>();
    // Tile it (and Q) have landed, from every thread's copies, and every
    // warp is done with tile it - 1: its stage takes tile it + 1.
    __syncthreads();
    if (it + 1 < ntiles) issue(it + 1, (it + 1) % TF_STAGES);
    cp_async_commit();
    const float* ks = ring + st * TF_K * (KROW + VROW);
    const float* vs = ks + TF_K * KROW;
    const int* kpos = kinfo + st * TF_INFO;
    const int* kok = kpos + TF_K;
    const bool edge = window > 0 || !kpos[2 * TF_K + 1] || kpos[2 * TF_K] > qmin;

    // S = Q K^T over 4 column tiles of 8 keys; k index tq is dim 2 tq.
    float s[TF_K / 8][4];
#pragma unroll
    for (int nt = 0; nt < TF_K / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DH / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + kk * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * KROW + kk * 8);
      const Tf32Frag a(x0.x, x1.x, x0.y, x1.y);
      float bk[TF_K / 8][2];
#pragma unroll
      for (int nt = 0; nt < TF_K / 8; ++nt) {
        const float2 y = *reinterpret_cast<const float2*>(ks + (nt * 8 + gq) * KROW + kk * 8 + 2 * tq);
        bk[nt][0] = y.x;
        bk[nt][1] = y.y;
      }
      mma_3xtf32<TF_K / 8>(s, a, bk);
    }

    // Logits in log2 units (scale, softcap), masked on an edge tile;
    // online softmax.
#pragma unroll
    for (int nt = 0; nt < TF_K / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = softcap_f(s[nt][e] * scale, softcap) * LOG2E;
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < TF_K / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nt * 8 + 2 * tq + (e & 1), i = e >> 1;
          const int kp = kpos[j];
          if (!(kok[j] && kp <= qp[i] && (window <= 0 || kp > qp[i] - window))) s[nt][e] = NEG_INF;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < TF_K / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], mref[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      mref[i] = m_new == NEG_INF ? 0.f : m_new;  // no key seen yet: every p is 0
    }
#pragma unroll
    for (int nt = 0; nt < TF_K / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == NEG_INF ? 0.f : exp2f(s[nt][e] - mref[e >> 1]);
        lsum[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + lsum[i];
#pragma unroll
    for (int dt = 0; dt < OC / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V over this warp's columns c0 ..: S's column tile j is the A
    // fragment of keys j * 8 .. + 7 (k index tq is key 2 tq, tq + 4 key
    // 2 tq + 1).
#pragma unroll
    for (int j = 0; j < TF_K / 8; ++j) {
      const Tf32Frag a(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* v0 = vs + (j * 8 + 2 * tq) * VROW + c0 + gq;
#pragma unroll
      for (int d0 = 0; d0 < OC / 8; d0 += 8) {
        float bv[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          bv[n][0] = v0[(d0 + n) * 8];
          bv[n][1] = v0[VROW + (d0 + n) * 8];
        }
        mma_3xtf32<8>(o + d0, a, bv);
      }
    }
  }

  // out = o / l (l == 0 read as 1: a row that saw no key writes zeros).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = q0 + warp * 16 + gq + 8 * i;
    if (r >= T) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    float* orow = out + ((row0 + r) * H + h) * DH + c0 + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < OC / 8; ++dt)
      *reinterpret_cast<float2*>(orow + dt * 8) = make_float2(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
  }
}

template <int DH>
int launch_prefill_f32(const void* q, const void* k, const void* v, const int* positions,
                       const unsigned char* kv_valid, void* out, int B, int T, int H, int Hkv,
                       float scale, float softcap, int window, void* stream) {
  static unsigned opted = 0;
  const cudaError_t err = allow_smem(prefill_tf_kernel<DH>, tf_smem_bytes<DH>(), opted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TF_Q - 1) / TF_Q, H, B);
  prefill_tf_kernel<DH>
      <<<grid, tf_threads<DH>(), tf_smem_bytes<DH>(), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, positions, kv_valid, (float*)out, T, H,
      Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 const int* positions, const unsigned char* kv_valid,
                                 void* out, int B, int T, int H, int Hkv, float scale,
                                 float softcap, int window, int dh, void* stream) {
  switch (dh) {
    case 64:
      return launch_prefill_f32<64>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                    softcap, window, stream);
    case 128:
      return launch_prefill_f32<128>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                     softcap, window, stream);
    case 256:
      return launch_prefill_f32<256>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                     softcap, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* positions, const unsigned char* kv_valid,
                             void* out, int B, int T, int H, int Hkv,
                             float scale, float softcap, int window, int dh,
                             void* stream) {
  switch (dh) {
    case 64:
      return launch_prefill<64>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                softcap, window, stream);
    case 80:
      return launch_prefill<80>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                softcap, window, stream);
    case 96:
      return launch_prefill<96>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                softcap, window, stream);
    case 128:
      return launch_prefill<128>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                 softcap, window, stream);
    case 256:
      return launch_prefill<256>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                 softcap, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory an entry of kernel A (flash_prefill, or
// flash_prefill_f32) launches with at head dim dh (any G), and its blocks
// an SM holds (out[1]).
extern "C" int resources(const char* entry, int dh, int, int* out) {
  if (!strcmp(entry, "flash_prefill_f32")) {
    switch (dh) {
      case 64:
        return occupancy(prefill_tf_kernel<64>, tf_threads<64>(), tf_smem_bytes<64>(),
                         tf_smem_bytes<64>(), out);
      case 128:
        return occupancy(prefill_tf_kernel<128>, tf_threads<128>(), tf_smem_bytes<128>(),
                         tf_smem_bytes<128>(), out);
      case 256:
        return occupancy(prefill_tf_kernel<256>, tf_threads<256>(), tf_smem_bytes<256>(),
                         tf_smem_bytes<256>(), out);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (strcmp(entry, "flash_prefill")) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return occupancy(flash_prefill_kernel<64>, TC_THREADS, prefill_smem_bytes<64>(),
                       prefill_smem_bytes<64>(), out);
    case 80:
      return occupancy(flash_prefill_kernel<80>, TC_THREADS, prefill_smem_bytes<80>(),
                       prefill_smem_bytes<80>(), out);
    case 96:
      return occupancy(flash_prefill_kernel<96>, TC_THREADS, prefill_smem_bytes<96>(),
                       prefill_smem_bytes<96>(), out);
    case 128:
      return occupancy(flash_prefill_kernel<128>, TC_THREADS, prefill_smem_bytes<128>(),
                       prefill_smem_bytes<128>(), out);
    case 256:
      return occupancy(flash_prefill_kernel<256>, TC_THREADS, prefill_smem_bytes<256>(),
                       prefill_smem_bytes<256>(), out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
