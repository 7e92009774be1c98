// Device routines shared by the attention kernels of this package.
//
// Semantics are those of crowdllama_tpu_torch/ops/attention.py: logits are
// dot(q, k) * scale, optionally softcapped (cap * tanh(s / cap)), masked to
// NEG_INF; an fp32 online softmax (running max m, denominator l) carries
// across key tiles; a row that saw no valid key ends with l == 0, which is
// read as 1, so it outputs zeros and never NaN.  Query head h reads kv head
// h / G.  The head dim DH is a template parameter of every routine; the
// kernels instantiate 64 (TinyLlama), 80 (H2O-Danube-1.8B), 96, 128
// (Llama-3, Mistral, Qwen, Gemma-2-27b) and 256 (Gemma-2-9b and -2b; the
// fp32 entries stay at 64, 128 and 256) and their C entries dispatch on it
// (the wrappers refuse other dims).  Int8 K/V come with per-key fp32
// scales: the K scale multiplies the score after `scale`, before the
// softcap; the V scale multiplies the probability after it was added to l,
// so only the output sum sees it (ops/pallas/paged.py _decode_kernel,
// _chunk_kernel).
//
// Two ways to attend query rows to key tiles:
//
// - Decode rows (kernels B, D, F and C's decode blocks): the split-KV
//   decode stages of decode_common.cuh, fp32 FMAs on the CUDA cores.
// - tc_attend, the tensor-core tile (kernel A, and the chunk blocks of
//   kernels C and E).  Bound on the H100: operations, 4 * DH flops per
//   visible (row, key) pair at 989 TF/s bf16; the K/V bytes are read once
//   per block, mostly from L2, and take less time.  Design: a block holds
//   128 (query, head) rows of one kv head, 16 per warp; Q's mma fragments
//   are loaded once per block into registers at Dh 64 and 128; at Dh 256
//   (tc_q_smem) Q's tile stays in shared memory and each k-step re-reads
//   its two fragments with ldmatrix, so a thread's registers hold only its
//   fp32 O (128) and S; key tiles of tc_tile<DH>() keys (128 at Dh 64, 96
//   at Dh 80, 64 at Dh 96 and 128, 32 at Dh 256, so a thread's fp32 S, O
//   and Q fragments fit its registers), gathered from wherever the caller
//   says each 16 keys live (pages of the pool, or a stretch of a
//   contiguous K/V), stream
//   through a three-stage cp.async ring, so two tiles are in flight while
//   one is computed, with one barrier per tile (int8: two, around its
//   conversion); S = Q K^T of a whole tile is mma.sync.m16n8k16 (bf16 in,
//   fp32 accumulate) from ldmatrix fragments into fp32 registers
//   (k-steps of 16 dims in pairs, an ldmatrix.x4 a pair, and at Dh 80 a
//   last odd step from an ldmatrix.x2); row max
//   and sum by quad shuffles; a mask policy (SpanMask for keys whose
//   positions are their indices, PosMask for keys with positions and valid
//   flags of their own) masks only the tiles that cross a live row's view;
//   O rescaled once per tile; P reused in registers as the A operand of O
//   += P V (ldmatrix.trans for V).  Rows are padded in shared memory by 16
//   bytes (144, 176, 208, 272 or 528 bytes: the 8 rows an ldmatrix reads
//   fall on distinct 4-bank groups), so ldmatrix has no bank conflicts.
//   An int8 tile is staged raw (half the bytes) and converted to bf16 in
//   shared memory once per block, exactly (|x| <= 127).
//   Products of bf16 values are exact in the fp32 accumulators; the one
//   rounding the TPU kernel does not make is P in bf16 (it keeps P in
//   fp32), after l's sum and after the V scale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace cla {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float softcap_f(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

__device__ __forceinline__ bool key_visible(int kpos, int qpos, int kv_len,
                                            int window) {
  return kpos < kv_len && kpos <= qpos &&
         (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Opt `kernel` in, once per device, to `bytes` of dynamic shared memory
// (past the 48 KB default; each launcher passes the most any of its
// launches takes).  `done` holds a bit per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The build report of a kernel: the dynamic shared memory it launches with
// (`bytes`) and how many of its blocks of `threads` an SM holds, registers
// and shared memory both, into out[0] and out[1].  The kernel's opt-in is
// set to `max_bytes`, what its launcher opts it in to, so a report never
// lowers it.
template <typename Kernel>
int occupancy(Kernel* kernel, int threads, size_t bytes, size_t max_bytes, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  out[0] = (int)bytes;
  out[1] = blocks;
  return (int)err;
}

// ------------------------------------------------------------------------
// The tensor-core tile.

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // (query, head) rows of a block
constexpr int TC_STAGES = 3;            // tiles in the cp.async ring
constexpr int TC_GROUP = 16;            // keys a caller places together
constexpr float LOG2E = 1.4426950408889634f;

// Keys per staged tile: 8192 / DH rounded down to a multiple of 32
// (PosMask stages a tile by whole warps): 128 at Dh 64, 96 at Dh 80, 64
// at Dh 96 and 128, 32 at Dh 256.  A thread holds TILE / 2 fp32 of S, DH /
// 2 of O and (below Dh 256) DH / 4 words of Q's fragments: 112 at Dh 64,
// 108 at Dh 80, 104 at Dh 96, 128 at Dh 128, and at Dh 256, Q in shared
// memory, 144 (16 of S, 128 of O).  (96-key tiles at Dh 96, 120 of them,
// spilled kernel A's PosMask thread past 255 registers.)
template <int DH>
__host__ __device__ constexpr int tc_tile() {
  static_assert(DH == 64 || DH == 80 || DH == 96 || DH == 128 || DH == 256,
                "head dims 64, 80, 96, 128 and 256");
  return 8192 / DH / 32 * 32;
}

// Does the tile keep Q's fragments in shared memory (re-read by ldmatrix
// at each k-step) rather than in registers?  At Dh 256 they would take 64
// registers a thread beside O's 128.
template <int DH>
__host__ __device__ constexpr bool tc_q_smem() { return DH > 128; }

// bf16 shared-memory row: 16 bytes of padding, so the 8 rows an ldmatrix
// reads start on distinct 4-bank groups (144, 176, 208, 272 or 528 bytes).
template <int DH>
__host__ __device__ constexpr int tc_srow() { return DH + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A 16-byte copy that reads nothing and writes zeros when !valid (src must
// still be a mapped address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Wait until at most the N newest committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8 x 8 matrices: lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Bytes 2i and 2i + 1 of w (signed) as a bf16 pair, exactly.
__device__ __forceinline__ uint32_t i8x2_to_bf16(uint32_t w, int i) {
  return pack_bf16((float)((int)(w << (24 - 16 * i)) >> 24),
                   (float)((int)(w << (16 - 16 * i)) >> 24));
}

// Shared memory of tc_attend's key tiles.  bf16: a ring of TC_STAGES K and
// V tiles [TILE][SROW].  int8: the bf16 K and V tiles the mma reads, a
// ring of raw stages (K, V [TILE][DH] int8, then their bf16 scales), and
// the current tile's scales in fp32.
template <typename T, int DH>
__host__ __device__ constexpr size_t tc_ring_bytes() {
  constexpr size_t TILE = tc_tile<DH>(), SROW = tc_srow<DH>();
  return std::is_same<T, int8_t>::value
             ? TILE * (2 * SROW * 2 + TC_STAGES * (2 * DH + 2 * 2) + 2 * 4)
             : TILE * TC_STAGES * 2 * SROW * 2;
}

// Shared memory of tc_attend: the key tiles, then (tc_q_smem) Q's tile
// [TC_ROWS][SROW] bf16.  At Dh 256: 101,376 + 67,584 bytes on bf16 pools,
// 83,584 + 67,584 on int8.
template <typename T, int DH>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return tc_ring_bytes<T, DH>() + (tc_q_smem<DH>() ? (size_t)TC_ROWS * tc_srow<DH>() * 2 : 0);
}

// Mask policy of keys whose positions are their indices (the paged
// callers): key kpos is seen by the query at qpos when key_visible()
// allows it; the block's live queries sit at q_start .. q_last.
struct SpanMask {
  int q_start, q_last, kv_len, window;

  __device__ __forceinline__ int qpos(int qi) const { return q_start + qi; }
  __device__ __forceinline__ void stage(int, int, int) const {}
  // Does a key of the tile at [base, base + tile) fall outside some live
  // row's view?  (Block-wide; qlo / qhi unused.)
  __device__ __forceinline__ bool edge(int base, int tile, int, int, int) const {
    return base + tile > kv_len || base + tile - 1 > q_start ||
           (window > 0 && base <= q_last - window);
  }
  __device__ __forceinline__ bool visible(int kpos, int, int, int qp) const {
    return key_visible(kpos, qp, kv_len, window);
  }
};

// Mask policy of keys with positions and valid flags of their own (kernel
// A): key j is seen by a query at qpos when kval[j] holds, kpos[j] <= qpos
// and the window allows it (kpos[j] > qpos - window).  Each tile's
// positions and flags are staged beside its K/V stage (plain stores at
// issue time, ordered by the ring's barrier before use), with each warp's
// min and max position and whether all its keys are valid, so a thread can
// tell cheaply whether its live rows see every key of the tile.  Keys at
// or past n_keys are invalid.
template <int TILE>
struct PosMask {
  const int* qpos_row;            // the block's first query's position
  const int* kpos_row;            // key positions [n_keys]
  const unsigned char* kval_row;  // key valid flags [n_keys], or null: all valid
  int n_keys, window;
  int* kpos_s;                    // [TC_STAGES][TILE]
  unsigned char* kval_s;          // [TC_STAGES][TILE]
  int* stats;                     // [TC_STAGES][TILE / 32][3]: min, max, all valid

  static constexpr size_t smem_bytes() {
    return (size_t)TC_STAGES * TILE * (4 + 1) + (size_t)TC_STAGES * (TILE / 32) * 3 * 4;
  }
  __device__ __forceinline__ int qpos(int qi) const { return qpos_row[qi]; }
  __device__ __forceinline__ void stage(int n, int st, int tid) const {
    if (tid >= TILE) return;  // whole warps: TILE is a multiple of 32
    const int j = n * TILE + tid;
    const bool ok = j < n_keys && (!kval_row || kval_row[j]);
    const int p = j < n_keys ? kpos_row[j] : 0;
    kpos_s[st * TILE + tid] = p;
    kval_s[st * TILE + tid] = ok;
    const int all = __all_sync(0xffffffffu, ok);
    const int mn = __reduce_min_sync(0xffffffffu, p), mx = __reduce_max_sync(0xffffffffu, p);
    if ((tid & 31) == 0) {
      int* s = stats + (st * (TILE / 32) + tid / 32) * 3;
      s[0] = mn;
      s[1] = mx;
      s[2] = all;
    }
  }
  // Does some key of stage st's tile fall outside the view of a live row
  // at a position in [qlo, qhi]?  (No live row: qlo > qhi, never.)
  __device__ __forceinline__ bool edge(int, int, int st, int qlo, int qhi) const {
    if (qlo > qhi) return false;
    int mn = INT_MAX, mx = INT_MIN, all = 1;
#pragma unroll
    for (int w = 0; w < TILE / 32; ++w) {
      const int* s = stats + (st * (TILE / 32) + w) * 3;
      mn = min(mn, s[0]);
      mx = max(mx, s[1]);
      all &= s[2];
    }
    return !all || mx > qlo || (window > 0 && mn <= qhi - window);
  }
  __device__ __forceinline__ bool visible(int, int col, int st, int qp) const {
    const int p = kpos_s[st * TILE + col];
    return kval_s[st * TILE + col] && p <= qp && (window <= 0 || p > qp - window);
  }
};

// Attention of one block of 128 (query, head) rows over the keys at
// indices [k_lo, k_hi), all TC_THREADS threads.  Rows are query-major: row
// r is query r / G of the block, at position mask.qpos(r / G), and head r
// % G of the kv head (queries per block: TC_ROWS / G; a group that does
// not divide 128 pads the last rows).  q and out point at the block's
// first query for its first head; queries are q_stride elements apart,
// heads DH.  Queries >= n_queries do not exist (never read or written);
// queries >= q_valid carry no query and are written as zeros.  The caller
// says where the keys live: key 16 g + r (r < 16) is row key_row(g, r) of k
// and v ([rows, DH]) and, on int8, of the scales ks and vs, for g <
// groups, the 8 keys from an r of 0 or 8 on consecutive rows (a tile past
// the groups re-reads group groups - 1, whose keys the mask hides).
// `mask` says which keys a row sees (SpanMask, PosMask).  `smem` holds
// tc_smem_bytes<T, DH>() bytes, 16-byte aligned.
template <typename T, int DH, typename KeyRow, typename Mask>
__device__ __forceinline__ void tc_attend(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    size_t q_stride, int G, int n_queries, int q_valid, const T* __restrict__ k,
    const T* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, KeyRow key_row, int groups, int k_lo, int k_hi,
    const Mask& mask, float scale, float softcap) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  constexpr int TILE = tc_tile<DH>(), SROW = tc_srow<DH>();
  constexpr int NT = TILE / 8;  // S column tiles of 8 keys
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row (and row + 8), column pair

  // This thread's two fragment rows: warp * 16 + gq and that + 8.
  size_t roff[2];
  int qpos[2];
  bool exist[2], live[2];
  int qlo = INT_MAX, qhi = INT_MIN;  // positions of its live rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i, qi = r / G;
    exist[i] = qi < TC_ROWS / G && qi < n_queries;
    live[i] = exist[i] && qi < q_valid;
    qpos[i] = exist[i] ? mask.qpos(qi) : 0;
    roff[i] = (size_t)qi * q_stride + (size_t)(r % G) * DH;
    if (live[i]) {
      qlo = min(qlo, qpos[i]);
      qhi = max(qhi, qpos[i]);
    }
  }
  // Q as the A operand of DH / 16 k-steps of 16 dims, zero on rows without
  // a query: in registers, or (QS) in shared memory, where each k-step's
  // fragment is read back with ldmatrix (row lane % 16, dims (lane / 16) *
  // 8 of the step: the same fragment).
  constexpr bool QS = tc_q_smem<DH>();
  static_assert(!QS || DH % 32 == 0, "Q's tile in shared memory takes k-steps in pairs");
  uint32_t qf[QS ? 1 : DH / 16][4];
  if constexpr (!QS) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 1, col = kk * 16 + 2 * tq + (e >> 1) * 8;
        qf[kk][e] = live[i] ? *reinterpret_cast<const uint32_t*>(q + roff[i] + col) : 0u;
      }
    }
  }
  __nv_bfloat16* const Qs =
      reinterpret_cast<__nv_bfloat16*>(smem + tc_ring_bytes<T, DH>());
  // Copy Q's tile in (with the first ring stage's group): row r is query r
  // / G, head r % G; rows without a live query are zero-filled.
  auto issue_q = [&]() {
    for (int c = tid; c < TC_ROWS * (DH / 8); c += TC_THREADS) {
      const int r = c / (DH / 8), col = (c % (DH / 8)) * 8, qi = r / G;
      const bool ok = qi < TC_ROWS / G && qi < n_queries && qi < q_valid;
      cp_async16_zfill(Qs + r * SROW + col,
                       ok ? q + (size_t)qi * q_stride + (size_t)(r % G) * DH + col : q, ok);
    }
  };

  float o[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  constexpr size_t TILE_B = (size_t)TILE * SROW * 2;  // one bf16 K or V tile
  __nv_bfloat16* const tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* const raw = reinterpret_cast<int8_t*>(smem + 2 * TILE_B);
  __nv_bfloat16* const raw_sc =
      reinterpret_cast<__nv_bfloat16*>(raw + (size_t)TC_STAGES * 2 * TILE * DH);
  float* const KSc = reinterpret_cast<float*>(raw_sc + (size_t)TC_STAGES * 2 * TILE);
  float* const VSc = KSc + TILE;

  // Start the copies of key tile n into ring stage `stage`.
  auto issue = [&](int n, int stage) {
    const int g0 = n * (TILE / TC_GROUP);
    if constexpr (!Q8) {
      __nv_bfloat16* kd = tiles + (size_t)stage * 2 * TILE * SROW;
      __nv_bfloat16* vd = kd + (size_t)TILE * SROW;
#pragma unroll
      for (int c = tid; c < TILE * (DH / 8); c += TC_THREADS) {
        const int r = c / (DH / 8), col = (c % (DH / 8)) * 8;
        const size_t row = key_row(min(g0 + r / TC_GROUP, groups - 1), r % TC_GROUP);
        cp_async16(kd + r * SROW + col, k + row * DH + col);
        cp_async16(vd + r * SROW + col, v + row * DH + col);
      }
    } else {
      int8_t* kd = raw + (size_t)stage * 2 * TILE * DH;
      int8_t* vd = kd + (size_t)TILE * DH;
#pragma unroll
      for (int c = tid; c < TILE * (DH / 16); c += TC_THREADS) {
        const int r = c / (DH / 16), col = (c % (DH / 16)) * 16;
        const size_t row = key_row(min(g0 + r / TC_GROUP, groups - 1), r % TC_GROUP);
        cp_async16(kd + r * DH + col, k + row * DH + col);
        cp_async16(vd + r * DH + col, v + row * DH + col);
      }
      // Scales: 8 keys a copy, two copies a group; K's, then V's.
      if (tid < 2 * (TILE / 8)) {
        const int c = tid % (TILE / 8);
        const size_t row = key_row(min(g0 + c / 2, groups - 1), (c % 2) * 8);
        const bool isv = tid >= TILE / 8;
        __nv_bfloat16* sd = raw_sc + (size_t)(stage * 2 + isv) * TILE;
        cp_async16(sd + c * 8, (isv ? vs : ks) + row);
      }
    }
    mask.stage(n, stage, tid);
  };

  const int t_lo = max(k_lo, 0) / TILE;
  const int ntiles = k_hi > 0 ? (k_hi + TILE - 1) / TILE - t_lo : 0;
  if constexpr (QS) {
    if (ntiles > 0) issue_q();
  }
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < ntiles) issue(t_lo + st, st);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int n = t_lo + it, stage = it % TC_STAGES;
    cp_async_wait<TC_STAGES - 2>();
    // Tile n has landed, from every thread's copies, and every warp is
    // done with tile n - 1: its stage takes tile n + TC_STAGES - 1.
    __syncthreads();
    if (it + TC_STAGES - 1 < ntiles)
      issue(n + TC_STAGES - 1, (it + TC_STAGES - 1) % TC_STAGES);
    cp_async_commit();
    const __nv_bfloat16* Ks = tiles;
    if constexpr (Q8) {
      // int8 -> bf16 once per element per block, scales -> fp32.
      const int8_t* kr = raw + (size_t)stage * 2 * TILE * DH;
#pragma unroll
      for (int c = tid; c < 2 * TILE * (DH / 16); c += TC_THREADS) {
        const uint4 w = *reinterpret_cast<const uint4*>(kr + c * 16);
        // c covers K rows then V rows, DH / 16 chunks of 16 a row.
        uint4* d = reinterpret_cast<uint4*>(tiles + (size_t)(c / (DH / 16)) * SROW +
                                            (c % (DH / 16)) * 16);
        d[0] = make_uint4(i8x2_to_bf16(w.x, 0), i8x2_to_bf16(w.x, 1), i8x2_to_bf16(w.y, 0),
                          i8x2_to_bf16(w.y, 1));
        d[1] = make_uint4(i8x2_to_bf16(w.z, 0), i8x2_to_bf16(w.z, 1), i8x2_to_bf16(w.w, 0),
                          i8x2_to_bf16(w.w, 1));
      }
      const __nv_bfloat16* sc = raw_sc + (size_t)stage * 2 * TILE;
      if (tid < TILE) {
        KSc[tid] = __bfloat162float(sc[tid]);
        VSc[tid] = __bfloat162float(sc[TILE + tid]);
      }
      __syncthreads();
    } else {
      Ks = tiles + (size_t)stage * 2 * TILE * SROW;
    }
    const __nv_bfloat16* Vs = Ks + (size_t)TILE * SROW;

    const int base = n * TILE;
    const bool edge = mask.edge(base, TILE, stage, qlo, qhi);

    // S = Q K^T: column tile nt holds keys nt * 8 .. + 7; each ldmatrix
    // brings 32 dims (two k-steps), and at Dh 80 a last ldmatrix.x2 the odd
    // 16.  Every column tile sums its k-steps in ascending order either way.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (!QS) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + (lane & 7)) * SROW + (lane >> 3) * 8;
#pragma unroll
        for (int kk = 0; kk < DH / 32; ++kk) {
          uint32_t b[4];
          ldsm_x4(b, kr + kk * 32);
          mma_16816(s[nt], qf[2 * kk], b[0], b[1]);
          mma_16816(s[nt], qf[2 * kk + 1], b[2], b[3]);
        }
        if constexpr (DH % 32 != 0) {
          uint32_t b[2];
          ldsm_x2(b, kr + (DH - 16));
          mma_16816(s[nt], qf[DH / 16 - 1], b[0], b[1]);
        }
      }
    } else {
      const __nv_bfloat16* qr = Qs + (warp * 16 + (lane & 15)) * SROW + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < DH / 32; ++kk) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, qr + kk * 32);
        ldsm_x4(a1, qr + kk * 32 + 16);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[4];
          ldsm_x4(b, Ks + (nt * 8 + (lane & 7)) * SROW + (lane >> 3) * 8 + kk * 32);
          mma_16816(s[nt], a0, b[0], b[1]);
          mma_16816(s[nt], a1, b[2], b[3]);
        }
      }
    }
    // Logits in log2 units: dot * scale (* K scale), softcap, mask.
    if (softcap > 0.f) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale;
          if constexpr (Q8) x *= KSc[nt * 8 + 2 * tq + (e & 1)];
          s[nt][e] = softcap * tanhf(x / softcap) * LOG2E;
        }
    } else {
      const float scale2 = scale * LOG2E;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale2;
          if constexpr (Q8) x *= KSc[nt * 8 + 2 * tq + (e & 1)];
          s[nt][e] = x;
        }
    }
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * tq + (e & 1);
          if (!mask.visible(base + col, col, stage, qpos[e >> 1])) s[nt][e] = NEG_INF;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
      // A row that has seen no key yet: every logit is NEG_INF, and
      // exp2(NEG_INF - 0) is 0.
      mref[i] = m_new == NEG_INF ? 0.f : m_new;
    }
    // P = exp(S - m) in fp32 into l, then (int8) times the V scale.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(s[nt][e] - mref[i]);
        lsum[i] += p;
        if constexpr (Q8) p *= VSc[nt * 8 + 2 * tq + (e & 1)];
        s[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + lsum[i];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // O += P V: P's accumulator tiles 2kt, 2kt + 1 are the A fragment of
    // keys kt * 16 .. + 15, rounded to bf16.
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      const uint32_t a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      const int mi = lane >> 3;
      const __nv_bfloat16* vr =
          Vs + (kt * 16 + (lane & 7) + (mi & 1) * 8) * SROW + (mi >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vr + dp * 16);
        mma_16816(o[2 * dp], a, b[0], b[1]);
        mma_16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (!exist[i]) continue;
    const float inv = live[i] ? 1.f / (l[i] == 0.f ? 1.f : l[i]) : 0.f;
    __nv_bfloat16* orow = out + roff[i];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * tq) =
          live[i] ? __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv)
                  : __floats2bfloat162_rn(0.f, 0.f);
  }
}

}  // namespace cla
