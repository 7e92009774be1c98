// The split-KV decode stages shared by the decode kernels of this package:
// kernel B (paged_decode, and F through it) and C's decode rows over the
// paged pool (paged_attention.cu), kernel D over the contiguous cache
// (flash_decode.cu).
//
// One query token per slot.  Bound on the H100: bytes.  Each live key is DH
// K and DH V elements per kv head; a decode row does 4 * DH flops per key
// per query head (G = H / Hkv heads share a key), ~2 flop per byte read,
// far below the ~295 flop/byte at which the tensor cores would bound, so the
// least time is the live KV bytes at 3.35 TB/s and the products stay on the
// CUDA cores.  What the design does about it:
// - Split-KV.  A (slot, kv head) pair's keys are cut into splits of `span`
//   keys (a multiple of DEC_KEYS), one block each, grid (kv heads, slots,
//   splits).  Split s walks the keys [s * span, (s + 1) * span) below the
//   slot's bound and, with a window, from its first visible key; splits
//   with no such key return at once.  The callers' plans come from shapes
//   alone (a paged table's width and page, a contiguous cache's length),
//   never from the lengths, so the host sizes the grid without reading
//   them.
// - The in-launch merge (decode_split).  A slot with one live split writes
//   its output directly.  Otherwise each split writes its fp32 partial
//   (running max m, sum l and the unnormalised DH outputs of each of its G
//   heads) to a scratch buffer, fences, and counts itself in an int32
//   counter per (slot, kv head) row; the block that brings the count to the
//   number of live splits merges them all, reading the partials in split
//   order (never arrival order, so the result is the same every run), writes
//   the output (bf16, or fp32 beside an fp32 cache) and resets the counter
//   to 0.  The wrappers make the scratch and counters once per device: a
//   call launches nothing else.
// - A staged ring (decode_span).  Stages of DEC_KEYS = 64 keys (32 on fp32
//   rows at Dh 256, below; K and V rows found by a key-row policy, keys
//   outside the split's range zero-filled and never read) stream through a
//   DEC_STAGES = 3 deep ring of 16-byte cp.async copies, so two stages load
//   while one is computed.  The paged
//   policy reads the table's page ids one stage ahead of the copies that
//   need them; the contiguous policy addresses its plane directly.  A bf16
//   stage is 16 KB at Dh 64, 20 KB at Dh 80, 24 KB at Dh 96, 32 KB at Dh
//   128 and 64 KB at Dh 256: 53,472, 65,760, 78,048, 102,624 and 200,928 B
//   a block in all (int8: 29,664, 35,808, 41,952, 54,240 and 103,392),
//   room for two blocks a SM below Dh 256, one at Dh 256 on bf16 (two
//   stages in flight are 128 KB a SM, far more than the bytes the card's
//   memory latency needs in flight).  Splits are multiples of
//   64 keys at every head dim and type (a 32-key stage walks two a 64), so
//   the plans of ops/cuda/paged.py and flash.py do not depend on either.
// - Every K and V element is read from shared memory once and used for all
//   G heads of its kv head (the block's 8 warps, whatever G is; G is padded
//   to GP = 4 or 8, a template parameter).  Scores: LPK lanes a key
//   (dec_lanes: 8 at Dh 64 and 128; at Dh 256 16 for GP 4 and 32 for GP 8,
//   so a lane's q slice stays at 64 fp32 registers), each holding a Dh /
//   LPK slice of every head's q in fp32 registers, sum their slices and
//   exchange them in shuffles (lane g ends with head g's dot).  Softmax:
//   warp g takes head g's 64 scores (running max m, sum l, rescale alpha)
//   and writes the probabilities.  P.V: warp w sums keys
//   8w .. 8w + 7 (4w .. 4w + 3 on a 32-key stage) into all heads' outputs
//   for its lane's dec_dims (Dh / 32: 2, 4 or 8), so no FMA chain is
//   longer than 8 a stage; the warps' sums are
//   added in warp order at the end.
// - Head dims 80 and 96 (H2O-Danube-1.8B's 80).  A bf16 row is 10 or 12
//   16-byte loads (int8: 10 or 12 of 8 bytes), which 8 lanes a key do not
//   share evenly: each lane scores whole loads, the first NL % 8 lanes of
//   a key one more than the rest (a lane's q slice is two loads wide, as
//   at Dh 128).  In P.V the first DH / 4 lanes (20 or 24) own 4 output
//   dims each and the others idle.  Nothing is padded in device memory or
//   in the stages: rows keep the pools' exact [.., DH] layout.
//   Three barriers a stage.  Registers: GP 4 kernels below Dh 256 and bf16
//   GP 8 at Dh 64 are held to 128, two blocks a SM.
// - fp32 caches (kernel D beside an fp32 model) stage fp32 rows (twice
//   bf16's bytes: 102,624 and 200,928 B a block at Dh 64 and 128, two
//   blocks a SM at Dh 64, one at 128) and take fp32 queries and write fp32
//   outputs (io_t); the arithmetic is the bf16 path's, fp32 throughout.
//   At Dh 256 a 64-key fp32 stage is 128 KB, so not even two fit a block's
//   227 KB: those stages hold 32 keys (dec_keys; 64 KB, three in the ring,
//   198,864 B a block, one a SM), the softmax warp holds one score a lane
//   instead of two, and the P.V warps sum 4 keys each.  Only the
//   contiguous policy (kernel D) runs them.
// - int8 pools stage their raw bytes (half of bf16's) and their bf16
//   scales; the one thread that reads an element converts it to fp32
//   (exact: |x| <= 127), once per staged tile, through the same scoring
//   and P.V code as bf16.  The K scale goes on the score, the V scale on
//   the probability after l is summed.

#pragma once

#include "attention_common.cuh"

namespace cla {

constexpr int DEC_THREADS = TC_THREADS;  // 8 warps a decode block
constexpr int MAX_SPLITS = 32;  // splits of a (slot, kv head): a lane each in the merge
constexpr int DEC_KEYS = 64;    // keys a decode stage holds (the splits' unit)
constexpr int DEC_STAGES = 3;   // stages in the decode ring
constexpr int DEC_WARPS = DEC_THREADS / 32;

template <typename T>
__host__ __device__ constexpr bool is_q8() { return std::is_same<T, int8_t>::value; }

template <typename T>
__host__ __device__ constexpr bool is_f32() { return std::is_same<T, float>::value; }

// The type of the query and output rows beside a K/V element type T: fp32
// caches take fp32 queries and write fp32 outputs; bf16 and int8 ones
// bf16.
template <typename T>
using io_t = typename std::conditional<is_f32<T>(), float, __nv_bfloat16>::type;

// Blocks a SM a decode kernel's registers are held to: two for GP 4 and
// for bf16 at Dh 64 GP 8; int8 Dh 64 GP 8 and Dh 128 GP 8 need more
// registers than half a SM's.  At Dh 256 a bf16 block's shared memory
// (200,928 B) leaves one a SM, and an int8 block's q slice and 8 output
// dims a head would not fit 128 registers without spills: not held.
template <typename T, int DH, int GP>
__host__ __device__ constexpr int decode_min_blocks() {
  return is_f32<T>() ? (DH == 64 ? 2 : 1)
                     : (DH < 256 && (GP == 4 || (DH == 64 && !is_q8<T>())) ? 2 : 1);
}

// Lanes that score one key together: 8, or at Dh 256 DH * GP / 64 (16 for
// GP 4, 32 for GP 8), so a lane holds DH / LPK dims of each of the GP
// heads' q rows: 64 fp32 registers at Dh 256 (128 at Dh 128 GP 8).
template <int DH, int GP>
__host__ __device__ constexpr int dec_lanes() { return DH <= 128 ? 8 : DH * GP / 64; }

// Output dims a decode lane owns in P.V and the merge: DH / 32 (2, 4 or 8),
// or 4 at Dh 80 and 96, where only the first dec_out_lanes (20 or 24) own
// any.
template <int DH>
__host__ __device__ constexpr int dec_dims() { return DH % 64 == 0 ? DH / 32 : 4; }
template <int DH>
__host__ __device__ constexpr int dec_out_lanes() { return DH / dec_dims<DH>(); }

// Keys a decode stage holds over K/V elements of type T at head dim DH:
// DEC_KEYS, or 32 for fp32 rows at Dh 256 (a 64-key stage there is 128 KB).
template <typename T, int DH>
__host__ __device__ constexpr int dec_keys() { return is_f32<T>() && DH > 128 ? 32 : DEC_KEYS; }

// A decode block's shared memory: the ring of DEC_STAGES stages (K and V
// rows [KEYS][DH], bf16, fp32 or int8, then on int8 pools their bf16 K and
// V scales [KEYS] each); the page id of each 16-key group of each ring
// stage (the paged policy's); the stage's scores S [8][KEYS + 4] and
// probabilities PT [KEYS][GP] fp32 (GP = 4 or 8 heads, sized for 8); each
// head's alpha; a flag word.  Every part is a multiple of 16 bytes.  After
// the last stage the ring holds the warps' output sums [DEC_WARPS][GP][DH]
// fp32.
template <typename T, int DH>
struct DecodeSmem {
  static constexpr int KEYS = dec_keys<T, DH>();  // keys a stage
  static constexpr int GROUPS = KEYS / 16;        // 16-key groups a stage
  static constexpr size_t STAGE =
      2 * (size_t)KEYS * DH * sizeof(T) + (is_q8<T>() ? 2 * KEYS * 2 : 0);
  static constexpr size_t PID_OFF = DEC_STAGES * STAGE;
  static constexpr size_t S_OFF = PID_OFF + align16(DEC_STAGES * GROUPS * 4);
  static constexpr size_t PT_OFF = S_OFF + 8 * (KEYS + 4) * 4;
  static constexpr size_t ALPHA_OFF = PT_OFF + KEYS * 8 * 4;
  static constexpr size_t FLAG_OFF = ALPHA_OFF + 32;
  static constexpr size_t BYTES = FLAG_OFF + 16;
  static_assert(DEC_WARPS * 8 * DH * 4 <= DEC_STAGES * STAGE, "output sums fit the ring");
  static_assert(BYTES <= 232448, "a block's shared memory");

  __device__ static int* pids(unsigned char* smem) {
    return reinterpret_cast<int*>(smem + PID_OFF);
  }
};

template <typename T, int DH>
__host__ __device__ constexpr size_t decode_smem_bytes() {
  return DecodeSmem<T, DH>::BYTES;
}

// Floats of one head's partial in the split scratch: m, l, two pads, then
// the DH unnormalised outputs (16-byte aligned).
template <int DH>
__host__ __device__ constexpr int part_stride() { return DH + 4; }

// Elements N * i .. N * i + N - 1 (N = 2, 4 or 8) of a staged bf16 or
// int8 row as fp32: a decode lane's share of the output dims.
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* row, int i, float (&f)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "a lane owns 2, 4 or 8 dims");
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(row) + (N / 2) * i;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const float2 x = __bfloat1622float2(r2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* row, int i, float (&f)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "a lane owns 2, 4 or 8 dims");
  if constexpr (N == 2) {
    const float2 x = reinterpret_cast<const float2*>(row)[i];
    f[0] = x.x;
    f[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < N / 4; ++e) {
      const float4 x = reinterpret_cast<const float4*>(row)[(N / 4) * i + e];
      f[4 * e] = x.x;
      f[4 * e + 1] = x.y;
      f[4 * e + 2] = x.z;
      f[4 * e + 3] = x.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const int8_t* row, int i, float (&f)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "a lane owns 2, 4 or 8 dims");
  if constexpr (N == 2) {
    const char2 c = reinterpret_cast<const char2*>(row)[i];
    f[0] = (float)c.x;
    f[1] = (float)c.y;
  } else if constexpr (N == 4) {
    const char4 c = reinterpret_cast<const char4*>(row)[i];
    f[0] = (float)c.x;
    f[1] = (float)c.y;
    f[2] = (float)c.z;
    f[3] = (float)c.w;
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(row)[i];
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[4 * j + e] = (float)((int)(w[j] << (24 - 8 * e)) >> 24);
  }
}

// acc / l (l == 0 read as 1) as bf16 into elements N * i .. of a row.
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* row, int i, const float (&acc)[N],
                                          float l) {
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(row) + (N / 2) * i;
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    d2[e] = __floats2bfloat162_rn(acc[2 * e] * inv, acc[2 * e + 1] * inv);
}

// acc / l (l == 0 read as 1) as fp32 into elements N * i .. of a row.
template <int N>
__device__ __forceinline__ void store_vec(float* row, int i, const float (&acc)[N], float l) {
  const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
  for (int e = 0; e < N; ++e) row[N * i + e] = acc[e] * inv;
}

// W consecutive elements of a staged row (bf16: one 16-byte load; fp32:
// two; int8: 8 or 16 bytes) as fp32.
template <int W>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&f)[W]) {
  static_assert(W == 8, "bf16 loads are 16 bytes");
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&f)[W]) {
  static_assert(W == 8, "fp32 loads are two 16-byte loads");
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float4 u = reinterpret_cast<const float4*>(p)[e];
    f[4 * e] = u.x;
    f[4 * e + 1] = u.y;
    f[4 * e + 2] = u.z;
    f[4 * e + 3] = u.w;
  }
}

template <int W>
__device__ __forceinline__ void load_row(const int8_t* p, float (&f)[W]) {
  static_assert(W == 8 || W == 16, "int8 loads are 8 or 16 bytes");
  uint32_t w[W / 4];
  if constexpr (W == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  }
#pragma unroll
  for (int i = 0; i < W / 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * i + e] = (float)((int)(w[i] << (24 - 8 * e)) >> 24);
}

// Key-row policies of decode_span: where the key at position `pos`, row r
// of ring stage `st` (pos = the stage's first position + r), lives, as a
// row of the K/V viewed as [rows, DH] (and of the scales as [rows]), asked
// only for keys in the span's range.  start, land and ahead let a policy
// read what it needs one stage ahead of the copies.

// The paged pool: key pos of the slot sits in its table row's entry pos /
// page, for kv head h, row pos % page of that page.  The page id of each
// 16-key group of each ring stage (a group never straddles a page: pages
// hold multiples of 16 keys) is kept in shared memory (pid_s), -1 for a
// group with no key in range; threads tid < GROUPS read the table one stage
// ahead of the copies, into `next`, so no copy waits on a table read.
struct PageDecodeRows {
  static constexpr int NG = DEC_KEYS / 16;
  const int* trow;  // the slot's table row
  int Hkv, h, page;
  int* pid_s;       // [DEC_STAGES][NG], shared memory
  int next = -1;

  __device__ __forceinline__ int page_of(int n, int g, int k_lo, int k_hi) const {
    const int pos = n * DEC_KEYS + 16 * g;
    return pos < k_hi && pos + 16 > k_lo ? trow[pos / page] : -1;
  }
  // Page ids of the first DEC_STAGES - 1 stages from stage t_lo, and the
  // next stage's read ahead (before the ring's first barrier).
  __device__ __forceinline__ void start(int t_lo, int ntiles, int k_lo, int k_hi, int tid) {
    for (int i = tid; i < (DEC_STAGES - 1) * NG; i += DEC_THREADS)
      pid_s[i] = i / NG < ntiles ? page_of(t_lo + i / NG, i % NG, k_lo, k_hi) : -1;
    if (tid < NG && DEC_STAGES - 1 < ntiles) next = page_of(t_lo + DEC_STAGES - 1, tid, k_lo, k_hi);
  }
  // Step it, before its barrier: the ids read ahead go to the ring slot
  // that stage it + DEC_STAGES - 1 takes.
  __device__ __forceinline__ void land(int it, int tid) {
    if (tid < NG) pid_s[(it + DEC_STAGES - 1) % DEC_STAGES * NG + tid] = next;
  }
  // After stage n + DEC_STAGES - 1 was issued: read stage n + DEC_STAGES's.
  __device__ __forceinline__ void ahead(int n, int it, int ntiles, int k_lo, int k_hi, int tid) {
    if (tid < NG && it + DEC_STAGES < ntiles) next = page_of(n + DEC_STAGES, tid, k_lo, k_hi);
  }
  __device__ __forceinline__ size_t row(int st, int r, int pos) const {
    return ((size_t)pid_s[st * NG + r / 16] * Hkv + h) * page + pos % page;
  }
};

// The contiguous cache: key pos of a (slot, kv head) pair is row plane +
// pos of the cache viewed as [B * Hkv * S, DH] (plane = (b * Hkv + h) * S).
// Nothing to read ahead.
struct ContigDecodeRows {
  size_t plane;

  __device__ __forceinline__ void start(int, int, int, int, int) {}
  __device__ __forceinline__ void land(int, int) {}
  __device__ __forceinline__ void ahead(int, int, int, int, int, int) {}
  __device__ __forceinline__ size_t row(int, int, int pos) const { return plane + pos; }
};

// Decode attention of one slot's query token for the G <= GP query heads
// of a kv head over the slot's keys at positions [k_lo, k_hi) (where
// `rows` says they live; keys seen as key_visible(kpos, qpos, kv_len,
// window) says), in stages of KEYS = dec_keys<T, DH>() keys at positions
// that are multiples of KEYS, by the block's DEC_THREADS threads.  Each staged K
// and V element is read (and, on int8, converted) by one thread and used
// for every head:
// - scores: LPK = dec_lanes<DH, GP>() lanes a key, each holding a DH /
//   LPK slice of all GP heads' q rows in fp32 registers, sum their slice of
//   each head's dot and exchange the sums (lane `sub` < GP ends with head
//   sub's);
// - softmax: warp g < G takes head g's stage scores (online max m, sum l,
//   alpha) and writes the probabilities (times the V scale on int8);
// - P.V: warp w sums keys KPW w .. KPW w + KPW - 1 of the stage (KPW =
//   KEYS / 8) into all GP heads' outputs for its lane's dec_dims<DH>()
//   dims (lanes below dec_out_lanes<DH>()); the warps' sums are added in
//   warp order after the last stage.
// Warp g < G returns head g's running max m, sum l and its lane's
// dec_dims<DH>() unnormalised output dims (m = NEG_INF, l = 0 when no key
// was seen; nothing on lanes past dec_out_lanes<DH>()).
// q_row points at head 0 of the kv head ([G][DH]).
template <typename T, int DH, int GP, typename Rows>
__device__ __forceinline__ void decode_span(unsigned char* smem,
                                            const io_t<T>* __restrict__ q_row,
                                            const T* __restrict__ pool_k,
                                            const T* __restrict__ pool_v,
                                            const __nv_bfloat16* __restrict__ k_scale,
                                            const __nv_bfloat16* __restrict__ v_scale,
                                            Rows rows, int G, int qpos, int kv_len, int window,
                                            int k_lo, int k_hi, float scale, float softcap,
                                            float& m, float& l,
                                            float (&acc)[dec_dims<DH>()]) {
  using S = DecodeSmem<T, DH>;
  constexpr int KEYS = S::KEYS;                    // keys a stage
  constexpr bool Q8 = is_q8<T>();
  constexpr int N = dec_dims<DH>();                // output dims a lane owns
  constexpr int OL = dec_out_lanes<DH>();          // lanes that own them
  constexpr int LPK = dec_lanes<DH, GP>();         // lanes a key
  constexpr int W = Q8 ? (DH / LPK < 16 ? 8 : 16) : 8;  // elements a load
  constexpr int NL = DH / W;                       // loads a row
  constexpr int NSEG = (NL + LPK - 1) / LPK;       // loads a lane a key, at most
  constexpr int DPL = NSEG * W;                    // q dims a lane holds a head
  static_assert(DH % W == 0, "whole loads a row");
  constexpr int KPP = DEC_THREADS / LPK;           // keys a score pass
  constexpr int SS = KEYS + 4;                     // S row stride (conflict-free writes)
  constexpr int KPW = KEYS / DEC_WARPS;            // P.V keys a warp
  constexpr int SPL = KEYS / 32;                   // a softmax lane's scores
  static_assert(KEYS % KPP == 0 && KPW % 4 == 0 && LPK >= GP && LPK <= 32 && SPL >= 1,
                "stage shape");
  // The paged policy reads its page ids in 64-key stages.
  static_assert(KEYS == DEC_KEYS || std::is_same<Rows, ContigDecodeRows>::value,
                "short stages run over the contiguous cache only");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % LPK, kq = tid / LPK;  // place in its key's lane group; key of the pass
  // Segment i of this lane's dims starts at element seg(i): the LPK lanes
  // of a key read LPK consecutive pieces of its row (8 lanes, 128 bytes, a
  // load phase on bf16).
  auto seg = [&](int i) { return (i * LPK + sub) * W; };
  // Does this lane take load i of its key?  (All do but at Dh 80 and 96,
  // where the last load goes to the first NL % LPK lanes.)
  auto has = [&](int i) { return NL % LPK == 0 || i * LPK + sub < NL; };

  float* const Ssm = reinterpret_cast<float*>(smem + S::S_OFF);
  float* const PT = reinterpret_cast<float*>(smem + S::PT_OFF);
  float* const alpha_s = reinterpret_cast<float*>(smem + S::ALPHA_OFF);
  const int t_lo = k_lo / KEYS;
  const int ntiles = k_hi > k_lo ? (k_hi + KEYS - 1) / KEYS - t_lo : 0;
  rows.start(t_lo, ntiles, k_lo, k_hi, tid);
  // Heads past G keep P = 0 and alpha = 1.
  for (int i = tid; i < KEYS * GP; i += DEC_THREADS) PT[i] = 0.f;
  if (tid < GP) alpha_s[tid] = 1.f;

  // This lane's slice of every head's q row, fp32 (zeros past G).
  float qr[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < NSEG; ++i) {
      float f[8];
#pragma unroll
      for (int c = 0; c < W; c += 8) {
        if (g < G && has(i)) {
          load_row<8>(q_row + (size_t)g * DH + seg(i) + c, f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[g][i * W + c + e] = f[e];
      }
    }
  float o[GP][N];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < N; ++e) o[g][e] = 0.f;
  m = NEG_INF;
  l = 0.f;

  // Start the copies of stage n (keys n * KEYS ..) into ring slot st.
  auto issue = [&](int n, int st) {
    T* kd = reinterpret_cast<T*>(smem + (size_t)st * S::STAGE);
    T* vd = kd + (size_t)KEYS * DH;
    const int base = n * KEYS;
    constexpr int C = DH * (int)sizeof(T) / 16;  // 16-byte chunks a row
    constexpr int E = 16 / (int)sizeof(T);       // elements a chunk
    for (int c = tid; c < KEYS * C; c += DEC_THREADS) {
      const int r = c / C, col = (c % C) * E, pos = base + r;
      const bool in = pos >= k_lo && pos < k_hi;
      const size_t row = in ? rows.row(st, r, pos) : 0;
      cp_async16_zfill(kd + r * DH + col, pool_k + row * DH + col, in);
      cp_async16_zfill(vd + r * DH + col, pool_v + row * DH + col, in);
    }
    if constexpr (Q8) {
      // Scales: 8 keys a copy (a page holds a multiple of 16), K's then V's.
      __nv_bfloat16* sd = reinterpret_cast<__nv_bfloat16*>(vd + (size_t)KEYS * DH);
      for (int c = tid; c < 2 * (KEYS / 8); c += DEC_THREADS) {
        const int g = c % (KEYS / 8), pos = base + 8 * g;
        const bool isv = c >= KEYS / 8, in = pos + 7 >= k_lo && pos < k_hi;
        const size_t row = in ? rows.row(st, 8 * g, pos) : 0;
        cp_async16_zfill(sd + isv * KEYS + 8 * g, (isv ? v_scale : k_scale) + row, in);
      }
    }
  };

  __syncthreads();  // the first stages' page ids
#pragma unroll
  for (int st = 0; st < DEC_STAGES - 1; ++st) {
    if (st < ntiles) issue(t_lo + st, st);
    cp_async_commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int n = t_lo + it, st = it % DEC_STAGES;
    cp_async_wait<DEC_STAGES - 2>();
    rows.land(it, tid);
    // Stage n has landed, from every thread's copies, and every warp is
    // done with stage n - 1: its ring slot takes stage n + DEC_STAGES - 1,
    // whose page ids were just stored.
    __syncthreads();
    if (it + DEC_STAGES - 1 < ntiles)
      issue(n + DEC_STAGES - 1, (it + DEC_STAGES - 1) % DEC_STAGES);
    cp_async_commit();
    rows.ahead(n, it, ntiles, k_lo, k_hi, tid);
    const T* Ks = reinterpret_cast<const T*>(smem + (size_t)st * S::STAGE);
    const T* Vs = Ks + (size_t)KEYS * DH;
    const __nv_bfloat16* sc8 = reinterpret_cast<const __nv_bfloat16*>(Vs + (size_t)KEYS * DH);
    const int base = n * KEYS;

    // Scores: key kq + KPP * p of the stage, this lane's slice.
#pragma unroll
    for (int p = 0; p < KEYS / KPP; ++p) {
      const int j = kq + KPP * p;
      float d[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) d[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NSEG; ++i) {
        if (!has(i)) continue;
        float k[W];
        load_row<W>(Ks + j * DH + seg(i), k);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < W; ++e) d[g] = fmaf(qr[g][i * W + e], k[e], d[g]);
      }
      // Lane sub < GP ends with head sub's dot: add across lane groups of
      // GP first, then halve the heads each step.
#pragma unroll
      for (int hw = LPK / 2; hw >= GP; hw /= 2)
#pragma unroll
        for (int g = 0; g < GP; ++g) d[g] += __shfl_xor_sync(0xffffffffu, d[g], hw);
#pragma unroll
      for (int hw = GP / 2; hw >= 1; hw /= 2) {
        const bool up = sub & hw;
#pragma unroll
        for (int g = 0; g < hw; ++g) {
          const float give = up ? d[g] : d[g + hw];
          d[g] = (up ? d[g + hw] : d[g]) + __shfl_xor_sync(0xffffffffu, give, hw);
        }
      }
      if (sub < G) {
        const int pos = base + j;
        float x = d[0] * scale;
        if constexpr (Q8) x *= __bfloat162float(sc8[j]);
        Ssm[sub * SS + j] = pos >= k_lo && pos < k_hi && key_visible(pos, qpos, kv_len, window)
                                ? softcap_f(x, softcap)
                                : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax of head `warp` over the stage: keys lane + 32 i.
    if (warp < G) {
      float sv[SPL];
#pragma unroll
      for (int i = 0; i < SPL; ++i) sv[i] = Ssm[warp * SS + lane + 32 * i];
      float mx = sv[0];
#pragma unroll
      for (int i = 1; i < SPL; ++i) mx = fmaxf(mx, sv[i]);
      const float m_new = fmaxf(m, warp_max(mx));
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < SPL; ++i) sv[i] = sv[i] == NEG_INF ? 0.f : expf(sv[i] - m_new);
      float ps = sv[0];
#pragma unroll
      for (int i = 1; i < SPL; ++i) ps += sv[i];
      l = l * alpha + warp_sum(ps);
      m = m_new;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        if constexpr (Q8)  // the V scale after l's sum
          PT[(lane + 32 * i) * GP + warp] = sv[i] * __bfloat162float(sc8[KEYS + lane + 32 * i]);
        else
          PT[(lane + 32 * i) * GP + warp] = sv[i];
      }
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    // P.V: keys KPW * warp .. of the stage into every head's dims.
    {
      float al[GP];
#pragma unroll
      for (int g = 0; g < GP; g += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(alpha_s + g);
        al[g] = a4.x;
        al[g + 1] = a4.y;
        al[g + 2] = a4.z;
        al[g + 3] = a4.w;
      }
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < N; ++e) o[g][e] *= al[g];
#pragma unroll
      for (int jj = 0; jj < KPW; ++jj) {
        if (lane >= OL) break;  // lanes that own no dims (Dh 80 and 96)
        const int j = KPW * warp + jj;
        float v[N];
        load_vec<N>(Vs + j * DH, lane, v);
#pragma unroll
        for (int g = 0; g < GP; g += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(PT + j * GP + g);
          const float pg[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < N; ++e) o[g + u][e] = fmaf(pg[u], v[e], o[g + u][e]);
        }
      }
    }
  }

  // The warps' output sums through the ring, added in warp order.
  cp_async_wait<0>();
  __syncthreads();
  float* const sums = reinterpret_cast<float*>(smem);  // [DEC_WARPS][GP][DH]
#pragma unroll
  for (int g = 0; g < GP; ++g)
    if (g < G && lane < OL)
#pragma unroll
      for (int e = 0; e < N; ++e) sums[((size_t)warp * GP + g) * DH + lane * N + e] = o[g][e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  if (warp < G && lane < OL)
    for (int w = 0; w < DEC_WARPS; ++w)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += sums[((size_t)w * GP + warp) * DH + lane * N + e];
}

// Block (x, y, s) of a split-KV decode grid (x: the kv head, with the rank
// under kernel F; y: the slot): split s of the (slot, kv head) pair `row` =
// y * gridDim.x + x, whose query token (q_row: head 0 of the kv head,
// [G][DH]) sits at position len - 1 and sees the keys below `bound` (those
// that exist) that the window allows, cut into splits of `span` keys (at
// most `splits`, MAX_SPLITS or fewer).  Writes the G heads' outputs (io_t<T>) at
// o_row ([G][DH]; zeros when no key is seen, from split 0).  The row's
// partials live at scratch + row * splits * G * part_stride<DH>() floats,
// its arrival counter at counters[row], zero between launches.
template <typename T, int DH, int GP, typename Rows>
__device__ __forceinline__ void decode_split(unsigned char* smem,
                                             const io_t<T>* __restrict__ q_row,
                                             const T* __restrict__ k, const T* __restrict__ v,
                                             const __nv_bfloat16* __restrict__ ks,
                                             const __nv_bfloat16* __restrict__ vs,
                                             const Rows& rows, io_t<T>* __restrict__ o_row,
                                             float* __restrict__ scratch,
                                             int* __restrict__ counters, int G, int len,
                                             int window, int bound, int span, int splits,
                                             float scale, float softcap) {
  constexpr int N = dec_dims<DH>(), OL = dec_out_lanes<DH>(), PS = part_stride<DH>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, s = blockIdx.z;
  const int qpos = len - 1;
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;  // first key the window sees
  const int s_lo = lo / span, s_hi = (bound + span - 1) / span;  // live splits
  if (s_hi <= s_lo) {  // no key to see (a zero-length slot): zeros, from split 0
    if (s == 0)
      for (int i = threadIdx.x; i < G * DH; i += blockDim.x) o_row[i] = io_t<T>(0.f);
    return;
  }
  if (s < s_lo || s >= s_hi) return;

  float m, l, acc[N];
  decode_span<T, DH, GP>(smem, q_row, k, v, ks, vs, rows, G, qpos, len, window,
                         max(lo, s * span), min(bound, (s + 1) * span), scale, softcap, m, l,
                         acc);
  const bool head = warp < G, owns = lane < OL;
  if (s_hi - s_lo == 1) {  // one live split: no partials
    if (head && owns) store_vec<N>(o_row + (size_t)warp * DH, lane, acc, l);
    return;
  }

  // This split's partial, then count it; the last split to arrive merges.
  const size_t row = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* const part = scratch + row * splits * G * PS;
  if (head) {
    float* p = part + ((size_t)s * G + warp) * PS;
    if (lane == 0) {
      p[0] = m;
      p[1] = l;
    }
    if (owns)
#pragma unroll
      for (int e = 0; e < N; ++e) p[4 + lane * N + e] = acc[e];
  }
  __threadfence();  // the partial is visible device-wide before it is counted
  __syncthreads();
  int* const last = reinterpret_cast<int*>(smem + DecodeSmem<T, DH>::FLAG_OFF);
  if (threadIdx.x == 0) *last = atomicAdd(counters + row, 1) == s_hi - s_lo - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();  // every partial counted before this block's is read after it
  if (threadIdx.x == 0) counters[row] = 0;
  if (!head) return;
  // Merge head `warp` over the live splits (L2 reads: other blocks wrote
  // them).  Lane t holds split s_lo + t's m and l (at most MAX_SPLITS = 32
  // splits); the sums run in split order.
  const int nl = s_hi - s_lo;
  const float* mine = part + ((size_t)s_lo * G + warp) * PS;
  const float m_t = lane < nl ? __ldcg(mine + (size_t)lane * G * PS) : NEG_INF;
  const float l_t = lane < nl ? __ldcg(mine + (size_t)lane * G * PS + 1) : 0.f;
  const float M = warp_max(m_t);
  const float w_t = lane < nl ? expf(m_t - M) : 0.f;
  float L = 0.f, o[N];
#pragma unroll
  for (int e = 0; e < N; ++e) o[e] = 0.f;
#pragma unroll 4
  for (int t = 0; t < nl; ++t) {
    const float w = __shfl_sync(0xffffffffu, w_t, t);
    L += w * __shfl_sync(0xffffffffu, l_t, t);
    const float* p = mine + (size_t)t * G * PS + 4 + lane * N;
    if (owns)
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] += w * __ldcg(p + e);
  }
  if (owns) store_vec<N>(o_row + (size_t)warp * DH, lane, o, L);
}

}  // namespace cla
