// Kernels B, C and E: attention over the paged KV pool, read through the
// page table.
//
// B, paged_decode, replaces crowdllama_tpu/ops/pallas/paged.py
// flash_paged_decode_attention (_decode_kernel): one query token per slot
// over that slot's pages.  The same launch serves kernel F of the TPU
// package (flash_paged_decode_attention_tp): the ranks of a tensor-parallel
// pool that share a device run as one grid, each rank's pointers passed by
// value (Ranks, up to MAX_RANKS).  C, ragged_paged, replaces
// flash_ragged_paged_attention (_ragged_v2_kernel): B decode rows plus one
// prefill chunk cut into query blocks, in one launch.  E, ragged_chunk,
// replaces flash_ragged_chunk_attention (_chunk_kernel): one prefill chunk
// alone over its slot's pages, C's chunk blocks without the decode rows
// (both run the same chunk_block routine).
//
// Pool layout (one layer): [P, Hkv, page, DH] bf16 (DH 64 or 128, a
// template parameter; every C entry takes `dh` and dispatches), or int8 with per-key
// scales [P, Hkv, page] bf16 (the *_i8 entries, the TPU kernels' `quant`
// branch); page id `P - 1` is the engine's dump page and is read like any
// other.  The table is [B, NP] int32.  Masks follow ops/attention.py: a
// key at position kpos is seen by a query at qpos when kpos < kv_len,
// kpos <= qpos and the window allows it (window <= 0 disables; decode's
// qpos is its newest position).
//
// Decode rows (B, and C's decode blocks).  Bound on the H100: bytes.  Each
// live key is DH K and DH V elements per kv head; a decode row does 4 * DH
// flops per key per query head (G = H / Hkv heads share a key), ~2 flop per
// byte read, far below the ~295 flop/byte at which the tensor cores would
// bound, so the least time is the live KV bytes at 3.35 TB/s and the
// products stay on the CUDA cores.  What the design does about it:
// - Split-KV.  B's grid is (ranks x Hkv, B, S): split s of a (slot, kv
//   head) walks the keys of pages [s * PPS, (s + 1) * PPS) below the
//   slot's bound (min(seq_len, NP * page)) and, with a window, from its
//   first visible key; splits with no such key return at once.  PPS and S
//   come from the table width and the page alone (split_plan in
//   ops/cuda/paged.py: 256 keys a split at page 128, at most 32 splits),
//   never from the lengths, so the host sizes the grid without reading
//   them, and a tensor-parallel rank splits each (slot, kv head) exactly as
//   B on the whole pool does: F is bit-equal to B.  At the serving shapes
//   (8 slots, 16 pages of 128) that is 8 x Hkv x 8 blocks, where one block
//   per (slot, kv head) walked up to 16 pages in turn.
// - The in-launch merge.  A slot with one live split writes its output
//   directly.  Otherwise each split writes its fp32 partial (running max m,
//   sum l and the unnormalised DH outputs of each of its G heads) to a
//   scratch buffer, fences, and counts itself in an int32 counter per
//   (slot, rank, kv head); the block that brings the count to the number
//   of live splits merges them all, reading the partials in split order
//   (never arrival order, so the result is the same every run and B's and
//   F's agree), writes bf16 out and resets the counter to 0.  The wrapper
//   makes the scratch and counters once per device: a call launches
//   nothing else.
// - A staged ring.  Stages of DEC_KEYS = 64 keys (K and V rows gathered
//   from the table by position, keys outside the split's range
//   zero-filled) stream through a DEC_STAGES = 3 deep ring of 16-byte
//   cp.async copies, so two stages load while one is computed.  The
//   table's page ids are read one stage ahead of the copies that need
//   them.  A bf16 stage is 16 KB at Dh 64 and 32 KB at Dh 128: 53,472 and
//   102,624 B a block in all (int8: 29,664 and 54,240), room for two blocks
//   a SM at both.
// - Every K and V element is read from shared memory once and used for all
//   G heads of its kv head (the block's 8 warps, whatever G is; G is padded
//   to GP = 4 or 8, a template parameter).  Scores: 8 lanes a key, each
//   holding a Dh / 8 slice of every head's q in fp32 registers, sum their
//   slices and exchange them in 7 shuffles (lane g ends with head g's
//   dot).  Softmax: warp g takes head g's 64 scores (running max m, sum l,
//   rescale alpha) and writes the probabilities.  P.V: warp w sums keys
//   8w .. 8w + 7 into all heads' outputs for its lane's Dh / 32 dims, so
//   no FMA chain is longer than 8 a stage; the warps' sums are added in
//   warp order at the end.  Three barriers a stage.  Registers: GP 4
//   kernels and bf16 GP 8 at Dh 64 are held to 128, two blocks a SM.
// - int8 pools stage their raw bytes (half of bf16's) and their bf16
//   scales; the one thread that reads an element converts it to fp32
//   (exact: |x| <= 127), once per staged tile, through the same scoring
//   and P.V code as bf16.  The K scale goes on the score, the V scale on
//   the probability after l is summed.
// C's decode blocks run the same stages over the whole slot, one split.
//
// Chunk blocks (C's chunk rows, and every block of E): one block per
// (query block of 128 / G queries, kv head), the 128 (query, head) rows of
// the tensor-core tile of attention_common.cuh (tc_attend), which gathers
// its key tiles (128 keys at Dh 64, 64 at Dh 128) from the slot's pages in
// 16-key groups.  Bound on the H100: operations, 4 * DH flops per visible
// (row, key) pair at 989 TF/s bf16 (TinyLlama's 512-row chunk at context
// 1024 moves ~5.8 MB of q, K/V and out, whose time at 3.35 TB/s is about a
// third of the operations' time).  The block walks only the tiles that
// hold a key some live row sees: from the window's start for its first
// query to its causal/validity bound.  With G = 8 a block holds 16
// queries, so a 512-row chunk is 32 x Hkv blocks.  Dynamic shared memory
// is 110,592 bytes at Dh 64 (three bf16 stages of K and V; int8: 88,576)
// and 104,448 at Dh 128 (int8: 85,248), past the 48 KB default: each
// launcher opts its kernel in once per device, as B's does.  The registers
// (a whole tile's fp32 S, O and Q's fragments) hold an SM to one such
// block of 256 threads; C's 8 decode + 32 chunk blocks per kv head thus
// fill the card once and a fraction.

#include <cstring>

#include "attention_common.cuh"

namespace {

using namespace cla;

constexpr int THREADS_C = TC_THREADS;  // 8 warps (C's blocks and B's)
constexpr int MAX_RANKS = 8;   // ranks one B launch takes (kernel F on one device)
constexpr int MAX_SPLITS = 32; // splits of a (slot, kv head): a lane each in the merge
constexpr int DEC_KEYS = 64;   // keys a decode stage holds
constexpr int DEC_STAGES = 3;  // stages in the decode ring
constexpr int DEC_WARPS = THREADS_C / 32;

template <typename T>
__host__ __device__ constexpr bool is_q8() { return std::is_same<T, int8_t>::value; }

// A decode block's shared memory: the ring of DEC_STAGES stages (K and V
// rows [DEC_KEYS][DH], bf16 or int8, then on int8 pools their bf16 K and V
// scales [DEC_KEYS] each); the page id of each 16-key group of each ring
// stage; the stage's scores S [8][DEC_KEYS + 4] and probabilities PT
// [DEC_KEYS][GP] fp32 (GP = 4 or 8 heads, sized for 8); each head's alpha;
// a flag word.  Every part is a multiple of 16 bytes.  After the last
// stage the ring holds the warps' output sums [DEC_WARPS][GP][DH] fp32.
template <typename T, int DH>
struct DecodeSmem {
  static constexpr int GROUPS = DEC_KEYS / 16;  // 16-key groups a stage
  static constexpr size_t STAGE =
      2 * (size_t)DEC_KEYS * DH * sizeof(T) + (is_q8<T>() ? 2 * DEC_KEYS * 2 : 0);
  static constexpr size_t PID_OFF = DEC_STAGES * STAGE;
  static constexpr size_t S_OFF = PID_OFF + align16(DEC_STAGES * GROUPS * 4);
  static constexpr size_t PT_OFF = S_OFF + 8 * (DEC_KEYS + 4) * 4;
  static constexpr size_t ALPHA_OFF = PT_OFF + DEC_KEYS * 8 * 4;
  static constexpr size_t FLAG_OFF = ALPHA_OFF + 32;
  static constexpr size_t BYTES = FLAG_OFF + 16;
  static_assert(DEC_WARPS * 8 * DH * 4 <= DEC_STAGES * STAGE, "output sums fit the ring");
};

// Floats of one head's partial in the split scratch: m, l, two pads, then
// the DH unnormalised outputs (16-byte aligned).
template <int DH>
__host__ __device__ constexpr int part_stride() { return DH + 4; }

// W consecutive elements of a staged row (bf16: one 16-byte load; int8: 8
// or 16 bytes) as fp32.
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

// Decode attention of one slot's query token for the G <= GP query heads
// of kv head h over the slot's keys at positions [k_lo, k_hi) (table row
// `trow`, keys seen as key_visible(kpos, qpos, kv_len, window) says), in
// stages of DEC_KEYS keys at positions that are multiples of DEC_KEYS, by
// the block's THREADS_C threads.  Each staged K and V element is read (and,
// on int8, converted) by one thread and used for every head:
// - scores: 8 lanes a key, each holding a DH / 8 slice of all GP heads' q
//   rows in fp32 registers, sum their slice of each head's dot and
//   exchange the sums (7 shuffles: lane `sub` < GP ends with head sub's);
// - softmax: warp g < G takes head g's stage scores (online max m, sum l,
//   alpha) and writes the probabilities (times the V scale on int8);
// - P.V: warp w sums keys 8w .. 8w + 7 of the stage into all GP heads'
//   outputs for its lane's DH / 32 dims; the warps' sums are added in warp
//   order after the last stage.
// Warp g < G returns head g's running max m, sum l and its lane's DH / 32
// unnormalised output dims (m = NEG_INF, l = 0 when no key was seen).
// q_row points at head 0 of the kv head ([G][DH]).
template <typename T, int DH, int GP>
__device__ __forceinline__ void decode_span(unsigned char* smem,
                                            const __nv_bfloat16* __restrict__ q_row,
                                            const T* __restrict__ pool_k,
                                            const T* __restrict__ pool_v,
                                            const __nv_bfloat16* __restrict__ k_scale,
                                            const __nv_bfloat16* __restrict__ v_scale,
                                            const int* __restrict__ trow, int G, int h, int Hkv,
                                            int page, int qpos, int kv_len, int window,
                                            int k_lo, int k_hi, float scale, float softcap,
                                            float& m, float& l, float (&acc)[DH / 32]) {
  using S = DecodeSmem<T, DH>;
  constexpr bool Q8 = is_q8<T>();
  constexpr int N = DH / 32;                       // output dims a lane owns
  constexpr int DPL = DH / 8;                      // dims a lane scores
  constexpr int W = Q8 ? (DPL < 16 ? DPL : 16) : 8;  // elements a load
  constexpr int NSEG = DPL / W;                    // loads a lane a key
  constexpr int KPP = THREADS_C / 8;               // keys a score pass
  constexpr int SS = DEC_KEYS + 4;                 // S row stride (conflict-free writes)
  constexpr int KPW = DEC_KEYS / DEC_WARPS;        // P.V keys a warp
  static_assert(DEC_KEYS % KPP == 0 && KPW % 4 == 0, "stage shape");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % 8, kq = tid / 8;  // place in its key's lane group; key of the pass
  // Segment i of this lane's dims starts at element seg(i): the 8 lanes of
  // a key read 8 consecutive pieces of its row (128 bytes a load on bf16).
  auto seg = [&](int i) { return (i * 8 + sub) * W; };

  // Page ids of each ring stage's 16-key groups (a group never straddles a
  // page: pages hold multiples of 16 keys), -1 for a group with no key in
  // range.  Threads tid < GROUPS read the table one stage ahead of the
  // copies, into next_pid, so no copy waits on a table read.
  constexpr int NG = S::GROUPS;
  int* const pid_s = reinterpret_cast<int*>(smem + S::PID_OFF);
  float* const Ssm = reinterpret_cast<float*>(smem + S::S_OFF);
  float* const PT = reinterpret_cast<float*>(smem + S::PT_OFF);
  float* const alpha_s = reinterpret_cast<float*>(smem + S::ALPHA_OFF);
  auto page_of = [&](int n, int g) {
    const int pos = n * DEC_KEYS + 16 * g;
    return pos < k_hi && pos + 16 > k_lo ? trow[pos / page] : -1;
  };
  const int t_lo = k_lo / DEC_KEYS;
  const int ntiles = k_hi > k_lo ? (k_hi + DEC_KEYS - 1) / DEC_KEYS - t_lo : 0;
  for (int i = tid; i < (DEC_STAGES - 1) * NG; i += THREADS_C)
    pid_s[i] = i / NG < ntiles ? page_of(t_lo + i / NG, i % NG) : -1;
  int next_pid = -1;
  if (tid < NG && DEC_STAGES - 1 < ntiles) next_pid = page_of(t_lo + DEC_STAGES - 1, tid);
  // Heads past G keep P = 0 and alpha = 1.
  for (int i = tid; i < DEC_KEYS * GP; i += THREADS_C) PT[i] = 0.f;
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
        if (g < G) {
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

  // Start the copies of stage n (keys n * DEC_KEYS ..) into ring slot st,
  // whose page ids are in pid_s.
  auto issue = [&](int n, int st) {
    T* kd = reinterpret_cast<T*>(smem + (size_t)st * S::STAGE);
    T* vd = kd + (size_t)DEC_KEYS * DH;
    const int* pids = pid_s + st * NG;
    const int base = n * DEC_KEYS;
    constexpr int C = DH * (int)sizeof(T) / 16;  // 16-byte chunks a row
    constexpr int E = 16 / (int)sizeof(T);       // elements a chunk
    for (int c = tid; c < DEC_KEYS * C; c += THREADS_C) {
      const int r = c / C, col = (c % C) * E, pos = base + r;
      const bool in = pos >= k_lo && pos < k_hi;
      const size_t row = in ? ((size_t)pids[r / 16] * Hkv + h) * page + pos % page : 0;
      cp_async16_zfill(kd + r * DH + col, pool_k + row * DH + col, in);
      cp_async16_zfill(vd + r * DH + col, pool_v + row * DH + col, in);
    }
    if constexpr (Q8) {
      // Scales: 8 keys a copy (a page holds a multiple of 16), K's then V's.
      __nv_bfloat16* sd = reinterpret_cast<__nv_bfloat16*>(vd + (size_t)DEC_KEYS * DH);
      for (int c = tid; c < 2 * (DEC_KEYS / 8); c += THREADS_C) {
        const int g = c % (DEC_KEYS / 8), pos = base + 8 * g;
        const bool isv = c >= DEC_KEYS / 8, in = pos + 7 >= k_lo && pos < k_hi;
        const size_t row = in ? ((size_t)pids[g / 2] * Hkv + h) * page + pos % page : 0;
        cp_async16_zfill(sd + isv * DEC_KEYS + 8 * g, (isv ? v_scale : k_scale) + row, in);
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
    if (tid < NG) pid_s[(it + DEC_STAGES - 1) % DEC_STAGES * NG + tid] = next_pid;
    // Stage n has landed, from every thread's copies, and every warp is
    // done with stage n - 1: its ring slot takes stage n + DEC_STAGES - 1,
    // whose page ids were just stored.
    __syncthreads();
    if (it + DEC_STAGES - 1 < ntiles)
      issue(n + DEC_STAGES - 1, (it + DEC_STAGES - 1) % DEC_STAGES);
    cp_async_commit();
    if (tid < NG && it + DEC_STAGES < ntiles) next_pid = page_of(n + DEC_STAGES, tid);
    const T* Ks = reinterpret_cast<const T*>(smem + (size_t)st * S::STAGE);
    const T* Vs = Ks + (size_t)DEC_KEYS * DH;
    const __nv_bfloat16* sc8 = reinterpret_cast<const __nv_bfloat16*>(Vs + (size_t)DEC_KEYS * DH);
    const int base = n * DEC_KEYS;

    // Scores: key kq + KPP * p of the stage, this lane's slice.
#pragma unroll
    for (int p = 0; p < DEC_KEYS / KPP; ++p) {
      const int j = kq + KPP * p;
      float d[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) d[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NSEG; ++i) {
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
      for (int hw = 4; hw >= GP; hw /= 2)
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

    // Online softmax of head `warp` over the stage.
    if (warp < G) {
      const float s0 = Ssm[warp * SS + lane], s1 = Ssm[warp * SS + lane + 32];
      const float m_new = fmaxf(m, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m - m_new);
      const float p0 = s0 == NEG_INF ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == NEG_INF ? 0.f : expf(s1 - m_new);
      l = l * alpha + warp_sum(p0 + p1);
      m = m_new;
      if constexpr (Q8) {  // the V scale after l's sum
        PT[lane * GP + warp] = p0 * __bfloat162float(sc8[DEC_KEYS + lane]);
        PT[(lane + 32) * GP + warp] = p1 * __bfloat162float(sc8[DEC_KEYS + lane + 32]);
      } else {
        PT[lane * GP + warp] = p0;
        PT[(lane + 32) * GP + warp] = p1;
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
    if (g < G)
#pragma unroll
      for (int e = 0; e < N; ++e) sums[((size_t)warp * GP + g) * DH + lane * N + e] = o[g][e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  if (warp < G)
    for (int w = 0; w < DEC_WARPS; ++w)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] += sums[((size_t)w * GP + warp) * DH + lane * N + e];
}

// Where the keys of a chunk block's slot live: key 16 g + r sits in table
// entry 16 g / page's page for kv head h, as row r past the group's first
// of the pool viewed as [P * Hkv * page, DH] (and of the scales as [P *
// Hkv * page]); a group never straddles a page (page % 16 == 0).
struct PageRows {
  const int* table;
  int Hkv, h, page;
  __device__ __forceinline__ size_t operator()(int g, int r) const {
    const int pos = g * TC_GROUP;
    return ((size_t)table[pos / page] * Hkv + h) * page + pos % page + r;
  }
};

// Chunk query block jb for kv head h: the chunk's queries jb * QB + i (i <
// QB = 128 / G, below C) at positions ctx + jb * QB + i; the first q_len
// queries of the chunk carry a query, the others are written as zeros.
// The tensor-core tile over the slot's pages `trow` (np of them), from the
// window's start for the block's first query to its causal/validity
// bound.  q and out point at chunk row 0 ([C, H, DH]).  Kernel C runs it
// for its chunk blocks, kernel E for all of its blocks.
template <typename T, int DH>
__device__ __forceinline__ void chunk_block(unsigned char* smem,
                                            const __nv_bfloat16* __restrict__ q,
                                            const T* __restrict__ pool_k,
                                            const T* __restrict__ pool_v,
                                            const __nv_bfloat16* __restrict__ k_scale,
                                            const __nv_bfloat16* __restrict__ v_scale,
                                            const int* __restrict__ trow,
                                            __nv_bfloat16* __restrict__ out, int jb, int C,
                                            int H, int G, int Hkv, int h, int page, int np,
                                            int ctx, int q_len, int kv_len, int window,
                                            float scale, float softcap) {
  const int qb = TC_ROWS / G;
  const int q0 = jb * qb;
  const int q_start = ctx + q0;
  const int q_valid = max(0, min(qb, q_len - q0));
  const int bound = q_valid > 0 ? min(kv_len, q_start + q_valid) : 0;
  const int k_lo = window > 0 ? q_start - window + 1 : 0;
  const size_t first = ((size_t)q0 * H + (size_t)h * G) * DH;
  tc_attend<T, DH>(smem, q + first, out + first, (size_t)H * DH, G, C - q0, q_valid, pool_k,
                   pool_v, k_scale, v_scale, PageRows{trow, Hkv, h, page},
                   np * page / TC_GROUP, k_lo, bound,
                   SpanMask{q_start, q_start + q_valid - 1, kv_len, window}, scale, softcap);
}

// Each rank's operands of a B launch (one rank for B, a device's ranks
// for F), passed by value.
template <typename T>
struct Ranks {
  const __nv_bfloat16* q[MAX_RANKS];  // [B, H, DH]
  const T* k[MAX_RANKS];              // [P, Hkv, page, DH]
  const T* v[MAX_RANKS];
  const __nv_bfloat16* ks[MAX_RANKS];  // [P, Hkv, page] (int8 pools)
  const __nv_bfloat16* vs[MAX_RANKS];
  __nv_bfloat16* out[MAX_RANKS];  // [B, H, DH]
};

// Kernel B: grid (ranks x Hkv, B, splits), THREADS_C threads, for G <= GP
// query heads per kv head (GP 4 or 8: two blocks a SM where the registers
// allow); H and Hkv are one rank's.  The table and seq_lens are shared by the ranks.  scratch
// holds (B x ranks x Hkv) x splits x G partials of part_stride<DH>()
// floats; counters one int32 per (slot, rank, kv head), zero between
// launches.
template <typename T, int DH, int GP>
__global__ void __launch_bounds__(THREADS_C, GP == 4 || (DH == 64 && !is_q8<T>()) ? 2 : 1)
paged_decode_kernel(const Ranks<T> rk, const int* __restrict__ table,
                    const int* __restrict__ seq_lens, float* __restrict__ scratch,
                    int* __restrict__ counters, int H, int Hkv, int page, int np, int pps,
                    int splits, float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = DH / 32, PS = part_stride<DH>();
  const int G = H / Hkv;
  const int rank = blockIdx.x / Hkv, h = blockIdx.x % Hkv, b = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = seq_lens[b], qpos = len - 1;
  const int bound = max(0, min(len, np * page));     // keys that exist in the table
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;  // first key the window sees
  const int span = pps * page;
  const int s_lo = lo / span, s_hi = (bound + span - 1) / span;  // live splits
  const size_t head0 = ((size_t)b * H + (size_t)h * G) * DH;
  __nv_bfloat16* const o_row = rk.out[rank] + head0;
  if (s_hi <= s_lo) {  // no key to see (a zero-length slot): zeros, from split 0
    if (s == 0)
      for (int i = threadIdx.x; i < G * DH; i += blockDim.x) o_row[i] = __float2bfloat16(0.f);
    return;
  }
  if (s < s_lo || s >= s_hi) return;

  float m, l, acc[N];
  decode_span<T, DH, GP>(smem, rk.q[rank] + head0, rk.k[rank], rk.v[rank], rk.ks[rank],
                         rk.vs[rank], table + (size_t)b * np, G, h, Hkv, page, qpos, len,
                         window, max(lo, s * span), min(bound, (s + 1) * span), scale, softcap,
                         m, l, acc);
  const bool head = warp < G;
  if (s_hi - s_lo == 1) {  // one live split: no partials
    if (head) store_vec<N>(o_row + (size_t)warp * DH, lane, acc, l);
    return;
  }

  // This split's partial, then count it; the last split to arrive merges.
  const size_t row = (size_t)b * gridDim.x + blockIdx.x;  // (slot, rank, kv head)
  float* const part = scratch + row * splits * G * PS;
  if (head) {
    float* p = part + ((size_t)s * G + warp) * PS;
    if (lane == 0) {
      p[0] = m;
      p[1] = l;
    }
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
#pragma unroll
    for (int e = 0; e < N; ++e) o[e] += w * __ldcg(p + e);
  }
  store_vec<N>(o_row + (size_t)warp * DH, lane, o, L);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS_C)
ragged_paged_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ table, const int* __restrict__ q_lens,
                    const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
                    int B, int C, int H, int Hkv, int page, int np, int chunk_slot,
                    float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const int nb = blockIdx.x, h = blockIdx.y;

  if (nb < B) {  // decode row nb: its newest position is kv_len - 1
    constexpr int N = DH / 32;
    __nv_bfloat16* o_row = out + (size_t)nb * H * DH + (size_t)h * G * DH;
    if (q_lens[nb] <= 0) {  // inactive slot: zeros, as the TPU kernel writes
      for (int i = threadIdx.x; i < G * DH; i += blockDim.x) o_row[i] = __float2bfloat16(0.f);
      return;
    }
    const int kv_len = kv_lens[nb], qpos = kv_len - 1;
    float m, l, acc[N];
    const __nv_bfloat16* q_row = q + (size_t)nb * H * DH + (size_t)h * G * DH;
    const int* trow = table + (size_t)nb * np;
    const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
    const int bound = max(0, min(kv_len, np * page));
    if (G <= 4)
      decode_span<T, DH, 4>(smem, q_row, pool_k, pool_v, k_scale, v_scale, trow, G, h, Hkv,
                            page, qpos, kv_len, window, lo, bound, scale, softcap, m, l, acc);
    else
      decode_span<T, DH, 8>(smem, q_row, pool_k, pool_v, k_scale, v_scale, trow, G, h, Hkv,
                            page, qpos, kv_len, window, lo, bound, scale, softcap, m, l, acc);
    const int warp = threadIdx.x / 32;
    if (warp < G) store_vec<N>(o_row + (size_t)warp * DH, threadIdx.x % 32, acc, l);
    return;
  }

  // Chunk block nb - B of the chunk rows that follow the B decode rows.
  const int kv_len = kv_lens[B];
  chunk_block<T, DH>(smem, q + (size_t)B * H * DH, pool_k, pool_v, k_scale, v_scale,
                     table + (size_t)chunk_slot * np, out + (size_t)B * H * DH, nb - B, C, H,
                     G, Hkv, h, page, np, kv_len - q_lens[B], q_lens[B], kv_len, window,
                     scale, softcap);
}

// Kernel E: one prefill chunk alone, grid (chunk blocks, kv heads).  The
// context and key lengths are read from device memory (the TPU kernel's
// scalar prefetch), so the host never waits on them; rows j >= kv_len -
// ctx_len carry no query and are written as zeros (the caller drops them).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS_C)
ragged_chunk_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ pages,
                    const int* __restrict__ ctx_len, const int* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out, int C, int H, int Hkv, int page, int np,
                    float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ctx = *ctx_len;
  const int kv = min(*kv_len, np * page);  // never past the slot's pages
  const int q_len = max(0, min(C, kv - ctx));
  chunk_block<T, DH>(smem, q, pool_k, pool_v, k_scale, v_scale, pages, out, blockIdx.x, C, H,
                     H / Hkv, Hkv, blockIdx.y, page, np, ctx, q_len, kv, window, scale,
                     softcap);
}

template <typename T, int DH>
constexpr size_t decode_smem_bytes() {
  return DecodeSmem<T, DH>::BYTES;
}

template <typename T, int DH, int GP>
int launch_decode_gp(const Ranks<T>& rk, int nranks, const int* table, const int* seq_lens,
                     float* scratch, int* counters, int B, int H, int Hkv, int page, int np,
                     int pps, int splits, float scale, float softcap, int window,
                     void* stream) {
  static unsigned opted = 0;
  const cudaError_t err =
      allow_smem(paged_decode_kernel<T, DH, GP>, decode_smem_bytes<T, DH>(), opted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nranks * Hkv, B, splits);
  paged_decode_kernel<T, DH, GP><<<grid, THREADS_C, decode_smem_bytes<T, DH>(),
                                   (cudaStream_t)stream>>>(rk, table, seq_lens, scratch,
                                                           counters, H, Hkv, page, np, pps,
                                                           splits, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_decode(const Ranks<T>& rk, int nranks, const int* table, const int* seq_lens,
                  float* scratch, int* counters, int B, int H, int Hkv, int page, int np,
                  int pps, int splits, float scale, float softcap, int window, void* stream) {
  auto go = H / Hkv <= 4 ? launch_decode_gp<T, DH, 4> : launch_decode_gp<T, DH, 8>;
  return go(rk, nranks, table, seq_lens, scratch, counters, B, H, Hkv, page, np, pps, splits,
            scale, softcap, window, stream);
}

// C's shared memory: the chunk tile's, or a decode block's if that is
// larger.
template <typename T, int DH>
size_t ragged_smem_bytes() {
  const size_t dec = decode_smem_bytes<T, DH>();
  return dec > tc_smem_bytes<T, DH>() ? dec : tc_smem_bytes<T, DH>();
}

template <typename T, int DH>
int launch_ragged(const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
                  const void* v_scale, const int* table, const int* q_lens,
                  const int* kv_lens, void* out, int B, int C, int H, int Hkv, int page,
                  int np, int chunk_slot, float scale, float softcap, int window,
                  void* stream) {
  static unsigned opted = 0;
  const cudaError_t err = allow_smem(ragged_paged_kernel<T, DH>,
                                     ragged_smem_bytes<T, DH>(), opted);
  if (err != cudaSuccess) return (int)err;
  const int qb = TC_ROWS / (H / Hkv);
  dim3 grid(B + (C + qb - 1) / qb, Hkv);
  ragged_paged_kernel<T, DH><<<grid, THREADS_C, ragged_smem_bytes<T, DH>(),
                               (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const T*)pool_k, (const T*)pool_v,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale, table, q_lens, kv_lens,
      (__nv_bfloat16*)out, B, C, H, Hkv, page, np, chunk_slot, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_chunk(const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
                 const void* v_scale, const int* pages, const int* ctx_len, const int* kv_len,
                 void* out, int C, int H, int Hkv, int page, int np, float scale, float softcap,
                 int window, void* stream) {
  static unsigned opted = 0;
  const cudaError_t err =
      allow_smem(ragged_chunk_kernel<T, DH>, tc_smem_bytes<T, DH>(), opted);
  if (err != cudaSuccess) return (int)err;
  const int qb = TC_ROWS / (H / Hkv);
  dim3 grid((C + qb - 1) / qb, Hkv);
  ragged_chunk_kernel<T, DH><<<grid, THREADS_C, tc_smem_bytes<T, DH>(), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const T*)pool_k, (const T*)pool_v,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale, pages, ctx_len, kv_len,
      (__nv_bfloat16*)out, C, H, Hkv, page, np, scale, softcap, window);
  return (int)cudaGetLastError();
}

// B's entries take `nranks` ranks on the calling device (1 for kernel B,
// up to MAX_RANKS for kernel F), each operand a host array of nranks device
// pointers.
template <typename T>
Ranks<T> gather_ranks(int n, const void* const* q, const void* const* pool_k,
                      const void* const* pool_v, const void* const* k_scale,
                      const void* const* v_scale, void* const* out) {
  Ranks<T> rk{};
  for (int i = 0; i < n; ++i) {
    rk.q[i] = (const __nv_bfloat16*)q[i];
    rk.k[i] = (const T*)pool_k[i];
    rk.v[i] = (const T*)pool_v[i];
    rk.ks[i] = k_scale ? (const __nv_bfloat16*)k_scale[i] : nullptr;
    rk.vs[i] = v_scale ? (const __nv_bfloat16*)v_scale[i] : nullptr;
    rk.out[i] = (__nv_bfloat16*)out[i];
  }
  return rk;
}

// The build report of entry `entry` at head dim DH and G query heads per kv
// head (every entry launches THREADS_C threads; B's kernel depends on G
// through GP; attention_common.cuh occupancy).
template <typename T, int DH>
int report_decode(int G, int* out) {
  return G <= 4 ? occupancy(paged_decode_kernel<T, DH, 4>, THREADS_C,
                            decode_smem_bytes<T, DH>(), decode_smem_bytes<T, DH>(), out)
                : occupancy(paged_decode_kernel<T, DH, 8>, THREADS_C,
                            decode_smem_bytes<T, DH>(), decode_smem_bytes<T, DH>(), out);
}

template <int DH>
int report(const char* entry, int G, int* out) {
  using bf = __nv_bfloat16;
  if (!strcmp(entry, "paged_decode")) return report_decode<bf, DH>(G, out);
  if (!strcmp(entry, "paged_decode_i8")) return report_decode<int8_t, DH>(G, out);
  if (!strcmp(entry, "ragged_paged"))
    return occupancy(ragged_paged_kernel<bf, DH>, THREADS_C, ragged_smem_bytes<bf, DH>(),
                     ragged_smem_bytes<bf, DH>(), out);
  if (!strcmp(entry, "ragged_paged_i8"))
    return occupancy(ragged_paged_kernel<int8_t, DH>, THREADS_C,
                     ragged_smem_bytes<int8_t, DH>(), ragged_smem_bytes<int8_t, DH>(), out);
  if (!strcmp(entry, "ragged_chunk"))
    return occupancy(ragged_chunk_kernel<bf, DH>, THREADS_C, tc_smem_bytes<bf, DH>(),
                     tc_smem_bytes<bf, DH>(), out);
  if (!strcmp(entry, "ragged_chunk_i8"))
    return occupancy(ragged_chunk_kernel<int8_t, DH>, THREADS_C, tc_smem_bytes<int8_t, DH>(),
                     tc_smem_bytes<int8_t, DH>(), out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry runs its launcher's Dh-64 or Dh-128 instantiation.
#define CLA_BY_DH(launcher, T, ...)                     \
  switch (dh) {                                         \
    case 64:                                            \
      return launcher<T, 64>(__VA_ARGS__);              \
    case 128:                                           \
      return launcher<T, 128>(__VA_ARGS__);             \
    default:                                            \
      return (int)cudaErrorInvalidValue;                \
  }

extern "C" int paged_decode(int nranks, const void* const* q, const void* const* pool_k,
                            const void* const* pool_v, void* const* out, const int* table,
                            const int* seq_lens, void* scratch, void* counters, int B, int H,
                            int Hkv, int page, int np, int pps, int splits, float scale,
                            float softcap, int window, int dh, void* stream) {
  if (nranks < 1 || nranks > MAX_RANKS || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const Ranks<__nv_bfloat16> rk =
      gather_ranks<__nv_bfloat16>(nranks, q, pool_k, pool_v, nullptr, nullptr, out);
  CLA_BY_DH(launch_decode, __nv_bfloat16, rk, nranks, table, seq_lens, (float*)scratch,
            (int*)counters, B, H, Hkv, page, np, pps, splits, scale, softcap, window, stream)
}

extern "C" int paged_decode_i8(int nranks, const void* const* q, const void* const* pool_k,
                               const void* const* pool_v, const void* const* k_scale,
                               const void* const* v_scale, void* const* out, const int* table,
                               const int* seq_lens, void* scratch, void* counters, int B,
                               int H, int Hkv, int page, int np, int pps, int splits,
                               float scale, float softcap, int window, int dh, void* stream) {
  if (nranks < 1 || nranks > MAX_RANKS || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const Ranks<int8_t> rk =
      gather_ranks<int8_t>(nranks, q, pool_k, pool_v, k_scale, v_scale, out);
  CLA_BY_DH(launch_decode, int8_t, rk, nranks, table, seq_lens, (float*)scratch,
            (int*)counters, B, H, Hkv, page, np, pps, splits, scale, softcap, window, stream)
}

extern "C" int ragged_paged(const void* q, const void* pool_k, const void* pool_v,
                            const int* table, const int* q_lens, const int* kv_lens,
                            void* out, int B, int C, int H, int Hkv, int page, int np,
                            int chunk_slot, float scale, float softcap, int window, int dh,
                            void* stream) {
  CLA_BY_DH(launch_ragged, __nv_bfloat16, q, pool_k, pool_v, nullptr, nullptr, table,
            q_lens, kv_lens, out, B, C, H, Hkv, page, np, chunk_slot, scale, softcap,
            window, stream)
}

extern "C" int ragged_paged_i8(const void* q, const void* pool_k, const void* pool_v,
                               const void* k_scale, const void* v_scale, const int* table,
                               const int* q_lens, const int* kv_lens, void* out, int B,
                               int C, int H, int Hkv, int page, int np, int chunk_slot,
                               float scale, float softcap, int window, int dh,
                               void* stream) {
  CLA_BY_DH(launch_ragged, int8_t, q, pool_k, pool_v, k_scale, v_scale, table, q_lens,
            kv_lens, out, B, C, H, Hkv, page, np, chunk_slot, scale, softcap, window,
            stream)
}

extern "C" int ragged_chunk(const void* q, const void* pool_k, const void* pool_v,
                            const int* pages, const int* ctx_len, const int* kv_len, void* out,
                            int C, int H, int Hkv, int page, int np, float scale, float softcap,
                            int window, int dh, void* stream) {
  CLA_BY_DH(launch_chunk, __nv_bfloat16, q, pool_k, pool_v, nullptr, nullptr, pages,
            ctx_len, kv_len, out, C, H, Hkv, page, np, scale, softcap, window, stream)
}

extern "C" int ragged_chunk_i8(const void* q, const void* pool_k, const void* pool_v,
                               const void* k_scale, const void* v_scale, const int* pages,
                               const int* ctx_len, const int* kv_len, void* out, int C, int H,
                               int Hkv, int page, int np, float scale, float softcap,
                               int window, int dh, void* stream) {
  CLA_BY_DH(launch_chunk, int8_t, q, pool_k, pool_v, k_scale, v_scale, pages, ctx_len,
            kv_len, out, C, H, Hkv, page, np, scale, softcap, window, stream)
}

// The dynamic shared memory entry `entry` launches with at head dim dh and
// G query heads per kv head (out[0]), and its blocks an SM holds (out[1]).
extern "C" int resources(const char* entry, int dh, int G, int* out) {
  switch (dh) {
    case 64:
      return report<64>(entry, G, out);
    case 128:
      return report<128>(entry, G, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
