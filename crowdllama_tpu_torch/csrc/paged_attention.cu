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
// Pool layout (one layer): [P, Hkv, page, DH] bf16 (DH 64, 80, 96, 128 or
// 256, a template parameter; every C entry takes `dh` and dispatches), or int8 with per-key
// scales [P, Hkv, page] bf16 (the *_i8 entries, the TPU kernels' `quant`
// branch); page id `P - 1` is the engine's dump page and is read like any
// other.  The table is [B, NP] int32.  Masks follow ops/attention.py: a
// key at position kpos is seen by a query at qpos when kpos < kv_len,
// kpos <= qpos and the window allows it (window <= 0 disables; decode's
// qpos is its newest position).
//
// Decode rows (B, and C's decode blocks) run the split-KV decode stages of
// decode_common.cuh (bound: bytes, the live K/V rows at 3.35 TB/s; the
// design is described there) over the pool through the page table
// (PageDecodeRows: the page ids read one stage ahead of the copies).  B's
// grid is (ranks x Hkv, B, S): pages per split PPS and S come from the
// table width and the page alone (split_plan in ops/cuda/paged.py: 256
// keys a split at page 128, at most 32 splits), so a tensor-parallel rank
// splits each (slot, kv head) exactly as B on the whole pool does, and the
// merge reads partials in split order: F is bit-equal to B.  At the serving
// shapes (8 slots, 16 pages of 128) that is 8 x Hkv x 8 blocks.  The
// counters are one per (slot, rank, kv head).
// C's decode blocks run the same stages over the whole slot, one split.
//
// Chunk blocks (C's chunk rows, and every block of E): one block per
// (query block of 128 / G queries, kv head), the 128 (query, head) rows of
// the tensor-core tile of attention_common.cuh (tc_attend), which gathers
// its key tiles (128 keys at Dh 64, 96 at Dh 80, 64 at Dh 96 and 128, 32
// at Dh 256) from the slot's pages in
// 16-key groups.  Bound on the H100: operations, 4 * DH flops per visible
// (row, key) pair at 989 TF/s bf16 (TinyLlama's 512-row chunk at context
// 1024 moves ~5.8 MB of q, K/V and out, whose time at 3.35 TB/s is about a
// third of the operations' time).  The block walks only the tiles that
// hold a key some live row sees: from the window's start for its first
// query to its causal/validity bound.  With G = 8 a block holds 16
// queries, so a 512-row chunk is 32 x Hkv blocks.  Dynamic shared memory
// is 110,592 bytes at Dh 64 (three bf16 stages of K and V; int8: 88,576),
// 104,448 at Dh 128 (int8: 85,248) and 168,960 at Dh 256 with Q's tile
// (int8: 151,168; C's block takes the decode stages' 200,928 /
// 103,392 when larger), past the 48 KB default: each
// launcher opts its kernel in once per device, as B's does.  The registers
// (a whole tile's fp32 S, O and Q's fragments) hold an SM to one such
// block of 256 threads; C's 8 decode + 32 chunk blocks per kv head thus
// fill the card once and a fraction.

#include <cstring>

#include "decode_common.cuh"

namespace {

using namespace cla;

constexpr int THREADS_C = TC_THREADS;  // 8 warps (C's blocks and B's)
constexpr int MAX_RANKS = 8;   // ranks one B launch takes (kernel F on one device)

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
__global__ void __launch_bounds__(THREADS_C, decode_min_blocks<T, DH, GP>())
paged_decode_kernel(const Ranks<T> rk, const int* __restrict__ table,
                    const int* __restrict__ seq_lens, float* __restrict__ scratch,
                    int* __restrict__ counters, int H, int Hkv, int page, int np, int pps,
                    int splits, float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const int rank = blockIdx.x / Hkv, h = blockIdx.x % Hkv, b = blockIdx.y;
  const int len = seq_lens[b];
  const size_t head0 = ((size_t)b * H + (size_t)h * G) * DH;
  decode_split<T, DH, GP>(
      smem, rk.q[rank] + head0, rk.k[rank], rk.v[rank], rk.ks[rank], rk.vs[rank],
      PageDecodeRows{table + (size_t)b * np, Hkv, h, page, DecodeSmem<T, DH>::pids(smem)},
      rk.out[rank] + head0, scratch, counters, G, len, window, max(0, min(len, np * page)),
      pps * page, splits, scale, softcap);
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
    constexpr int N = dec_dims<DH>();
    __nv_bfloat16* o_row = out + (size_t)nb * H * DH + (size_t)h * G * DH;
    if (q_lens[nb] <= 0) {  // inactive slot: zeros, as the TPU kernel writes
      for (int i = threadIdx.x; i < G * DH; i += blockDim.x) o_row[i] = __float2bfloat16(0.f);
      return;
    }
    const int kv_len = kv_lens[nb], qpos = kv_len - 1;
    float m, l, acc[N];
    const __nv_bfloat16* q_row = q + (size_t)nb * H * DH + (size_t)h * G * DH;
    const PageDecodeRows rows{table + (size_t)nb * np, Hkv, h, page,
                              DecodeSmem<T, DH>::pids(smem)};
    const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
    const int bound = max(0, min(kv_len, np * page));
    if (G <= 4)
      decode_span<T, DH, 4>(smem, q_row, pool_k, pool_v, k_scale, v_scale, rows, G, qpos,
                            kv_len, window, lo, bound, scale, softcap, m, l, acc);
    else
      decode_span<T, DH, 8>(smem, q_row, pool_k, pool_v, k_scale, v_scale, rows, G, qpos,
                            kv_len, window, lo, bound, scale, softcap, m, l, acc);
    const int warp = threadIdx.x / 32;
    if (warp < G && threadIdx.x % 32 < dec_out_lanes<DH>())
      store_vec<N>(o_row + (size_t)warp * DH, threadIdx.x % 32, acc, l);
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

// Each entry runs its launcher's instantiation at head dim dh.
#define CLA_BY_DH(launcher, T, ...)                     \
  switch (dh) {                                         \
    case 64:                                            \
      return launcher<T, 64>(__VA_ARGS__);              \
    case 80:                                            \
      return launcher<T, 80>(__VA_ARGS__);              \
    case 96:                                            \
      return launcher<T, 96>(__VA_ARGS__);              \
    case 128:                                           \
      return launcher<T, 128>(__VA_ARGS__);             \
    case 256:                                           \
      return launcher<T, 256>(__VA_ARGS__);             \
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
    case 80:
      return report<80>(entry, G, out);
    case 96:
      return report<96>(entry, G, out);
    case 128:
      return report<128>(entry, G, out);
    case 256:
      return report<256>(entry, G, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
