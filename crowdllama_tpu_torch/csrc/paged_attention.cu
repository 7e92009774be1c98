// Kernels B, C and E: attention over the paged KV pool, read through the
// page table.
//
// B, paged_decode, replaces crowdllama_tpu/ops/pallas/paged.py
// flash_paged_decode_attention (_decode_kernel): one query token per slot
// over that slot's pages.  C, ragged_paged, replaces
// flash_ragged_paged_attention (_ragged_v2_kernel): B decode rows plus one
// prefill chunk cut into query blocks, in one launch.  E,
// ragged_chunk, replaces flash_ragged_chunk_attention (_chunk_kernel): one
// prefill chunk alone over its slot's pages, C's chunk blocks without the
// decode rows (both run the same chunk_block routine).  Kernel F of the
// TPU package (flash_paged_decode_attention_tp) is B launched once per
// tensor-parallel rank, from ops/cuda/paged.py; it has no code here.
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
// Decode rows (B, and C's decode blocks): one block per (slot, kv head),
// one warp per query head; each lane scores keys lane, lane + 32, ... of a
// page, warp shuffles give the page's max and sum, the heads' q rows are
// staged through shared memory into fp32 registers, and each lane
// accumulates DH / 32 output dims.  Bound on the H100: bytes.  Each live page
// is [page, DH] K and V per kv head; a decode row does 4 * DH flops per key
// per query head (G = 8 heads share a key), ~2 flop per byte read, far
// below the ~295 flop/byte at which the tensor cores would bound.  So the
// least time is the live KV bytes at 3.35 TB/s.  What the design does about
// it: a block reads only the pages below its causal/validity bound
// (ceil(bound / page) pages, never the table's full width); the G query
// heads of a kv head share every page read; and no gathered copy of the
// pool is ever written.  An int8 pool halves the K/V bytes: its page is
// staged as int8, with the page's K and V scales beside it as fp32, and
// converted to fp32 in registers; the K scale goes on the score and the V
// scale on the probability after l is summed.  This first version stages
// one page at a time without overlapping the next page's load, so it stays
// well above the bound; double-buffered staging and split-KV are later
// work.
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
// launcher opts its kernel in once per device, as B's does for its page
// (74,240 bytes at Dh 128, page 128, G 8).  The registers (a whole tile's fp32
// S, O and Q's fragments) hold an SM to one such block of 256 threads;
// C's 8 decode + 32 chunk blocks per kv head thus fill the card once and
// a fraction.

#include "attention_common.cuh"

namespace {

using namespace cla;

constexpr int THREADS_C = TC_THREADS;  // 8 warps: a decode warp per head (G <= 8)
constexpr int MAX_PAGE = 128;          // keys per page: 4 per decode lane
constexpr int MAX_G = 8;

template <typename T>
__host__ __device__ constexpr bool is_q8() { return std::is_same<T, int8_t>::value; }

// Padded K row stride in elements: an odd number of 32-bit words per row
// (bf16: DH + 2 elements; int8: DH + 4 bytes), so decode lanes that read
// different rows hit different banks.
template <typename T, int DH>
__host__ __device__ constexpr int k_stride() { return is_q8<T>() ? DH + 4 : DH + 2; }

template <typename T>
struct PageSmem {
  T* K;        // [page][k_stride]
  T* V;        // [page][DH]
  float* KSc;  // [page] K scales (int8 pools; null for bf16)
  float* VSc;  // [page] V scales
  float* P;    // [warps][page] decode probabilities (V scale folded in)
  float* Q;    // [G][DH] decode queries
};

// Byte offsets of K, V, scales, P and Q in the block's shared memory.
template <typename T, int DH>
__host__ __device__ __forceinline__ void smem_layout(int page, int warps, int G,
                                                     size_t (&off)[6]) {
  off[0] = 0;
  off[1] = align16((size_t)page * k_stride<T, DH>() * sizeof(T));
  off[2] = off[1] + (size_t)page * DH * sizeof(T);
  off[3] = off[2] + (is_q8<T>() ? 2 * (size_t)page * sizeof(float) : 0);
  off[4] = off[3] + (size_t)warps * page * sizeof(float);
  off[5] = off[4] + (size_t)G * DH * sizeof(float);  // total
}

template <typename T, int DH>
__device__ __forceinline__ PageSmem<T> carve(unsigned char* base, int page, int warps,
                                             int G) {
  size_t off[6];
  smem_layout<T, DH>(page, warps, G, off);
  PageSmem<T> s;
  s.K = reinterpret_cast<T*>(base);
  s.V = reinterpret_cast<T*>(base + off[1]);
  s.KSc = is_q8<T>() ? reinterpret_cast<float*>(base + off[2]) : nullptr;
  s.VSc = is_q8<T>() ? s.KSc + page : nullptr;
  s.P = reinterpret_cast<float*>(base + off[3]);
  s.Q = reinterpret_cast<float*>(base + off[4]);
  return s;
}

template <typename T, int DH>
size_t page_smem_bytes(int page, int warps, int G) {
  size_t off[6];
  smem_layout<T, DH>(page, warps, G, off);
  return off[5];
}

template <typename T, int DH>
__device__ __forceinline__ void stage_page(const PageSmem<T>& s, const T* pool_k, const T* pool_v,
                                           const __nv_bfloat16* k_scale,
                                           const __nv_bfloat16* v_scale, int pid, int h,
                                           int Hkv, int page) {
  const size_t base = ((size_t)pid * Hkv + h) * page;
  stage_rows<DH>(s.K, k_stride<T, DH>(), pool_k + base * DH, page, page);
  stage_rows<DH>(s.V, DH, pool_v + base * DH, page, page);
  if constexpr (is_q8<T>()) {
    for (int j = threadIdx.x; j < page; j += blockDim.x) {
      s.KSc[j] = __bfloat162float(k_scale[base + j]);
      s.VSc[j] = __bfloat162float(v_scale[base + j]);
    }
  }
}

// Decode attention of one slot row for the G query heads of kv head h.
// q_row / o_row point at [H, DH] rows; `table_row` lists the slot's pages.
template <typename T, int DH>
__device__ __forceinline__ void decode_heads(const PageSmem<T>& s,
                                             const __nv_bfloat16* __restrict__ q_row,
                                             const T* __restrict__ pool_k,
                                             const T* __restrict__ pool_v,
                                             const __nv_bfloat16* __restrict__ k_scale,
                                             const __nv_bfloat16* __restrict__ v_scale,
                                             const int* __restrict__ table_row,
                                             __nv_bfloat16* o_row, int h, int G, int Hkv,
                                             int page, int qpos, int kv_len, int window,
                                             float scale, float softcap) {
  constexpr int KS = k_stride<T, DH>(), N = DH / 32;  // output dims per lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool head = warp < G;
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x)
    s.Q[i] = __bfloat162float(q_row[(size_t)h * G * DH + i]);
  __syncthreads();
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = head ? s.Q[warp * DH + d] : 0.f;

  float m = NEG_INF, l = 0.f, acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  const int bound = min(kv_len, qpos + 1);
  const int npages = bound > 0 ? (bound + page - 1) / page : 0;
  float* P = s.P + warp * page;
  for (int n = 0; n < npages; ++n) {
    __syncthreads();  // previous page fully consumed
    stage_page<T, DH>(s, pool_k, pool_v, k_scale, v_scale, table_row[n], h, Hkv, page);
    __syncthreads();
    if (!head) continue;
    float sc[4];
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane + 32 * i;
      sc[i] = NEG_INF;
      if (j < page && key_visible(n * page + j, qpos, kv_len, window)) {
        float x = dot_row<DH>(qr, s.K + j * KS) * scale;
        if constexpr (is_q8<T>()) x *= s.KSc[j];
        sc[i] = softcap_f(x, softcap);
        tmax = fmaxf(tmax, sc[i]);
      }
    }
    tmax = warp_max(tmax);
    if (tmax == NEG_INF) continue;  // no visible key in this page (uniform)
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane + 32 * i;
      const float p = sc[i] == NEG_INF ? 0.f : expf(sc[i] - m_new);
      if (j < page) {
        if constexpr (is_q8<T>()) P[j] = p * s.VSc[j];  // after l's sum
        else P[j] = p;
      }
      psum += p;
    }
    l = l * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] *= alpha;
    for (int j = 0; j < page; ++j) {
      float f[N];
      load_vec<N>(s.V + j * DH, lane, f);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = fmaf(P[j], f[e], acc[e]);
    }
    __syncwarp();
  }
  if (head) store_vec<N>(o_row + ((size_t)h * G + warp) * DH, lane, acc, l);
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

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS_C)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ table, const int* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out, int H, int Hkv, int page,
                    int np, float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const PageSmem<T> s = carve<T, DH>(smem, page, blockDim.x / 32, G);
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = seq_lens[b];
  decode_heads<T, DH>(s, q + (size_t)b * H * DH, pool_k, pool_v, k_scale, v_scale,
                      table + (size_t)b * np, out + (size_t)b * H * DH, h, G, Hkv, page,
                      len - 1, len, window, scale, softcap);
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

  if (nb < B) {  // decode row nb: q_start = kv_len - 1, q_valid = q_lens[nb]
    const PageSmem<T> s = carve<T, DH>(smem, page, THREADS_C / 32, G);
    __nv_bfloat16* o_row = out + (size_t)nb * H * DH;
    if (q_lens[nb] <= 0) {  // inactive slot: zeros, as the TPU kernel writes
      for (int i = threadIdx.x; i < G * DH; i += blockDim.x)
        o_row[(size_t)h * G * DH + i] = __float2bfloat16(0.f);
      return;
    }
    const int kv_len = kv_lens[nb];
    decode_heads<T, DH>(s, q + (size_t)nb * H * DH, pool_k, pool_v, k_scale, v_scale,
                        table + (size_t)nb * np, o_row, h, G, Hkv, page, kv_len - 1, kv_len,
                        window, scale, softcap);
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
int launch_decode(const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
                  const void* v_scale, const int* table, const int* seq_lens, void* out,
                  int B, int H, int Hkv, int page, int np, float scale, float softcap,
                  int window, void* stream) {
  static unsigned opted = 0;
  const cudaError_t err = allow_smem(paged_decode_kernel<T, DH>,
                                     page_smem_bytes<T, DH>(MAX_PAGE, MAX_G, MAX_G),
                                     opted);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Hkv;
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, DH><<<grid, 32 * G, page_smem_bytes<T, DH>(page, G, G),
                               (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const T*)pool_k, (const T*)pool_v,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale, table, seq_lens,
      (__nv_bfloat16*)out, H, Hkv, page, np, scale, softcap, window);
  return (int)cudaGetLastError();
}

// C's shared memory: the chunk tile's, or a decode block's page if that is
// larger (it is not at any page the wrappers take).
template <typename T, int DH>
size_t ragged_smem_bytes(int page, int G) {
  const size_t dec = page_smem_bytes<T, DH>(page, THREADS_C / 32, G);
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
                                     ragged_smem_bytes<T, DH>(MAX_PAGE, MAX_G), opted);
  if (err != cudaSuccess) return (int)err;
  const int qb = TC_ROWS / (H / Hkv);
  dim3 grid(B + (C + qb - 1) / qb, Hkv);
  ragged_paged_kernel<T, DH><<<grid, THREADS_C, ragged_smem_bytes<T, DH>(page, H / Hkv),
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

extern "C" int paged_decode(const void* q, const void* pool_k, const void* pool_v,
                            const int* table, const int* seq_lens, void* out, int B,
                            int H, int Hkv, int page, int np, float scale,
                            float softcap, int window, int dh, void* stream) {
  CLA_BY_DH(launch_decode, __nv_bfloat16, q, pool_k, pool_v, nullptr, nullptr, table,
            seq_lens, out, B, H, Hkv, page, np, scale, softcap, window, stream)
}

extern "C" int paged_decode_i8(const void* q, const void* pool_k, const void* pool_v,
                               const void* k_scale, const void* v_scale, const int* table,
                               const int* seq_lens, void* out, int B, int H, int Hkv,
                               int page, int np, float scale, float softcap, int window,
                               int dh, void* stream) {
  CLA_BY_DH(launch_decode, int8_t, q, pool_k, pool_v, k_scale, v_scale, table, seq_lens,
            out, B, H, Hkv, page, np, scale, softcap, window, stream)
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
