// Kernels B and C: attention over the paged KV pool, read through the page
// table.
//
// B, paged_decode, replaces crowdllama_tpu/ops/pallas/paged.py
// flash_paged_decode_attention (_decode_kernel): one query token per slot
// over that slot's pages.  C, ragged_paged, replaces
// flash_ragged_paged_attention (_ragged_v2_kernel): B decode rows plus one
// prefill chunk cut into QB-row query blocks, in one launch.
//
// Pool layout (one layer): [P, Hkv, page, DH] bf16; page id `P - 1` is the
// engine's dump page and is read like any other.  The table is [B, NP]
// int32.  Masks follow ops/attention.py: a key at position kpos is seen by
// a query at qpos when kpos < kv_len, kpos <= qpos and the window allows it
// (window <= 0 disables; decode's qpos is its newest position).
//
// Bound on the H100: bytes.  Each live page is [page, DH] K and V per kv
// head; a decode row does 4 * DH flops per key per query head (G = 8 heads
// share a key), ~2 flop per byte read, far below the ~295 flop/byte at which
// the tensor cores would bound.  So the least time is the live KV bytes at
// 3.35 TB/s.  What the design does about it: a block reads only the pages
// below its causal/validity bound (ceil(bound / page) pages, never the
// table's full width); the G query heads of a kv head share every page read
// (one warp per query head over one staged page); and no gathered copy of
// the pool is ever written.  This first version stages one page at a time
// without overlapping the next page's load, so it stays well above the
// bound; double-buffered cp.async/TMA staging is later work.
//
// Decode rows (B, and C's decode blocks): one block per (slot, kv head),
// one warp per query head; each lane scores keys lane, lane + 32, ... of a
// page, warp shuffles give the page's max and sum, and each lane
// accumulates two output dims.  Chunk blocks of C: one block per (query
// block of QB = 32 queries, kv head), one thread per (query, head) row,
// the shared thread-per-row routine of attention_common.cuh.

#include "attention_common.cuh"

namespace {

using namespace cla;

constexpr int QB = 32;          // chunk query rows per block (TPU _CHUNK_QB)
constexpr int THREADS_C = 256;  // QB x G (G <= 8) rows; 8 warps for decode
constexpr int KS = DH + 2;      // padded K row stride: lanes reading different
                                // rows hit different banks

struct PageSmem {
  __nv_bfloat16* K;  // [page][KS]
  __nv_bfloat16* V;  // [page][DH]
  float* P;          // [warps][page] decode probabilities
  float* Q;          // [G][DH] decode queries
};

__device__ __forceinline__ PageSmem carve(unsigned char* base, int page, int warps, int G) {
  PageSmem s;
  s.K = reinterpret_cast<__nv_bfloat16*>(base);
  size_t off = ((size_t)page * KS * sizeof(__nv_bfloat16) + 15) & ~size_t(15);
  s.V = reinterpret_cast<__nv_bfloat16*>(base + off);
  off += (size_t)page * DH * sizeof(__nv_bfloat16);
  s.P = reinterpret_cast<float*>(base + off);
  off += (size_t)warps * page * sizeof(float);
  s.Q = reinterpret_cast<float*>(base + off);
  return s;
}

__device__ __forceinline__ void stage_page(const PageSmem& s, const __nv_bfloat16* pool_k,
                                           const __nv_bfloat16* pool_v, int pid, int h,
                                           int Hkv, int page) {
  const size_t base = ((size_t)pid * Hkv + h) * page * DH;
  stage_rows(s.K, KS, pool_k + base, page, page);
  stage_rows(s.V, DH, pool_v + base, page, page);
}

// Decode attention of one slot row for the G query heads of kv head h.
// q_row / o_row point at [H, DH] rows; `table_row` lists the slot's pages.
__device__ __forceinline__ void decode_heads(const PageSmem& s, const __nv_bfloat16* __restrict__ q_row,
                             const __nv_bfloat16* __restrict__ pool_k,
                             const __nv_bfloat16* __restrict__ pool_v,
                             const int* __restrict__ table_row, __nv_bfloat16* o_row,
                             int h, int G, int Hkv, int page, int qpos, int kv_len,
                             int window, float scale, float softcap) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool head = warp < G;
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x)
    s.Q[i] = __bfloat162float(q_row[(size_t)h * G * DH + i]);
  __syncthreads();
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = head ? s.Q[warp * DH + d] : 0.f;

  float m = NEG_INF, l = 0.f, a0 = 0.f, a1 = 0.f;
  const int bound = min(kv_len, qpos + 1);
  const int npages = bound > 0 ? (bound + page - 1) / page : 0;
  float* P = s.P + warp * page;
  for (int n = 0; n < npages; ++n) {
    __syncthreads();  // previous page fully consumed
    stage_page(s, pool_k, pool_v, table_row[n], h, Hkv, page);
    __syncthreads();
    if (!head) continue;
    float sc[4];
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane + 32 * i;
      sc[i] = NEG_INF;
      if (j < page && key_visible(n * page + j, qpos, kv_len, window)) {
        sc[i] = softcap_f(dot_row(qr, s.K + j * KS) * scale, softcap);
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
      if (j < page) P[j] = p;
      psum += p;
    }
    l = l * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();
    a0 *= alpha;
    a1 *= alpha;
    const __nv_bfloat162* V2 = reinterpret_cast<const __nv_bfloat162*>(s.V);
    for (int j = 0; j < page; ++j) {
      const float2 f = __bfloat1622float2(V2[j * (DH / 2) + lane]);
      a0 = fmaf(P[j], f.x, a0);
      a1 = fmaf(P[j], f.y, a1);
    }
    __syncwarp();
  }
  if (head) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    reinterpret_cast<__nv_bfloat162*>(o_row + ((size_t)h * G + warp) * DH)[lane] =
        __floats2bfloat162_rn(a0 * inv, a1 * inv);
  }
}

__global__ void __launch_bounds__(THREADS_C)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pool_k,
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ table, const int* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out, int H, int Hkv, int page,
                    int np, float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const PageSmem s = carve(smem, page, blockDim.x / 32, G);
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = seq_lens[b];
  decode_heads(s, q + (size_t)b * H * DH, pool_k, pool_v, table + (size_t)b * np,
               out + (size_t)b * H * DH, h, G, Hkv, page, len - 1, len, window,
               scale, softcap);
}

__global__ void __launch_bounds__(THREADS_C)
ragged_paged_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pool_k,
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ table, const int* __restrict__ q_lens,
                    const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
                    int B, int C, int H, int Hkv, int page, int np, int chunk_slot,
                    float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const PageSmem s = carve(smem, page, THREADS_C / 32, G);
  const int nb = blockIdx.x, h = blockIdx.y;

  if (nb < B) {  // decode row nb: q_start = kv_len - 1, q_valid = q_lens[nb]
    __nv_bfloat16* o_row = out + (size_t)nb * H * DH;
    if (q_lens[nb] <= 0) {  // inactive slot: zeros, as the TPU kernel writes
      for (int i = threadIdx.x; i < G * DH; i += blockDim.x)
        o_row[(size_t)h * G * DH + i] = __float2bfloat16(0.f);
      return;
    }
    const int kv_len = kv_lens[nb];
    decode_heads(s, q + (size_t)nb * H * DH, pool_k, pool_v, table + (size_t)nb * np,
                 o_row, h, G, Hkv, page, kv_len - 1, kv_len, window, scale, softcap);
    return;
  }

  // Chunk block jb: queries ctx + jb*QB + r for r < q_valid.
  const int jb = nb - B;
  const int kv_len = kv_lens[B];
  const int ctx = kv_len - q_lens[B];
  const int q_start = ctx + jb * QB;
  const int q_valid = max(0, min(QB, q_lens[B] - jb * QB));
  const int r = threadIdx.x / G, g = threadIdx.x % G;
  const int row = jb * QB + r;  // chunk row index in [0, C)
  const bool exists = r < QB && row < C;
  const bool live = exists && r < q_valid;
  const int qpos = q_start + r;

  float qr[DH], acc[DH];
  float m = NEG_INF, l = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  if (live) {
    load_row_f32(q + ((size_t)(B + row) * H + h * G + g) * DH, qr);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = 0.f;
  }
  const int* trow = table + (size_t)chunk_slot * np;
  const int bound = min(kv_len, q_start + q_valid);
  const int npages = q_valid > 0 && bound > 0 ? (bound + page - 1) / page : 0;
  for (int n = 0; n < npages; ++n) {
    __syncthreads();
    stage_page(s, pool_k, pool_v, trow[n], h, Hkv, page);
    __syncthreads();
    if (live)
      row_attend_tile(qr, acc, m, l, s.K, KS, s.V, DH, page, nullptr, nullptr,
                      n * page, qpos, kv_len, window, scale, softcap);
  }
  if (exists) store_row(out + ((size_t)(B + row) * H + h * G + g) * DH, acc, l);
}

size_t page_smem_bytes(int page, int warps, int G) {
  size_t k = ((size_t)page * KS * sizeof(__nv_bfloat16) + 15) & ~size_t(15);
  return k + (size_t)page * DH * sizeof(__nv_bfloat16) + (size_t)warps * page * sizeof(float) +
         (size_t)G * DH * sizeof(float);
}

}  // namespace

extern "C" int paged_decode(const void* q, const void* pool_k, const void* pool_v,
                            const int* table, const int* seq_lens, void* out, int B,
                            int H, int Hkv, int page, int np, float scale,
                            float softcap, int window, void* stream) {
  const int G = H / Hkv;
  const int threads = 32 * G;
  dim3 grid(Hkv, B);
  paged_decode_kernel<<<grid, threads, page_smem_bytes(page, G, G), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)pool_k,
      (const __nv_bfloat16*)pool_v, table, seq_lens, (__nv_bfloat16*)out, H, Hkv,
      page, np, scale, softcap, window);
  return (int)cudaGetLastError();
}

extern "C" int ragged_paged(const void* q, const void* pool_k, const void* pool_v,
                            const int* table, const int* q_lens, const int* kv_lens,
                            void* out, int B, int C, int H, int Hkv, int page, int np,
                            int chunk_slot, float scale, float softcap, int window,
                            void* stream) {
  const int G = H / Hkv;
  dim3 grid(B + (C + QB - 1) / QB, Hkv);
  ragged_paged_kernel<<<grid, THREADS_C, page_smem_bytes(page, THREADS_C / 32, G),
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)pool_k,
      (const __nv_bfloat16*)pool_v, table, q_lens, kv_lens, (__nv_bfloat16*)out, B, C,
      H, Hkv, page, np, chunk_slot, scale, softcap, window);
  return (int)cudaGetLastError();
}
