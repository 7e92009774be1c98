// Kernel A: causal GQA prefill attention for one (padded) prompt batch.
//
// Replaces crowdllama_tpu/ops/pallas/flash.py flash_prefill_attention
// (_prefill_kernel).  Same function: q [B, T, H, DH], head-major k/v
// [B, Hkv, T, DH], all bf16; the mask is kpos <= qpos from `positions`
// [B, T] plus an optional kv_valid [B, T] padding mask, softcap and a
// sliding window (<= 0 disables); fp32 online softmax; out [B, T, H, DH].
//
// Bound on the H100: arithmetic for long prompts, bytes for short ones.
// The causal work is 4 * H * DH * T(T+1)/2 flops against 2 * T * (H + Hkv)
// * DH * 2 bytes of q/k/v/out: for TinyLlama (H 32, Hkv 4, DH 64) that is
// ~1.1 GFLOP over ~4.5 MB at T = 512, ~240 flop/byte, just under the card's
// ~295 flop/byte balance point (989 TF/s bf16 over 3.35 TB/s), and it grows
// linearly with T.  This first version does its arithmetic with fp32 FMAs,
// not tensor cores, so it runs far above either bound; what the design does
// about the bound is skip work and bytes: each block stops its key loop at
// its query tile's causal end (the upper triangle is never read or
// computed, the TPU kernel's causal_rows tile skip), all G query heads of a
// kv head share every staged K/V tile, and scores never leave registers.
//
// Layout: one block per (query tile of BQ = 128 / G queries, kv head,
// batch row); thread t owns query row t / G of the tile and query head
// t % G, holding its q row and fp32 accumulator in registers.  K/V tiles
// of TK keys are staged in shared memory and read by all threads
// (broadcast).  The caller guarantees positions[b, t] <= t (arange, or
// arange clamped at plen-1 with kv_valid masking the padding), which is
// what makes the causal tile skip exact.

#include "attention_common.cuh"

namespace {

constexpr int ROWS = 128;  // threads per block = query rows x heads
constexpr int TK = 64;     // keys per staged tile

__global__ void __launch_bounds__(ROWS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ positions,
                     const unsigned char* __restrict__ kv_valid,
                     __nv_bfloat16* __restrict__ out, int T, int H, int Hkv,
                     float scale, float softcap, int window) {
  using namespace cla;
  __shared__ __align__(16) __nv_bfloat16 Ks[TK * DH];
  __shared__ __align__(16) __nv_bfloat16 Vs[TK * DH];
  __shared__ int kpos_s[TK];
  __shared__ unsigned char kval_s[TK];

  const int G = H / Hkv;
  const int BQ = ROWS / G;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int qi = q0 + r;
  const bool live = qi < T;

  float qr[DH], acc[DH];
  float m = NEG_INF, l = 0.f;
  int qpos = 0;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  if (live) {
    load_row_f32(q + ((size_t)(b * T + qi) * H + h * G + g) * DH, qr);
    qpos = positions[b * T + qi];
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = 0.f;
  }

  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + h) * T * DH;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + h) * T * DH;
  const int kend = min(T, q0 + BQ);  // causal bound of this query tile
  for (int k0 = 0; k0 < kend; k0 += TK) {
    const int n = min(TK, kend - k0);
    __syncthreads();  // previous tile fully consumed
    stage_rows(Ks, DH, kb + (size_t)k0 * DH, n, TK);
    stage_rows(Vs, DH, vb + (size_t)k0 * DH, n, TK);
    for (int j = threadIdx.x; j < TK; j += blockDim.x) {
      kpos_s[j] = j < n ? positions[b * T + k0 + j] : 0;
      kval_s[j] = j < n ? (kv_valid ? kv_valid[b * T + k0 + j] : 1) : 0;
    }
    __syncthreads();
    if (live)
      row_attend_tile(qr, acc, m, l, Ks, DH, Vs, DH, n, kpos_s, kval_s, 0,
                      qpos, 0x7fffffff, window, scale, softcap);
  }
  if (live) store_row(out + ((size_t)(b * T + qi) * H + h * G + g) * DH, acc, l);
}

}  // namespace

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* positions, const unsigned char* kv_valid,
                             void* out, int B, int T, int H, int Hkv,
                             float scale, float softcap, int window,
                             void* stream) {
  const int G = H / Hkv;
  const int BQ = ROWS / G;
  dim3 grid((T + BQ - 1) / BQ, Hkv, B);
  flash_prefill_kernel<<<grid, ROWS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, positions, kv_valid, (__nv_bfloat16*)out, T, H,
      Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}
