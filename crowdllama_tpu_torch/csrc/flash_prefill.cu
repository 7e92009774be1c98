// Kernel A: causal GQA prefill attention for one (padded) prompt batch.
//
// Replaces crowdllama_tpu/ops/pallas/flash.py flash_prefill_attention
// (_prefill_kernel).  Same function: q [B, T, H, DH], head-major k/v
// [B, Hkv, T, DH], all bf16; the mask is kpos <= qpos from `positions`
// [B, T] plus an optional kv_valid [B, T] padding mask, softcap and a
// sliding window (<= 0 disables); fp32 online softmax; out [B, T, H, DH].
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

}  // namespace

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const int* positions, const unsigned char* kv_valid,
                             void* out, int B, int T, int H, int Hkv,
                             float scale, float softcap, int window, int dh,
                             void* stream) {
  switch (dh) {
    case 64:
      return launch_prefill<64>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                softcap, window, stream);
    case 128:
      return launch_prefill<128>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                 softcap, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory kernel A launches with at head dim dh (any G),
// and its blocks an SM holds (out[1]).
extern "C" int resources(const char* entry, int dh, int, int* out) {
  if (strcmp(entry, "flash_prefill")) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return occupancy(flash_prefill_kernel<64>, TC_THREADS, prefill_smem_bytes<64>(),
                       prefill_smem_bytes<64>(), out);
    case 128:
      return occupancy(flash_prefill_kernel<128>, TC_THREADS, prefill_smem_bytes<128>(),
                       prefill_smem_bytes<128>(), out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
