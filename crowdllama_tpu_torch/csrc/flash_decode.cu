// Kernel D: one decode token per slot over the contiguous KV cache.
//
// Replaces crowdllama_tpu/ops/pallas/flash.py flash_decode_attention
// (_decode_kernel).  Cache layout (one layer): [B, Hkv, S, DH] bf16, head
// major, so a (slot, kv head) pair's keys are one contiguous [S, DH] plane.
// Key j of slot b is seen when j < seq_lens[b] and (window <= 0 or
// j > seq_lens[b] - 1 - window); keys at or past S do not exist.  The
// output is acc / l with l == 0 read as 1, so a slot with seq_len 0 writes
// zeros.
//
// Bound on the H100: bytes.  A slot's G = H / Hkv query heads share every
// key of their kv head, 4 * DH flops per key per head, ~2 flop per byte
// read, far below the tensor cores' ~295 flop/byte, so the least time is
// the live K and V rows (min(seq_len, S) keys of each (slot, kv head)) read
// once at 3.35 TB/s.  What the design does about it: D runs the split-KV
// decode stages of decode_common.cuh, the ones kernel B runs over the
// paged pool, with the contiguous key-row policy (ContigDecodeRows: row
// (b * Hkv + h) * S + pos, no table):
// - the grid is (Hkv, B, splits) with splits of `span` keys from S alone
//   (flash_decode_plan in ops/cuda/flash.py: 256 keys a split, at most 32
//   splits, widened in multiples of 64 keys past 8,192), so enough blocks
//   stream the live rows at once (at the serving shapes 8 x Hkv x 8, where
//   one block per (slot, kv head) walked up to 2,048 keys in turn) and the
//   host sizes the grid without reading the lengths; splits past a slot's
//   length or before its window return at once, and the live splits merge
//   in the same launch, in split order;
// - 64-key stages stream through a three-stage cp.async ring, so two
//   stages load while one is computed; keys at or past min(seq_len, S) are
//   zero-filled and masked, never read, so S need not be a multiple of 64;
// - each staged K and V element is read from shared memory once and used
//   for all G heads of its kv head, and no FMA chain is longer than 8 keys
//   a stage.

#include <cstring>

#include "decode_common.cuh"

namespace {

using namespace cla;
using bf16 = __nv_bfloat16;

// Grid (Hkv, B, splits), DEC_THREADS threads, for G <= GP query heads per
// kv head (GP 4 or 8).  scratch holds (B x Hkv) x splits x G partials of
// part_stride<DH>() floats; counters one int32 per (slot, kv head), zero
// between launches.
template <int DH, int GP>
__global__ void __launch_bounds__(DEC_THREADS, decode_min_blocks<bf16, DH, GP>())
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_cache,
                    const bf16* __restrict__ v_cache, const int* __restrict__ seq_lens,
                    float* __restrict__ scratch, int* __restrict__ counters,
                    bf16* __restrict__ out, int H, int Hkv, int S, int span, int splits,
                    float scale, float softcap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = seq_lens[b];
  const size_t head0 = ((size_t)b * H + (size_t)h * G) * DH;
  decode_split<bf16, DH, GP>(smem, q + head0, k_cache, v_cache, nullptr, nullptr,
                             ContigDecodeRows{((size_t)b * Hkv + h) * S}, out + head0, scratch,
                             counters, G, len, window, max(0, min(len, S)), span, splits, scale,
                             softcap);
}

template <int DH, int GP>
int launch_gp(const void* q, const void* k_cache, const void* v_cache, const int* seq_lens,
              void* scratch, void* counters, void* out, int B, int H, int Hkv, int S, int span,
              int splits, float scale, float softcap, int window, void* stream) {
  constexpr size_t bytes = decode_smem_bytes<bf16, DH>();
  static unsigned opted = 0;
  const cudaError_t err = allow_smem(flash_decode_kernel<DH, GP>, bytes, opted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B, splits);
  flash_decode_kernel<DH, GP><<<grid, DEC_THREADS, bytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache, seq_lens, (float*)scratch,
      (int*)counters, (bf16*)out, H, Hkv, S, span, splits, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_decode(const void* q, const void* k_cache, const void* v_cache, const int* seq_lens,
                  void* scratch, void* counters, void* out, int B, int H, int Hkv, int S,
                  int span, int splits, float scale, float softcap, int window, void* stream) {
  auto go = H / Hkv <= 4 ? launch_gp<DH, 4> : launch_gp<DH, 8>;
  return go(q, k_cache, v_cache, seq_lens, scratch, counters, out, B, H, Hkv, S, span, splits,
            scale, softcap, window, stream);
}

template <int DH>
int report(int G, int* out) {
  constexpr size_t bytes = decode_smem_bytes<bf16, DH>();
  return G <= 4 ? occupancy(flash_decode_kernel<DH, 4>, DEC_THREADS, bytes, bytes, out)
                : occupancy(flash_decode_kernel<DH, 8>, DEC_THREADS, bytes, bytes, out);
}

}  // namespace

// splits of span keys each (span a multiple of the 64-key stage) cover the
// S keys of every (slot, kv head); at most MAX_SPLITS of them.
extern "C" int flash_decode(const void* q, const void* k_cache, const void* v_cache,
                            const int* seq_lens, void* scratch, void* counters, void* out,
                            int B, int H, int Hkv, int S, int span, int splits, float scale,
                            float softcap, int window, int dh, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || span < 1 || span % DEC_KEYS ||
      (long long)span * splits < S)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return launch_decode<64>(q, k_cache, v_cache, seq_lens, scratch, counters, out, B, H, Hkv,
                               S, span, splits, scale, softcap, window, stream);
    case 128:
      return launch_decode<128>(q, k_cache, v_cache, seq_lens, scratch, counters, out, B, H,
                                Hkv, S, span, splits, scale, softcap, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory kernel D launches with at head dim dh and G
// query heads per kv head (out[0]), and its blocks an SM holds (out[1]).
extern "C" int resources(const char* entry, int dh, int G, int* out) {
  if (strcmp(entry, "flash_decode")) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return report<64>(G, out);
    case 128:
      return report<128>(G, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
