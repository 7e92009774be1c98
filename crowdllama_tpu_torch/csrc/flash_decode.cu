// Kernel D: one decode token per slot over the contiguous KV cache.
//
// Replaces crowdllama_tpu/ops/pallas/flash.py flash_decode_attention
// (_decode_kernel).  Cache layout (one layer): [B, Hkv, S, DH] bf16, head
// major, so a (slot, kv head) pair's keys are one contiguous [S, DH] plane.
// Key j of slot b is seen when j < seq_lens[b] and (window <= 0 or
// j > seq_lens[b] - 1 - window); the output is acc / l with l == 0 read as
// 1, so a slot with seq_len 0 writes zeros.
//
// Bound on the H100: bytes.  A slot reads its live K and V rows once; the
// G = H / Hkv query heads of a kv head share every key, 4 * DH flops per key
// per head, ~2 flop per byte read, far below the tensor cores' ~295
// flop/byte.  So the least time is the live KV bytes at 3.35 TB/s.  What
// the design does about it: one block per (kv head, slot) stages TILE keys
// at a time in shared memory for its G query heads (one warp each, q in
// fp32 registers, each lane owning DH / 32 output dims), the
// key loop stops at seq_len and starts at the first tile the window can
// see, so only live rows are read (the TPU kernel block-copies the whole
// row into VMEM and only skips compute).  This first version does not
// overlap the next tile's load with the current tile's math, and at the
// serving shape (8 slots x 4 or 8 kv heads) the grid is 32-64 blocks on 132
// SMs: splitting the key axis across blocks (split-KV) is later work.

#include <cstring>

#include "attention_common.cuh"

namespace {

using namespace cla;

constexpr int TILE = 128;  // keys staged per step (4 per lane)
constexpr int MAX_G = 8;   // query heads per kv head: one warp each

// Padded K row stride: an odd number of words, so lanes reading different
// rows hit different banks.
template <int DH>
__host__ __device__ constexpr int k_stride() { return DH + 2; }

template <int DH>
size_t smem_bytes(int G) {
  return align16((size_t)TILE * k_stride<DH>() * sizeof(__nv_bfloat16)) +
         (size_t)TILE * DH * sizeof(__nv_bfloat16) + (size_t)G * TILE * sizeof(float) +
         (size_t)G * DH * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(32 * MAX_G)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_cache,
                    const __nv_bfloat16* __restrict__ v_cache,
                    const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
                    int H, int Hkv, int S, float scale, float softcap, int window) {
  constexpr int KS = k_stride<DH>(), N = DH / 32;  // output dims per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  size_t off = align16((size_t)TILE * KS * sizeof(__nv_bfloat16));
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + off);
  off += (size_t)TILE * DH * sizeof(__nv_bfloat16);
  float* P = reinterpret_cast<float*>(smem + off) + warp * TILE;
  off += (size_t)G * TILE * sizeof(float);
  float* Qs = reinterpret_cast<float*>(smem + off);

  const __nv_bfloat16* q_row = q + ((size_t)b * H + (size_t)h * G) * DH;
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x) Qs[i] = __bfloat162float(q_row[i]);
  __syncthreads();
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = Qs[warp * DH + d];

  const int len = seq_lens[b];
  const int qpos = len - 1;
  const int live = min(len, S);  // keys that exist in the cache
  const int first = window > 0 ? max(0, len - window) : 0;
  const size_t plane = ((size_t)b * Hkv + h) * S * DH;

  float m = NEG_INF, l = 0.f, acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int t0 = (first / TILE) * TILE; t0 < live; t0 += TILE) {
    const int rows = min(TILE, live - t0);
    __syncthreads();  // previous tile fully consumed
    stage_rows<DH>(Ks, KS, k_cache + plane + (size_t)t0 * DH, rows, TILE);
    stage_rows<DH>(Vs, DH, v_cache + plane + (size_t)t0 * DH, rows, TILE);
    __syncthreads();
    float sc[4];
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane + 32 * i;
      sc[i] = NEG_INF;
      if (j < rows && key_visible(t0 + j, qpos, len, window)) {
        sc[i] = softcap_f(dot_row<DH>(qr, Ks + j * KS) * scale, softcap);
        tmax = fmaxf(tmax, sc[i]);
      }
    }
    tmax = warp_max(tmax);
    if (tmax == NEG_INF) continue;  // no visible key in this tile (uniform)
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane + 32 * i;
      const float p = sc[i] == NEG_INF ? 0.f : expf(sc[i] - m_new);
      P[j] = p;
      psum += p;
    }
    l = l * alpha + warp_sum(psum);
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] *= alpha;
    for (int j = 0; j < rows; ++j) {
      float f[N];
      load_vec<N>(Vs + j * DH, lane, f);
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = fmaf(P[j], f[e], acc[e]);
    }
    __syncwarp();
  }
  store_vec<N>(out + ((size_t)b * H + (size_t)h * G + warp) * DH, lane, acc, l);
}

template <int DH>
int launch_decode(const void* q, const void* k_cache, const void* v_cache, const int* seq_lens,
                  void* out, int B, int H, int Hkv, int S, float scale, float softcap,
                  int window, void* stream) {
  static unsigned opted = 0;
  const cudaError_t err = allow_smem(flash_decode_kernel<DH>, smem_bytes<DH>(MAX_G), opted);
  if (err != cudaSuccess) return (int)err;
  const int G = H / Hkv;
  dim3 grid(Hkv, B);
  flash_decode_kernel<DH><<<grid, 32 * G, smem_bytes<DH>(G), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cache, (const __nv_bfloat16*)v_cache,
      seq_lens, (__nv_bfloat16*)out, H, Hkv, S, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode(const void* q, const void* k_cache, const void* v_cache,
                            const int* seq_lens, void* out, int B, int H, int Hkv, int S,
                            float scale, float softcap, int window, int dh, void* stream) {
  switch (dh) {
    case 64:
      return launch_decode<64>(q, k_cache, v_cache, seq_lens, out, B, H, Hkv, S, scale,
                               softcap, window, stream);
    case 128:
      return launch_decode<128>(q, k_cache, v_cache, seq_lens, out, B, H, Hkv, S, scale,
                                softcap, window, stream);
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
      return occupancy(flash_decode_kernel<64>, 32 * G, smem_bytes<64>(G), smem_bytes<64>(MAX_G),
                       out);
    case 128:
      return occupancy(flash_decode_kernel<128>, 32 * G, smem_bytes<128>(G),
                       smem_bytes<128>(MAX_G), out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
