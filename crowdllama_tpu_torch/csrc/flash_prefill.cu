// Kernel A: causal GQA prefill attention for one (padded) prompt batch.
//
// Replaces crowdllama_tpu/ops/pallas/flash.py flash_prefill_attention
// (_prefill_kernel).  Same function: q [B, T, H, DH], head-major k/v
// [B, Hkv, T, DH], all bf16 (entry flash_prefill) or all fp32
// (flash_prefill_f32); the mask is kpos <= qpos from `positions`
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
//
// fp32 (entry flash_prefill_f32: q/k/v and out fp32, the distillation
// trainer's fp32 teacher and student).  Bound: operations, the same causal
// flops against twice the bytes, at the 67 TF/s of fp32 FMAs outside the
// tensor cores (tc_attend's bf16 mma would round the operands, and TF32
// rounds them further than the plain fp32 version does).  Design: a SIMT
// tile (prefill_simt_kernel), one block of 256 threads per (64 queries,
// query head, batch row), key tiles of 64; Q and each K tile sit
// transposed in shared memory ([DH][64 + 4]) so a thread's 4 rows and 4
// keys are one 16-byte load each per dim, 16 FMAs per pair of loads; a
// row's 64 scores live on 16 lanes of one warp (max and sum by 4
// shuffles), P goes through shared memory ([64 keys][64 + 4 rows]) and
// each thread accumulates its 4 rows x DH / 16 output dims.  One tile in
// flight (no ring): a simple tile that is right; the key walk stops at the
// query block's causal end as the bf16 kernel's does.

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

// ---------------------------------------------------------------- fp32

constexpr int SP_Q = 64;            // query rows of a block (one query head)
constexpr int SP_K = 64;            // keys of a tile
constexpr int SP_THREADS = 256;     // 16 x 16: 4 rows x 4 keys a thread
constexpr int SP_S = SP_Q + 4;      // row stride of Qt, Kt and P (16-byte aligned)

// Qt [DH][SP_S], Kt [DH][SP_S], V [SP_K][DH], P [SP_K][SP_S] fp32, then the
// tile's key positions and valid flags [SP_K] int32 each.
template <int DH>
constexpr size_t simt_smem_bytes() {
  return (size_t)(2 * DH * SP_S + SP_K * DH + SP_K * SP_S) * 4 + 2 * SP_K * 4;
}

template <int DH>
__global__ void __launch_bounds__(SP_THREADS)
prefill_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ positions, const unsigned char* __restrict__ kv_valid,
                    float* __restrict__ out, int T, int H, int Hkv, float scale, float softcap,
                    int window) {
  constexpr int N = DH / 16;  // output dims a thread owns: N / 4 runs of 4
  extern __shared__ __align__(16) unsigned char smem[];
  float* const Qt = reinterpret_cast<float*>(smem);
  float* const Kt = Qt + DH * SP_S;
  float* const Vs = Kt + DH * SP_S;
  float* const Ps = Vs + SP_K * DH;
  int* const kpos = reinterpret_cast<int*>(Ps + SP_K * SP_S);
  int* const kok = kpos + SP_K;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * SP_Q, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * T;
  const size_t plane = ((size_t)b * Hkv + h / (H / Hkv)) * T;

  // Q transposed (row fastest: conflict-free stores); rows past T are zeros.
  for (int i = tid; i < SP_Q * (DH / 4); i += SP_THREADS) {
    const int r = i % SP_Q, c = i / SP_Q * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) x = *reinterpret_cast<const float4*>(q + ((row0 + q0 + r) * H + h) * DH + c);
    Qt[c * SP_S + r] = x.x;
    Qt[(c + 1) * SP_S + r] = x.y;
    Qt[(c + 2) * SP_S + r] = x.z;
    Qt[(c + 3) * SP_S + r] = x.w;
  }
  int qp[4];  // this thread's rows' positions; -1 past T sees no key
  float m[4], l[4], o[4][N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    qp[i] = r < T ? positions[row0 + r] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) o[i][e] = 0.f;
  }

  const int kend = min(T, q0 + SP_Q);  // the causal end (positions[t] <= t)
  for (int k0 = 0; k0 < kend; k0 += SP_K) {
    __syncthreads();  // Qt stored; the last tile's Kt, V and P reads done
    for (int i = tid; i < SP_K * (DH / 4); i += SP_THREADS) {
      const int j = i % SP_K, c = i / SP_K * 4;  // K: key fastest
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < T) x = *reinterpret_cast<const float4*>(k + (plane + k0 + j) * DH + c);
      Kt[c * SP_S + j] = x.x;
      Kt[(c + 1) * SP_S + j] = x.y;
      Kt[(c + 2) * SP_S + j] = x.z;
      Kt[(c + 3) * SP_S + j] = x.w;
      const int jv = i / (DH / 4), cv = i % (DH / 4) * 4;  // V: dims fastest
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + jv < T) y = *reinterpret_cast<const float4*>(v + (plane + k0 + jv) * DH + cv);
      *reinterpret_cast<float4*>(Vs + jv * DH + cv) = y;
    }
    if (tid < SP_K) {
      const int key = k0 + tid;
      kpos[tid] = key < T ? positions[row0 + key] : 0;
      kok[tid] = key < T && (!kv_valid || kv_valid[row0 + key]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(Qt + d * SP_S + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(Kt + d * SP_S + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, bk[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // Mask, then the online softmax of each row over its 16 lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kpos[tx * 4 + j];
        const bool seen = kok[tx * 4 + j] && kp <= qp[i] && (window <= 0 || kp > qp[i] - window);
        s[i][j] = seen ? softcap_f(s[i][j] * scale, softcap) : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < N; ++e) o[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx * 4 + j) * SP_S + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int kn = min(SP_K, kend - k0);
    for (int j = 0; j < kn; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + j * SP_S + ty * 4);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < N / 4; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(Vs + j * DH + g * 64 + tx * 4);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][g * 4 + e] = fmaf(p[i], vv[e], o[i][g * 4 + e]);
      }
    }
  }

  // out = o / l (l == 0 read as 1: a row that saw no key writes zeros).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= T) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int g = 0; g < N / 4; ++g)
      *reinterpret_cast<float4*>(out + ((row0 + r) * H + h) * DH + g * 64 + tx * 4) =
          make_float4(o[i][g * 4] * inv, o[i][g * 4 + 1] * inv, o[i][g * 4 + 2] * inv,
                      o[i][g * 4 + 3] * inv);
  }
}

template <int DH>
int launch_prefill_f32(const void* q, const void* k, const void* v, const int* positions,
                       const unsigned char* kv_valid, void* out, int B, int T, int H, int Hkv,
                       float scale, float softcap, int window, void* stream) {
  static unsigned opted = 0;
  const cudaError_t err = allow_smem(prefill_simt_kernel<DH>, simt_smem_bytes<DH>(), opted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + SP_Q - 1) / SP_Q, H, B);
  prefill_simt_kernel<DH><<<grid, SP_THREADS, simt_smem_bytes<DH>(), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, positions, kv_valid, (float*)out, T, H,
      Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 const int* positions, const unsigned char* kv_valid,
                                 void* out, int B, int T, int H, int Hkv, float scale,
                                 float softcap, int window, int dh, void* stream) {
  switch (dh) {
    case 64:
      return launch_prefill_f32<64>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                    softcap, window, stream);
    case 128:
      return launch_prefill_f32<128>(q, k, v, positions, kv_valid, out, B, T, H, Hkv, scale,
                                     softcap, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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

// The dynamic shared memory an entry of kernel A (flash_prefill, or
// flash_prefill_f32) launches with at head dim dh (any G), and its blocks
// an SM holds (out[1]).
extern "C" int resources(const char* entry, int dh, int, int* out) {
  if (!strcmp(entry, "flash_prefill_f32")) {
    switch (dh) {
      case 64:
        return occupancy(prefill_simt_kernel<64>, SP_THREADS, simt_smem_bytes<64>(),
                         simt_smem_bytes<64>(), out);
      case 128:
        return occupancy(prefill_simt_kernel<128>, SP_THREADS, simt_smem_bytes<128>(),
                         simt_smem_bytes<128>(), out);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
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
