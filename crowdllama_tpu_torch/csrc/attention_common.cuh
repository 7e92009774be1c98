// Device routines shared by the attention kernels of this package.
//
// Semantics are those of crowdllama_tpu_torch/ops/attention.py: logits are
// dot(q, k) * scale, optionally softcapped (cap * tanh(s / cap)), masked to
// NEG_INF; an fp32 online softmax (running max m, denominator l) carries
// across key tiles; a row that saw no valid key ends with l == 0, which is
// read as 1, so it outputs zeros and never NaN.  Query head h reads kv head
// h / G.  Head dim is fixed at DH = 64 (the wrappers refuse anything else).
//
// Staged K/V rows are bf16 or int8 (the routines are templates on the
// element type).  An int8 row comes with a per-key fp32 scale in shared
// memory: the K scale multiplies the score after `scale`, before the
// softcap; the V scale multiplies the probability after it was added to
// l, so only the output sum sees it (ops/pallas/paged.py _decode_kernel).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cla {

constexpr float NEG_INF = -1e30f;
constexpr int DH = 64;
// Keys scored per online-softmax update in the thread-per-row routine.
constexpr int SUB = 16;

__device__ __forceinline__ float softcap_f(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

__device__ __forceinline__ bool key_visible(int kpos, int qpos, int kv_len,
                                            int window) {
  return kpos < kv_len && kpos <= qpos &&
         (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One bf16 row of DH from device memory into fp32 registers.
__device__ __forceinline__ void load_row_f32(const __nv_bfloat16* src, float (&dst)[DH]) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    uint4 u = s4[c];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(h2[e]);
      dst[c * 8 + 2 * e] = f.x;
      dst[c * 8 + 2 * e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float dot_row(const float (&q)[DH], const __nv_bfloat16* krow) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(krow);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 2; ++d) {
    float2 f = __bfloat1622float2(k2[d]);
    acc = fmaf(q[2 * d], f.x, acc);
    acc = fmaf(q[2 * d + 1], f.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot_row(const float (&q)[DH], const int8_t* krow) {
  const char4* k4 = reinterpret_cast<const char4*>(krow);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const char4 c = k4[d];
    acc = fmaf(q[4 * d], (float)c.x, acc);
    acc = fmaf(q[4 * d + 1], (float)c.y, acc);
    acc = fmaf(q[4 * d + 2], (float)c.z, acc);
    acc = fmaf(q[4 * d + 3], (float)c.w, acc);
  }
  return acc;
}

// Elements (2i, 2i + 1) of a staged bf16 or int8 row as fp32.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row, int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[i]);
}

__device__ __forceinline__ float2 load_pair(const int8_t* row, int i) {
  const char2 c = reinterpret_cast<const char2*>(row)[i];
  return make_float2((float)c.x, (float)c.y);
}

// Stage `rows` rows of DH elements (bf16 or int8, contiguous in device
// memory) into shared memory with row stride `stride` elements (a multiple
// of 4 bytes); rows in [rows, cap) are zeroed so a partial tile reads
// defined values.  Called by every thread.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src, int rows,
                                           int cap) {
  constexpr int C16 = DH * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int E16 = 16 / (int)sizeof(T);       // elements per chunk
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int c = threadIdx.x; c < cap * C16; c += blockDim.x) {
    int r = c / C16, col = c % C16;
    uint4 u = r < rows ? s4[c] : make_uint4(0u, 0u, 0u, 0u);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * stride + col * E16);
    d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
  }
}

// Thread-per-row online-softmax update over one staged key tile of `n`
// keys (n <= the tile's allocated rows, rows past n zero-filled).  Key j
// sits at position kpos_sm[j] (or kpos0 + j when kpos_sm is null) and is
// valid when kval_sm[j] != 0 (all valid when null) and key_visible().
// Int8 tiles (T = int8_t) read their per-key scales from ksc/vsc.
template <typename T>
__device__ __forceinline__ void row_attend_tile(
    const float (&q)[DH], float (&acc)[DH], float& m, float& l,
    const T* Ksm, int kstride, const T* Vsm, int vstride,
    int n, const int* kpos_sm, const unsigned char* kval_sm, int kpos0,
    int qpos, int kv_len, int window, float scale, float softcap,
    const float* ksc = nullptr, const float* vsc = nullptr) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  for (int j0 = 0; j0 < n; j0 += SUB) {
    float s[SUB];
    float tmax = NEG_INF;
    unsigned ok = 0u;
#pragma unroll
    for (int jj = 0; jj < SUB; ++jj) {
      const int j = j0 + jj;
      bool v = j < n;
      if (v) {
        const int kp = kpos_sm ? kpos_sm[j] : kpos0 + j;
        v = key_visible(kp, qpos, kv_len, window) && (!kval_sm || kval_sm[j]);
      }
      float sc = NEG_INF;
      if (v) {
        sc = dot_row(q, Ksm + j * kstride) * scale;
        if constexpr (Q8) sc *= ksc[j];
        sc = softcap_f(sc, softcap);
        ok |= 1u << jj;
        tmax = fmaxf(tmax, sc);
      }
      s[jj] = sc;
    }
    if (!ok) continue;  // every key masked: the update is the identity
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < SUB; ++jj) {
      s[jj] = (ok >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
      psum += s[jj];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < SUB; ++jj) {
      if (j0 + jj >= n) break;
      const T* vrow = Vsm + (j0 + jj) * vstride;
      float p = s[jj];
      if constexpr (Q8) p *= vsc[j0 + jj];
#pragma unroll
      for (int d = 0; d < DH / 2; ++d) {
        const float2 f = load_pair(vrow, d);
        acc[2 * d] = fmaf(p, f.x, acc[2 * d]);
        acc[2 * d + 1] = fmaf(p, f.y, acc[2 * d + 1]);
      }
    }
  }
}

// acc / l (l == 0 read as 1) as bf16 into a DH row of device memory.
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float (&acc)[DH], float l) {
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
  for (int d = 0; d < DH / 2; ++d)
    d2[d] = __floats2bfloat162_rn(acc[2 * d] * inv, acc[2 * d + 1] * inv);
}

}  // namespace cla
