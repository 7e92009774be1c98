// Kernel G: a grouped GEMM over an expert bank with the weight's
// dequantisation in shared memory (ops/cuda/gemm.py grouped_gemm).
//
// It replaces no Pallas kernel.  The JAX package leaves the MoE expert
// product (lax.ragged_dot, models/transformer.py _moe_sorted) and the
// weight-only dequantisation fused into every matmul (ops/quant.py
// qeinsum, qragged_dot) to XLA.  The plain PyTorch route fails on the
// card twice: it needs the group sizes on the host to loop over experts
// (a sync per layer, which a captured megastep graph cannot hold), and it
// writes a bf16 copy of every quantized weight at every call (two to three
// times the bytes of a decode step whose point is to read fewer).
//
// y[r] = x[r] @ W[e] for the rows r in [offsets[e], offsets[e + 1]) of
// every expert e (offsets in device memory, computed from the router on
// the device; null offsets: one expert over all M rows, the dense
// product).  W is the bank [E, K, N] as stored, in the JAX layout:
//   MODE 0: bf16;
//   MODE 1: int8 with one bf16 scale per output channel, s [E, N];
//   MODE 2: int4, two values a byte along N (column 2j the low nibble,
//           2j + 1 the high one), one bf16 scale per group of K / groups
//           input rows per output channel, s [E, groups, N].
// A weight element is dequantised exactly as ops/quant.py dequant does,
// q * s rounded to bf16 (the fp32 product of a small integer and a bf16
// scale is exact, so one rounding).  x and y are bf16 [M, K] and [M, N];
// the products are mma.sync.m16n8k16 (bf16 in, fp32 accumulate), rounded
// to bf16 once at the end.
//
// Bound on the H100: bytes in decode (a few rows an expert: every touched
// expert's weights and scales are read once, 3.35 TB/s), operations at
// prefill shapes (2 * rows * K * N at 989 TF/s bf16).  Design, a simple
// first version: one block of 4 warps per (64-column tile of N, expert,
// slice z of the group's 64-row passes); the block reads its group's
// offsets itself, so an empty group reads no weight and a block with no
// pass exits at once.  Each pass streams its expert's K x 64 weight slab
// through a three-stage cp.async ring of 64-row tiles (raw int8 / packed
// bytes for MODEs 1-2, converted to a bf16 tile in shared memory once per
// block and tile), beside the pass's 64 x 64 tiles of x; each warp owns 16
// columns and every 16-row slice of the pass that holds rows.  No
// transposed or dequantised copy of a weight exists outside shared
// memory.  wgmma / TMA and a persistent schedule are later work.

#include <cstring>

#include "attention_common.cuh"

namespace cla {

using bf16 = __nv_bfloat16;

constexpr int GG_BM = 64;    // rows of a pass
constexpr int GG_BN = 64;    // columns of a block
constexpr int GG_BK = 64;    // input rows of a staged tile
constexpr int GG_WARPS = 4;  // each owns 16 columns
constexpr int GG_THREADS = 32 * GG_WARPS;
constexpr int GG_STAGES = 3;
constexpr int GG_ROW = GG_BK + 8;  // bf16 row of the x and W tiles (144 B)
static_assert(GG_BN == GG_BK, "the x and W tiles share their row");

// Bytes of one raw weight tile (GG_BK input rows x GG_BN columns).
template <int MODE>
__host__ __device__ constexpr int gg_raw_bytes() {
  return MODE == 0 ? GG_BK * GG_ROW * 2 : MODE == 1 ? GG_BK * GG_BN : GG_BK * GG_BN / 2;
}

// Shared memory: the x ring, the raw weight ring (MODE 0: the bf16 tiles
// the mma reads), then for MODEs 1-2 the converted bf16 tile, and for
// MODE 1 the block's 64 column scales in fp32.
template <int MODE>
__host__ __device__ constexpr size_t gg_smem_bytes() {
  return (size_t)GG_STAGES * GG_BM * GG_ROW * 2 + (size_t)GG_STAGES * gg_raw_bytes<MODE>() +
         (MODE == 0 ? 0 : (size_t)GG_BK * GG_ROW * 2) + (MODE == 1 ? GG_BN * 4 : 0);
}

template <int MODE>
__global__ void __launch_bounds__(GG_THREADS)
    grouped_gemm_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
                        const bf16* __restrict__ scale, const int* __restrict__ offsets,
                        bf16* __restrict__ y, int M, int K, int N, int groups, int msplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  unsigned char* raw = smem + (size_t)GG_STAGES * GG_BM * GG_ROW * 2;
  bf16* wt = reinterpret_cast<bf16*>(raw + (size_t)GG_STAGES * gg_raw_bytes<MODE>());
  float* sc = reinterpret_cast<float*>(wt + GG_BK * GG_ROW);

  const int n0 = blockIdx.x * GG_BN;
  const int e = blockIdx.y;
  const int lo = offsets ? offsets[e] : 0;
  const int hi = offsets ? offsets[e + 1] : M;
  if (hi - lo <= (int)blockIdx.z * GG_BM) return;  // an empty group, or no pass

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ktiles = K / GG_BK;
  const size_t ew = (size_t)e * K * (MODE == 2 ? N / 2 : N);  // expert's first element
  const bf16* scale_e = scale + (MODE == 2 ? (size_t)e * groups * N : (size_t)e * N);
  const int gsize = MODE == 2 ? K / groups : 0;

  if (MODE == 1) {
    if (tid < GG_BN) sc[tid] = __bfloat162float(scale_e[n0 + tid]);
    __syncthreads();
  }

  for (int m0 = lo + blockIdx.z * GG_BM; m0 < hi; m0 += msplit * GG_BM) {
    const int rows = min(GG_BM, hi - m0);
    const int mtiles = (rows + 15) / 16;

    // Tile kt of x (rows past the pass are left as they are: a row of the
    // mma's A only reaches its own, unstored, output row) and of W.
    auto load = [&](int st, int kt) {
      bf16* xd = xs + st * GG_BM * GG_ROW;
#pragma unroll
      for (int i = 0; i < GG_BM * GG_BK / 8 / GG_THREADS; ++i) {
        const int c = tid + i * GG_THREADS, r = c / (GG_BK / 8), col = c % (GG_BK / 8) * 8;
        if (r < rows) cp_async16(xd + r * GG_ROW + col, x + (size_t)(m0 + r) * K + kt * GG_BK + col);
      }
      unsigned char* wd = raw + st * gg_raw_bytes<MODE>();
      if (MODE == 0) {
        const bf16* wb = reinterpret_cast<const bf16*>(w) + ew;
#pragma unroll
        for (int i = 0; i < GG_BK * GG_BN / 8 / GG_THREADS; ++i) {
          const int c = tid + i * GG_THREADS, r = c / (GG_BN / 8), col = c % (GG_BN / 8) * 8;
          cp_async16(reinterpret_cast<bf16*>(wd) + r * GG_ROW + col,
                     wb + (size_t)(kt * GG_BK + r) * N + n0 + col);
        }
      } else {
        const int8_t* wb = reinterpret_cast<const int8_t*>(w) + ew;
        constexpr int RB = MODE == 1 ? GG_BN : GG_BN / 2;  // raw bytes a row
        const int ld = MODE == 1 ? N : N / 2, c0 = MODE == 1 ? n0 : n0 / 2;
#pragma unroll
        for (int i = 0; i < GG_BK * RB / 16 / GG_THREADS; ++i) {
          const int c = tid + i * GG_THREADS, r = c / (RB / 16), col = c % (RB / 16) * 16;
          cp_async16(wd + r * RB + col, wb + (size_t)(kt * GG_BK + r) * ld + c0 + col);
        }
      }
    };

    float acc[4][2][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
    for (int s = 0; s < GG_STAGES - 1; ++s) {
      if (s < ktiles) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<GG_STAGES - 2>();
      __syncthreads();
      const int nk = kt + GG_STAGES - 1;
      if (nk < ktiles) load(nk % GG_STAGES, nk);
      cp_async_commit();
      const int st = kt % GG_STAGES;
      const unsigned char* rt = raw + st * gg_raw_bytes<MODE>();
      const bf16* wtile = reinterpret_cast<const bf16*>(rt);
      if (MODE == 1) {
        // 32 int8 of one row a thread, times their column's scale.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = tid * 2 + i, r = c / 4, col = c % 4 * 16;
          const uint4 v = *reinterpret_cast<const uint4*>(rt + r * GG_BN + col);
          const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
          uint32_t o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int b = col + 2 * j;
            const uint32_t word = wv[j / 2];
            const int sh = (j % 2) * 16;
            const float q0 = (float)((int)(word << (24 - sh)) >> 24);
            const float q1 = (float)((int)(word << (16 - sh)) >> 24);
            o[j] = pack_bf16(__bfloat162float(__float2bfloat16_rn(q0 * sc[b])),
                             __bfloat162float(__float2bfloat16_rn(q1 * sc[b + 1])));
          }
          uint4* dst = reinterpret_cast<uint4*>(wt + r * GG_ROW + col);
          dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
          dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
        __syncthreads();
        wtile = wt;
      } else if (MODE == 2) {
        // 16 packed bytes (32 columns) of one row a thread, times their
        // group's scales (read through the read-only cache).
        const int r = tid / 2, pc = tid % 2 * 16, col = pc * 2;
        const uint4 v = *reinterpret_cast<const uint4*>(rt + r * (GG_BN / 2) + pc);
        const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
        const uint4* sp = reinterpret_cast<const uint4*>(
            scale_e + (size_t)((kt * GG_BK + r) / gsize) * N + n0 + col);
        uint4* dst = reinterpret_cast<uint4*>(wt + r * GG_ROW + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // 8 bytes, 16 columns, at a time
          const uint4 s0 = __ldg(sp + 2 * h), s1 = __ldg(sp + 2 * h + 1);
          const uint32_t sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          uint32_t o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int byte = (int)(int8_t)((wv[2 * h + j / 4] >> (8 * (j % 4))) & 0xFF);
            const float q0 = (float)((int)((unsigned)byte << 28) >> 28);  // column 2j: low
            const float q1 = (float)(byte >> 4);  // column 2j + 1: the high nibble
            const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(&sv[j]);
            o[j] = pack_bf16(__bfloat162float(__float2bfloat16_rn(q0 * __low2float(s2))),
                             __bfloat162float(__float2bfloat16_rn(q1 * __high2float(s2))));
          }
          dst[2 * h] = make_uint4(o[0], o[1], o[2], o[3]);
          dst[2 * h + 1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
        __syncthreads();
        wtile = wt;
      }

      const bf16* xt = xs + st * GG_BM * GG_ROW;
#pragma unroll
      for (int ks = 0; ks < GG_BK / 16; ++ks) {
        uint32_t b[4];
        const int mi = lane / 8;
        ldsm_x4_trans(b, wtile + (ks * 16 + (mi & 1) * 8 + lane % 8) * GG_ROW + warp * 16 +
                             (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < mtiles) {
            uint32_t a[4];
            ldsm_x4(a, xt + (mt * 16 + lane % 16) * GG_ROW + ks * 16 + (lane / 16) * 8);
            mma_16816(acc[mt][0], a, b[0], b[1]);
            mma_16816(acc[mt][1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass's loads overwrite every stage

#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt < mtiles) {
        const int r = mt * 16 + lane / 4;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = n0 + warp * 16 + nt * 8 + (lane % 4) * 2;
          if (r < rows)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * N + col) =
                __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
          if (r + 8 < rows)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r + 8) * N + col) =
                __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    }
  }
}

template <int MODE>
int launch_grouped(const void* x, const void* w, const void* scale, const void* offsets, void* y,
                   int M, int K, int N, int E, int groups, int msplit, void* stream) {
  static unsigned done = 0;
  auto* kernel = grouped_gemm_kernel<MODE>;
  cudaError_t err = allow_smem(kernel, gg_smem_bytes<MODE>(), done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / GG_BN, E, msplit);
  kernel<<<grid, GG_THREADS, gg_smem_bytes<MODE>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), w, static_cast<const bf16*>(scale),
      static_cast<const int*>(offsets), static_cast<bf16*>(y), M, K, N, groups, msplit);
  return (int)cudaGetLastError();
}

template <int MODE>
int report(int* out) {
  return occupancy(grouped_gemm_kernel<MODE>, GG_THREADS, gg_smem_bytes<MODE>(),
                   gg_smem_bytes<MODE>(), out);
}

}  // namespace cla

using namespace cla;

// x [M, K] bf16, w the bank [E, K, N] (packed [E, K, N / 2] int8 for int4),
// scale (int8: [E, N]; int4: [E, groups, N]; bf16 weights: unused),
// offsets [E + 1] int32 or null (E == 1: every row), y [M, N] bf16.
// Requires K % 64 == 0, N % 64 == 0; the wrapper checks.  msplit: blocks
// that share one (column tile, expert)'s 64-row passes.
extern "C" int grouped_gemm_bf16(const void* x, const void* w, const void* scale,
                                 const void* offsets, void* y, int M, int K, int N, int E,
                                 int groups, int msplit, void* stream) {
  return launch_grouped<0>(x, w, scale, offsets, y, M, K, N, E, groups, msplit, stream);
}

extern "C" int grouped_gemm_i8(const void* x, const void* w, const void* scale,
                               const void* offsets, void* y, int M, int K, int N, int E,
                               int groups, int msplit, void* stream) {
  return launch_grouped<1>(x, w, scale, offsets, y, M, K, N, E, groups, msplit, stream);
}

extern "C" int grouped_gemm_i4(const void* x, const void* w, const void* scale,
                               const void* offsets, void* y, int M, int K, int N, int E,
                               int groups, int msplit, void* stream) {
  return launch_grouped<2>(x, w, scale, offsets, y, M, K, N, E, groups, msplit, stream);
}

// The dynamic shared memory an entry launches with (out[0]) and its blocks
// an SM holds (out[1]); its shapes do not depend on the head dim or the
// group, which the other libraries' reports take.
extern "C" int resources(const char* entry, int dh, int G, int* out) {
  (void)dh, (void)G;
  if (!strcmp(entry, "grouped_gemm_bf16")) return report<0>(out);
  if (!strcmp(entry, "grouped_gemm_i8")) return report<1>(out);
  if (!strcmp(entry, "grouped_gemm_i4")) return report<2>(out);
  return (int)cudaErrorInvalidValue;
}
