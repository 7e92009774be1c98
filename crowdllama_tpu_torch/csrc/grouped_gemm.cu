// Kernel G: a grouped GEMM over an expert bank that dequantises the weight
// inside the kernel (ops/cuda/gemm.py grouped_gemm).
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
// the products take bf16 in and accumulate in fp32, rounded to bf16 once
// at the end.
//
// Two schedules, chosen by the wrapper from the shapes alone (M, K, N, E,
// the format and the int4 group), never from the offsets' values, so a
// captured graph replays the same grid (ops/cuda/gemm.py launch_shape):
//
// - The streaming schedule (grouped_stream_kernel), for few rows an
//   expert (decode).  Bound on the H100: bytes, every touched expert's
//   weights and scales read once at 3.35 TB/s.  The weight is the mma's A
//   operand (mma.sync.m16n8k16, 16 output columns a fragment) and the rows
//   of x its 8-wide B operand, so two decode rows waste 6 of 8 columns and
//   not 14 of 16 rows.  A block of 4 warps owns 128 columns of one expert
//   (64 for bf16, so a staged row is at most 128 bytes in every format)
//   and one slice of K; the raw weight tiles (64 input rows, as stored)
//   stream through a cp.async ring (four stages; three for bf16, so three
//   of its blocks share an SM) beside the pass's rows of x (up to 32), and
//   each warp turns its ldmatrix.trans fragments into bf16 in registers:
//   int8 by the byte-permute / magic-exponent trick (2^23 + q + 128 in
//   fp32, less 2^23 + 128, exact), int4 two nibbles at a time into the
//   mantissa of 128.0 (one lop3, less 136, exact), then __hmul2 by the
//   column's scale (the one rounding dequant makes).  No shared-memory
//   copy of a dequantised tile and no barrier for one.  K is split across
//   blocks by a factor fixed from the shapes (the wrapper's launch_shape:
//   a launch within one wave of resident blocks is split until it fills
//   the wave, one past a wave but short of one and a half in two), so a
//   dense decode product keeps every SM streaming; each block writes its
//   fp32 partial to the wrapper's scratch and the last block of a (column
//   tile, expert) to arrive (an integer counter, reset by it) sums the
//   partials in split order and rounds once: no float atomics, the same
//   bits on every run.
// - The wgmma schedule (grouped_wgmma_kernel), for many rows an expert
//   (prefill).  Bound: operations, 2 * rows * K * N at 989 TF/s bf16.
//   One warpgroup a block owns 128 columns of one expert and walks its
//   group's passes of 128 rows (blocks z, z + split, ...; it reads its
//   group's offsets itself, so an empty group reads no weight); each k
//   tile of 64 is two wgmma.m64n128k16 chains over a three-stage cp.async
//   ring, x K-major and the weight N-major (tnspB), both in the 128-byte
//   swizzle the wgmma descriptors name.  bf16 weight rows are copied
//   straight into that layout; int8 / int4 rows are staged as stored and
//   dequantised once a tile (the register tricks above, 8 columns of a
//   row at a time) into the one bf16 tile the wgmma reads.  The loads are
//   cp.async by every thread, not TMA behind a producer warp, and a
//   block's dequantisation does not overlap its wgmma: the other block on
//   the SM fills those gaps.
// No transposed or dequantised copy of a weight exists outside shared
// memory or registers.

#include <cstring>

#include "attention_common.cuh"

namespace cla {

using bf16 = __nv_bfloat16;

// ------------------------------------------------ the streaming schedule

constexpr int GS_WARPS = 4;
constexpr int GS_THREADS = 32 * GS_WARPS;
constexpr int GS_BK = 64;             // input rows of a staged weight tile
constexpr int GS_ROWS = 32;           // rows of x a pass: four 8-row mma tiles
constexpr int GS_XROW = GS_BK + 8;    // bf16 row of the x tile (144 B)
constexpr int GS_SROWS = GS_BK / 16;  // int4 scale rows a stage holds

// Columns of a block: 128 for int8 and int4 (32 a warp), 64 for bf16 (16
// a warp), so a block's row of W is 128 bytes or fewer in every format and
// a bf16 bank gets as many blocks per byte as an int8 one.
template <int MODE>
__host__ __device__ constexpr int gs_bn() {
  return MODE == 0 ? 64 : 128;
}

// Tiles in the cp.async ring: 4, and 3 for bf16, whose smaller ring lets
// three of its blocks share an SM with fewer registers each.
template <int MODE>
__host__ __device__ constexpr int gs_stages() {
  return MODE == 0 ? 3 : 4;
}

// Bytes of a staged weight row: the block's columns as stored, plus 16 of
// padding, so the 8 rows an ldmatrix reads start on distinct banks.
template <int MODE>
__host__ __device__ constexpr int gs_wrow() {
  return (MODE == 0 ? gs_bn<MODE>() * 2 : MODE == 1 ? gs_bn<MODE>() : gs_bn<MODE>() / 2) + 16;
}

// One ring stage: the weight tile [GS_BK][wrow], the pass's x tile
// [GS_ROWS][GS_XROW] bf16, and for MODE 2 the scale rows of the groups the
// tile's four 16-row k-steps fall in [GS_SROWS][gs_bn] bf16.
template <int MODE>
__host__ __device__ constexpr size_t gs_stage_bytes() {
  return (size_t)GS_BK * gs_wrow<MODE>() + (size_t)GS_ROWS * GS_XROW * 2 +
         (MODE == 2 ? (size_t)GS_SROWS * gs_bn<MODE>() * 2 : 0);
}

template <int MODE>
__host__ __device__ constexpr size_t gs_smem_bytes() {
  return gs_stages<MODE>() * gs_stage_bytes<MODE>();
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Bytes 0-3 of w (signed int8) as exact fp32 values whose upper 16 bits
// are the bf16 of the byte.  Each byte, biased to q + 128, becomes the low
// mantissa byte of the fp32 2^23; less 2^23 + 128 it is q exactly, and its
// upper 16 bits are q in bf16 (|q| <= 128 needs 8 significant bits).
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, uint32_t (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f);
}

// The upper halves of two such values as one bf16 pair (a low, b high).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// Bytes 0-3 of w (signed int8) as exact bf16 pairs: even = (byte 0, byte
// 2), odd = (byte 1, byte 3).
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& even, uint32_t& odd) {
  uint32_t f[4];
  i8x4_to_f32(w, f);
  even = bf16_pair(f[0], f[2]);
  odd = bf16_pair(f[1], f[3]);
}

// Nibble J of each 16-bit half of w (signed) as an exact bf16 pair: the
// nibble with its sign bit flipped (q + 8) is the low mantissa of 128.0
// (one lop3), so the pair holds 136 + q; less 136, q.
template <int J>
__device__ __forceinline__ uint32_t i4x2_to_bf16(uint32_t w) {
  return bf16x2_sub(((w >> (4 * J)) & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

// The column of the block (0 .. gs_bn) that accumulator row L (0 .. 15) of
// warp `warp`'s 16-column tile t holds (bf16: one tile a warp).  The
// fragments come from ldmatrix.trans over the stored rows, so int8
// interleaves a tile's two 8-row halves (a 16-bit element is columns 2c,
// 2c + 1) and int4 spreads four columns over its two tiles (a 16-bit
// element is 4 columns).
template <int MODE>
__device__ __forceinline__ int gs_col(int warp, int t, int L) {
  if (MODE == 0) return warp * 16 + L;
  if (MODE == 1) return warp * 32 + t * 16 + (L < 8 ? 2 * L : 2 * (L - 8) + 1);
  return warp * 32 + 4 * (L % 8) + 2 * t + (L >= 8);
}

template <int MODE>
__global__ void __launch_bounds__(GS_THREADS)
    grouped_stream_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
                          const bf16* __restrict__ scale, const int* __restrict__ offsets,
                          bf16* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters,
                          int M, int K, int N, int groups, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  constexpr int WROW = gs_wrow<MODE>();
  constexpr int RB = WROW - 16;  // stored bytes of a block's row of W
  constexpr int BN = gs_bn<MODE>();
  constexpr int WC = BN / GS_WARPS;      // columns of a warp
  constexpr int TILES = MODE == 0 ? 1 : 2;  // its 16-column mma tiles
  constexpr int STAGES = gs_stages<MODE>();
  const int tile = blockIdx.x, e = blockIdx.y, split = blockIdx.z;
  const int n0 = tile * BN;
  const int lo = offsets ? offsets[e] : 0;
  const int hi = offsets ? offsets[e + 1] : M;
  if (hi <= lo) return;  // an empty group: no block of it reads a weight

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ktiles = K / GS_BK;
  const int per = (ktiles + splits - 1) / splits;
  const int kt0 = split * per, nk = min(ktiles, kt0 + per) - kt0;
  const int ncols = min(BN, N - n0);  // BN, or 64 in a last tile of 128
  const bool live = warp * WC < ncols;   // the warp's columns exist
  const int vb = ncols * RB / BN;        // stored bytes of a row that exist
  const size_t ld = (size_t)N * RB / BN;  // bytes between rows of W
  const unsigned char* wsrc =
      static_cast<const unsigned char*>(w) + (size_t)e * K * ld + (size_t)n0 * RB / BN;
  const bf16* scale_e = scale + (MODE == 2 ? (size_t)e * groups * N : (size_t)e * N);
  const int gsize = MODE == 2 ? K / groups : 1;

  // int8: the scales of this thread's columns, as {s, s} pairs for the
  // even and odd accumulator rows of its two 16-column tiles.
  uint32_t s8[2][2] = {{0u, 0u}, {0u, 0u}};
  if (MODE == 1 && live) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint32_t v =
          __ldg(reinterpret_cast<const unsigned*>(scale_e + n0 + warp * 32 + t * 16 + 2 * gq));
      s8[t][0] = __byte_perm(v, v, 0x1010);
      s8[t][1] = __byte_perm(v, v, 0x3232);
    }
  }

  for (int m0 = lo; m0 < hi; m0 += GS_ROWS) {
    const int rows = min(GS_ROWS, hi - m0);
    const int rtiles = (rows + 7) / 8;

    // Stage st takes k tile kt: the block's columns of W's 64 rows, the
    // pass's rows of x (rows past the pass are left as they are: a column
    // of the mma's B only reaches its own, unstored, output row), and for
    // MODE 2 the scale rows of the tile's groups.
    auto load = [&](int st, int kt) {
      unsigned char* base = smem + st * gs_stage_bytes<MODE>();
      const unsigned char* src = wsrc + (size_t)kt * GS_BK * ld;
#pragma unroll
      for (int i = 0; i < GS_BK * RB / 16 / GS_THREADS; ++i) {
        const int c = tid + i * GS_THREADS, r = c / (RB / 16), col = c % (RB / 16) * 16;
        if (col < vb) cp_async16(base + r * WROW + col, src + r * ld + col);
      }
      bf16* xd = reinterpret_cast<bf16*>(base + GS_BK * WROW);
      for (int c = tid; c < rows * (GS_BK / 8); c += GS_THREADS) {
        const int r = c / (GS_BK / 8), col = c % (GS_BK / 8) * 8;
        cp_async16(xd + r * GS_XROW + col, x + (size_t)(m0 + r) * K + kt * GS_BK + col);
      }
      if (MODE == 2) {
        const int g0 = kt * GS_BK / gsize, g1 = (kt * GS_BK + GS_BK - 1) / gsize;
        bf16* sd = xd + GS_ROWS * GS_XROW;
        for (int c = tid; c < (g1 - g0 + 1) * (BN / 8); c += GS_THREADS) {
          const int r = c / (BN / 8), col = c % (BN / 8) * 8;
          if (col < ncols) cp_async16(sd + r * BN + col, scale_e + (size_t)(g0 + r) * N + n0 + col);
        }
      }
    };

    float acc[TILES][4][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int rt = 0; rt < 4; ++rt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[t][rt][c] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, kt0 + s);
      cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
      cp_async_wait<STAGES - 2>();
      // Tile it has landed, from every thread's copies, and every warp is
      // done with tile it - 1: its stage takes tile it + STAGES - 1.
      __syncthreads();
      const int nx = it + STAGES - 1;
      if (nx < nk) load(nx % STAGES, kt0 + nx);
      cp_async_commit();
      if (!live) continue;
      const unsigned char* wt = smem + (it % STAGES) * gs_stage_bytes<MODE>();
      const bf16* xt = reinterpret_cast<const bf16*>(wt + GS_BK * WROW);
      const bf16* st = xt + GS_ROWS * GS_XROW;
      const int k0 = (kt0 + it) * GS_BK;
#pragma unroll
      for (int kh = 0; kh < GS_BK / 32; ++kh) {
        // B: rows rt * 8 .. + 7 of x, k-steps 2 kh and 2 kh + 1.
        uint32_t b[4][4];
#pragma unroll
        for (int rt = 0; rt < 4; ++rt)
          if (rt < rtiles)
            ldsm_x4(b[rt], xt + (rt * 8 + lane % 8) * GS_XROW + kh * 32 + (lane / 8) * 8);
        // A: the warp's 16-column tiles over the same two k-steps.
        uint32_t a[2][2][4];
        if (MODE == 0) {
          const int mi = lane / 8;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            ldsm_x4_trans(a[0][ks], wt + (kh * 32 + ks * 16 + (mi >> 1) * 8 + lane % 8) * WROW +
                                        (warp * WC + (mi & 1) * 8) * 2);
        } else if (MODE == 1) {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            uint32_t r[4];
            ldsm_x4_trans(r, wt + (kh * 32 + lane) * WROW + warp * 32 + t * 16);
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              uint32_t e0, o0, e1, o1;
              i8x4_to_bf16(r[2 * ks], e0, o0);
              i8x4_to_bf16(r[2 * ks + 1], e1, o1);
              a[t][ks][0] = bf16x2_mul(e0, s8[t][0]);
              a[t][ks][1] = bf16x2_mul(o0, s8[t][1]);
              a[t][ks][2] = bf16x2_mul(e1, s8[t][0]);
              a[t][ks][3] = bf16x2_mul(o1, s8[t][1]);
            }
          }
        } else {
          uint32_t r[4];
          ldsm_x4_trans(r, wt + (kh * 32 + lane) * WROW + warp * 16);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int k = k0 + kh * 32 + ks * 16;
            const uint2 sv = *reinterpret_cast<const uint2*>(
                st + (k / gsize - k0 / gsize) * BN + warp * 32 + 4 * gq);
            const uint32_t p0 = __byte_perm(sv.x, sv.x, 0x1010), p1 = __byte_perm(sv.x, sv.x, 0x3232);
            const uint32_t p2 = __byte_perm(sv.y, sv.y, 0x1010), p3 = __byte_perm(sv.y, sv.y, 0x3232);
            const uint32_t rl = r[2 * ks], rh = r[2 * ks + 1];
            a[0][ks][0] = bf16x2_mul(i4x2_to_bf16<0>(rl), p0);
            a[0][ks][1] = bf16x2_mul(i4x2_to_bf16<1>(rl), p1);
            a[0][ks][2] = bf16x2_mul(i4x2_to_bf16<0>(rh), p0);
            a[0][ks][3] = bf16x2_mul(i4x2_to_bf16<1>(rh), p1);
            a[1][ks][0] = bf16x2_mul(i4x2_to_bf16<2>(rl), p2);
            a[1][ks][1] = bf16x2_mul(i4x2_to_bf16<3>(rl), p3);
            a[1][ks][2] = bf16x2_mul(i4x2_to_bf16<2>(rh), p2);
            a[1][ks][3] = bf16x2_mul(i4x2_to_bf16<3>(rh), p3);
          }
        }
#pragma unroll
        for (int t = 0; t < TILES; ++t)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int rt = 0; rt < 4; ++rt)
              if (rt < rtiles) mma_16816(acc[t][rt], a[t][ks], b[rt][2 * ks], b[rt][2 * ks + 1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass's loads overwrite every stage

    // The pass's outputs: bf16 rows of y, or this split's fp32 partial.
    if (live) {
#pragma unroll
      for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int rt = 0; rt < 4; ++rt) {
          if (rt >= rtiles) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = rt * 8 + 2 * tq + (c & 1);
            if (r >= rows) continue;
            const size_t at = (size_t)(m0 + r) * N + n0 + gs_col<MODE>(warp, t, gq + (c >> 1) * 8);
            if (splits == 1)
              y[at] = __float2bfloat16_rn(acc[t][rt][c]);
            else
              ws[(size_t)split * M * N + at] = acc[t][rt][c];
          }
        }
    }
  }
  if (splits == 1) return;

  // The last block of this (column tile, expert) to finish sums every
  // split's partial, in split order, and leaves the counter at zero.
  __threadfence();
  __syncthreads();
  int* count = counters + (size_t)e * gridDim.x + tile;
  if (tid == 0) last = atomicAdd(count, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int quads = ncols / 4;
  for (int i = tid; i < (hi - lo) * quads; i += GS_THREADS) {
    const size_t at = (size_t)(lo + i / quads) * N + n0 + i % quads * 4;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(ws + at));
    for (int z = 1; z < splits; ++z) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(ws + (size_t)z * M * N + at));
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    uint2 o;
    o.x = pack_bf16(sum.x, sum.y);
    o.y = pack_bf16(sum.z, sum.w);
    *reinterpret_cast<uint2*>(y + at) = o;
  }
  if (tid == 0) *count = 0;
}

// ------------------------------------------- the wgmma schedule (prefill)

constexpr int GW_ROWS = 128;        // rows of x a pass: two m64 wgmma tiles
constexpr int GW_BN = 128;          // columns of a block (the wgmma's N)
constexpr int GW_BK = 64;           // input rows of a staged tile
constexpr int GW_THREADS = 128;     // one warpgroup
constexpr int GW_STAGES = 3;
constexpr int GW_XTILE = 64 * 128;  // bytes of one 64-row x tile (bf16, 128 B rows)
constexpr int GW_WTILE = GW_BK * GW_BN * 2;  // bytes of a bf16 weight tile

// Raw weight bytes of a staged tile: GW_BK rows of the block's columns.
template <int MODE>
__host__ __device__ constexpr int gw_raw_bytes() {
  return GW_BK * (MODE == 0 ? GW_BN * 2 : MODE == 1 ? GW_BN : GW_BN / 2);
}

// Shared memory, 1024-byte aligned tiles: the x ring (two 64-row tiles a
// stage) and the weight ring (bf16: the tiles the wgmma reads; int8 and
// int4: the raw rows, then the one bf16 tile they are dequantised into and
// a scale row a stage: int8's column scales in the first, int4's group
// row where a group spans whole tiles).
template <int MODE>
__host__ __device__ constexpr size_t gw_smem_bytes() {
  return 1024 + (size_t)GW_STAGES * (2 * GW_XTILE + gw_raw_bytes<MODE>()) +
         (MODE == 0 ? 0 : GW_WTILE + GW_STAGES * GW_BN * 2);
}

// Byte offset of 16-byte chunk c (0 .. 7) of row r in a tile of 128-byte
// rows as the wgmma's 128-byte swizzle lays it out.
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Byte offset of columns 8 j .. 8 j + 7 of weight row k in the N-major
// bf16 tile: atoms of 8 rows x 64 columns (1024 bytes, 128-byte swizzle),
// two along N 1024 bytes apart, the 8-row groups 2048 bytes apart.
__device__ __forceinline__ int wtile_at(int k, int j) {
  return (k >> 3) * 2048 + (j >> 3) * 1024 + sw128(k & 7, j & 7);
}

// Shared-memory matrix descriptors with the 128-byte swizzle: x K-major
// (rows of 128 bytes, 8-row groups 1024 bytes apart), the weight N-major
// (atoms along N 1024 bytes apart, 8-row groups along K 2048 apart).
__device__ __forceinline__ uint64_t gw_desc(const void* p, int lbo, int sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 128 fp32, the warpgroup's fragments) += A (64 x 16, K-major) B
// (16 x 128, N-major), bf16 from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Bytes 0-3 of w (signed int8) as exact bf16 pairs in column order: lo =
// (byte 0, byte 1), hi = (byte 2, byte 3).
__device__ __forceinline__ void i8x4_to_bf16_cols(uint32_t w, uint32_t& lo, uint32_t& hi) {
  uint32_t f[4];
  i8x4_to_f32(w, f);
  lo = bf16_pair(f[0], f[1]);
  hi = bf16_pair(f[2], f[3]);
}

// Byte b of w (two int4 columns: the low nibble first) as an exact bf16
// pair in column order: the byte in both halves, a nibble of each, sign
// bit flipped into the mantissa of 128.0 (136 + q), less 136.
template <int B>
__device__ __forceinline__ uint32_t i4_byte_to_bf16(uint32_t w) {
  const uint32_t t = __byte_perm(w, 0u, B | 4 << 4 | B << 8 | 4 << 12);  // [b, 0, b, 0]
  return bf16x2_sub(((t & 0x0000000Fu) | ((t >> 4) & 0x000F0000u)) ^ 0x43084308u, 0x43084308u);
}

template <int MODE>
__global__ void __launch_bounds__(GW_THREADS)
    grouped_wgmma_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
                         const bf16* __restrict__ scale, const int* __restrict__ offsets,
                         bf16* __restrict__ y, int M, int K, int N, int groups, int msplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                            // stage st: two 64-row x tiles
  unsigned char* raw = xs + GW_STAGES * 2 * GW_XTILE;  // stage st: the weight rows
  unsigned char* wq = raw + GW_STAGES * gw_raw_bytes<MODE>();  // int8 / int4: the bf16 tile
  // int8: the block's column scales; int4: stage st's scale row, where a
  // group holds whole tiles.
  bf16* s_col = reinterpret_cast<bf16*>(wq + GW_WTILE);
  constexpr int RB = gw_raw_bytes<MODE>() / GW_BK;  // raw bytes a weight row

  const int tile = blockIdx.x, e = blockIdx.y;
  const int n0 = tile * GW_BN;
  const int lo = offsets ? offsets[e] : 0;
  const int hi = offsets ? offsets[e + 1] : M;
  if (hi - lo <= (int)blockIdx.z * GW_ROWS) return;  // an empty group, or no pass

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ktiles = K / GW_BK;
  const int ncols = min(GW_BN, N - n0);
  const size_t ld = (size_t)N * RB / GW_BN;
  const unsigned char* wsrc =
      static_cast<const unsigned char*>(w) + (size_t)e * K * ld + (size_t)n0 * RB / GW_BN;
  const bf16* scale_e = scale + (MODE == 2 ? (size_t)e * groups * N : (size_t)e * N);
  const int gsize = MODE == 2 ? K / groups : 1;
  const bool tile_group = MODE == 2 && gsize % GW_BK == 0;  // a tile's rows share their scales
  if (MODE == 1) {
    if (tid < ncols) s_col[tid] = scale_e[n0 + tid];
    __syncthreads();
  }

  for (int m0 = lo + blockIdx.z * GW_ROWS; m0 < hi; m0 += msplit * GW_ROWS) {
    const int rows = min(GW_ROWS, hi - m0);
    const int ptiles = rows > 64 ? 2 : 1;

    // Stage st takes k tile kt: the pass's rows of x (K-major, swizzled;
    // rows past the pass are left as they are: a row of the wgmma's A only
    // reaches its own, unstored, output row) and the weight rows (bf16:
    // straight into the N-major tile; int8 / int4: as stored).
    auto load = [&](int st, int kt) {
      unsigned char* xd = xs + st * 2 * GW_XTILE;
      for (int c = tid; c < rows * 8; c += GW_THREADS) {
        const int r = c / 8, ch = c % 8;
        cp_async16(xd + (r / 64) * GW_XTILE + sw128(r % 64, ch),
                   x + (size_t)(m0 + r) * K + kt * GW_BK + ch * 8);
      }
      unsigned char* rd = raw + st * gw_raw_bytes<MODE>();
      const unsigned char* src = wsrc + (size_t)kt * GW_BK * ld;
      const int vb = ncols * RB / GW_BN;
#pragma unroll
      for (int i = 0; i < GW_BK * RB / 16 / GW_THREADS; ++i) {
        const int c = tid + i * GW_THREADS, r = c / (RB / 16), col = c % (RB / 16) * 16;
        if (col < vb)
          cp_async16(rd + (MODE == 0 ? wtile_at(r, col / 16) : r * RB + col), src + r * ld + col);
      }
      if (tile_group && tid < ncols / 8)
        cp_async16(s_col + st * GW_BN + tid * 8,
                   scale_e + (size_t)(kt * GW_BK / gsize) * N + n0 + tid * 8);
    };

    float acc[2][64];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;

#pragma unroll
    for (int s0 = 0; s0 < GW_STAGES - 1; ++s0) {
      if (s0 < ktiles) load(s0, s0);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      const int st = kt % GW_STAGES;
      cp_async_wait<GW_STAGES - 2>();
      // Tile kt has landed; every thread's wgmma of tile kt - 1 is done,
      // so the bf16 tile and tile kt - 1's stage are free.
      __syncthreads();
      const int nx = kt + GW_STAGES - 1;
      if (nx < ktiles) load(nx % GW_STAGES, nx);
      cp_async_commit();
      const unsigned char* wt = raw + st * gw_raw_bytes<MODE>();
      if (MODE != 0) {
        // Dequantise as ops/quant.py dequant does (q * s, one rounding),
        // 8 columns of one row a chunk, into the N-major bf16 tile.
#pragma unroll
        for (int i = 0; i < GW_BK * (GW_BN / 8) / GW_THREADS; ++i) {
          const int c = tid + i * GW_THREADS, k = c / (GW_BN / 8), j = c % (GW_BN / 8);
          if (j * 8 >= ncols) continue;
          uint32_t o[4];
          if (MODE == 1) {
            const uint2 v = *reinterpret_cast<const uint2*>(wt + k * RB + j * 8);
            const uint4 sc = *reinterpret_cast<const uint4*>(s_col + j * 8);
            i8x4_to_bf16_cols(v.x, o[0], o[1]);
            i8x4_to_bf16_cols(v.y, o[2], o[3]);
            o[0] = bf16x2_mul(o[0], sc.x);
            o[1] = bf16x2_mul(o[1], sc.y);
            o[2] = bf16x2_mul(o[2], sc.z);
            o[3] = bf16x2_mul(o[3], sc.w);
          } else {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(wt + k * RB + j * 4);
            const uint4 sc =
                tile_group
                    ? *reinterpret_cast<const uint4*>(s_col + st * GW_BN + j * 8)
                    : __ldg(reinterpret_cast<const uint4*>(
                          scale_e + (size_t)((kt * GW_BK + k) / gsize) * N + n0 + j * 8));
            o[0] = bf16x2_mul(i4_byte_to_bf16<0>(v), sc.x);
            o[1] = bf16x2_mul(i4_byte_to_bf16<1>(v), sc.y);
            o[2] = bf16x2_mul(i4_byte_to_bf16<2>(v), sc.z);
            o[3] = bf16x2_mul(i4_byte_to_bf16<3>(v), sc.w);
          }
          *reinterpret_cast<uint4*>(wq + wtile_at(k, j)) = make_uint4(o[0], o[1], o[2], o[3]);
        }
        wt = wq;
      }
      // The tiles written by cp.async and st.shared are read by the wgmma
      // through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const unsigned char* xt = xs + st * 2 * GW_XTILE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < GW_BK / 16; ++ks) {
        const uint64_t db = gw_desc(wt + ks * 2 * 2048, 1024, 2048);
        wgmma_m64n128k16(acc[0], gw_desc(xt + ks * 32, 16, 1024), db);
        if (ptiles > 1) wgmma_m64n128k16(acc[1], gw_desc(xt + GW_XTILE + ks * 32, 16, 1024), db);
      }
      wgmma_commit();
      wgmma_wait0();
    }

    // Fragment (p, i): row p * 64 + 16 warp + gq (+ 8 for i % 4 >= 2),
    // column 8 (i / 4) + 2 tq + (i % 2).
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= ptiles) continue;
#pragma unroll
      for (int j = 0; j < GW_BN / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col >= ncols) continue;
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const int r = p * 64 + 16 * warp + gq + 8 * hrow;
          if (r < rows)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * N + n0 + col) =
                __floats2bfloat162_rn(acc[p][4 * j + 2 * hrow], acc[p][4 * j + 2 * hrow + 1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass's loads overwrite every stage
  }
}

// schedule 0: the streaming kernel, `split` splits of K; 1: the wgmma
// kernel, `split` blocks sharing one (column tile, expert)'s passes.
template <int MODE>
int launch_grouped(const void* x, const void* w, const void* scale, const void* offsets, void* y,
                   void* ws, void* counters, int M, int K, int N, int E, int groups, int schedule,
                   int split, void* stream) {
  if (schedule == 0) {
    static unsigned done = 0;
    auto* kernel = grouped_stream_kernel<MODE>;
    cudaError_t err = allow_smem(kernel, gs_smem_bytes<MODE>(), done);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + gs_bn<MODE>() - 1) / gs_bn<MODE>(), E, split);
    kernel<<<grid, GS_THREADS, gs_smem_bytes<MODE>(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), w, static_cast<const bf16*>(scale),
        static_cast<const int*>(offsets), static_cast<bf16*>(y), static_cast<float*>(ws),
        static_cast<int*>(counters), M, K, N, groups, split);
    return (int)cudaGetLastError();
  }
  if (schedule != 1) return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  auto* kernel = grouped_wgmma_kernel<MODE>;
  cudaError_t err = allow_smem(kernel, gw_smem_bytes<MODE>(), done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + GW_BN - 1) / GW_BN, E, split);
  kernel<<<grid, GW_THREADS, gw_smem_bytes<MODE>(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), w, static_cast<const bf16*>(scale),
      static_cast<const int*>(offsets), static_cast<bf16*>(y), M, K, N, groups, split);
  return (int)cudaGetLastError();
}

template <int MODE>
int report(int* out, bool stream) {
  if (stream)
    return occupancy(grouped_stream_kernel<MODE>, GS_THREADS, gs_smem_bytes<MODE>(),
                     gs_smem_bytes<MODE>(), out);
  return occupancy(grouped_wgmma_kernel<MODE>, GW_THREADS, gw_smem_bytes<MODE>(),
                   gw_smem_bytes<MODE>(), out);
}

}  // namespace cla

using namespace cla;

// x [M, K] bf16, w the bank [E, K, N] (packed [E, K, N / 2] int8 for int4),
// scale (int8: [E, N]; int4: [E, groups, N]; bf16 weights: unused),
// offsets [E + 1] int32 or null (E == 1: every row), y [M, N] bf16.
// Requires K % 64 == 0, N % 64 == 0; the wrapper checks.  schedule 0
// (streaming): `split` splits of K, ws the fp32 partials [split, M, N] and
// counters one int32 per (column tile, expert: tiles of 64 columns for
// bf16, 128 for int8 and int4), zeros, left at
// zero (both unused at one split); the int4 group K / groups a multiple
// of 16.  schedule 1 (wgmma): `split` blocks share one (column tile of
// 128, expert)'s 128-row passes; ws and counters unused.
extern "C" int grouped_gemm_bf16(const void* x, const void* w, const void* scale,
                                 const void* offsets, void* y, void* ws, void* counters, int M,
                                 int K, int N, int E, int groups, int schedule, int split,
                                 void* stream) {
  return launch_grouped<0>(x, w, scale, offsets, y, ws, counters, M, K, N, E, groups, schedule,
                           split, stream);
}

extern "C" int grouped_gemm_i8(const void* x, const void* w, const void* scale,
                               const void* offsets, void* y, void* ws, void* counters, int M,
                               int K, int N, int E, int groups, int schedule, int split,
                               void* stream) {
  return launch_grouped<1>(x, w, scale, offsets, y, ws, counters, M, K, N, E, groups, schedule,
                           split, stream);
}

extern "C" int grouped_gemm_i4(const void* x, const void* w, const void* scale,
                               const void* offsets, void* y, void* ws, void* counters, int M,
                               int K, int N, int E, int groups, int schedule, int split,
                               void* stream) {
  return launch_grouped<2>(x, w, scale, offsets, y, ws, counters, M, K, N, E, groups, schedule,
                           split, stream);
}

// The dynamic shared memory an entry launches with (out[0]) and its blocks
// an SM holds (out[1]): "grouped_gemm_<fmt>" its wgmma schedule,
// "grouped_gemm_<fmt>_stream" its streaming one.  Their shapes do not
// depend on the head dim or the group, which the other libraries' reports
// take.
extern "C" int resources(const char* entry, int dh, int G, int* out) {
  (void)dh, (void)G;
  if (!strcmp(entry, "grouped_gemm_bf16")) return report<0>(out, false);
  if (!strcmp(entry, "grouped_gemm_i8")) return report<1>(out, false);
  if (!strcmp(entry, "grouped_gemm_i4")) return report<2>(out, false);
  if (!strcmp(entry, "grouped_gemm_bf16_stream")) return report<0>(out, true);
  if (!strcmp(entry, "grouped_gemm_i8_stream")) return report<1>(out, true);
  if (!strcmp(entry, "grouped_gemm_i4_stream")) return report<2>(out, true);
  return (int)cudaErrorInvalidValue;
}
