// HEVC residuals (8.6.2-8.6.4, flat scaling list, 8-bit) of whole planes:
// dequantisation and the two-stage inverse DCT / DST, exact in int32, a
// 32x32 area of one plane a warp. Built by
// jmcodec_tpu_torch/kernels/_build.py; bound with ctypes by
// jmcodec_tpu_torch/kernels/hevc_resid.py (resid_planes), whose plain
// torch version (planes_reference, on residual_reference) it must equal
// bit for bit.
//
// Replaces the residual stage that jmcodec_tpu runs as XLA matrix products
// (kernels/hevc_tiles.py: _residual_plane at :84, with _dequant_blocks,
// _itransform_blocks and _exact_int_matmul). There every n-aligned block of
// the plane goes through the transform at every TU size n (a
// static shape for the MXU, each product split into hi and lo halves to
// stay exact in f32), and a mask keeps the blocks whose origin cell holds
// that size; the contributions of every size are summed. Here a block is
// transformed only where its origin cell holds its size and one of its
// levels is not zero (a zero block gives zeros through both rounding
// stages), and the sum is kept: a TU map that is not a clean quadtree
// gives overlapping blocks, and they add, as in the reference.
//
// Layout, for F frames and K = 1 (luma) or 2 (Cb, Cr) components of one
// H x W plane size:
//     coeff0, coeff1 [F, H, W] int16   the levels of component 0 and 1
//                                      (coeff1 null for K = 1)
//     tu   [F, H/4, W/4] int8          log2 TU size per 4x4 cell (0: none)
//     qp   [F, s H/4, s W/4] int8      the luma cell QP; s = 2 for chroma,
//                                      whose cell (cy, cx) takes the luma
//                                      cell (2 cy, 2 cx) through
//                                      QPC_T[clip(qp + off[f], 0, 57)]
//     off0, off1 [F] int32             the chroma QP offsets (chroma only)
//     out  [K F, H, W] int16           the residual of every size, summed
//                                      (at most 28,224: int16 holds it;
//                                      hevc_resid.py); plane k F + f (Cb
//                                      of every frame, then Cr)
// Luma takes the TU sizes 4..32 on planes whose H and W are multiples of
// 32; chroma (4:2:0) 4..16 on multiples of 16, so the areas of the last
// column and row may be half outside the plane (masked).
//
// Bound on this card: bytes (2 B of level in and 2 B of residual out a
// sample: 0.041 / 0.021 ms for the luma / Cb + Cr launch at the 1080p
// batch of 16); the partial butterflies' multiply-adds take less. The
// design keeps the matrices out of memory and each sample in registers,
// reads and writes each sample of the plane once, and has no CTA barrier:
// each warp of a CTA takes an area of its own.
//  1. staging: a lane loads 4 x 16 B of levels (8 samples of 4 rows) into
//     the warp's shared tile and the TU size and QP of two cells, and
//     turns each QP into its dequantisation (levelScale, QP / 6); the warp
//     ORs which cells hold a level, and which hold one outside their DC
//     sample.
//  2. the active blocks: ballots find the blocks whose origin cell holds
//     their size and whose cells hold a level. A DCT block whose one level
//     is its DC has one residual value throughout (the DCT's row 0 is 64
//     throughout): the lane that found it computes it, and no transform
//     runs; a cell's DC value is the sum over the DC blocks that cover it,
//     gathered by shuffles. The other blocks are listed by size. The
//     output tile starts at the DC values (if any block is listed).
//  3. the blocks, in rounds of 32 lanes, one size a round, largest first:
//     n lanes an n x n block (n >= 8), a column each, or a lane a 4x4
//     block. A lane loads its column's levels, dequantises them, runs the
//     inverse transform as a partial butterfly (the even inputs through the
//     n/2-point DCT, the odd ones through the odd rows' n/2 x n/2
//     products, two a __dp2a_lo, as HM's partialButterflyInverse; DST-VII
//     as its fastInverseDst), every matrix entry an immediate, and stores the
//     rounded, clipped column into the transpose tile; after a __syncwarp
//     of its block's lanes it loads its row, runs the same butterfly and
//     adds the rounded row to the output tile, 16 B at a time. A 4x4 block
//     stays in its lane's registers throughout. Every block adds, so the
//     blocks of a map that is not a clean tree (they overlap) sum as in
//     the reference, with no test for it.
//  4. a lane stores 4 x 16 B of the residual: the output tile, or the DC
//     values (zeros where no block lies) if no block was listed.
// What holds it back (chip_smoke.py's phase 30, PERF.md): the 32x32
// blocks' butterflies on the integer pipe (64 lanes an SM a clock), which
// one warp runs alone, and the latency a warp waits for its area's levels
// before it has work.
//
// Arithmetic: int32 throughout; every partial sum is below 2^27, so the
// butterfly's reordering of the exact integer sums is exact. The rounding
// constants ride on the DC input: the DCT's row 0 is 64 throughout, so
// (y + 64) >> 7 and (y + 2048) >> 12 take x[0] + 1 and x[0] + 32. The
// dequantisation is _dequant_blocks' (floor division of the QP as torch
// does it, so negative int8 QPs index like the plain version; the domain
// is QP <= 51), the left shift a multiply, the right shifts arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kA = 32;       // a warp's area: kA x kA samples of one plane
constexpr int kC = kA / 4;   // its 4x4 cells a side
constexpr int kTP = kA + 2;  // pitch (int16) of the transpose tile

// 8.6.4.2's transMatrix, the 32-point DCT's first column: the magnitude
// for the angle a pi / 64, a = 0..32 (codec/hevc/transform.py: _B)
__host__ __device__ constexpr int dct_basis(int a) {
  switch (a) {
    case 0: return 64;
    case 1: return 90;
    case 2: return 90;
    case 3: return 90;
    case 4: return 89;
    case 5: return 88;
    case 6: return 87;
    case 7: return 85;
    case 8: return 83;
    case 9: return 82;
    case 10: return 80;
    case 11: return 78;
    case 12: return 75;
    case 13: return 73;
    case 14: return 70;
    case 15: return 67;
    case 16: return 64;
    case 17: return 61;
    case 18: return 57;
    case 19: return 54;
    case 20: return 50;
    case 21: return 46;
    case 22: return 43;
    case 23: return 38;
    case 24: return 36;
    case 25: return 31;
    case 26: return 25;
    case 27: return 22;
    case 28: return 18;
    case 29: return 13;
    case 30: return 9;
    case 31: return 4;
    case 32: return 0;
  }
  return 0;
}

// 64 cos(a pi / 64) as the spec rounds it, from the basis by symmetry
__host__ __device__ constexpr int cos64(int a) {
  a &= 127;
  int s = 1;
  if (a > 64) {  // cos(x + pi) = -cos(x)
    a -= 64;
    s = -1;
  }
  if (a > 32) {  // cos(pi - x) = -cos(x)
    a = 64 - a;
    s = -s;
  }
  return s * dct_basis(a);
}

// the N-point DCT's entry (k, j): frequency k, sample j (transform.DCT[N])
template <int N>
__host__ __device__ constexpr int dct(int k, int j) {
  return cos64(k * (32 / N) * (2 * j + 1));
}

// the 4x4 DST-VII's entry (k, j) (8.6.4.2; transform.DST4)
__host__ __device__ constexpr int dst4(int k, int j) {
  switch (4 * k + j) {
    case 0: return 29;
    case 1: return 55;
    case 2: return 74;
    case 3: return 84;
    case 4: return 74;
    case 5: return 74;
    case 6: return 0;
    case 7: return -74;
    case 8: return 84;
    case 9: return -29;
    case 10: return -74;
    case 11: return 55;
    case 12: return 55;
    case 13: return -84;
    case 14: return 74;
    case 15: return -29;
  }
  return 0;
}

// fastInverseDst takes the DST's rows as (a, b, c, a + b), (c, c, 0, -c),
// (a + b, -a, -c, b), (b, -(a + b), c, -a)
constexpr int kDa = dst4(0, 0), kDb = dst4(0, 1), kDc = dst4(0, 2);
static_assert(dst4(0, 3) == kDa + kDb && dst4(1, 0) == kDc &&
                  dst4(1, 1) == kDc && dst4(1, 2) == 0 &&
                  dst4(1, 3) == -kDc && dst4(2, 0) == kDa + kDb &&
                  dst4(2, 1) == -kDa && dst4(2, 2) == -kDc &&
                  dst4(2, 3) == kDb && dst4(3, 0) == kDb &&
                  dst4(3, 1) == -(kDa + kDb) && dst4(3, 2) == kDc &&
                  dst4(3, 3) == -kDa,
              "the DST-VII does not have fastInverseDst's form");
static_assert(dct<32>(0, 7) == 64 && dct<4>(1, 0) == 83 &&
                  dct<4>(3, 0) == 36 && dct<32>(1, 0) == 90 &&
                  dct<32>(31, 0) == 4 && dct<32>(31, 1) == -13,
              "the DCT basis or its symmetry is wrong");

// 8.6.3's levelScale, and Table 8-10's QpC for qPi = 0..57 (4:2:0)
__constant__ int kLevelScale[6] = {40, 45, 51, 57, 64, 72};
__constant__ int kQpcT[58] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51};

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

// y[j] = sum_k dct<N>(k, j) x[k] for j, k < N, as a partial butterfly:
// E = the N/2-point transform of the even inputs, O[j] = sum_m
// dct<N>(2m + 1, j) x[2m + 1], y[j] = E[j] + O[j], y[N-1-j] = E[j] - O[j]
// (dct<N>(2m, j) = dct<N/2>(m, j); the even rows are symmetric about the
// middle, the odd ones antisymmetric). The odd inputs fit int16 (only
// x[0] carries a rounding bias) and the entries int8, so O takes them two
// at a time: __dp2a_lo of a packed pair of inputs and a pair of entries.
template <int N>
__device__ __forceinline__ void idct(const int (&x)[N], int (&y)[N]) {
  if constexpr (N == 1) {
    y[0] = dct<1>(0, 0) * x[0];
  } else {
    constexpr int H = N / 2;
    int xe[H], e[H];
#pragma unroll
    for (int m = 0; m < H; ++m) xe[m] = x[2 * m];
    idct<H>(xe, e);
    if constexpr (H == 1) {
      const int o = dct<N>(1, 0) * x[1];
      y[0] = e[0] + o;
      y[1] = e[0] - o;
    } else {
      int pk[H / 2];
#pragma unroll
      for (int m = 0; m < H / 2; ++m)
        pk[m] = __byte_perm(x[4 * m + 1], x[4 * m + 3], 0x5410);
#pragma unroll
      for (int j = 0; j < H; ++j) {
        int o = 0;
#pragma unroll
        for (int m = 0; m < H / 2; ++m)
          o = __dp2a_lo(pk[m],
                        (dct<N>(4 * m + 1, j) & 0xFF) |
                            ((dct<N>(4 * m + 3, j) & 0xFF) << 8),
                        o);
        y[j] = e[j] + o;
        y[N - 1 - j] = e[j] - o;
      }
    }
  }
}

// y[j] = sum_k dst4(k, j) x[k] + bias, as fastInverseDst
__device__ __forceinline__ void idst4(const int (&x)[4], int (&y)[4],
                                      int bias) {
  const int c0 = x[0] + x[2], c1 = x[2] + x[3], c2 = x[0] - x[3];
  const int c3 = kDc * x[1] + bias;
  y[0] = kDa * c0 + kDb * c1 + c3;
  y[1] = kDb * c2 - kDa * c1 + c3;
  y[2] = kDc * (x[0] - x[2] + x[3]) + bias;
  y[3] = kDb * c0 + kDa * c2 - (c3 - 2 * bias);
}

// the stage's transform with its rounding, (sum + (1 << (SHIFT - 1))) >>
// SHIFT (the DCT's bias on x[0], see above), clipped to int16 if CLIP
template <int N, int SHIFT, bool CLIP>
__device__ __forceinline__ void stage(int (&x)[N], int (&y)[N], bool dst) {
  constexpr int bias = 1 << (SHIFT - 1);
  bool done = false;
  if constexpr (N == 4) {
    if (dst) {
      idst4(x, y, bias);
      done = true;
    }
  }
  if (!done) {
    static_assert(bias % dct<N>(0, 0) == 0, "the bias is not a DC step");
    x[0] += bias / dct<N>(0, 0);
    idct<N>(x, y);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    y[i] = CLIP ? clip16(y[i] >> SHIFT) : y[i] >> SHIFT;
}

constexpr int kWarps = 4;     // warps a CTA, an area each
constexpr int kOP = kA + 8;   // pitch (int16) of the output tile (16 B rows)

// A warp's shared memory
struct WarpSmem {
  int16_t lev[kA * kA];   // the area's levels
  int16_t out[kA * kOP];  // its residual
  int16_t tr[kA * kTP];   // the transpose tile of the round in hand
  int dq[kC * kC];        // a cell's levelScale * 16 + (QP / 6) * 65536
  uint8_t list[96];       // the other active blocks by size, their origin
                          // cells: 4x4 at 0, 8x8 at 64, 16x16 at 80
};
static_assert(sizeof(int16_t) * kA * kA % 16 == 0 &&
                  sizeof(int16_t) * kOP % 16 == 0 &&
                  sizeof(WarpSmem) % 16 == 0,
              "the tiles' rows are not 16 B aligned");

// _dequant_blocks at TU size 1 << log2 for a cell's dq, as one formula:
// clip16((c * mul + add) >> sh) (the left shift of QP / 6 >= log2 + 3 a
// multiply: |c * levelScale * 16| < 2^26, so it does not overflow)
__device__ __forceinline__ void dequant_of(int dq, int log2, int& mul,
                                          int& add, int& sh) {
  const int k = (dq >> 16) - (log2 + 3);
  mul = (dq & 0xFFFF) << (k > 0 ? k : 0);
  sh = k < 0 ? -k : 0;
  add = k < 0 ? 1 << (sh - 1) : 0;
}

// The residual of a block whose one level is its DC: the same value at
// every sample (the DCT's row 0 is 64 throughout)
__device__ __forceinline__ int dc_value(int c, int dq, int log2) {
  int mul, add, sh;
  dequant_of(dq, log2, mul, add, sh);
  const int d = clip16((c * mul + add) >> sh);
  const int e = clip16((dct<4>(0, 0) * d + 64) >> 7);
  return (dct<4>(0, 0) * e + 2048) >> 12;
}

// two int16 values in one word
__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (unsigned)(lo & 0xFFFF) | ((unsigned)hi << 16);
}

// One n x n block (n = 1 << LOG2 >= 8) at the area's cell `origin`: the
// lane takes its column, then adds its row j to the output tile. gmask:
// the block's n lanes.
template <int LOG2>
__device__ __forceinline__ void block(WarpSmem& sm, int origin, int j,
                                      unsigned gmask) {
  constexpr int N = 1 << LOG2;
  const int by = (origin >> 3) * 4, bx = (origin & 7) * 4;
  int mul, add, sh;
  dequant_of(sm.dq[origin], LOG2, mul, add, sh);
  const int16_t* lev = &sm.lev[by * kA + bx + j];
  int x[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = clip16((lev[i * kA] * mul + add) >> sh);
  // columns: the column's N values into the transpose tile
  stage<N, 7, true>(x, y, false);
#pragma unroll
  for (int i = 0; i < N; ++i) sm.tr[(by + i) * kTP + bx + j] = (int16_t)y[i];
  __syncwarp(gmask);
  // rows: row j of the block (int16 inputs: below 2^15 after the shift,
  // so the clip is left out; tests/test_torch_hevc_residual.py bounds it)
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = sm.tr[(by + j) * kTP + bx + i];
  stage<N, 12, false>(x, y, false);
  // (int16 lanes wrap: the sum of the blocks fits int16, so it is exact)
  uint4* o = reinterpret_cast<uint4*>(&sm.out[(by + j) * kOP + bx]);
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    uint4 t = o[q];
    t.x = __vadd2(t.x, pack2(y[8 * q], y[8 * q + 1]));
    t.y = __vadd2(t.y, pack2(y[8 * q + 2], y[8 * q + 3]));
    t.z = __vadd2(t.z, pack2(y[8 * q + 4], y[8 * q + 5]));
    t.w = __vadd2(t.w, pack2(y[8 * q + 6], y[8 * q + 7]));
    o[q] = t;
  }
}

// One 4x4 block at the area's cell `origin`, all in the lane's registers,
// added to the output tile (dst: the DST-VII, intra luma)
__device__ __forceinline__ void block4(WarpSmem& sm, int origin, bool dst) {
  const int by = (origin >> 3) * 4, bx = (origin & 7) * 4;
  int mul, add, sh;
  dequant_of(sm.dq[origin], 2, mul, add, sh);
  int x[4][4], y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // row i: 8 B
    const uint2 r =
        *reinterpret_cast<const uint2*>(&sm.lev[(by + i) * kA + bx]);
    const int c[4] = {(int16_t)r.x, (int)r.x >> 16, (int16_t)r.y,
                      (int)r.y >> 16};
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = clip16((c[j] * mul + add) >> sh);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // columns
    int col[4] = {x[0][j], x[1][j], x[2][j], x[3][j]};
    stage<4, 7, true>(col, y, dst);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i][j] = y[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // rows
    stage<4, 12, false>(x[i], y, dst);
    uint2* o = reinterpret_cast<uint2*>(&sm.out[(by + i) * kOP + bx]);
    const uint2 r = *o;
    *o = make_uint2(__vadd2(r.x, pack2(y[0], y[1])),
                    __vadd2(r.y, pack2(y[2], y[3])));
  }
}

__device__ __forceinline__ int up32(int v) { return (v + 31) & ~31; }

// CTAs an SM holds: their shared memory (4 x 7,136 B, and 1 KB the card
// keeps a CTA) fills it at seven.
// Chroma's kernel fits 72 registers a thread, so all seven stay; luma's
// 32-point butterflies take up to 80 without spilling, so six.
constexpr int ctas_per_sm(int vmax) { return vmax == 5 ? 6 : 7; }

// VMAX: the largest log2 TU size, 5 (luma: the QP read as it is) or 4
// (chroma: the QP through QPC_T). Warp w of CTA (bx, by, p) takes the area
// in column bx kWarps + w, row by of plane p.
template <int VMAX>
__global__ void __launch_bounds__(32 * kWarps, ctas_per_sm(VMAX))
    hevc_resid_butterfly(const int16_t* __restrict__ coeff0,
                         const int16_t* __restrict__ coeff1,
                         const int8_t* __restrict__ tu,
                         const int8_t* __restrict__ qp,
                         const int* __restrict__ off0,
                         const int* __restrict__ off1,
                         int16_t* __restrict__ out, int frames, int H, int W,
                         int dst4) {
  __shared__ __align__(16) WarpSmem smem[kWarps];
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ax = blockIdx.x * kWarps + w;
  if (ax * kA >= W) return;
  WarpSmem& sm = smem[w];
  const int p = blockIdx.z, comp = p >= frames, f = p - comp * frames;
  const int y0 = blockIdx.y * kA, x0 = ax * kA;
  const int H4 = H / 4, W4 = W / 4;

  // ---- 1. staging: rows lane / 4 + 8 i, 8 samples at (lane % 4) * 8;
  // cells lane and lane + 32 ----
  const int ry = lane >> 2, rx = (lane & 3) * 8;
  const int16_t* src = (comp ? coeff1 : coeff0) + ((size_t)f * H + y0) * W;
  int4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = make_int4(0, 0, 0, 0);
    if (y0 + ry + 8 * i < H && x0 + rx < W)
      v[i] = *reinterpret_cast<const int4*>(src + (size_t)(ry + 8 * i) * W +
                                            x0 + rx);
  }
  int tu2[2], dq2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h, gy = y0 / 4 + (c >> 3), gx = x0 / 4 + (c & 7);
    int q = 0;
    tu2[h] = 0;
    if (gy < H4 && gx < W4) {
      tu2[h] = tu[((size_t)f * H4 + gy) * W4 + gx];
      if (VMAX == 5) {
        q = qp[((size_t)f * H4 + gy) * W4 + gx];
      } else {
        q = qp[((size_t)f * (2 * H4) + 2 * gy) * (2 * W4) + 2 * gx] +
            (comp ? off1 : off0)[f];
        q = kQpcT[q < 0 ? 0 : (q > 57 ? 57 : q)];
      }
    }
    int s = q / 6, m = q - 6 * s;
    if (m < 0) {
      m += 6;
      s -= 1;
    }
    dq2[h] = kLevelScale[m] * 16 + s * 65536;
  }
  // cells 0..31, 32..63 with a level; with one outside their DC sample
  unsigned nz2[2] = {0u, 0u}, ac2[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 q = v[i];
    *reinterpret_cast<int4*>(&sm.lev[(ry + 8 * i) * kA + rx]) = q;
    const int c = ((ry + 8 * i) >> 2) * kC + (rx >> 2);
    const unsigned dc_row = (ry & 3) == 0 ? 0xFFFF0000u : 0xFFFFFFFFu;
    nz2[i >> 1] |= (((q.x | q.y) != 0 ? 1u : 0u) |
                    ((q.z | q.w) != 0 ? 2u : 0u))
                   << (c & 31);
    ac2[i >> 1] |= ((((q.x & dc_row) | q.y) != 0 ? 1u : 0u) |
                    (((q.z & dc_row) | q.w) != 0 ? 2u : 0u))
                   << (c & 31);
  }
  sm.dq[lane] = dq2[0];
  sm.dq[lane + 32] = dq2[1];
  __syncwarp();
  const auto or64 = [&](unsigned long long m) {
    return __reduce_or_sync(kAll, (unsigned)m) |
           (unsigned long long)__reduce_or_sync(kAll, (unsigned)(m >> 32))
               << 32;
  };
  const unsigned long long nz =
      or64(nz2[0] | (unsigned long long)nz2[1] << 32);
  const unsigned long long ac =
      or64(ac2[0] | (unsigned long long)ac2[1] << 32);

  // ---- 2. the active blocks: origin cell holding the size, a level. A
  // lane's candidates: the 4x4 blocks at cells lane and lane + 32, and
  // the 8x8 block lane (< 16), the 16x16 block lane - 16 (< 20) or the
  // 32x32 block (20) ----
  const bool a4lo = tu2[0] == 2 && (nz >> lane & 1);
  const bool a4hi = tu2[1] == 2 && (nz >> (32 + lane) & 1);
  int o, v_big;
  unsigned long long cells;
  if (lane < 16) {  // 8x8 block (lane / 4, lane % 4)
    v_big = 3;
    o = (lane >> 2) * 16 + (lane & 3) * 2;
    cells = 0x303ull << o;
  } else if (lane < 20) {  // 16x16 block
    v_big = 4;
    o = ((lane - 16) >> 1) * 32 + ((lane - 16) & 1) * 4;
    cells = 0x0F0F0F0Full << o;
  } else {  // 32x32 block
    v_big = 5;
    o = 0;
    cells = ~0ull;
  }
  const int tu_lo = __shfl_sync(kAll, tu2[0], o & 31);
  const int tu_hi = __shfl_sync(kAll, tu2[1], o & 31);
  const bool abig = lane <= 20 && v_big <= VMAX &&
                    (o < 32 ? tu_lo : tu_hi) == v_big && (nz & cells) != 0;
  int16_t* res = out + ((size_t)p * H + y0) * W;
  if (__ballot_sync(kAll, a4lo || a4hi || abig) == 0) {  // no block
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (y0 + ry + 8 * i < H && x0 + rx < W)
        *reinterpret_cast<int4*>(res + (size_t)(ry + 8 * i) * W + x0 + rx) =
            make_int4(0, 0, 0, 0);
    return;
  }
  // DC blocks (the one level at the origin; the DCT): their residual is
  // one value. A cell's DC value is the sum of those of the blocks that
  // cover it (more than one where a map is not a clean tree): its own 4x4
  // block's and the larger ones' from the lanes that found them (cells
  // lane and lane + 32)
  const bool dst = dst4 != 0;
  const bool dc4lo = a4lo && !dst && !(ac >> lane & 1);
  const bool dc4hi = a4hi && !dst && !(ac >> (32 + lane) & 1);
  const bool dcbig =
      abig && !(ac >> o & 1) && (nz & cells & ~(1ull << o)) == 0;
  const int rbig = dcbig ? dc_value(sm.lev[(o >> 3) * 4 * kA + (o & 7) * 4],
                                    sm.dq[o], v_big)
                         : 0;
  const unsigned mdc = __ballot_sync(kAll, dcbig);
  int dc2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h, cy = c >> 3, cx = c & 7;
    const int b8 = (cy >> 1) * 4 + (cx >> 1), b16 = 16 + (cy >> 2) * 2 +
                                                        (cx >> 2);
    const int r8 = __shfl_sync(kAll, rbig, b8);
    const int r16 = __shfl_sync(kAll, rbig, b16);
    const int r32 = __shfl_sync(kAll, rbig, 20);
    dc2[h] = (h ? dc4hi : dc4lo)
                 ? dc_value(sm.lev[cy * 4 * kA + cx * 4], dq2[h], 2)
                 : 0;
    dc2[h] += (mdc >> b8 & 1 ? r8 : 0) + (mdc >> b16 & 1 ? r16 : 0) +
              (mdc >> 20 & 1 ? r32 : 0);
  }
  // the DC values of the lane's 16 B rows: ry + 8 i, samples rx..rx + 7
  // (cells c0 + 16 i and c0 + 16 i + 1), as int16 pairs
  const int c0 = (ry >> 2) * kC + (rx >> 2);
  unsigned init[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      init[i][h] =
          ((unsigned)__shfl_sync(kAll, dc2[i >> 1], c0 + 16 * (i & 1) + h) &
           0xFFFF) *
          0x10001u;
  // the other active blocks, listed by size
  const bool f4lo = a4lo && !dc4lo, f4hi = a4hi && !dc4hi;
  const bool fbig = abig && !dcbig;
  const unsigned m4lo = __ballot_sync(kAll, f4lo);
  const unsigned m4hi = __ballot_sync(kAll, f4hi);
  const unsigned mbig = __ballot_sync(kAll, fbig);
  const unsigned lt = (1u << lane) - 1;
  if (f4lo) sm.list[__popc(m4lo & lt)] = (uint8_t)lane;
  if (f4hi) sm.list[__popc(m4lo) + __popc(m4hi & lt)] = (uint8_t)(32 + lane);
  if (fbig && lane < 16)
    sm.list[64 + __popc(mbig & 0xFFFFu & lt)] = (uint8_t)o;
  if (fbig && lane >= 16 && lane < 20)
    sm.list[80 + __popc(mbig & 0xF0000u & lt)] = (uint8_t)o;
  const int c4 = __popc(m4lo) + __popc(m4hi), c8 = __popc(mbig & 0xFFFFu);
  const int c16 = __popc(mbig & 0xF0000u), c32 = (mbig >> 20) & 1;
  const int s32 = 32 * c32, s16 = up32(16 * c16), s8 = up32(8 * c8);
  const int total = s32 + s16 + s8 + up32(c4);
  if (total != 0) {  // the output tile starts at the DC values
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(&sm.out[(ry + 8 * i) * kOP + rx]) =
          make_uint4(init[i][0], init[i][0], init[i][1], init[i][1]);
  }
  __syncwarp();

  // ---- 3. the blocks: slots 32-aligned by size, largest first (n lanes
  // an n x n block, a lane a 4x4 one), a round of 32 a size ----
  for (int base = 0; base < total; base += 32) {
    int r = base + lane;
    if (r < s32) {
      if constexpr (VMAX == 5) block<5>(sm, 0, lane, kAll);
    } else if ((r -= s32) < s16) {
      if (r >> 4 < c16)
        block<4>(sm, sm.list[80 + (r >> 4)], r & 15,
                 0xFFFFu << (lane & 16));
    } else if ((r -= s16) < s8) {
      if (r >> 3 < c8)
        block<3>(sm, sm.list[64 + (r >> 3)], r & 7,
                 0xFFu << (lane & 24));
    } else if ((r -= s8) < c4) {
      block4(sm, sm.list[r], dst);
    }
    __syncwarp();
  }

  // ---- 4. the residual, 16 B a store: the output tile, or the DC
  // values where no block was transformed ----
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = ry + 8 * i;
    const uint4 r =
        total != 0 ? *reinterpret_cast<const uint4*>(&sm.out[y * kOP + rx])
                   : make_uint4(init[i][0], init[i][0], init[i][1],
                                init[i][1]);
    if (y0 + y < H && x0 + rx < W)
      asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                       res + (size_t)y * W + x0 + rx),
                   "r"(r.x), "r"(r.y), "r"(r.z), "r"(r.w)
                   : "memory");
  }
}

}  // namespace

// chroma: Cb and Cr (K = 2, coeff1 and off1 set; K = 1 would take one
// component), the TU sizes 4..16, H and W multiples of 16, each block's QP
// derived through QPC_T with off0 / off1; else luma (coeff1 null), the
// sizes 4..32, H and W multiples of 32, the QP read from qp. dst4: the DST
// at 4x4 (intra luma). Every pointer 16-byte aligned. Launches on
// `stream`, does not synchronise. Returns the launch's cudaError_t (0 =
// success).
extern "C" int hevc_resid_launch(const void* coeff0, const void* coeff1,
                                 const void* tu, const void* qp,
                                 const void* off0, const void* off1,
                                 void* out, int frames, int H, int W,
                                 int dst4, int chroma, void* stream) {
  const int K = coeff1 != nullptr ? 2 : 1, R = chroma ? 16 : 32;
  if (frames <= 0 || H <= 0 || W <= 0 || H % R != 0 || W % R != 0 ||
      (long long)frames * K > 65535 || (H + kA - 1) / kA > 65535 ||
      (chroma && (off0 == nullptr || (K == 2 && off1 == nullptr))))
    return (int)cudaErrorInvalidValue;
  const auto c0 = static_cast<const int16_t*>(coeff0);
  const auto c1 = static_cast<const int16_t*>(coeff1);
  const auto t8 = static_cast<const int8_t*>(tu);
  const auto q8 = static_cast<const int8_t*>(qp);
  const auto o0 = static_cast<const int*>(off0);
  const auto o1 = static_cast<const int*>(off1);
  const auto o = static_cast<int16_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kA * kWarps - 1) / (kA * kWarps), (H + kA - 1) / kA,
                  frames * K);
  if (chroma)
    hevc_resid_butterfly<4><<<grid, 32 * kWarps, 0, s>>>(
        c0, c1, t8, q8, o0, o1, o, frames, H, W, dst4);
  else
    hevc_resid_butterfly<5><<<grid, 32 * kWarps, 0, s>>>(
        c0, c1, t8, q8, o0, o1, o, frames, H, W, dst4);
  return (int)cudaGetLastError();
}
