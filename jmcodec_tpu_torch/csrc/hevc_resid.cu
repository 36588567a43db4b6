// HEVC residuals (8.6.2-8.6.4, flat scaling list, 8-bit) of whole planes:
// dequantisation and the two-stage inverse DCT / DST, exact in int32, a
// region of the plane a CTA. Built by jmcodec_tpu_torch/kernels/_build.py;
// bound with ctypes by jmcodec_tpu_torch/kernels/hevc_resid.py
// (resid_planes), whose plain torch version (planes_reference, on
// residual_reference) it must equal bit for bit.
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
//     tab  int8, kTabLen               DCT32, DST4, LEVEL_SCALE, QPC_T
//                                      (hevc_resid.py: tables())
//     out  [K F, H, W] int16           the residual of every size, summed
//                                      (at most 28,224: int16 holds it;
//                                      hevc_resid.py); plane k F + f (Cb
//                                      of every frame, then Cr)
// Luma takes the TU sizes 4..32, chroma (4:2:0) 4..16. H and W are
// multiples of R, the largest of them and the region a CTA takes: 32 for
// luma, 16 for chroma. The n-point DCT is rows 0, 32/n, ... of the
// 32-point one, its first n columns.
//
// Bound on this card: bytes (2 B of level in and 2 B of residual out a
// sample, ~50 M samples at the 1080p batch of 16: 0.06 ms); the
// multiply-adds a partial butterfly needs take less. The design is the
// simple one: a CTA of R*R/4 threads a region, each thread four samples of
// one column (its levels in registers, its sum over the sizes in
// registers), the region's cell maps, the block flags and the two stages'
// int32 blocks in shared memory. A region without a level or without a TU
// of its sizes writes zeros and stops; a size no block of the region takes
// is passed over. The stages are dot products over shared memory, a sample a
// thread; no butterfly yet.
//
// Arithmetic: int32 throughout; every partial sum is below 2^27. The
// dequantisation is _dequant_blocks' (floor division of the QP as torch
// does it, so negative int8 QPs index like the plain version; the domain
// is QP <= 51), the left shift a multiply, the right shifts arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// offsets in the int8 table (hevc_resid.py: TAB_* hold the same)
constexpr int kTabDct = 0;      // DCT32[k][j], 32 x 32
constexpr int kTabDst = 1024;   // DST4[k][j], 4 x 4
constexpr int kTabLs = 1040;    // LEVEL_SCALE[6]
constexpr int kTabQpc = 1048;   // QPC_T[58]
constexpr int kTabLen = 1106;

__device__ __forceinline__ int clip16(int v) {
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

// _dequant_blocks for one level c of a block of size 1 << log2 at QP qp
__device__ __forceinline__ int dequant(int c, int qp, int log2,
                                       const int* ls) {
  int s = qp / 6, m = qp - 6 * s;
  if (m < 0) {
    m += 6;
    s -= 1;
  }
  const int bd_shift = log2 + 3;
  const int d1 = c * (ls[m] * 16);  // |d1| < 2^26
  const int k = s - bd_shift;
  if (k >= 0) {
    const int lim = 1 << (15 - k);
    return d1 >= lim ? 32767 : (d1 < -lim ? -32768 : d1 * (1 << k));
  }
  return clip16((d1 + (1 << (-k - 1))) >> (-k));
}

template <int R>
struct Smem {
  static constexpr int R4 = R / 4;
  int tab[kTabLs + 6];   // DCT32, DST4, LEVEL_SCALE as int32
  int d[R * R];          // dequantised levels of the size in hand
  int e[R * R];          // after the column stage
  int tu[R4 * R4];
  int qp[R4 * R4];
  int nz[R4 * R4];       // a block of the size in hand has a level != 0
                         // (at its origin cell)
};

// One TU size (n = 1 << LOG2) over the CTA's region: the blocks whose
// origin cell holds LOG2 and a level != 0, dequantised, column stage, row
// stage, added into acc. Called by every thread of the CTA.
template <int R, int LOG2>
__device__ __forceinline__ void one_size(Smem<R>& sm, const int (&coef)[4],
                                         int (&acc)[4], int tx, int ty,
                                         bool dst) {
  constexpr int T = R * R / 4, ROWS = T / R, R4 = R / 4;
  constexpr int n = 1 << LOG2, c4 = n / 4;
  const int t = threadIdx.x;
  if (t < R4 * R4) sm.nz[t] = 0;
  __syncthreads();
  int oc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = ty + ROWS * k;
    oc[k] = (y >> LOG2) * c4 * R4 + (tx >> LOG2) * c4;
    if (coef[k] != 0) sm.nz[oc[k]] = 1;
  }
  __syncthreads();
  bool act[4], any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = ty + ROWS * k;
    act[k] = sm.tu[oc[k]] == LOG2 && sm.nz[oc[k]] != 0;
    any |= act[k];
    sm.d[y * R + tx] =
        act[k] ? dequant(coef[k], sm.qp[oc[k]], LOG2, sm.tab + kTabLs) : 0;
  }
  if (!__syncthreads_or(any)) return;

  // M(i, j) = m[i * ms + j]: the n-point DCT's row i, or DST4's
  const int* m = dst ? sm.tab + kTabDst : sm.tab + kTabDct;
  const int ms = dst ? 4 : (32 / n) * 32;
  // columns: e[j][x] = clip16((sum_i M(i, j) d[i][x] + 64) >> 7)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!act[k]) continue;
    const int y = ty + ROWS * k;
    const int j = y & (n - 1), by = y - j;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < n; ++i) sum += m[i * ms + j] * sm.d[(by + i) * R + tx];
    sm.e[y * R + tx] = clip16((sum + 64) >> 7);
  }
  __syncthreads();
  // rows: r[y][j] = clip16((sum_i e[y][i] M(i, j) + 2048) >> 12)
  const int j = tx & (n - 1), bx = tx - j;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!act[k]) continue;
    const int y = ty + ROWS * k;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < n; ++i) sum += sm.e[y * R + bx + i] * m[i * ms + j];
    acc[k] += clip16((sum + 2048) >> 12);
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(R * R / 4)
    hevc_resid_kernel(const int16_t* __restrict__ coeff0,
                      const int16_t* __restrict__ coeff1,
                      const int8_t* __restrict__ tu,
                      const int8_t* __restrict__ qp,
                      const int* __restrict__ off0,
                      const int* __restrict__ off1,
                      const int8_t* __restrict__ tab,
                      int16_t* __restrict__ out, int frames, int H, int W,
                      int dst4, int chroma) {
  constexpr int T = R * R / 4, ROWS = T / R, R4 = R / 4;
  __shared__ Smem<R> sm;
  const int t = threadIdx.x, tx = t % R, ty = t / R;
  const int p = blockIdx.z, comp = p / frames, f = p - comp * frames;
  const int y0 = blockIdx.y * R, x0 = blockIdx.x * R;
  const int16_t* src = (comp ? coeff1 : coeff0) + (size_t)f * H * W;
  int16_t* res = out + (size_t)p * H * W;

  int coef[4];
  bool nz = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    coef[k] = src[(size_t)(y0 + ty + ROWS * k) * W + x0 + tx];
    nz |= coef[k] != 0;
  }
  bool has_tu = false;
  if (t < R4 * R4) {
    const int cy = y0 / 4 + t / R4, cx = x0 / 4 + t % R4;
    const int W4 = W / 4, s = chroma ? 2 : 1;
    const int v = tu[((size_t)f * (H / 4) + cy) * W4 + cx];
    sm.tu[t] = v;
    has_tu = v >= 2 && (1 << v) <= R;
    int q = qp[((size_t)f * (s * H / 4) + s * cy) * (s * W4) + s * cx];
    if (chroma) {
      q += (comp ? off1 : off0)[f];
      q = tab[kTabQpc + (q < 0 ? 0 : (q > 57 ? 57 : q))];
    }
    sm.qp[t] = q;
  }
  const bool any_nz = __syncthreads_or(nz);
  const bool any_tu = __syncthreads_or(has_tu);
  if (!any_nz || !any_tu) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      res[(size_t)(y0 + ty + ROWS * k) * W + x0 + tx] = 0;
    return;
  }
  for (int i = t; i < kTabLs + 6; i += T) sm.tab[i] = tab[i];
  __syncthreads();

  int acc[4] = {0, 0, 0, 0};
  one_size<R, 2>(sm, coef, acc, tx, ty, dst4 != 0);
  one_size<R, 3>(sm, coef, acc, tx, ty, false);
  one_size<R, 4>(sm, coef, acc, tx, ty, false);
  if constexpr (R == 32) one_size<R, 5>(sm, coef, acc, tx, ty, false);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    res[(size_t)(y0 + ty + ROWS * k) * W + x0 + tx] = (int16_t)clip16(acc[k]);
}

template <int R>
cudaError_t launch(const int16_t* c0, const int16_t* c1, const int8_t* tu,
                   const int8_t* qp, const int* o0, const int* o1,
                   const int8_t* tab, int16_t* out, int F, int K, int H,
                   int W, int dst4, int chroma, cudaStream_t s) {
  const dim3 grid(W / R, H / R, F * K);
  hevc_resid_kernel<R><<<grid, R * R / 4, 0, s>>>(
      c0, c1, tu, qp, o0, o1, tab, out, F, H, W, dst4, chroma);
  return cudaGetLastError();
}

}  // namespace

// chroma: Cb and Cr (K = 2, coeff1 and off1 set; K = 1 would take one
// component), the TU sizes 4..16 in 16x16 regions, each block's QP
// derived through QPC_T with off0 / off1; else luma (coeff1 null), the
// sizes 4..32 in 32x32 regions, the QP read from qp. H and W are multiples
// of the region. dst4: the DST at 4x4 (intra luma). Every pointer 16-byte
// aligned. Launches on `stream`, does not synchronise. Returns the
// launch's cudaError_t (0 = success).
extern "C" int hevc_resid_launch(const void* coeff0, const void* coeff1,
                                 const void* tu, const void* qp,
                                 const void* off0, const void* off1,
                                 const void* tab, void* out, int frames,
                                 int H, int W, int dst4, int chroma,
                                 void* stream) {
  const int K = coeff1 != nullptr ? 2 : 1, R = chroma ? 16 : 32;
  if (frames <= 0 || H <= 0 || W <= 0 || H % R != 0 || W % R != 0 ||
      (long long)frames * K > 65535 || H / R > 65535 ||
      (chroma && (off0 == nullptr || (K == 2 && off1 == nullptr))))
    return (int)cudaErrorInvalidValue;
  const auto c0 = static_cast<const int16_t*>(coeff0);
  const auto c1 = static_cast<const int16_t*>(coeff1);
  const auto t8 = static_cast<const int8_t*>(tu);
  const auto q8 = static_cast<const int8_t*>(qp);
  const auto o0 = static_cast<const int*>(off0);
  const auto o1 = static_cast<const int*>(off1);
  const auto tb = static_cast<const int8_t*>(tab);
  const auto o = static_cast<int16_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (chroma)
    return (int)launch<16>(c0, c1, t8, q8, o0, o1, tb, o, frames, K, H, W,
                           dst4, chroma, s);
  return (int)launch<32>(c0, c1, t8, q8, o0, o1, tb, o, frames, K, H, W,
                         dst4, chroma, s);
}
