// The device code of the HEVC intra TU-tree walk (8.4.4.2), shared by the
// walk kernel of one scan step (hevc_walk.cu) and the persistent scan
// kernel (hevc_scan.cu): the staging helpers, the reference positions of a
// TU by sample (ref_positions, the walk kernel's table) or by 4x4 cell
// (ref_cells, the scan kernel's), the TU list's entries (make_entry), one
// TU by one warp (walk_tu<LOG2, CELLS>) and one whole CTB in z-order
// (walk_ctb: the ballot compaction of the TU list, the positions, then the
// chain of TUs; the walk kernel's). hevc_walk.cu's notes say what bounds
// the walk kernel and what its design does about it, hevc_scan.cu's the
// scan kernel's.
//
// Everything is in an anonymous namespace: each kernel source that
// includes the header has its own copy of the constant tables.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxTu = 32;
constexpr int kRefSlots = 4 * kMaxTu + 1 + 3;   // 4n+1, a pad slot each side
constexpr int kExtSlots = 2 * kMaxTu + 3;       // projected main ref, 0..2n
constexpr unsigned kFull = 0xffffffffu;
// intraPredAngle (Table 8-5) and invAngle (Table 8-6) by mode; 0 for
// planar/DC and for angles >= 0 (invAngle unused there)
__constant__ int c_angle[35] = {
    0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
    -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int c_inv_angle[35] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910, -630, -482, -390,
    -315, -256, -315, -390, -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0,
    0, 0, 0, 0};
// intraHorVerDistThres by log2 TU size (8.4.4.2.3); sizes 1, 2 unused
__constant__ int c_filter_thresh[6] = {0, 0, 10, 7, 1, 0};

__host__ __device__ __forceinline__ int pad16(int bytes) {
  return (bytes + 15) & ~15;
}

// The reference-position table has a row of 4n + 4 slots for every TU the
// map could mark (any cell may mark any size, so TUs can overlap): first
// the rows of all 4x4 TUs by cell z-index, then those of all 8x8 TUs, ...
// pos_row: first slot of the row of the TU of log2 size v whose first cell
// has z-index zi. pos_row(log2T + 1, 0, cells) is the table's size.
__host__ __device__ __forceinline__ int pos_row(int v, int zi, int cells) {
  int base = 0;
  for (int u = 2; u < v; ++u)
    base += (cells >> (2 * (u - 2))) * ((16 << (u - 2)) + 4);
  return base + (zi >> (2 * (v - 2))) * ((16 << (v - 2)) + 4);
}


__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// the even bits of a z-order index (x; y is even_bits(z >> 1)), 8 bits in
__device__ __forceinline__ int even_bits(int z) {
  z &= 0x55;
  z = (z | (z >> 1)) & 0x33;
  return (z | (z >> 2)) & 0x0f;
}

// Start the copy of nbytes (even) from device memory at src to base +
// (src & 15) in shared memory, so that 16-byte chunks are aligned on both
// sides: whole chunks by cp.async, the ragged ends as 2-byte elements.
// Returns where byte 0 lands. The caller commits and waits.
__device__ __forceinline__ unsigned char* stage(unsigned char* base,
                                                const void* src, int nbytes,
                                                int t) {
  const unsigned char* g = (const unsigned char*)src;
  const int mis = (int)((uintptr_t)g & 15);
  unsigned char* s = base + mis;
  const int head = min((16 - mis) & 15, nbytes);
  const int body = (nbytes - head) & ~15;
  for (int i = 2 * t; i < head; i += 2 * kWarp)
    *(uint16_t*)(s + i) = *(const uint16_t*)(g + i);
  for (int i = head + 16 * t; i < head + body; i += 16 * kWarp)
    __pipeline_memcpy_async(s + i, g + i, 16);
  for (int i = head + body + 2 * t; i < nbytes; i += 2 * kWarp)
    *(uint16_t*)(s + i) = *(const uint16_t*)(g + i);
  return s;
}

// Store nbytes (even) from shared memory at s to device memory at dst:
// 16-byte chunks where s and dst are misaligned alike, else 2-byte elements.
__device__ __forceinline__ void unstage(void* dst, const unsigned char* s,
                                        int nbytes, int t) {
  unsigned char* g = (unsigned char*)dst;
  const int mis = (int)((uintptr_t)g & 15);
  int head = nbytes, body = 0;
  if (mis == (int)((uintptr_t)s & 15)) {
    head = min((16 - mis) & 15, nbytes);
    body = (nbytes - head) & ~15;
  }
  for (int i = 2 * t; i < head; i += 2 * kWarp)
    *(uint16_t*)(g + i) = *(const uint16_t*)(s + i);
  for (int i = head + 16 * t; i < head + body; i += 16 * kWarp)
    *(uint4*)(g + i) = *(const uint4*)(s + i);
  for (int i = head + body + 2 * t; i < nbytes; i += 2 * kWarp)
    *(uint16_t*)(g + i) = *(const uint16_t*)(s + i);
}

// Where a TU's reference sample i sits in its row of the position table:
// the left column and the top row in 4-sample cells, the corner last.
template <int n>
__device__ __forceinline__ int pos_slot(int i) {
  return i < 2 * n ? i : (i == 2 * n ? 4 * n : i - 1);
}

// The F-independent half of reference substitution (8.4.4.2.2) for one TU
// of nc 4-sample cells per side at cell (cx, cy), by one thread: for every
// reference sample, the position in F (row-major, width WF) it takes its
// value from. A sample of an available cell (6.4.1: the cell's decode-order
// index is below the TU's) is its own source; one of an unavailable cell
// takes the last sample of the nearest available cell before it in scan
// order (left column bottom-up, corner, top row left to right), a leading
// run the first available sample; `none` (a slot that holds 128) where
// nothing is available. P: this TU's row of the table, in pos_slot order.
__device__ __forceinline__ void ref_positions(uint16_t* P, const int32_t* sZ,
                                              int WZ, int WF, int cx, int cy,
                                              int nc, int none) {
  const int x0 = cx << 2, y0 = cy << 2, n2 = nc << 2;      // n2 = 2n
  const int z_org = sZ[(1 + cy) * WZ + 1 + cx];
  unsigned long long avail = 0;   // bit per cell, in scan order
  for (int c = 0; c < nc; ++c) {
    avail |= (unsigned long long)(sZ[(cy + nc - c) * WZ + cx] < z_org) << c;
    avail |= (unsigned long long)(sZ[cy * WZ + 1 + cx + c] < z_org)
             << (nc + 1 + c);
  }
  avail |= (unsigned long long)(sZ[cy * WZ + cx] < z_org) << nc;
  int last = none;
  if (avail != 0) {
    const int fc = __ffsll((long long)avail) - 1;
    last = fc < nc ? (y0 + n2 - 4 * fc) * WF + x0
                   : y0 * WF + x0 + (fc == nc ? 0 : 4 * (fc - nc) - 3);
  }
  uint2* P4 = (uint2*)P;          // four 16-bit positions per store
  for (int c = 0; c < nc; ++c) {  // left column, bottom-up
    int p0 = last, p1 = last, p2 = last, p3 = last;
    if (avail >> c & 1) {
      p0 = (y0 + n2 - 4 * c) * WF + x0;
      p1 = p0 - WF;
      p2 = p1 - WF;
      p3 = p2 - WF;
      last = p3;
    }
    P4[c] = make_uint2(p0 | p1 << 16, p2 | p3 << 16);
  }
  if (avail >> nc & 1) last = y0 * WF + x0;
  const int corner = last;
  for (int c = 0; c < nc; ++c) {  // top row, left to right
    int p0 = last, p1 = last, p2 = last, p3 = last;
    if (avail >> (nc + 1 + c) & 1) {
      p0 = y0 * WF + x0 + 1 + 4 * c;
      p1 = p0 + 1;
      p2 = p0 + 2;
      p3 = p0 + 3;
      last = p3;
    }
    P4[nc + c] = make_uint2(p0 | p1 << 16, p2 | p3 << 16);
  }
  P[2 * n2] = (uint16_t)corner;
}

// The cell form of ref_positions, for one TU of nc 4-sample cells per side
// at cell (cx, cy), by one thread: P gets 2 nc + 1 entries, one a reference
// cell in scan order (the left column's nc cells bottom-up, the corner,
// the top row's nc cells). An available cell's entry is the position in F
// of its first sample in scan order with bit 15 set (its other samples
// follow it up the column or along the row); an unavailable cell's is the
// position all its samples take (the last available sample before it, the
// first available one for a leading run, `none` where nothing is
// available). Positions are below 32768. Returns the availability bits in
// scan order. NC: nc (4x4: 2, ... 32x32: 16).
template <int NC>
__device__ __forceinline__ unsigned long long ref_cells(
    uint16_t* P, const int32_t* sZ, int WZ, int WF, int cx, int cy,
    int none) {
  constexpr int nc = NC;
  const int x0 = cx << 2, y0 = cy << 2, n2 = nc << 2;      // n2 = 2n
  const int z_org = sZ[(1 + cy) * WZ + 1 + cx];
  unsigned long long avail = 0;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    avail |= (unsigned long long)(sZ[(cy + nc - c) * WZ + cx] < z_org) << c;
    avail |= (unsigned long long)(sZ[cy * WZ + 1 + cx + c] < z_org)
             << (nc + 1 + c);
  }
  avail |= (unsigned long long)(sZ[cy * WZ + cx] < z_org) << nc;
  int last = none;
  if (avail != 0) {
    const int fc = __ffsll((long long)avail) - 1;
    last = fc < nc ? (y0 + n2 - 4 * fc) * WF + x0
                   : y0 * WF + x0 + (fc == nc ? 0 : 4 * (fc - nc) - 3);
  }
#pragma unroll
  for (int c = 0; c < nc; ++c) {  // left column, bottom-up
    if (avail >> c & 1) {
      const int p0 = (y0 + n2 - 4 * c) * WF + x0;
      P[c] = (uint16_t)(0x8000 | p0);
      last = p0 - 3 * WF;
    } else {
      P[c] = (uint16_t)last;
    }
  }
  if (avail >> nc & 1) {
    last = y0 * WF + x0;
    P[nc] = (uint16_t)(0x8000 | last);
  } else {
    P[nc] = (uint16_t)last;
  }
#pragma unroll
  for (int c = 0; c < nc; ++c) {  // top row, left to right
    if (avail >> (nc + 1 + c) & 1) {
      const int p0 = y0 * WF + x0 + 1 + 4 * c;
      P[nc + 1 + c] = (uint16_t)(0x8000 | p0);
      last = p0 + 3;
    } else {
      P[nc + 1 + c] = (uint16_t)last;
    }
  }
  return avail;
}

// Position in F of reference sample i (0..4n, in pos_slot's scan order) of
// a TU of size n: from its row of the sample table (ref_positions), or,
// with CELLS, from its row of the cell table (ref_cells).
template <int n, bool CELLS>
__device__ __forceinline__ int ref_pos(const uint16_t* P, int i, int WF) {
  if (!CELLS) return P[pos_slot<n>(i)];
  if (i < 2 * n) {
    const int e = P[i >> 2];
    return e & 0x8000 ? (e & 0x7fff) - (i & 3) * WF : e;
  }
  if (i == 2 * n) return P[n / 2] & 0x7fff;
  const int j = i - 2 * n - 1, e = P[n / 2 + 1 + (j >> 2)];
  return e & 0x8000 ? (e & 0x7fff) + (j & 3) : e;
}

// Index into the reference vector of entry e of the angular main reference
// ext[0..3n+1], where ext[n] is the corner, ext[n+1+i] = main[i], and
// ext[e < n] (negative angles only) is the invAngle projection of the side
// reference; sgn is -1 for a horizontal mode (the main reference runs down
// the left column, backwards in the vector), +1 for a vertical one. Without
// a branch. Index -1 or 4n+1 comes out only where the weight is 0.
template <int n>
__device__ __forceinline__ int ext_index(int e, int sgn, int inv) {
  const int d = e - n;
  const int j = min((d * inv + 128) >> 8, 2 * n - 1) - 1;
  return 2 * n + sgn * (d >= 0 ? d : -(max(j, -1) + 1));
}

// A TU as the list holds it: everything about it that does not depend on F,
// computed off the chain (16 bytes, one load).
//  x: log2 size - 2 | mode << 2 | first slot of its position-table row << 8
//  y: offset of its first pixel in F | offset of its first residual << 16
//  z: intraPredAngle (16 bits, signed) | invAngle << 16
//  w: references filtered (8.4.4.2.3) | cx << 8 | cy << 12, in 4x4 cells
__device__ __forceinline__ uint4 make_entry(int v, int cx, int cy, int mode,
                                            int row, int WF, int C,
                                            bool luma) {
  const bool filt = luma && v > 2 && mode != 1 &&
                    min(abs(mode - 10), abs(mode - 26)) > c_filter_thresh[v];
  return make_uint4(
      (unsigned)(v - 2) | mode << 2 | row << 8,
      (unsigned)((4 * cy + 1) * WF + 4 * cx + 1) | (4 * cy * C + 4 * cx) << 16,
      (unsigned)(c_angle[mode] & 0xffff) | (unsigned)c_inv_angle[mode] << 16,
      (unsigned)filt | cx << 8 | cy << 12);
}

// One TU of size n = 1 << LOG2, by one warp. sP is the reference-position
// table (of samples, or with CELLS of cells: ref_pos); sA, sB hold
// reference vectors (index -1 and 4n+1 are pad slots whose value is only
// ever multiplied by 0), sE the projected main reference.
// Loads are started first and what does not depend on them is computed in
// their shadow: one warp hides its latencies only with its own
// independent instructions.
template <int LOG2, bool CELLS = false>
__device__ __forceinline__ void walk_tu(int16_t* sF, const int16_t* sR,
                                        const uint16_t* sP, int* sA, int* sB,
                                        int* sE, uint4 ent, int WF, int C,
                                        bool luma, bool strong, int t) {
  constexpr int n = 1 << LOG2;
  constexpr int L = 4 * n + 1;
  constexpr int K = (L + kWarp - 1) / kWarp;       // references per thread
  constexpr int ROUNDS = (n * n + kWarp - 1) / kWarp;
  constexpr bool small = LOG2 <= 3;                // per-pixel state in registers

  const int mode = ent.x >> 2 & 63;
  const uint16_t* P = sP + (ent.x >> 8);
  int16_t* out = sF + (ent.y & 0xffff);
  const int16_t* res = sR + (ent.y >> 16);
  const int ang = (int16_t)(ent.z & 0xffff), inv = (int)ent.z >> 16;
  const int sgn = mode < 18 ? -1 : 1;
  const bool edges = luma && n < 32;

  // 1. substituted references: two loads each. Thread t owns samples t,
  //    t+32, ...
  int own[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + kWarp * k;
    own[k] = i < L ? sF[ref_pos<n, CELLS>(P, i, WF)] : 0;
  }
  // small TUs: this thread's pixels t, t+32 in raster order, their residuals
  // and, for an angular mode, their two taps in the reference vector
  constexpr int SR = small ? ROUNDS : 1;
  int py[ROUNDS], px[ROUNDS], rs[SR] = {}, ia[SR] = {}, ib[SR] = {},
      fr[SR] = {};
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int p = (t + kWarp * r) & (n * n - 1);   // 4x4: half the warp idles
    py[r] = p >> LOG2;
    px[r] = p & (n - 1);
    if (small) rs[r] = res[py[r] * C + px[r]];
    if (small && mode >= 2) {
      const int rr = sgn < 0 ? px[r] : py[r], cc = sgn < 0 ? py[r] : px[r];
      const int a = (rr + 1) * ang;
      const int e = n + 1 + (a >> 5) + cc;
      fr[r] = a & 31;
      ia[r] = ext_index<n>(e, sgn, inv);
      ib[r] = ext_index<n>(e + 1, sgn, inv);
    }
  }
  const bool live = n * n >= kWarp || t < n * n;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = t + kWarp * k;
    if (i < L) sA[i] = own[k];
  }
  __syncwarp();

  // 2. reference filtering (8.4.4.2.3)
  const int* vf = sA;
  if (LOG2 > 2 && (ent.w & 1)) {
    const int tl0 = sA[2 * n], bl0 = sA[0], tr0 = sA[4 * n];
    const bool bilinear = n == 32 && strong &&
                          abs(tl0 + tr0 - 2 * sA[3 * n]) < 8 &&
                          abs(tl0 + bl0 - 2 * sA[n]) < 8;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + kWarp * k;
      if (i < L) {
        int o;
        if (bilinear) {
          if (i < 2 * n) {
            const int j = 2 * n - 1 - i;
            o = j == 2 * n - 1
                    ? bl0
                    : ((2 * n - 1 - j) * tl0 + (j + 1) * bl0 + 32) >> 6;
          } else if (i == 2 * n) {
            o = tl0;
          } else {
            const int j = i - 2 * n - 1;
            o = j == 2 * n - 1
                    ? tr0
                    : ((2 * n - 1 - j) * tl0 + (j + 1) * tr0 + 32) >> 6;
          }
        } else if (i == 0 || i == L - 1) {
          o = own[k];
        } else {
          o = (sA[i - 1] + 2 * own[k] + sA[i + 1] + 2) >> 2;
        }
        sB[i] = o;
      }
    }
    __syncwarp();
    vf = sB;
  }

  // 3. prediction + residual, clipped, written into F
  if (mode == 0) {
    const int tr = vf[3 * n + 1], bl = vf[n - 1];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int y = py[r], x = px[r];
      const int pred = ((n - 1 - x) * vf[2 * n - 1 - y] + (x + 1) * tr +
                        (n - 1 - y) * vf[2 * n + 1 + x] + (y + 1) * bl + n) >>
                       (LOG2 + 1);
      const int rv = small ? rs[r] : res[y * C + x];
      if (live) out[y * WF + x] = (int16_t)clip255(pred + rv);
    }
  } else if (mode == 1) {
    // DC is never filtered, so vf == sA and the sum runs over `own`
    int part = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + kWarp * k;
      if ((i >= n && i < 2 * n) || (i > 2 * n && i <= 3 * n)) part += own[k];
    }
    const int dc = (__reduce_add_sync(kFull, part) + n) >> (LOG2 + 1);
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int y = py[r], x = px[r];
      const int left = vf[2 * n - 1 - y], top = vf[2 * n + 1 + x];
      int pred = dc;
      if (edges && y == 0) pred = (top + 3 * dc + 2) >> 2;
      if (edges && x == 0) pred = (left + 3 * dc + 2) >> 2;
      if (edges && y == 0 && x == 0) pred = (left + 2 * dc + top + 2) >> 2;
      const int rv = small ? rs[r] : res[y * C + x];
      if (live) out[y * WF + x] = (int16_t)clip255(pred + rv);
    }
  } else {
    // angular: two taps of the main reference per pixel. For e >= n it is
    // the reference vector read forwards or backwards from the corner.
    const int tl = vf[2 * n];
    const int* ext = vf + 2 * n - sgn * n;
    int es = sgn;
    if (!small && ang < 0) {
      // large TUs: write ext[0..2n] out once instead of projecting twice
      // per pixel
      for (int s = t; s <= 2 * n; s += kWarp)
        sE[s] = s - n >= (n * ang) >> 5 ? vf[ext_index<n>(s, sgn, inv)] : 0;
      __syncwarp();
      ext = sE;
      es = 1;
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int y = py[r], x = px[r];
      int pred, rv;
      if (small) {
        pred = ((32 - fr[r]) * vf[ia[r]] + fr[r] * vf[ib[r]] + 16) >> 5;
        rv = rs[r];
      } else {
        const int a = ((sgn < 0 ? x : y) + 1) * ang;
        const int e = n + 1 + (a >> 5) + (sgn < 0 ? y : x), f = a & 31;
        pred = ((32 - f) * ext[es * e] + f * ext[es * (e + 1)] + 16) >> 5;
        rv = res[y * C + x];
      }
      if (edges && mode == 26 && x == 0)
        pred = clip255(((vf[2 * n - 1 - y] - tl) >> 1) + vf[2 * n + 1]);
      if (edges && mode == 10 && y == 0)
        pred = clip255(((vf[2 * n + 1 + x] - tl) >> 1) + vf[2 * n - 1]);
      if (live) out[y * WF + x] = (int16_t)clip255(pred + rv);
    }
  }
  __syncwarp();
}

// One CTB, walked by one warp in shared memory: sF the composite (HF x WF
// samples, the CTB at [1:1+C, 1:1+C], with one more slot after it), sZ
// its z-index border (width WZ), sR the residual (width C), sTU and sM the
// TU and mode maps (C/4 x C/4); list (C/4 * C/4 entries), sP (the
// position table) and sA, sB, sE (the reference vectors) are the walk's
// scratch. sZ, sTU and sM must be ready; sF and sR need be only once
// before_chain(count) returns, which is called with the number of active
// TUs after the list and the positions are built, before the chain, and
// must end in a __syncwarp() when count > 0 (the chain reads the
// positions other threads wrote). Writes every active TU into sF in
// z-order; returns their number.
template <class BeforeChain>
__device__ __forceinline__ int walk_ctb(int16_t* sF, const int16_t* sR,
                                        const int32_t* sZ,
                                        const int32_t* sTU,
                                        const int32_t* sM, uint4* list,
                                        uint16_t* sP, int* sA, int* sB,
                                        int* sE, int HF, int WF, int WZ,
                                        int C, int log2T, bool luma,
                                        bool strong,
                                        BeforeChain before_chain) {
  const int t = threadIdx.x & (kWarp - 1);
  const int C4 = C >> 2, cells = C4 * C4;
  const int none = HF * WF;       // the slot after F: 128, nothing available
  if (t == 0) sF[none] = 128;

  // the active TUs in z-order. A 4x4 cell at z-index zi whose map value is
  // v marks a TU of size 1 << v exactly when zi is a multiple of the TU's
  // cell count, and a cell holds one value, so the quadtree pre-order over
  // candidates is the order of zi.
  int count = 0;
  for (int zb = 0; zb < cells; zb += kWarp) {
    const int zi = zb + t;
    bool active = false;
    int cx = 0, cy = 0, v = 0;
    if (zi < cells) {
      cx = even_bits(zi);
      cy = even_bits(zi >> 1);
      v = sTU[cy * C4 + cx];
      active = v >= 2 && v <= log2T && (zi & ((1 << (2 * (v - 2))) - 1)) == 0;
    }
    const unsigned hits = __ballot_sync(kFull, active);
    if (active)
      list[count + __popc(hits & ((1u << t) - 1))] =
          make_entry(v, cx, cy, sM[cy * C4 + cx] & 63, pos_row(v, zi, cells),
                     WF, C, luma);
    count += __popc(hits);
  }
  __syncwarp();
  // thread t fills the position-table rows of TUs t, t+32, ...
  for (int e = t; e < count; e += kWarp) {
    const uint4 ent = list[e];
    ref_positions(sP + (ent.x >> 8), sZ, WZ, WF, ent.w >> 8 & 15,
                  ent.w >> 12 & 15, 2 << (ent.x & 3), none);
  }
  before_chain(count);

  // the chain: shared memory and registers only; the next entry is loaded
  // a TU ahead
  uint4 next = list[0];
  for (int e = 0; e < count; ++e) {
    const uint4 ent = next;
    next = list[min(e + 1, cells - 1)];
    switch (ent.x & 3) {
      case 0:
        walk_tu<2>(sF, sR, sP, sA, sB, sE, ent, WF, C, luma, strong, t);
        break;
      case 1:
        walk_tu<3>(sF, sR, sP, sA, sB, sE, ent, WF, C, luma, strong, t);
        break;
      case 2:
        walk_tu<4>(sF, sR, sP, sA, sB, sE, ent, WF, C, luma, strong, t);
        break;
      default:
        walk_tu<5>(sF, sR, sP, sA, sB, sE, ent, WF, C, luma, strong, t);
    }
  }

  return count;
}

}  // namespace
