// HEVC intra reconstruction (8.4.4.2) of whole planes: one CTB-row
// wavefront scan in one persistent launch, the lanes chained by progress
// flags (lane_chain.cuh), each CTB's TUs walked by dependency level on
// several warps with the TU walk of hevc_walk.cuh. Built by
// jmcodec_tpu_torch/kernels/_build.py; bound with ctypes by
// jmcodec_tpu_torch/kernels/hevc_scan.py (scan_planes), whose plain torch
// version (scan_reference) it must equal bit for bit.
//
// Replaces the scan that jmcodec_tpu runs as a jax.lax.scan on the device
// (kernels/hevc_tiles.py: _intra_scan, its body at :650 and the scan at
// :712), with the skew of its inputs (_skew) and the unskew of its output
// (_unskew_to_plane) around it. There a step assembles the composite F and
// the z-index border Z of one CTB a lane from the carry (the last skew + 1
// bottom rows, the left column), walks the CTB's TUs in z-order, and
// shifts the carry; the skew is the TPU's way to put one diagonal of CTBs
// into one dense batch. Here nothing is skewed: the kernel reads the
// planes and writes them.
//
// Layout, for CTB size C, H = ctb_h * C and W = ctb_w * C:
//     resid [P, H, W] int16     the residual planes, saturated to int16
//     base  [P, H, W] int16     an inter picture's base (the MC + inter
//                               residual), saturated to int16; or null
//     zidx, tu, mode [G, H/4, W/4] int32, per 4x4 cell: decode-order
//                               index, log2 TU size (0: none), intra mode;
//                               plane p uses cell plane p % G (chroma: the
//                               Cb planes of every frame, then the Cr
//                               planes, share one map a frame)
//     out   [P, H, W] int32     the reconstruction, every sample written
// A lane is one CTB row (cy) of one plane, or of two planes on one cell
// map (a frame's Cb and Cr), which share its schedule: a launch has
// ceil(NP / LP) x G x ctb_h lanes, for NP = P / G planes on a map and LP =
// min(NP, 2) planes a lane, and as many progress flags. A CTA takes the
// lanes by the ticket of lane_chain.cuh, the CTB row innermost, and walks
// each lane's CTBs left to right. CTB (cy, cx) reads the bottom rows of
// CTBs cx - 1 .. cx + skew - 1 of the row above (the corner, the top and
// the top-right references), so before it the CTA waits until the lane
// above has finished CTB min(cx + skew - 1, ctb_w - 1); skew is
// hevc_tables.skew_for of the luma CTB size (2 at CTU 64, 3 at CTU 16 and
// 32). The chain of a scan is ctb_w + skew (ctb_h - 1) CTBs long, as the
// JAX scan's steps are.
//
// A CTA is kWalkers walker warps and a planner warp. While the walkers
// walk CTB cx, the planner stages CTB cx + 1's residual and base with
// cp.async (its TU and mode maps and Z cells were staged with CTB cx's
// schedule), builds its Z (int32, 1 + C/4 + T/4 rows by 1 + skew C/4, as
// the torch loop builds it: kernels/hevc_tiles._intra_scan) and, from Z
// and the maps alone, its schedule (build_schedule):
//   - the active TUs in z-order (a ballot over the cells) as 16-byte
//     entries (entry_of);
//   - for each, its row of the cell table (ref_cells: where each of its
//     4n + 1 reference samples comes from in F after substitution) and
//     its predecessors, the writers of its available reference cells;
//   - each TU's dependency level (kernels/hevc_levels.py states the rule:
//     after every earlier TU whose block it reads or overlaps, and every
//     earlier TU that reads a cell it writes): the longest paths over the
//     predecessors (longest_paths), or, where TUs overlap or a TU reads a
//     cell a later one writes (no decoded picture does), the general pass
//     over the cells (tu_levels, exact on any map but serial in the TUs:
//     for every CTB it made the scans of the 1080p batch of 16 1.3-1.5x
//     slower, the planner on the chain; tools/time_hevc_scan.py);
//   - the entries sorted by (level, 4x4 or larger), stable, and a
//     descriptor a level.
// The walkers build F (int16, 1 + C rows by 1 + skew C columns for each of
// the lane's planes, the CTB at [1:1+C, 1:1+C]):
//   - column 0: the last column of the previous CTB, still in F;
//   - the interior: the base, or zeros;
//   - row 0: the lane above's bottom row over CTBs cx .. cx + skew - 1, 0
//     past the right edge of the picture, F[0, 0] the bottom-right sample
//     of CTB cx - 1 above; read from `out` through L2 after the acquire,
//     and only for a CTB that holds a TU (one without reads no neighbour);
// and walk it level by level, a barrier of the walkers between levels. A
// level's units go to the walkers in turn: a pair of 4x4 TUs of one plane
// (a half warp each, a pixel a lane: prep_pair4, run_pair4), an 8x8 TU (a
// warp, two pixels a lane, the [1 2 1] filter and the taps by shuffles:
// prep_8x8, run_8x8), both reading their reference samples straight from
// F through the cell table, or a 16x16 or 32x32 TU (hevc_walk.cuh's
// walk_tu, a warp). The TUs of a level write disjoint cells and read only
// cells of earlier levels and the borders. The CTB goes straight into
// `out`: its bottom row first, then the progress flag (a release store),
// then the rest (only the lane below reads `out` during the launch, and
// only bottom rows). A CTB without a TU is its interior (the base, or
// zeros): it is stored without a wait or a walk.
//
// What bounds it on this card: the chain, not the bytes. A scan takes about
// (its chain of CTBs) x (the levels of a CTB) x (a level: its slowest
// unit, a few hundred cycles for small TUs, and the barrier);
// tools/hevc_scan_chain.py counts the chain in levels: 3,506 at the 1080p
// fixture's luma planes against the 6,643 TUs the previous design walked
// one after another in z-order (2,344 against 3,952 for chroma). The bytes
// of a luma scan at the 1080p batch of 16 (the residual, the cell maps and
// the int32 output, ~226 MB) take 0.0674 ms at the HBM rate of 3.35 TB/s
// (chip_smoke.py's scan_bound). The schedule, the staging and Z are the
// planner's, off the chain while the planner keeps up with the walkers;
// the only reads that wait on another SM are the skew C + 1 samples of the
// row above. The walks of the 4x4 and 8x8 TUs are inlined into the level
// loop (tools/time_hevc_scan.py builds them behind calls with
// -DJMX_SCAN_SMALL_CALLS to time what calls cost); 16x16 and 32x32 TUs are
// always calls: inlined, nvcc 12.9 for sm_90a gave their luma DC and
// horizontal edge filters wrong top samples, as it miscompiled the
// previous design's inlined walk. chip_smoke.py phase 29 holds the kernel
// against the plain scan on seeded planes at CTU 16, 32 and 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hevc_walk.cuh"
#include "lane_chain.cuh"

namespace {

using namespace lane_chain;

constexpr int kWalkers = 3;                    // walker warps a CTA
constexpr int kWalkThreads = kWalkers * kWarp;
constexpr int kThreads = kWalkThreads + kWarp;  // and the planner warp
constexpr int kPlanner = kWalkers;             // the planner's warp index
constexpr int kLanePlanes = 2;                 // planes on one map a lane

// Per-phase timing (tools/time_hevc_scan.py builds this source with
// -DJMX_SCAN_TIMING; without it the macros compile to nothing): the
// planner's lane 0 (who 0) and the walkers' thread 0 (who 1) each add the
// SM clock cycles since their previous stamp to a slot of their CTA's sums,
// and counts; each CTA adds its sums into g_hs_cycles when it ends.
//   planner: 0 staging, 1 Z, 27 the TU list, 29 each cell's writer, 2 the
//     cell tables and predecessors, 3 the levels, 4 the sort, 5 waiting at
//     the end of a CTB; counts 6 TUs, 7 CTBs built, 16 CTBs whose levels
//     took tu_levels;
//   walkers: 8 F, 9 the wait on the lane above, 10 row 0, in the levels 17
//     warp 0's overhead, 19-22 its units (a pair of 4x4 TUs, 8x8, 16x16,
//     32x32; counts 23-26) and 18 its wait at the barrier, 11 the rest of
//     the levels, 12 the stores, 13 waiting at the end of a CTB; counts 14
//     levels walked, 15 CTBs walked.
#ifdef JMX_SCAN_TIMING
static __shared__ unsigned long long hs_cyc[32];
static __shared__ long long hs_last[2];
__device__ unsigned long long g_hs_cycles[32];
#define HS_IS(who) (threadIdx.x == ((who) ? 0 : kPlanner * kWarp))
#define HS_BEGIN()                                                          \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      for (int i_ = 0; i_ < 32; ++i_) hs_cyc[i_] = 0;                       \
      hs_last[0] = hs_last[1] = clock64();                                  \
    }                                                                       \
  } while (0)
#define HS_STAMP(who, i)                                                    \
  do {                                                                      \
    if (HS_IS(who)) {                                                       \
      const long long n_ = clock64();                                       \
      hs_cyc[i] += n_ - hs_last[who];                                       \
      hs_last[who] = n_;                                                    \
    }                                                                       \
  } while (0)
#define HS_COUNT(who, i, n)                                                 \
  do {                                                                      \
    if (HS_IS(who)) hs_cyc[i] += (n);                                       \
  } while (0)
#define HS_END()                                                            \
  do {                                                                      \
    __syncthreads();                                                        \
    if (threadIdx.x == 0)                                                   \
      for (int i_ = 0; i_ < 32; ++i_) atomicAdd(&g_hs_cycles[i_], hs_cyc[i_]); \
  } while (0)
#else
#define HS_BEGIN() do {} while (0)
#define HS_STAMP(who, i) do {} while (0)
#define HS_COUNT(who, i, n) do {} while (0)
#define HS_END() do {} while (0)
#endif

struct ScanArgs {
  const int16_t* resid;
  const int16_t* base;        // or null
  const int32_t *zidx, *tu, *mode;
  int32_t* out;
  int* flags;                 // [lanes] progress: CTBs finished
  int* ticket;                // the lanes' hand-out counter
  int P, G, ctb_h, ctb_w, C, log2C, T, log2T, skew, luma, strong;
  int zidx_none;
  int NP;                     // planes on one cell map: P / G
  int LP;                     // planes a lane: min(NP, kLanePlanes)
};

// The walkers' barrier (barrier 1; the planner does not take part).
__device__ __forceinline__ void walkers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWalkThreads) : "memory");
}

// The most cell-table entries (ref_cells) the TUs of one CTB can take: a
// cell starts at most one TU, of a size its z-index is aligned to.
__host__ __device__ __forceinline__ int cell_slots(int cells, int log2T) {
  int s = 0;
  for (int zi = 0; zi < cells; ++zi) {
    int v = 2;
    while (v < log2T && zi % (1 << (2 * (v - 1))) == 0) ++v;
    s += 2 * (1 << (v - 1)) + 1;
  }
  return s;
}

// Byte offsets of one CTA's shared memory: F of each of the lane's planes
// (with its slot for 128 after it), Z, the planner's scratch (the z-order
// TU list, each TU's level, the levels' scratch: longest_paths' writers and
// predecessors or tu_levels' cell levels, then the keys' counts), the
// walker warps' reference vectors, two schedules (Sched), two stage
// buffers, each the residual and the base (only with one) of each of the
// lane's planes, and the maps buffer: the TU map, the mode map, the CTB's
// Z cells, the Z cells of the row above (the corner first) and those of
// the column to the left.
struct Layout {
  int f, fplane, z, zlist, lvl, lscr, refs, refs_warp;
  int sched0, sched, ent, cpos, lvd, hdr;
  int stage0, stage, res, base, maps, tu, mode, zt, ztop, zleft;
  int total;
};

__host__ __device__ __forceinline__ Layout layout(int C, int T, int log2T,
                                                  int skew, bool has_base,
                                                  int LP) {
  const int C4 = C >> 2, cells = C4 * C4;
  const int WF = 1 + skew * C;
  const int HZ = 1 + C4 + (T >> 2), WZ = 1 + skew * C4;
  Layout L;
  int p = 0;
  L.fplane = pad16(((1 + C) * WF + 1) * 2);
  L.f = p;       p += LP * L.fplane;
  L.z = p;       p += pad16(HZ * WZ * 4);
  L.zlist = p;   p += cells * 16;
  L.lvl = p;     p += pad16(cells * 2);
  const int preds = cells * 4 + cell_slots(cells, log2T);
  const int counts = (2 * cells + 4) * 4;
  L.lscr = p;    p += pad16(preds > counts ? preds : counts);
  L.refs_warp = pad16((2 * kRefSlots + kExtSlots) * 4);
  L.refs = p;    p += kWalkers * L.refs_warp;
  int s = 0;
  L.ent = s;     s += cells * 16;
  L.cpos = s;    s += pad16(cell_slots(cells, log2T) * 2);
  L.lvd = s;     s += pad16((cells + 2) * 4);
  L.hdr = s;     s += 16;
  L.sched0 = p;
  L.sched = s;
  p += 2 * s;
  int q = 0;
  L.res = q;     q += LP * pad16(C * C * 2);
  L.base = q;    q += has_base ? LP * pad16(C * C * 2) : 0;
  L.stage0 = p;
  L.stage = q;
  p += 2 * q;
  int m = 0;
  L.tu = m;      m += pad16(cells * 4);
  L.mode = m;    m += pad16(cells * 4);
  L.zt = m;      m += pad16(cells * 4);
  L.ztop = m;    m += pad16((1 + skew * C4) * 4);
  L.zleft = m;   m += pad16(C4 * 4);
  L.maps = p;
  L.total = p + m;
  return L;
}

// Start the copy of `rows` rows of `rb` bytes (a multiple of 4) at src,
// `stride` bytes apart, to dst in shared memory, rb bytes apart, by thread
// t of nt: 16 bytes at a time where both sides allow it, else 4.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const void* src, int rows, int rb,
                                           long long stride, int t, int nt) {
  const unsigned char* g = static_cast<const unsigned char*>(src);
  if ((((uintptr_t)g | (uintptr_t)stride | (uintptr_t)rb) & 15) == 0) {
    const int per = rb >> 4;
    for (int i = t; i < rows * per; i += nt) {
      const int r = i / per, c = (i - r * per) << 4;
      cp16(dst + r * rb + c, g + r * stride + c);
    }
  } else {
    const int per = rb >> 2;
    for (int i = t; i < rows * per; i += nt) {
      const int r = i / per, c = (i - r * per) << 2;
      cp4(dst + r * rb + c, g + r * stride + c);
    }
  }
}

// Start staging the residual and base of CTB (cy, cx) of the lane's np
// planes p0, p0 + G, ... into st; by the planner warp (lane t).
__device__ void prefetch_planes(const ScanArgs& a, const Layout& L,
                                unsigned char* st, int p0, int np, int cy,
                                int cx, int t) {
  const int C = a.C;
  const long long W = (long long)a.ctb_w * C;
  const long long H = (long long)a.ctb_h * C;
  const int rb = pad16(C * C * 2);
  for (int j = 0; j < np; ++j) {
    const long long pix =
        ((long long)(p0 + j * a.G) * H + (long long)cy * C) * W +
        (long long)cx * C;
    stage_rows(st + L.res + j * rb, a.resid + pix, C, C * 2, W * 2, t,
               kWarp);
    if (a.base != nullptr)
      stage_rows(st + L.base + j * rb, a.base + pix, C, C * 2, W * 2, t,
                 kWarp);
  }
}

// Start staging the TU and mode maps and the Z cells of CTB (cy, cx) of
// cell plane g into st (the maps buffer); by the planner warp (lane t).
__device__ void prefetch_maps(const ScanArgs& a, const Layout& L,
                              unsigned char* st, int g, int cy, int cx,
                              int t) {
  const int C = a.C, C4 = C >> 2;
  const long long W4 = ((long long)a.ctb_w * C) >> 2;
  const long long H4 = ((long long)a.ctb_h * C) >> 2;
  const long long cell = ((long long)g * H4 + (long long)cy * C4) * W4 +
                         (long long)cx * C4;
  stage_rows(st + L.tu, a.tu + cell, C4, C4 * 4, W4 * 4, t, kWarp);
  stage_rows(st + L.mode, a.mode + cell, C4, C4 * 4, W4 * 4, t, kWarp);
  stage_rows(st + L.zt, a.zidx + cell, C4, C4 * 4, W4 * 4, t, kWarp);
  // the cells of the row above, from column cx*C4 - 1 on, and of the
  // column to the left; only those inside the plane (build_z masks the
  // rest)
  int32_t* ztop = reinterpret_cast<int32_t*>(st + L.ztop);
  int32_t* zleft = reinterpret_cast<int32_t*>(st + L.zleft);
  for (int c = t; c < 1 + a.skew * C4; c += kWarp) {
    const long long col = (long long)cx * C4 + c - 1;
    if (cy > 0 && col >= 0 && col < W4)
      cp4(ztop + c, a.zidx + cell - W4 + c - 1);
  }
  for (int r = t; r < C4; r += kWarp)
    if (cx > 0) cp4(zleft + r, a.zidx + cell + r * W4 - 1);
}

// Z of CTB (cy, cx) from the staged cells: row 0, column 0 and the CTB's
// own cells (the rest of Z is ZIDX_NONE for every CTB: init_z); by the
// planner warp.
__device__ __forceinline__ void build_z(const ScanArgs& a, const Layout& L,
                                        const unsigned char* st,
                                        int32_t* sZ, int cy, int cx, int WZ,
                                        int t) {
  const int C4 = a.C >> 2, W4 = (a.ctb_w * a.C) >> 2;
  const int32_t* zt = reinterpret_cast<const int32_t*>(st + L.zt);
  const int32_t* ztop = reinterpret_cast<const int32_t*>(st + L.ztop);
  const int32_t* zleft = reinterpret_cast<const int32_t*>(st + L.zleft);
  for (int c = t; c < WZ; c += kWarp)
    sZ[c] = cy > 0 && (c == 0 ? cx > 0 : cx * C4 + c - 1 < W4)
        ? ztop[c] : a.zidx_none;
  for (int r = t; r < C4; r += kWarp)
    sZ[(1 + r) * WZ] = cx > 0 ? zleft[r] : a.zidx_none;
  const int lc = 31 - __clz(C4);
  for (int i = t; i < C4 * C4; i += kWarp)
    sZ[(1 + (i >> lc)) * WZ + 1 + (i & (C4 - 1))] = zt[i];
}

// The cells of Z that no CTB writes: those past the CTB's last row or
// column (below-left and, inside the CTB's rows, top-right of the CTB),
// ZIDX_NONE; by every thread of the CTA, once.
__device__ __forceinline__ void init_z(int32_t* sZ, int C4, int HZ, int WZ,
                                       int none) {
  for (int i = threadIdx.x; i < HZ * WZ; i += blockDim.x) {
    const int r = i / WZ, c = i - r * WZ;
    if (r > C4 || (r > 0 && c > C4)) sZ[i] = none;
  }
}

// make_entry with its tables (Tables 8-5, 8-6 and the filter thresholds)
// read from the CTA's copy in shared memory, where lanes that take
// different modes do not serialise as they do on constant memory.
__shared__ int s_angle[35], s_inv_angle[35], s_filter_thresh[6];

__device__ __forceinline__ void init_tables() {
  for (int i = threadIdx.x; i < 35; i += blockDim.x) {
    s_angle[i] = c_angle[i];
    s_inv_angle[i] = c_inv_angle[i];
  }
  for (int i = threadIdx.x; i < 6; i += blockDim.x)
    s_filter_thresh[i] = c_filter_thresh[i];
}

__device__ __forceinline__ uint4 entry_of(int v, int cx, int cy, int mode,
                                          int row, int WF, int C,
                                          bool luma) {
  const bool filt = luma && v > 2 && mode != 1 &&
                    min(abs(mode - 10), abs(mode - 26)) > s_filter_thresh[v];
  return make_uint4(
      (unsigned)(v - 2) | mode << 2 | row << 8,
      (unsigned)((4 * cy + 1) * WF + 4 * cx + 1) | (4 * cy * C + 4 * cx) << 16,
      (unsigned)(s_angle[mode] & 0xffff) | (unsigned)s_inv_angle[mode] << 16,
      (unsigned)filt | cx << 8 | cy << 12);
}

// A CTB's schedule in shared memory, as build_schedule leaves it and the
// walkers read it.
struct Sched {
  uint4* ent;        // the active TUs, sorted by key = 2 level + (larger
                     // than 4x4), stably
  uint16_t* cpos;    // the cell table: 2 nc + 1 entries a TU (ref_cells)
  uint32_t* lvd;     // lvd[level]: the level's first entry in ent, its 4x4
                     // TUs << 9, its larger TUs << 18
  int* hdr;          // [0]: the active TUs, [1]: the levels
};

__device__ __forceinline__ Sched sched_at(unsigned char* smem,
                                          const Layout& L, int b) {
  unsigned char* s = smem + L.sched0 + b * L.sched;
  return Sched{reinterpret_cast<uint4*>(s + L.ent),
               reinterpret_cast<uint16_t*>(s + L.cpos),
               reinterpret_cast<uint32_t*>(s + L.lvd),
               reinterpret_cast<int*>(s + L.hdr)};
}

// The reference cell q (scan order: the left column bottom-up, the corner,
// the top row) of a TU at cell (tx, ty) with nc cells a side, as a cell of
// the CTB (C4 cells a side), or -1 where it lies outside the CTB.
__device__ __forceinline__ int ref_cell(int q, int tx, int ty, int nc,
                                        int C4) {
  const int x = q < nc ? tx - 1 : tx + q - nc - 1;
  const int y = q < nc ? ty + nc - 1 - q : ty - 1;
  return x >= 0 && y >= 0 && x < C4 && y < C4 ? y * C4 + x : -1;
}

// The TUs' levels (kernels/hevc_levels.py) where no TU overlaps another
// and none reads a cell that a later TU writes, as decoded pictures are:
// each TU's predecessors are the writers of its available reference cells
// (preds, 0xff: none), all before it, so its level is 1 + the highest of
// theirs. By the planner warp (lane t), 32 TUs at a time: a lane takes the
// levels of its TU's predecessors in earlier chunks from lvl, and those in
// its own chunk (bits of `in`) from the lanes before it, in lane order.
// Returns the levels.
__device__ int longest_paths(const uint4* zlist, const uint8_t* preds,
                             uint16_t* lvl, int count, int t) {
  int top = 0;
  for (int base = 0; base < count; base += kWarp) {
    const int e = base + t;
    int ext = 0;
    unsigned in = 0;
    if (e < count) {
      const unsigned x = zlist[e].x;
      const uint8_t* pr = preds + (x >> 8);
      const int nref = (4 << (x & 3)) + 1;
      for (int q = 0; q < nref; ++q) {
        const int p = pr[q];
        if (p == 0xff) continue;
        if (p < base)
          ext = max(ext, (int)lvl[p]);
        else
          in |= 1u << (p - base);
      }
    }
    // lane j's level is final once the lanes before it are: one step a
    // lane, its level passed on to the lanes it precedes
    int m = ext, cur = 0;
    const int lim = min(kWarp, count - base);
    for (int j = 0; j < lim; ++j) {
      if (t == j) cur = m + 1;
      const int cj = __shfl_sync(kFull, cur, j);
      if (in >> j & 1) m = max(m, cj);
    }
    if (e < count) lvl[e] = (uint16_t)cur;
    top = max(top, cur);
    __syncwarp();
  }
  return __reduce_max_sync(kFull, top);
}

// The TUs' levels in general (overlapping TUs, reads of cells that later
// TUs write), by the planner warp (lane t) in z-order: each TU's level is 1
// + the highest of the levels that last wrote a cell it reads or writes and
// of the levels that read a cell it writes; then those of its cells. The
// lanes take the TU's cells, 32 at a time: its own block, then its
// available reference cells inside the CTB in scan order (bit 15 of its
// cell-table entries). wlrl[c]: the level that last wrote cell c (low 16
// bits), the highest that read it (high 16 bits), zeroed before. Writes
// each TU's level to lvl; returns the levels.
__device__ int tu_levels(const uint4* zlist, const uint16_t* cpos,
                         uint32_t* wlrl, uint16_t* lvl, int count, int C4,
                         int t) {
  int top = 0;
  for (int e = 0; e < count; ++e) {
    const uint4 ent = zlist[e];
    const int v = (ent.x & 3) + 2, tx = ent.w >> 8 & 15, ty = ent.w >> 12 & 15;
    const int n4 = 1 << (v - 2), nc = 2 * n4, own = n4 * n4;
    const int nref = 2 * nc + 1, row = ent.x >> 8;
    const unsigned long long m =
        __ballot_sync(kFull, t < nref && (cpos[row + t] & 0x8000)) |
        (unsigned long long)__ballot_sync(
            kFull, t + kWarp < nref && (cpos[row + t + kWarp] & 0x8000))
            << kWarp;
    int cell[4];
    uint32_t word[4];
    int mx = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = t + kWarp * r;
      int c = -1;
      if (j < own)
        c = (ty + (j >> (v - 2))) * C4 + tx + (j & (n4 - 1));
      else if (j < own + nref && (m >> (j - own) & 1))
        c = ref_cell(j - own, tx, ty, nc, C4);
      cell[r] = c;
      word[r] = c >= 0 ? wlrl[c] : 0;
      const int w = word[r] & 0xffff, rd = word[r] >> 16;
      if (c >= 0) mx = max(mx, j < own ? max(w, rd) : w);
    }
    const int lv = __reduce_max_sync(kFull, mx) + 1;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = t + kWarp * r;
      if (cell[r] >= 0)
        wlrl[cell[r]] = j < own
            ? (word[r] & 0xffff0000u) | (uint32_t)lv
            : (word[r] & 0xffffu) |
                  (uint32_t)max((int)(word[r] >> 16), lv) << 16;
    }
    __syncwarp();
    if (t == 0) lvl[e] = (uint16_t)lv;
    top = max(top, lv);
  }
  return top;
}

// One TU's row of the cell table (ref_cells) and of the predecessors: the
// writer (cellw) of each of its available reference cells inside the CTB,
// 0xff where none. Returns whether a writer comes after the TU (index e).
template <int NC>
__device__ __forceinline__ bool cells_and_preds(uint16_t* P, uint8_t* pred,
                                                const int32_t* sZ,
                                                const int* cellw, int WZ,
                                                int WF, int C4, int tx,
                                                int ty, int none, int e) {
  const unsigned long long avail =
      ref_cells<NC>(P, sZ, WZ, WF, tx, ty, none);
  bool later = false;
#pragma unroll
  for (int q = 0; q <= 2 * NC; ++q) {
    const int c = avail >> q & 1 ? ref_cell(q, tx, ty, NC, C4) : -1;
    const int by = c >= 0 ? cellw[c] : -1;
    later |= by > e;
    pred[q] = (uint8_t)(by >= 0 ? by : 0xff);
  }
  return later;
}

// The schedule of CTB (cy, cx) from its staged maps and its Z, by the
// planner warp (lane t): the z-order TU list with each TU's cell table,
// the levels, the entries sorted by key into S.
__device__ void build_schedule(const ScanArgs& a, const Layout& L,
                               unsigned char* smem, const unsigned char* st,
                               Sched S, int WF, int WZ, int t) {
  const int C = a.C, C4 = C >> 2, cells = C4 * C4;
  const int32_t* sZ = reinterpret_cast<const int32_t*>(smem + L.z);
  const int32_t* sTU = reinterpret_cast<const int32_t*>(st + L.tu);
  const int32_t* sM = reinterpret_cast<const int32_t*>(st + L.mode);
  uint4* zlist = reinterpret_cast<uint4*>(smem + L.zlist);
  uint16_t* lvl = reinterpret_cast<uint16_t*>(smem + L.lvl);
  // the levels' scratch: each cell's writer and each TU's predecessors,
  // or the general pass's cell levels; then the keys' counts
  int* cellw = reinterpret_cast<int*>(smem + L.lscr);
  uint8_t* preds = smem + L.lscr + cells * 4;
  uint32_t* wlrl = reinterpret_cast<uint32_t*>(smem + L.lscr);
  int* kcnt = reinterpret_cast<int*>(smem + L.lscr);
  const int none = (1 + C) * WF;  // the slot after F: 128, nothing available

  // the active TUs in z-order (walk_ctb's rule), each with the offset of
  // its row in the cell table (a scan of the rows' lengths) and its list
  // index at its first cell
  for (int i = t; i < cells; i += kWarp) cellw[i] = -1;
  __syncwarp();
  int count = 0, off = 0;
  for (int zb = 0; zb < cells; zb += kWarp) {
    const int zi = zb + t;
    bool active = false;
    int cx = 0, cy = 0, v = 0;
    if (zi < cells) {
      cx = even_bits(zi);
      cy = even_bits(zi >> 1);
      v = sTU[cy * C4 + cx];
      active = v >= 2 && v <= a.log2T &&
               (zi & ((1 << (2 * (v - 2))) - 1)) == 0;
    }
    const int len = active ? 2 * (1 << (v - 1)) + 1 : 0;
    int incl = len;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (t >= d) incl += y;
    }
    const unsigned hits = __ballot_sync(kFull, active);
    if (active) {
      const int e = count + __popc(hits & ((1u << t) - 1));
      zlist[e] = entry_of(v, cx, cy, sM[cy * C4 + cx] & 63, off + incl - len,
                          WF, C, a.luma);
      cellw[cy * C4 + cx] = e;
    }
    count += __popc(hits);
    off += __shfl_sync(kFull, incl, kWarp - 1);
  }
  __syncwarp();
  HS_STAMP(0, 27);
  // each cell's writer: the active TU of each size whose block holds it (a
  // cell in two: TUs overlap)
  bool general = false;
  int by[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int zi = t + kWarp * k;
    by[k] = -1;
    if (zi < cells) {
#pragma unroll
      for (int v = 2; v <= 5; ++v) {
        const int fz = zi & ~((1 << (2 * (v - 2))) - 1);
        const int fc = even_bits(fz >> 1) * C4 + even_bits(fz);
        const int w = v <= a.log2T && sTU[fc] == v ? cellw[fc] : -1;
        general |= w >= 0 && by[k] >= 0;
        by[k] = w >= 0 ? w : by[k];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int zi = t + kWarp * k;
    if (zi < cells) cellw[even_bits(zi >> 1) * C4 + even_bits(zi)] = by[k];
  }
  __syncwarp();
  HS_STAMP(0, 29);
  // thread t fills the cell-table rows of TUs t, t+32, ... and their
  // predecessors: the writers of their available reference cells inside
  // the CTB (a writer after the TU: a cell read before a later TU writes
  // it)
  for (int e = t; e < count; e += kWarp) {
    const uint4 ent = zlist[e];
    const int tx = ent.w >> 8 & 15, ty = ent.w >> 12 & 15, row = ent.x >> 8;
    switch (ent.x & 3) {
      case 0:
        general |= cells_and_preds<2>(S.cpos + row, preds + row, sZ, cellw,
                                      WZ, WF, C4, tx, ty, none, e);
        break;
      case 1:
        general |= cells_and_preds<4>(S.cpos + row, preds + row, sZ, cellw,
                                      WZ, WF, C4, tx, ty, none, e);
        break;
      case 2:
        general |= cells_and_preds<8>(S.cpos + row, preds + row, sZ, cellw,
                                      WZ, WF, C4, tx, ty, none, e);
        break;
      default:
        general |= cells_and_preds<16>(S.cpos + row, preds + row, sZ, cellw,
                                       WZ, WF, C4, tx, ty, none, e);
    }
  }
  general = __any_sync(kFull, general);
  __syncwarp();
  HS_STAMP(0, 2);
  HS_COUNT(0, 6, count);
  int top = 0;
  if (!general) {
    top = longest_paths(zlist, preds, lvl, count, t);
  } else {
    HS_COUNT(0, 16, 1);
    for (int i = t; i < cells; i += kWarp) wlrl[i] = 0;
    __syncwarp();
    top = tu_levels(zlist, S.cpos, wlrl, lvl, count, C4, t);
  }
  top = __shfl_sync(kFull, top, 0);
  __syncwarp();
  HS_STAMP(0, 3);
  // the count of each key = 2 level + (larger than 4x4) at kcnt[key + 1]
  for (int i = t; i < 2 * top + 3; i += kWarp) kcnt[i] = 0;
  __syncwarp();
  for (int e = t; e < count; e += kWarp)
    atomicAdd(&kcnt[2 * lvl[e] + ((zlist[e].x & 3) != 0) + 1], 1);
  __syncwarp();
  // kcnt[k] = the start of key k: a scan of the counts over keys 0 .. 2
  // top + 2
  const int nk = 2 * top + 3;
  int carry = 0;
  for (int kb = 0; kb < nk; kb += kWarp) {
    const int k = kb + t;
    int incl = k < nk ? kcnt[k] : 0;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (t >= d) incl += y;
    }
    if (k < nk) kcnt[k] = carry + incl;
    carry += __shfl_sync(kFull, incl, kWarp - 1);
  }
  __syncwarp();
  // the entries into key order, z-order within a key; each key's start
  // moves on to its end
  for (int eb = 0; eb < count; eb += kWarp) {
    const int e = eb + t;
    uint4 ent = make_uint4(0, 0, 0, 0);
    int key = -1;
    if (e < count) {
      ent = zlist[e];
      key = 2 * lvl[e] + ((ent.x & 3) != 0);
    }
    const unsigned peers = __match_any_sync(kFull, key);
    const int rank = __popc(peers & ((1u << t) - 1));
    const int start = key >= 0 ? kcnt[key] : 0;
    __syncwarp();
    if (key >= 0) {
      S.ent[start + rank] = ent;
      if (rank == 0) kcnt[key] = start + __popc(peers);
    }
    __syncwarp();
  }
  // each level's descriptor: kcnt[2 lv - 1] is the start of its 4x4 TUs,
  // kcnt[2 lv] that of its larger ones, kcnt[2 lv + 1] their end
  for (int lv = 1 + t; lv <= top; lv += kWarp) {
    const int s0 = kcnt[2 * lv - 1], s1 = kcnt[2 * lv], s2 = kcnt[2 * lv + 1];
    S.lvd[lv] = (uint32_t)s0 | (uint32_t)(s1 - s0) << 9 |
                (uint32_t)(s2 - s1) << 18;
  }
  if (t == 0) {
    S.hdr[0] = count;
    S.hdr[1] = top;
  }
  __syncwarp();
  HS_STAMP(0, 4);
}

// A pixel of a 4x4 TU as the walk of its level needs it, resolved before
// the level starts from what does not depend on F: the TU's mode and
// weight, the positions in F of the reference samples the pixel reads,
// its residual and its own position (-1: no TU).
struct Pix4 {
  int mode, f, out, rs, x, y;
  int p[8];
};

// Pix4 of the pixel t & 15 of a 4x4 TU (ent, has: as walk_pair4) from its
// five cell-table entries (ref_cells). The reference samples, by mode:
//   planar: left, top-right, top, bottom-left;
//   DC: n .. 2n - 1 and 2n + 1 .. 3n (its left and top among them);
//   angular: the two taps (ext_index gives -1 or 4n + 1 only where the
//     weight is 0), then for the luma edge filters of modes 26 and 10 the
//     left, the top, the corner, the first top and the first left sample.
__device__ __forceinline__ Pix4 prep_pair4(const int16_t* sR,
                                           const uint16_t* sP, uint4 ent,
                                           bool has, int WF, int C, int t) {
  constexpr int n = 4;
  Pix4 q;
  const int h = t & 15, y = h >> 2, x = h & 3;
  q.x = x;
  q.y = y;
  q.mode = ent.x >> 2 & 63;
  const uint16_t* P = sP + (ent.x >> 8);
  const int c0 = P[0], c1 = P[1], c2 = P[2], c3 = P[3], c4 = P[4];
  q.rs = sR[(ent.y >> 16) + y * C + x];
  q.out = has ? (int)(ent.y & 0xffff) + y * WF + x : -1;
  auto pos = [&](int i) -> int {
    if (i < 2 * n) {
      const int e = i < n ? c0 : c1;
      return e & 0x8000 ? (e & 0x7fff) - (i & 3) * WF : e;
    }
    if (i == 2 * n) return c2 & 0x7fff;
    const int j = i - 2 * n - 1, e = j < n ? c3 : c4;
    return e & 0x8000 ? (e & 0x7fff) + (j & 3) : e;
  };
  q.f = 0;
  if (q.mode == 0) {
    q.p[0] = pos(2 * n - 1 - y);
    q.p[1] = pos(3 * n + 1);
    q.p[2] = pos(2 * n + 1 + x);
    q.p[3] = pos(n - 1);
  } else if (q.mode == 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      q.p[i] = pos(n + i);
      q.p[n + i] = pos(2 * n + 1 + i);
    }
  } else {
    const int ang = (int16_t)(ent.z & 0xffff), inv = (int)ent.z >> 16;
    const int sgn = q.mode < 18 ? -1 : 1;
    const int rr = sgn < 0 ? x : y, cc = sgn < 0 ? y : x;
    const int aa = (rr + 1) * ang;
    const int e = n + 1 + (aa >> 5) + cc;
    q.f = aa & 31;
    q.p[0] = pos(min(max(ext_index<n>(e, sgn, inv), 0), 4 * n));
    q.p[1] = pos(min(max(ext_index<n>(e + 1, sgn, inv), 0), 4 * n));
    q.p[2] = pos(2 * n - 1 - y);
    q.p[3] = pos(2 * n + 1 + x);
    q.p[4] = pos(2 * n);
    q.p[5] = pos(2 * n + 1);
    q.p[6] = pos(2 * n - 1);
  }
  return q;
}

// The walks of the 4x4 and 8x8 TUs: inlined, or behind calls of their own
// in tools/time_hevc_scan.py's build that times what the calls cost.
#ifdef JMX_SCAN_SMALL_CALLS
#define SMALL_WALK __noinline__
#else
#define SMALL_WALK __forceinline__
#endif

// The pixel of a Pix4 (walk_tu<2, true>'s arithmetic), its samples read
// from sF, written into sF.
__device__ SMALL_WALK void run_pair4(int16_t* sF, const Pix4& q, bool luma) {
  constexpr int n = 4;
  const int x = q.x, y = q.y;
  int pred;
  if (q.mode == 0) {
    pred = ((n - 1 - x) * sF[q.p[0]] + (x + 1) * sF[q.p[1]] +
            (n - 1 - y) * sF[q.p[2]] + (y + 1) * sF[q.p[3]] + n) >> 3;
  } else if (q.mode == 1) {
    int v[2 * n], sum = 0;
#pragma unroll
    for (int i = 0; i < 2 * n; ++i) {
      v[i] = sF[q.p[i]];
      sum += v[i];
    }
    const int dc = (sum + n) >> 3;
    const int left = y == 0 ? v[3] : y == 1 ? v[2] : y == 2 ? v[1] : v[0];
    const int top = x == 0 ? v[4] : x == 1 ? v[5] : x == 2 ? v[6] : v[7];
    pred = dc;
    if (luma && y == 0) pred = (top + 3 * dc + 2) >> 2;
    if (luma && x == 0) pred = (left + 3 * dc + 2) >> 2;
    if (luma && y == 0 && x == 0) pred = (left + 2 * dc + top + 2) >> 2;
  } else {
    pred = ((32 - q.f) * sF[q.p[0]] + q.f * sF[q.p[1]] + 16) >> 5;
    if (luma && q.mode == 26 && x == 0)
      pred = clip255(((sF[q.p[2]] - sF[q.p[4]]) >> 1) + sF[q.p[5]]);
    if (luma && q.mode == 10 && y == 0)
      pred = clip255(((sF[q.p[3]] - sF[q.p[4]]) >> 1) + sF[q.p[6]]);
  }
  if (q.out >= 0) sF[q.out] = (int16_t)clip255(pred + q.rs);
}

// An 8x8 TU's lane t as the walk of its level needs it, resolved before
// the level starts from what does not depend on F: the positions in F of
// reference sample t and of sample 32 (4n), and for its two pixels (t and
// t + 32 in raster order) their residuals, positions and the reference
// indices of their taps (planar: left, top-right, top, bottom-left;
// angular: the two taps, ext_index giving -1 or 4n + 1 only where the
// weight is 0; DC: its left and top).
struct Pix8 {
  int mode, filt, own, last;
  int f[2], rs[2], out[2], i0[2], i1[2], i2[2], i3[2];
};

__device__ __forceinline__ Pix8 prep_8x8(const int16_t* sR,
                                         const uint16_t* sP, uint4 ent,
                                         int WF, int C, int t) {
  constexpr int n = 8;
  Pix8 px;
  px.mode = ent.x >> 2 & 63;
  px.filt = ent.w & 1;
  const uint16_t* P = sP + (ent.x >> 8);
  px.own = ref_pos<n, true>(P, t, WF);
  px.last = ref_pos<n, true>(P, 4 * n, WF);
  const int ang = (int16_t)(ent.z & 0xffff), inv = (int)ent.z >> 16;
  const int sgn = px.mode < 18 ? -1 : 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = t + kWarp * r, y = p >> 3, x = p & 7;
    px.rs[r] = sR[(ent.y >> 16) + y * C + x];
    px.out[r] = (int)(ent.y & 0xffff) + y * WF + x;
    px.i0[r] = 2 * n - 1 - y;     // left
    px.i2[r] = 2 * n + 1 + x;     // top
    px.i1[r] = 3 * n + 1;         // top-right (planar)
    px.i3[r] = n - 1;             // bottom-left (planar)
    px.f[r] = 0;
    if (px.mode >= 2) {
      const int rr = sgn < 0 ? x : y, cc = sgn < 0 ? y : x;
      const int aa = (rr + 1) * ang;
      const int e = n + 1 + (aa >> 5) + cc;
      px.f[r] = aa & 31;
      px.i1[r] = min(max(ext_index<n>(e, sgn, inv), 0), 4 * n);
      px.i3[r] = min(max(ext_index<n>(e + 1, sgn, inv), 0), 4 * n);
    }
  }
  return px;
}

// The two pixels of lane t of a Pix8 (walk_tu<3, true>'s arithmetic): each
// lane reads its reference sample from F, the [1 2 1] filter and the taps
// come from the other lanes by shuffles, the DC sum by a reduction.
__device__ SMALL_WALK void run_8x8(int16_t* sF, const Pix8& px, bool luma,
                                   int t) {
  constexpr int n = 8;
  const int v = sF[px.own], v4n = sF[px.last];
  const int vl = __shfl_up_sync(kFull, v, 1);
  const int vd = __shfl_down_sync(kFull, v, 1);
  const int vr = t == kWarp - 1 ? v4n : vd;
  const int fv = px.filt && t > 0 ? (vl + 2 * v + vr + 2) >> 2 : v;
  // reference i of the (filtered) vector
  auto ref = [&](int i) {
    const int a = __shfl_sync(kFull, fv, i & (kWarp - 1));
    return i == 4 * n ? v4n : a;
  };
  auto raw = [&](int i) { return __shfl_sync(kFull, v, i); };
  if (px.mode == 1) {
    const int part = (t >= n && t < 2 * n) || (t > 2 * n && t <= 3 * n) ? v
                                                                        : 0;
    const int dc = (__reduce_add_sync(kFull, part) + n) >> 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = t + kWarp * r, y = p >> 3, x = p & 7;
      const int left = raw(px.i0[r]), top = raw(px.i2[r]);
      int pred = dc;
      if (luma && y == 0) pred = (top + 3 * dc + 2) >> 2;
      if (luma && x == 0) pred = (left + 3 * dc + 2) >> 2;
      if (luma && y == 0 && x == 0) pred = (left + 2 * dc + top + 2) >> 2;
      sF[px.out[r]] = (int16_t)clip255(pred + px.rs[r]);
    }
  } else if (px.mode == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = t + kWarp * r, y = p >> 3, x = p & 7;
      const int pred = ((n - 1 - x) * ref(px.i0[r]) + (x + 1) * ref(px.i1[r]) +
                        (n - 1 - y) * ref(px.i2[r]) + (y + 1) * ref(px.i3[r]) +
                        n) >> 4;
      sF[px.out[r]] = (int16_t)clip255(pred + px.rs[r]);
    }
  } else {
    const bool edge = luma && (px.mode == 26 || px.mode == 10);
    const int tl = raw(2 * n), t0 = raw(2 * n + 1), l0 = raw(2 * n - 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = t + kWarp * r, y = p >> 3, x = p & 7;
      int pred = ((32 - px.f[r]) * ref(px.i1[r]) + px.f[r] * ref(px.i3[r]) +
                  16) >> 5;
      // the edge filters' modes are never filtered (fv == v there)
      const int left = raw(px.i0[r]), top = raw(px.i2[r]);
      if (edge && px.mode == 26 && x == 0)
        pred = clip255(((left - tl) >> 1) + t0);
      if (edge && px.mode == 10 && y == 0)
        pred = clip255(((top - tl) >> 1) + l0);
      sF[px.out[r]] = (int16_t)clip255(pred + px.rs[r]);
    }
  }
}

// The walks of the 16x16 and 32x32 TUs, behind a call of their own.
template <int LOG2>
__device__ __noinline__ void walk_tu_call(int16_t* sF, const int16_t* sR,
                                          const uint16_t* sP, int* sA,
                                          int* sB, int* sE, uint4 ent,
                                          int WF, int C, bool luma,
                                          bool strong, int t) {
  walk_tu<LOG2, true>(sF, sR, sP, sA, sB, sE, ent, WF, C, luma, strong, t);
}

// Row 0 of F for CTB (cy, cx) of plane p: the lane above's samples from
// `out` (written during the launch: through L2 only), 0 where there are
// none; by the walkers.
__device__ __forceinline__ void load_top(const ScanArgs& a, int16_t* sF,
                                         int p, int cy, int cx, int WF,
                                         int wt) {
  const int C = a.C, W = a.ctb_w * C;
  const int32_t* row =
      a.out + ((long long)p * a.ctb_h * C + (long long)cy * C - 1) * W;
  for (int c = wt; c < WF; c += kWalkThreads) {
    const int x = cx * C + c - 1;
    sF[c] = (int16_t)(cy > 0 && x >= 0 && x < W ? __ldcg(row + x) : 0);
  }
}

// Rows r0 .. r1 - 1 of the CTB in F to `out` at dst (row stride W), four
// int32 samples a store; by the walkers.
__device__ __forceinline__ void store_rows(int32_t* dst, const int16_t* sF,
                                           int WF, int C, int log2C, int W,
                                           int r0, int r1, int wt) {
  const int q4 = C >> 2;
  for (int i = wt; i < (r1 - r0) * q4; i += kWalkThreads) {
    const int y = r0 + (i >> (log2C - 2)), x = (i & (q4 - 1)) << 2;
    const int16_t* s = sF + (1 + y) * WF + 1 + x;
    *reinterpret_cast<int4*>(dst + (long long)y * W + x) =
        make_int4(s[0], s[1], s[2], s[3]);
  }
}

// CTB cx of the lane's np planes (p0, p0 + G, ...), by the walkers (thread
// wt, warp w): F, the wait for the lane above, the levels, the stores and
// the progress flag.
__device__ __forceinline__ void walk_levels(
    const ScanArgs& a, unsigned char* smem, Sched S, const unsigned char* st,
    const Layout& L, int* flag, const int* above, int p0, int np, int cy,
    int cx, int WF, int wt, int w) {
  const int C = a.C, W = a.ctb_w * C, H = a.ctb_h * C;
  const int t = wt & (kWarp - 1);
  const int rb = pad16(C * C * 2);
  auto plane_F = [&](int j) {
    return reinterpret_cast<int16_t*>(smem + L.f + j * L.fplane);
  };
  for (int j = 0; j < np; ++j) {
    int16_t* sF = plane_F(j);
    for (int y = wt; y < C; y += kWalkThreads)
      sF[(1 + y) * WF] = cx > 0 ? sF[(1 + y) * WF + C] : 0;
  }
  walkers_sync();
  for (int j = 0; j < np; ++j) {
    int16_t* sF = plane_F(j);
    const int16_t* sBase = a.base != nullptr
        ? reinterpret_cast<const int16_t*>(st + L.base + j * rb) : nullptr;
    for (int i = wt; i < C * C; i += kWalkThreads)
      sF[(1 + (i >> a.log2C)) * WF + 1 + (i & (C - 1))] =
          sBase != nullptr ? sBase[i] : 0;
  }
  const int count = S.hdr[0], levels = S.hdr[1];
  HS_STAMP(1, 8);
  if (count > 0) {
    // the lane above (none in a plane's first CTB row), then row 0 of F
    if (above != nullptr && w == 0)
      wait_progress(above, min(cx + a.skew, a.ctb_w));
    walkers_sync();
    HS_STAMP(1, 9);
    for (int j = 0; j < np; ++j)
      load_top(a, plane_F(j), p0 + j * a.G, cy, cx, WF, wt);
    walkers_sync();
    HS_STAMP(1, 10);
    HS_COUNT(1, 14, levels);
    int* sA = reinterpret_cast<int*>(smem + L.refs) +
              w * (L.refs_warp >> 2) + 1;
    int* sB = sA + kRefSlots;
    int* sE = sB + kRefSlots - 1;
    int16_t* F0 = plane_F(0);
    int16_t* F1 = plane_F(np - 1);
    const int16_t* R0 = reinterpret_cast<const int16_t*>(st + L.res);
    const int16_t* R1 = R0 + (np - 1) * (rb >> 1);
    uint32_t d = S.lvd[1];
    for (int lv = 1; lv <= levels; ++lv) {
      const uint32_t dn = lv < levels ? S.lvd[lv + 1] : 0;
      // this level's 4x4 TUs [s0, s0 + k4) in pairs, then its kb larger
      // ones, one unit of one plane a warp in turn
      const int s0 = d & 511, k4 = d >> 9 & 511, kb = d >> 18 & 511;
      const int pairs = (k4 + 1) >> 1;
      for (int u = w; u < np * (pairs + kb); u += kWalkers) {
        const int j = np == 2 ? u & 1 : 0, uu = np == 2 ? u >> 1 : u;
        int16_t* sF = j ? F1 : F0;
        const int16_t* sR = j ? R1 : R0;
        HS_STAMP(1, 17);
        if (uu < pairs) {
          const int e = s0 + 2 * uu + (t >> 4);
          const bool has = e < s0 + k4;
          const Pix4 pq =
              prep_pair4(sR, S.cpos, S.ent[has ? e : s0], has, WF, C, t);
          run_pair4(sF, pq, a.luma);
        } else {
          const uint4 ent = S.ent[s0 + k4 + uu - pairs];
          switch (ent.x & 3) {
            case 1: {
              const Pix8 p8 = prep_8x8(sR, S.cpos, ent, WF, C, t);
              run_8x8(sF, p8, a.luma, t);
              break;
            }
            case 2:
              walk_tu_call<4>(sF, sR, S.cpos, sA, sB, sE, ent, WF, C,
                              a.luma, a.strong, t);
              break;
            default:
              walk_tu_call<5>(sF, sR, S.cpos, sA, sB, sE, ent, WF, C,
                              a.luma, a.strong, t);
          }
        }
#ifdef JMX_SCAN_TIMING
        {
          const int cls = uu < pairs ? 0 : (S.ent[s0 + k4 + uu - pairs].x & 3);
          HS_STAMP(1, 19 + cls);
          HS_COUNT(1, 23 + cls, 1);
        }
#endif
      }
      HS_STAMP(1, 17);
      walkers_sync();
      HS_STAMP(1, 18);
      d = dn;
    }
    HS_STAMP(1, 11);
  } else {
    walkers_sync();
  }
  auto dst = [&](int j) {
    return a.out + ((long long)(p0 + j * a.G) * H + (long long)cy * C) * W +
           (long long)cx * C;
  };
  for (int j = 0; j < np; ++j)
    store_rows(dst(j), plane_F(j), WF, C, a.log2C, W, C - 1, C, wt);
  walkers_sync();
  if (wt == 0) st_release(flag, cx + 1);
  for (int j = 0; j < np; ++j)
    store_rows(dst(j), plane_F(j), WF, C, a.log2C, W, 0, C - 1, wt);
  HS_STAMP(1, 12);
  HS_COUNT(1, 15, 1);
}

// A CTA's ticket: the next lane, for every thread (slot: shared int).
__device__ __forceinline__ int cta_next_lane(int* ticket, int* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = atomicAdd(ticket, 1);
  __syncthreads();
  return *slot;
}

// A lane is one CTB row (cy) of up to LP planes on one cell map g: the
// planes p0 = g + G * LP * k, p0 + G, ... below P for the lane's chunk k of
// the map's NP planes. Lanes are numbered chunk by chunk (k * G + g), CTB
// row innermost, so the lane above a lane comes just before it.
__global__ void __launch_bounds__(kThreads, 3) hevc_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int lane_slot;
  const int tid = threadIdx.x, w = tid >> 5, t = tid & (kWarp - 1);
  const int C = a.C, C4 = C >> 2;
  const int WF = 1 + a.skew * C;
  const int HZ = 1 + C4 + (a.T >> 2), WZ = 1 + a.skew * C4;
  const Layout L = layout(C, a.T, a.log2T, a.skew, a.base != nullptr, a.LP);
  int32_t* sZ = reinterpret_cast<int32_t*>(smem + L.z);

  init_tables();
  init_z(sZ, C4, HZ, WZ, a.zidx_none);
  // F is 0 but where a CTB writes it: row 0, column 0, the interior; the
  // slot after it holds 128
  for (int j = 0; j < a.LP; ++j) {
    int16_t* sF = reinterpret_cast<int16_t*>(smem + L.f + j * L.fplane);
    for (int i = tid; i < (1 + C) * WF; i += kThreads) sF[i] = 0;
    if (tid == 0) sF[(1 + C) * WF] = 128;
  }

  HS_BEGIN();
  const int chunks = (a.NP + a.LP - 1) / a.LP;
  const int total = chunks * a.G * a.ctb_h;
  for (int id = cta_next_lane(a.ticket, &lane_slot); id < total;
       id = cta_next_lane(a.ticket, &lane_slot)) {
    const int ci = id / a.ctb_h, cy = id - ci * a.ctb_h;
    const int g = ci % a.G, k = ci / a.G;
    const int p0 = g + a.G * a.LP * k;
    const int np = min(a.LP, a.NP - a.LP * k);
    int* flag = a.flags + id;
    const int* above = cy > 0 ? flag - 1 : nullptr;
    // the planner stages CTB 0 and builds its schedule, then, while the
    // walkers walk CTB cx, those of CTB cx + 1
    unsigned char* maps = smem + L.maps;
    for (int cx = -1; cx < a.ctb_w; ++cx) {
      if (w == kPlanner) {
        if (cx + 1 < a.ctb_w) {
          // the maps of CTB cx + 1 were staged with the previous CTB's
          // schedule (or just now, for CTB 0); its residual goes into the
          // stage buffer the walkers are done with
          const int b = (cx + 1) & 1;
          if (cx < 0) {
            prefetch_maps(a, L, maps, g, cy, 0, t);
            commit();
          }
          prefetch_planes(a, L, smem + L.stage0 + b * L.stage, p0, np, cy,
                          cx + 1, t);
          commit();
          wait_groups(1);
          __syncwarp();
          HS_STAMP(0, 0);
          build_z(a, L, maps, sZ, cy, cx + 1, WZ, t);
          __syncwarp();
          HS_STAMP(0, 1);
          build_schedule(a, L, smem, maps, sched_at(smem, L, b), WF, WZ, t);
          HS_COUNT(0, 7, 1);
          if (cx + 2 < a.ctb_w) {
            prefetch_maps(a, L, maps, g, cy, cx + 2, t);
            commit();
            wait_groups(1);
          } else {
            wait_groups(0);
          }
          __syncwarp();
        }
      } else if (cx >= 0) {
        walk_levels(a, smem, sched_at(smem, L, cx & 1),
                    smem + L.stage0 + (cx & 1) * L.stage, L, flag, above, p0,
                    np, cy, cx, WF, tid, w);
      }
      __syncthreads();
      HS_STAMP(0, 5);
      HS_STAMP(1, 13);
    }
  }
  HS_END();
}

}  // namespace

// The geometry checks of a launch; 0 if the scan can run, and then T and
// the log2 sizes in *T, *log2C, *log2T.
static int check_geometry(int C, int max_tu, int skew, int* T, int* log2C,
                          int* log2T) {
  *T = C < max_tu ? C : max_tu;
  *log2C = *log2T = 0;
  while ((1 << *log2C) < C) ++*log2C;
  while ((1 << *log2T) < *T) ++*log2T;
  if ((1 << *log2C) != C || C < 8 || C > 64 || *T < 4 || *T > kMaxTu ||
      (1 << *log2T) != *T || C / *T > 2 || skew < 1 || skew > 4 ||
      (1 + C) * (1 + skew * C) + 1 > 32767)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The CTAs of this geometry that fit the current device at once (*n), after
// setting the kernel's shared memory limit to what the geometry needs.
static cudaError_t resident(const Layout& L, int* n) {
  cudaError_t e;
  if (L.total > 48 * 1024 &&
      (e = cudaFuncSetAttribute(hevc_scan_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                L.total)) != cudaSuccess)
    return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, hevc_scan_kernel, kThreads, L.total)) != cudaSuccess)
    return e;
  *n = sms * per_sm;
  return *n > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The CTAs a launch of this geometry keeps on the card at once (*n), the
// shared memory of each (*smem) and its threads (*threads). Returns a
// cudaError_t, or 0.
extern "C" int hevc_scan_resident(int C, int max_tu, int skew, int has_base,
                                  int lane_planes, int* n, int* smem,
                                  int* threads) {
  int T, log2C, log2T;
  const int bad = check_geometry(C, max_tu, skew, &T, &log2C, &log2T);
  if (bad) return bad;
  const int LP = lane_planes < 1 ? 1 : lane_planes > kLanePlanes
                                            ? kLanePlanes : lane_planes;
  const Layout L = layout(C, T, log2T, skew, has_base != 0, LP);
  *smem = L.total;
  *threads = kThreads;
  return (int)resident(L, n);
}

// Scan the planes (layout above) in one launch of min(lanes, the CTAs that
// fit the card at once) CTAs of kThreads threads on `stream`, for the
// lanes of the note above; does not synchronise. flags [lanes] and
// *ticket are scratch, all 0. base may be null. Returns the launch's
// cudaError_t, or 0.
extern "C" int hevc_scan_launch(const void* resid, const void* base,
                                const void* zidx, const void* tu,
                                const void* mode, void* out, void* flags,
                                void* ticket, int P, int G, int ctb_h,
                                int ctb_w, int C, int max_tu, int skew,
                                int is_chroma, int strong, int zidx_none,
                                void* stream) {
  int T, log2C, log2T;
  const int bad = check_geometry(C, max_tu, skew, &T, &log2C, &log2T);
  if (bad || P <= 0 || G <= 0 || P % G != 0 || ctb_h <= 0 || ctb_w <= 0)
    return bad ? bad : (int)cudaErrorInvalidValue;
  const int NP = P / G, LP = NP < kLanePlanes ? NP : kLanePlanes;
  const Layout L = layout(C, T, log2T, skew, base != nullptr, LP);
  int cap = 0;
  const cudaError_t e = resident(L, &cap);
  if (e != cudaSuccess) return (int)e;
  const int lanes = (NP + LP - 1) / LP * G * ctb_h;
  ScanArgs a{(const int16_t*)resid, (const int16_t*)base,
             (const int32_t*)zidx, (const int32_t*)tu,
             (const int32_t*)mode, (int32_t*)out, (int*)flags, (int*)ticket,
             P, G, ctb_h, ctb_w, C, log2C, T, log2T, skew, !is_chroma,
             strong != 0, zidx_none, NP, LP};
  const int grid = lanes < cap ? lanes : cap;
  hevc_scan_kernel<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#ifdef JMX_SCAN_TIMING
// g_hs_cycles to the host (32 values), then zeroed. Returns a cudaError_t.
extern "C" int hevc_scan_cycles(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_hs_cycles, sizeof(g_hs_cycles));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[32] = {0};
  return (int)cudaMemcpyToSymbol(g_hs_cycles, zero, sizeof(zero));
}
#endif
