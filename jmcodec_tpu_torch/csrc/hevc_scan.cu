// HEVC intra reconstruction (8.4.4.2) of whole planes: one CTB-row
// wavefront scan in one persistent launch, the lanes chained by progress
// flags (lane_chain.cuh), each CTB walked by the TU walk of hevc_walk.cuh.
// Built by jmcodec_tpu_torch/kernels/_build.py; bound with ctypes by
// jmcodec_tpu_torch/kernels/hevc_scan.py (scan_planes), whose plain torch
// version (scan_reference) it must equal bit for bit.
//
// Replaces the scan that jmcodec_tpu runs as a jax.lax.scan on the device
// (kernels/hevc_tiles.py: _intra_scan, its body at :650 and the scan at
// :712), with the skew of its inputs (_skew) and the unskew of its output
// (_unskew_to_plane) around it. There a step assembles the composite F and
// the z-index border Z of one CTB a lane from the carry (the last skew + 1
// bottom rows, the left column), walks, and shifts the carry; the skew is
// the TPU's way to put one diagonal of CTBs into one dense batch. Here
// nothing is skewed: the kernel reads the planes and writes them.
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
// A lane is one CTB row of one plane, (p, cy), and a CTA of one warp takes
// the lanes by the ticket of lane_chain.cuh, in the order p * ctb_h + cy,
// and walks each lane's CTBs left to right. CTB (cy, cx) reads the bottom
// rows of CTBs cx - 1 .. cx + skew - 1 of the row above (the corner, the
// top and the top-right references), so before it the warp waits until
// the lane above has finished CTB min(cx + skew - 1, ctb_w - 1); skew is
// hevc_tables.skew_for of the luma CTB size (2 at CTU 64, 3 at CTU 16 and
// 32). The chain of a scan is ctb_w + skew (ctb_h - 1) CTBs long, as the
// JAX scan's steps are.
//
// Per CTB, the composite F (int16, 1 + C + T rows by 1 + skew C columns,
// T = min(C, max_tu)) and Z (int32, 1 + C/4 + T/4 by 1 + skew C/4) are
// built in shared memory exactly as the torch loop builds them
// (kernels/hevc_tiles._intra_scan):
//   - row 0 of F: the lane above's bottom row over CTBs cx .. cx + skew - 1,
//     0 past the right edge of the picture (the JAX carry holds zeros
//     there), F[0, 0] the bottom-right sample of CTB cx - 1 above; read
//     from `out` through L2 after the acquire, and only for a CTB that
//     holds a TU (one without reads no neighbour);
//   - column 0 of F: the last column of the warp's previous CTB, still in
//     shared memory;
//   - the interior: the base, or zeros; the rest of F stays 0;
//   - Z: the CTB's own cells, and in row 0 and column 0 the cells of the
//     CTBs above and to the left, each ZIDX_NONE where there is no lane
//     above (cy = 0), no CTB to the left (cx = 0) or the picture ends.
// Then the walk (walk_ctb), and the CTB goes straight into `out`: its
// bottom row first, then the progress flag (a release store), then the
// rest (only the lane below reads `out` during the launch, and only bottom
// rows). A CTB without a TU is its interior (the base, or zeros): it is
// stored without a wait or a walk. Everything the launch does not write
// (the residual, the maps, the base) is staged a CTB ahead with cp.async
// into the second of two buffers, while the CTB before it is walked.
//
// What bounds it on this card: the chain, not the bytes. A CTB's walk is
// the serial chain of its TUs (hevc_walk.cu's notes), a lane's CTBs follow
// each other and a lane waits on the lane above, so a scan takes about
// (its chain of CTBs) x (the walk of one CTB). At 1080p and CTU 64 the
// luma scan moves ~17 MB a frame (residual and output) that would take ~5
// us at the HBM rate. The design keeps the host out of the chain (one
// launch a scan, against a launch and ~50 torch operations a step of the
// torch loop) and keeps each step of the chain at one CTB's walk: the
// staging of the next CTB and the TU list and positions of this one (Z is
// known before the scan) are off the chain, and the only reads that wait
// on another SM are the skew C + 1 samples of the row above. Measured at
// the 1080p batch of 16, CTU 64, on an H100 (chip_smoke.py phase 5): a
// luma scan 3.21 ms (51.7 us a CTB of its 62-CTB chain), a chroma scan
// 1.47 ms, against 2.96 / 1.22 ms for the 62 launches of the one-step walk
// kernel alone: a step of the chain is the walk of the heaviest CTBs.

#include <cuda_runtime.h>
#include <stdint.h>

// each TU size's walk a function of its own (see walk_one)
#define HEVC_WALK_TU_INLINE __noinline__
#include "hevc_walk.cuh"
#include "lane_chain.cuh"

namespace {

using namespace lane_chain;

struct ScanArgs {
  const int16_t* resid;
  const int16_t* base;        // or null
  const int32_t *zidx, *tu, *mode;
  int32_t* out;
  int* flags;                 // [P * ctb_h] progress: CTBs finished
  int* ticket;                // the lanes' hand-out counter
  int P, G, ctb_h, ctb_w, C, log2C, T, log2T, skew, luma, strong;
  int zidx_none;
};

// Byte offsets of one CTA's shared memory: F (with its slot for 128 after
// it), Z, the TU list, the position table, the reference vectors, then two
// stage buffers of `stage` bytes, each the residual, the base (only with
// one), the TU map, the mode map, the CTB's Z cells, the Z cells of the
// row above (the corner first) and those of the column to the left.
struct Layout {
  int f, z, list, pos, refs, stage0, stage;
  int res, base, tu, mode, zt, ztop, zleft;
  int total;
};

__host__ __device__ __forceinline__ Layout layout(int C, int T, int log2T,
                                                  int skew, bool has_base) {
  const int C4 = C >> 2, cells = C4 * C4;
  const int HF = 1 + C + T, WF = 1 + skew * C;
  const int HZ = 1 + C4 + (T >> 2), WZ = 1 + skew * C4;
  Layout L;
  int p = 0;
  L.f = p;      p += pad16(HF * WF * 2 + 2);
  L.z = p;      p += pad16(HZ * WZ * 4);
  L.list = p;   p += cells * 16;
  L.pos = p;    p += pad16(pos_row(log2T + 1, 0, cells) * 2);
  L.refs = p;   p += pad16((2 * kRefSlots + kExtSlots) * 4);
  int q = 0;
  L.res = q;    q += pad16(C * C * 2);
  L.base = q;   q += has_base ? pad16(C * C * 2) : 0;
  L.tu = q;     q += pad16(cells * 4);
  L.mode = q;   q += pad16(cells * 4);
  L.zt = q;     q += pad16(cells * 4);
  L.ztop = q;   q += pad16((1 + skew * C4) * 4);
  L.zleft = q;  q += pad16(C4 * 4);
  L.stage0 = p;
  L.stage = q;
  L.total = p + 2 * q;
  return L;
}

// Start the copy of `rows` rows of `rb` bytes (a multiple of 4) at src,
// `stride` bytes apart, to dst in shared memory, rb bytes apart: 16 bytes
// at a time where both sides allow it, else 4.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const void* src, int rows, int rb,
                                           long long stride) {
  const unsigned char* g = static_cast<const unsigned char*>(src);
  const int t = threadIdx.x;
  if ((((uintptr_t)g | (uintptr_t)stride | (uintptr_t)rb) & 15) == 0) {
    const int per = rb >> 4;
    for (int i = t; i < rows * per; i += kWarp) {
      const int r = i / per, c = (i - r * per) << 4;
      cp16(dst + r * rb + c, g + r * stride + c);
    }
  } else {
    const int per = rb >> 2;
    for (int i = t; i < rows * per; i += kWarp) {
      const int r = i / per, c = (i - r * per) << 2;
      cp4(dst + r * rb + c, g + r * stride + c);
    }
  }
}

// Stage the inputs of CTB (cy, cx) of plane p (cell plane g) into st.
__device__ void prefetch(const ScanArgs& a, const Layout& L,
                         unsigned char* st, int p, int g, int cy, int cx) {
  const int t = threadIdx.x;
  const int C = a.C, C4 = C >> 2;
  const long long W = (long long)a.ctb_w * C, W4 = W >> 2;
  const long long H = (long long)a.ctb_h * C, H4 = H >> 2;
  const long long pix = ((long long)p * H + (long long)cy * C) * W +
                        (long long)cx * C;
  stage_rows(st + L.res, a.resid + pix, C, C * 2, W * 2);
  if (a.base != nullptr)
    stage_rows(st + L.base, a.base + pix, C, C * 2, W * 2);
  const long long cell = ((long long)g * H4 + (long long)cy * C4) * W4 +
                         (long long)cx * C4;
  stage_rows(st + L.tu, a.tu + cell, C4, C4 * 4, W4 * 4);
  stage_rows(st + L.mode, a.mode + cell, C4, C4 * 4, W4 * 4);
  stage_rows(st + L.zt, a.zidx + cell, C4, C4 * 4, W4 * 4);
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

// Z of CTB (cy, cx) from the staged cells (HZ x WZ, ZIDX_NONE outside).
__device__ __forceinline__ void build_z(const ScanArgs& a, const Layout& L,
                                        const unsigned char* st,
                                        int32_t* sZ, int cy, int cx, int HZ,
                                        int WZ) {
  const int C4 = a.C >> 2, W4 = (a.ctb_w * a.C) >> 2;
  const int32_t* zt = reinterpret_cast<const int32_t*>(st + L.zt);
  const int32_t* ztop = reinterpret_cast<const int32_t*>(st + L.ztop);
  const int32_t* zleft = reinterpret_cast<const int32_t*>(st + L.zleft);
  for (int i = threadIdx.x; i < HZ * WZ; i += kWarp) {
    const int r = i / WZ, c = i - r * WZ;
    int v = a.zidx_none;
    if (r == 0) {
      if (cy > 0 && (c == 0 ? cx > 0 : cx * C4 + c - 1 < W4)) v = ztop[c];
    } else if (r <= C4) {
      if (c == 0) {
        if (cx > 0) v = zleft[r - 1];
      } else if (c <= C4) {
        v = zt[(r - 1) * C4 + c - 1];
      }
    }
    sZ[i] = v;
  }
}

// Row 0 of F for CTB (cy, cx) of plane p: the lane above's samples from
// `out` (written during the launch: through L2 only), 0 where there are
// none.
__device__ __forceinline__ void load_top(const ScanArgs& a, int16_t* sF,
                                         int p, int cy, int cx, int WF) {
  const int C = a.C, W = a.ctb_w * C;
  const int32_t* row =
      a.out + ((long long)p * a.ctb_h * C + (long long)cy * C - 1) * W;
  for (int c = threadIdx.x; c < WF; c += kWarp) {
    const int x = cx * C + c - 1;
    sF[c] = (int16_t)(cy > 0 && x >= 0 && x < W ? __ldcg(row + x) : 0);
  }
}

// Rows r0 .. r1 - 1 of the CTB in F to `out` at dst (row stride W), four
// int32 samples a store.
__device__ __forceinline__ void store_rows(int32_t* dst, const int16_t* sF,
                                           int WF, int C, int log2C, int W,
                                           int r0, int r1) {
  const int q4 = C >> 2;
  for (int i = threadIdx.x; i < (r1 - r0) * q4; i += kWarp) {
    const int y = r0 + (i >> (log2C - 2)), x = (i & (q4 - 1)) << 2;
    const int16_t* s = sF + (1 + y) * WF + 1 + x;
    *reinterpret_cast<int4*>(dst + (long long)y * W + x) =
        make_int4(s[0], s[1], s[2], s[3]);
  }
}

// What walk_ctb does before the chain of a CTB that holds a TU: wait for
// the lane above (none in a plane's first CTB row), then row 0 of F.
struct TopRow {
  const ScanArgs* a;
  int16_t* sF;
  const int* above;
  int p, cy, cx, WF;

  __device__ void operator()(int count) const {
    if (count == 0) return;
    if (above != nullptr) wait_progress(above, min(cx + a->skew, a->ctb_w));
    load_top(*a, sF, p, cy, cx, WF);
    __syncwarp();
  }
};

// walk_ctb as a function of its own, and walk_tu<LOG2> too
// (HEVC_WALK_TU_INLINE). Inlined into this kernel's loop over CTBs, the
// walk compiled by nvcc 12.9 for sm_90a stopped on 16x16 planar and DC TUs
// with a misaligned shared address; with walk_ctb alone behind a call, its
// 16x16 luma DC took wrong top samples into the edge filter (-Xptxas -O0
// did the same, -G did not). The same source inlined into the one-step
// walk kernel (hevc_walk.cu) is right, and so is this kernel with both
// calls, on every geometry its tests hold against the plain scan. The
// calls cost a jump a CTB and one a TU.
__device__ __noinline__ int walk_one(int16_t* sF, const int16_t* sR,
                                     const int32_t* sZ, const int32_t* sTU,
                                     const int32_t* sM, uint4* list,
                                     uint16_t* sP, int* sA, int* sB, int* sE,
                                     int HF, int WF, int WZ, int C,
                                     int log2T, bool luma, bool strong,
                                     TopRow top) {
  return walk_ctb(sF, sR, sZ, sTU, sM, list, sP, sA, sB, sE, HF, WF, WZ, C,
                  log2T, luma, strong, top);
}

__global__ void __launch_bounds__(kWarp) hevc_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int C = a.C, C4 = C >> 2;
  const int HF = 1 + C + a.T, WF = 1 + a.skew * C;
  const int HZ = 1 + C4 + (a.T >> 2), WZ = 1 + a.skew * C4;
  const int W = a.ctb_w * C, H = a.ctb_h * C;
  const Layout L = layout(C, a.T, a.log2T, a.skew, a.base != nullptr);
  int16_t* sF = reinterpret_cast<int16_t*>(smem + L.f);
  int32_t* sZ = reinterpret_cast<int32_t*>(smem + L.z);
  uint4* list = reinterpret_cast<uint4*>(smem + L.list);
  uint16_t* sP = reinterpret_cast<uint16_t*>(smem + L.pos);
  int* sA = reinterpret_cast<int*>(smem + L.refs) + 1;
  int* sB = sA + kRefSlots;
  int* sE = sB + kRefSlots - 1;

  // F is 0 but where a CTB writes it: row 0, column 0, the interior
  for (int i = t; i < HF * WF; i += kWarp) sF[i] = 0;
  __syncwarp();

  const int total = a.P * a.ctb_h;
  for (int id = next_lane(a.ticket); id < total; id = next_lane(a.ticket)) {
    const int p = id / a.ctb_h, cy = id - p * a.ctb_h, g = p % a.G;
    int* flag = a.flags + id;
    const int* above = cy > 0 ? flag - 1 : nullptr;
    int32_t* lane_out = a.out + ((long long)p * H + (long long)cy * C) * W;
    prefetch(a, L, smem + L.stage0, p, g, cy, 0);
    commit();
    for (int cx = 0; cx < a.ctb_w; ++cx) {
      unsigned char* st = smem + L.stage0 + (cx & 1) * L.stage;
      __syncwarp();               // the other buffer's CTB is done with
      if (cx + 1 < a.ctb_w)
        prefetch(a, L, smem + L.stage0 + ((cx + 1) & 1) * L.stage, p, g, cy,
                 cx + 1);
      commit();
      wait_groups(1);
      __syncwarp();
      build_z(a, L, st, sZ, cy, cx, HZ, WZ);
      for (int y = t; y < C; y += kWarp)
        sF[(1 + y) * WF] = cx > 0 ? sF[(1 + y) * WF + C] : 0;
      __syncwarp();
      const int16_t* sBase = a.base != nullptr
          ? reinterpret_cast<const int16_t*>(st + L.base) : nullptr;
      for (int i = t; i < C * C; i += kWarp)
        sF[(1 + (i >> a.log2C)) * WF + 1 + (i & (C - 1))] =
            sBase != nullptr ? sBase[i] : 0;
      __syncwarp();
      walk_one(sF, reinterpret_cast<const int16_t*>(st + L.res), sZ,
               reinterpret_cast<const int32_t*>(st + L.tu),
               reinterpret_cast<const int32_t*>(st + L.mode), list, sP, sA,
               sB, sE, HF, WF, WZ, C, a.log2T, a.luma, a.strong,
               TopRow{&a, sF, above, p, cy, cx, WF});
      __syncwarp();
      int32_t* dst = lane_out + (long long)cx * C;
      store_rows(dst, sF, WF, C, a.log2C, W, C - 1, C);
      publish(flag, cx + 1);
      store_rows(dst, sF, WF, C, a.log2C, W, 0, C - 1);
    }
  }
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
      (1 + C + *T) * (1 + skew * C) + 1 > 65535)
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
           &per_sm, hevc_scan_kernel, kWarp, L.total)) != cudaSuccess)
    return e;
  *n = sms * per_sm;
  return *n > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The CTAs a launch of this geometry keeps on the card at once (*n) and
// the shared memory of each (*smem). Returns a cudaError_t, or 0.
extern "C" int hevc_scan_resident(int C, int max_tu, int skew, int has_base,
                                  int* n, int* smem) {
  int T, log2C, log2T;
  const int bad = check_geometry(C, max_tu, skew, &T, &log2C, &log2T);
  if (bad) return bad;
  const Layout L = layout(C, T, log2T, skew, has_base != 0);
  *smem = L.total;
  return (int)resident(L, n);
}

// Scan the planes (layout above) in one launch of min(P * ctb_h, the CTAs
// that fit the card at once) CTAs of one warp on `stream`; does not
// synchronise. flags [P * ctb_h] and *ticket are scratch, all 0. base may
// be null. Returns the launch's cudaError_t, or 0.
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
  const Layout L = layout(C, T, log2T, skew, base != nullptr);
  int cap = 0;
  const cudaError_t e = resident(L, &cap);
  if (e != cudaSuccess) return (int)e;
  const int lanes = P * ctb_h;
  ScanArgs a{(const int16_t*)resid, (const int16_t*)base,
             (const int32_t*)zidx, (const int32_t*)tu,
             (const int32_t*)mode, (int32_t*)out, (int*)flags, (int*)ticket,
             P, G, ctb_h, ctb_w, C, log2C, T, log2T, skew, !is_chroma,
             strong != 0, zidx_none};
  const int grid = lanes < cap ? lanes : cap;
  hevc_scan_kernel<<<grid, kWarp, L.total, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
