// HEVC intra TU-tree walk of one CTB-diagonal wavefront step, for Hopper
// (sm_90a). Built by jmcodec_tpu_torch/kernels/_build.py with nvcc into a
// shared library with a plain C interface; bound with ctypes by
// jmcodec_tpu_torch/kernels/hevc_walk.py (walk), whose plain torch version
// (walk_reference) it must equal bit for bit.
//
// Replaces the TPU kernel make_pallas_walk
// (jmcodec_tpu/kernels/hevc_walk_pallas.py: _walk_call -> pl.pallas_call,
// kernel body _make_kernel / _candidate_body). It computes what
// hevc_tiles._make_walk computes, in the same layout (see hevc_walk.py):
// for every lane (one CTB of one frame or chroma plane) and every z-order
// TU candidate (n, x0, y0) where the TU map marks a TU of size n: gather
// the 4n+1 reference samples from the composite F, z-index availability
// (6.4.1), substitution (8.4.4.2.2), [1 2 1] or strong filter (8.4.4.2.3),
// planar / DC with edge filter / 33 angular modes with invAngle
// projection / H and V edge filters, add the residual, clip to 0..255 and
// write into F, where later candidates read it.
//
// What bounds it on this card: the latency of one lane's serial chain, not
// bytes or operations. A TU reads what the TUs before it wrote, so a lane's
// time is (its active TUs) x (the time of one TU), and a launch takes as
// long as its longest lane; an all-4x4 64x64 CTB has 256 TUs. One TU is
// ~120 instructions for 4x4, which a single warp runs at ~5 cycles each
// (400-600 cycles for 4x4, ~1000 for 8x8, ~1900 for 16x16, ~4800 for
// 32x32 on an H100 at 1980 MHz), against ~8 us of fixed cost for staging,
// the TU list and the store. The bytes (~64 KB per luma lane) would take a
// tenth of the time.
//
// What the design does about it: the chain touches nothing but shared
// memory and registers, visits nothing that is not a TU, crosses no barrier
// wider than a warp, and carries only work that depends on F.
//  - One warp walks one lane (one CTA of 32 threads per lane; lanes are
//    independent, so any B works). Most TUs are 4x4 or 8x8: 17 or 33
//    references and 16 or 64 pixels are one warp's work, and phases are
//    separated by __syncwarp() only. A 32x32 TU costs the warp 32 rounds of
//    prediction, ~8 times a 4x4 TU, but a CTB holds at most four of them
//    against 256 4x4 TUs: the long chains are the ones made of small TUs,
//    so a wider team for large TUs would shorten no launch.
//  - F, Z, the residual and the TU and mode maps of the lane are copied to
//    shared memory once, with 16-byte cp.async (the shared copy keeps the
//    source's misalignment, since a lane of F is 2-byte aligned); the maps
//    and Z land first and everything below is built while F and the
//    residual are still in flight. The only other device-memory access is
//    the final 16-byte store of F.
//  - The active TUs are found in parallel: thread t tests z-order cell t,
//    t+32, ... (a cell with map value v is a TU exactly when its z-index is
//    a multiple of the TU's cell count), and a ballot + popcount compacts
//    them, in order, into a list of 16-byte entries that hold all of a TU's
//    constants: mode, angle, invAngle, filter flag, pixel offsets.
//  - Reference substitution is split. Which sample each reference takes its
//    value from depends on Z alone, so it is resolved before the chain:
//    thread t walks the reference cells of TUs t, t+32, ... once and writes
//    a table of positions in F. On the chain a substituted reference is
//    two loads (position, then sample).
//  - Inside a TU, loads are started first and what does not depend on them
//    (pixel coordinates, residuals, the two tap indices of an angular
//    pixel, without a branch) is computed in their shadow. The angular main
//    reference is never materialised for n <= 8; for n >= 16 and a negative
//    angle its projected part is written out once. The DC sum is one warp
//    reduction over registers. A TU takes 2 to 4 __syncwarp() phases.
//  - The TU size is a template parameter, so every loop over references and
//    pixels is unrolled and every shift is a constant.
// The per-mode angle, invAngle and filter-threshold tables sit in constant
// memory and are read only while the list is built; no table depends on the
// CTB geometry.
//
// Dropped from the TPU kernel, which needed them for the TPU's layout
// rules: the lane-last transposes, the 8-aligned residue selects
// (_xload/_xstore), the MXU one-hot table selects (_tsel0), the
// masked-sum gathers (_gather0/_win0) and reversals (_rev0/_rep4_0).

#include "hevc_walk.cuh"

namespace {

// Shared memory of one lane: the five staged arrays (each with 16 bytes of
// slack for its source's misalignment), the reference-position table, the
// TU list (16 bytes per 4x4 cell) and the reference vectors.
__host__ __device__ __forceinline__ int smem_bytes(int HF, int WF, int HZ,
                                                   int WZ, int C, int log2T) {
  const int cells = (C >> 2) * (C >> 2);
  return pad16(HF * WF * 2) + pad16(HZ * WZ * 4) + pad16(C * C * 2) +
         2 * pad16(cells * 4) + 5 * 16 +
         cells * 16 + pad16(pos_row(log2T + 1, 0, cells) * 2) +
         pad16((2 * kRefSlots + kExtSlots) * 4);
}

__global__ void __launch_bounds__(kWarp)
hevc_walk_kernel(const int16_t* __restrict__ F_in, int16_t* __restrict__ F_out,
                 const int32_t* __restrict__ Zg, const int16_t* __restrict__ Rg,
                 const int32_t* __restrict__ TUg, const int32_t* __restrict__ Mg,
                 int HF, int WF, int HZ, int WZ, int C, int T, int is_chroma,
                 int strong) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int t = threadIdx.x;
  const size_t lane = blockIdx.x;
  const int C4 = C >> 2, cells = C4 * C4;
  const int fbytes = HF * WF * 2, zbytes = HZ * WZ * 4, rbytes = C * C * 2,
            mbytes = cells * 4;
  const int log2T = 31 - __clz(T);
  const bool luma = !is_chroma;

  unsigned char* p = smem;
  unsigned char* bTU = p;  p += pad16(mbytes) + 16;
  unsigned char* bM = p;   p += pad16(mbytes) + 16;
  unsigned char* bZ = p;   p += pad16(zbytes) + 16;
  unsigned char* bF = p;   p += pad16(fbytes) + 16;
  unsigned char* bR = p;   p += pad16(rbytes) + 16;
  uint4* list = (uint4*)p; p += cells * 16;
  uint16_t* sP = (uint16_t*)p;
  p += pad16(pos_row(log2T + 1, 0, cells) * 2);
  int* sA = (int*)p + 1;
  int* sB = sA + kRefSlots;
  int* sE = sB + kRefSlots - 1;

  // stage: the maps and Z first, then F and the residual
  const int32_t* sTU = (const int32_t*)stage(bTU, TUg + lane * cells, mbytes, t);
  const int32_t* sM = (const int32_t*)stage(bM, Mg + lane * cells, mbytes, t);
  const int32_t* sZ = (const int32_t*)stage(bZ, Zg + lane * HZ * WZ, zbytes, t);
  __pipeline_commit();
  int16_t* sF = (int16_t*)stage(bF, F_in + lane * HF * WF, fbytes, t);
  const int16_t* sR = (const int16_t*)stage(bR, Rg + lane * C * C, rbytes, t);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncwarp();

  // the TU list and the positions while F and the residual are in flight
  walk_ctb(sF, sR, sZ, sTU, sM, list, sP, sA, sB, sE, HF, WF, WZ, C, log2T,
           luma, strong, [](int) {
             __pipeline_wait_prior(0);
             __syncwarp();
           });

  unstage(F_out + lane * HF * WF, (const unsigned char*)sF, fbytes, t);
}

}  // namespace

// Launch one walk over B lanes on `stream`. F/out [B, HF, WF] int16,
// Z [B, HZ, WZ] int32, resid [B, C, C] int16, tu/mode [B, C/4, C/4]
// int32, all contiguous on the current device. Returns cudaGetLastError().
extern "C" int hevc_walk_launch(const void* F, void* out, const void* Z,
                                const void* resid, const void* tu,
                                const void* mode, int B, int HF, int WF,
                                int HZ, int WZ, int C, int max_tu,
                                int is_chroma, int strong, void* stream) {
  const int T = C < max_tu ? C : max_tu;
  if (B <= 0 || T < 4 || T > kMaxTu || C % T != 0 || C / T > 2)
    return (int)cudaErrorInvalidValue;
  int log2T = 2;
  while ((4 << (log2T - 1)) <= T) ++log2T;
  const int smem = smem_bytes(HF, WF, HZ, WZ, C, log2T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hevc_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  hevc_walk_kernel<<<B, kWarp, smem, (cudaStream_t)stream>>>(
      (const int16_t*)F, (int16_t*)out, (const int32_t*)Z,
      (const int16_t*)resid, (const int32_t*)tu, (const int32_t*)mode, HF, WF,
      HZ, WZ, C, T, is_chroma, strong);
  return (int)cudaGetLastError();
}
