// H.264 4x4 residual blocks: dequantisation, optional DC splice, inverse
// core transform (spec 8.5.12), for N blocks in one pass.
//
// Replaces the Pallas kernel jmcodec_tpu/kernels/pallas_idct.py
// (dequant_idct_blocks, body _kernel). Per block:
//     d[p]   = (c[p] * DEQUANT4x4[qp % 6][p]) << (qp / 6)
//     d[0]   = dc            where the block's dc_mask is set (Intra16x16
//                            luma DC, every chroma DC: values that come from
//                            a Hadamard stage outside this kernel)
//     r      = butterfly rows, butterfly columns (truncating >> 1),
//              (x + 32) >> 6
//
// Bound on this card: bytes. A block moves 32 B of int16 levels (64 B as
// int32) in, 4 B of qp, at most 5 B of dc and mask, and 64 B of int32
// residual out, against about 80 integer operations. The design is what
// that asks for and no more: one thread per block in the natural
// block-major layout, the block read and written as 128-bit vectors, the
// [6][16] scale table in constant memory indexed directly, a tail guard
// instead of padding. The TPU kernel's position-major transpose, 6-way
// select and padding to 512 blocks served its vector unit and are not
// carried over.
//
// Arithmetic wraps modulo 2^32 like the int32 tensor version beside the
// wrapper (kernels/idct.py): sums go through unsigned, the left shift is a
// multiply by 1 << s, so no signed overflow and no shift of a negative
// value is left to the compiler.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int c_dq[6][16] = {
    {10, 13, 10, 13, 13, 16, 13, 16, 10, 13, 10, 13, 13, 16, 13, 16},
    {11, 14, 11, 14, 14, 18, 14, 18, 11, 14, 11, 14, 14, 18, 14, 18},
    {13, 16, 13, 16, 16, 20, 16, 20, 13, 16, 13, 16, 16, 20, 16, 20},
    {14, 18, 14, 18, 18, 23, 18, 23, 14, 18, 14, 18, 18, 23, 18, 23},
    {16, 20, 16, 20, 20, 25, 20, 25, 16, 20, 16, 20, 20, 25, 20, 25},
    {18, 23, 18, 23, 23, 29, 23, 29, 18, 23, 18, 23, 23, 29, 23, 29}};

__device__ __forceinline__ int add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int sub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ void load_block(const int16_t *src, long long n,
                                           int (&c)[16]) {
    const uint4 *p = reinterpret_cast<const uint4 *>(src + n * 16);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        uint4 w = p[v];
        unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            c[v * 8 + 2 * k] = (int)(int16_t)(u[k] & 0xffffu);
            c[v * 8 + 2 * k + 1] = (int)(int16_t)(u[k] >> 16);
        }
    }
}

__device__ __forceinline__ void load_block(const int32_t *src, long long n,
                                           int (&c)[16]) {
    const int4 *p = reinterpret_cast<const int4 *>(src + n * 16);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
        int4 w = p[v];
        c[v * 4] = w.x;
        c[v * 4 + 1] = w.y;
        c[v * 4 + 2] = w.z;
        c[v * 4 + 3] = w.w;
    }
}

// one 4-point inverse butterfly of 8.5.12.2
__device__ __forceinline__ void butterfly(int d0, int d1, int d2, int d3,
                                          int &o0, int &o1, int &o2,
                                          int &o3) {
    int e0 = add(d0, d2);
    int e1 = sub(d0, d2);
    int e2 = sub(d1 >> 1, d3);
    int e3 = add(d1, d3 >> 1);
    o0 = add(e0, e3);
    o1 = add(e1, e2);
    o2 = sub(e1, e2);
    o3 = sub(e0, e3);
}

template <typename T>
__global__ void dequant_idct_kernel(const T *__restrict__ coeffs,
                                    const int *__restrict__ qp_blk,
                                    const int *__restrict__ dc,
                                    const uint8_t *__restrict__ dc_mask,
                                    int *__restrict__ out, long long N) {
    long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    int c[16];
    load_block(coeffs, n, c);
    int qp = qp_blk[n];
    int m = qp % 6;
    unsigned mul = 1u << (qp / 6);
    int d[16];
#pragma unroll
    for (int p = 0; p < 16; ++p)
        d[p] = (int)((unsigned)c[p] * (unsigned)c_dq[m][p] * mul);
    if (dc != nullptr && (dc_mask == nullptr || dc_mask[n] != 0)) d[0] = dc[n];

    int f[16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
        butterfly(d[4 * r], d[4 * r + 1], d[4 * r + 2], d[4 * r + 3],
                  f[4 * r], f[4 * r + 1], f[4 * r + 2], f[4 * r + 3]);
    int h[16];
#pragma unroll
    for (int x = 0; x < 4; ++x)
        butterfly(f[x], f[x + 4], f[x + 8], f[x + 12],
                  h[x], h[x + 4], h[x + 8], h[x + 12]);

    int4 *o = reinterpret_cast<int4 *>(out + n * 16);
#pragma unroll
    for (int v = 0; v < 4; ++v)
        o[v] = make_int4(add(h[4 * v], 32) >> 6, add(h[4 * v + 1], 32) >> 6,
                         add(h[4 * v + 2], 32) >> 6,
                         add(h[4 * v + 3], 32) >> 6);
}

}  // namespace

// coeffs: N blocks of 16 levels, int16 (coeff_i16 != 0) or int32, 16-byte
// aligned; qp_blk [N] int32 in 0..51; dc [N] int32 or null; dc_mask [N]
// bytes or null (with dc: every block); out [N * 16] int32, 16-byte aligned.
// Launches on `stream`, does not synchronise. Returns the launch's
// cudaError_t (0 = success).
extern "C" int dequant_idct_launch(const void *coeffs, int coeff_i16,
                                   const int *qp_blk, const int *dc,
                                   const uint8_t *dc_mask, int *out,
                                   long long N, void *stream) {
    if (N <= 0) return 0;
    const int threads = 128;
    unsigned blocks = (unsigned)((N + threads - 1) / threads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (coeff_i16)
        dequant_idct_kernel<int16_t><<<blocks, threads, 0, s>>>(
            static_cast<const int16_t *>(coeffs), qp_blk, dc, dc_mask, out, N);
    else
        dequant_idct_kernel<int32_t><<<blocks, threads, 0, s>>>(
            static_cast<const int32_t *>(coeffs), qp_blk, dc, dc_mask, out, N);
    return (int)cudaGetLastError();
}
