// Lane chains for the persistent H.264 scan kernels (h264_intra.cu,
// h264_deblock.cu): one warp (a CTA of 32 threads) walks one (frame, lane)
// of skewed macroblock tiles at a time, its tiles in diagonal order, and
// waits only on the lane above it through a progress flag.
//
// A lane's flag holds p: every tile of the lane on a diagonal below p is
// finished as far as the lane below reads it (its last rows), and those
// stores are visible at GPU scope (a release store after them, read with
// an acquire load); the rest of a tile may follow the flag. Lanes are
// handed out by an atomic ticket in (frame, lane) order, lane innermost,
// so the lane above a lane was taken earlier by a CTA that is already
// running: the wait ends even when the lanes outnumber the CTAs that fit
// the card at once.
//
// Tiles of another lane are read only after the acquire and only through
// L2 (ld.global.cg, cp.async.cg), never through L1 or the read-only cache,
// which are not coherent with other SMs' stores during the launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lane_chain {

constexpr unsigned FULL = 0xffffffffu;

// 16 bytes from device to shared memory through L2 only
__device__ __forceinline__ void cp16(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

// 4 bytes of an input that nothing writes during the launch
__device__ __forceinline__ void cp4(void *smem, const void *gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
__device__ __forceinline__ void wait_groups(int n) {
    if (n == 0)
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int *p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(int *p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Thread 0 polls the lane above's flag until it reaches `target`; then the
// whole warp goes on and sees what that lane stored before publishing. A
// wait of more than two seconds can only be a fault (a whole scan takes
// milliseconds): the kernel traps, and the launch reports an error, rather
// than hang the card.
__device__ __forceinline__ void wait_progress(const int *flag, int target) {
    if ((threadIdx.x & 31) == 0 && ld_acquire(flag) < target) {
        const unsigned long long t0 = now_ns();
        unsigned ns = 8;
        while (ld_acquire(flag) < target) {
            __nanosleep(ns);
            ns = ns < 64 ? 2 * ns : ns;
            if (now_ns() - t0 > 2000000000ull) __trap();
        }
    }
    __syncwarp();
}

// After the warp's stores of a tile: the warp's barrier orders every
// thread's stores before thread 0's, whose release store of the flag then
// makes them visible at GPU scope before the flag (the pattern of a
// semaphore released by one thread after a barrier).
__device__ __forceinline__ void publish(int *flag, int progress) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) st_release(flag, progress);
}

// the next (frame, lane) for this warp: its ticket
__device__ __forceinline__ int next_lane(int *ticket) {
    int v = 0;
    if ((threadIdx.x & 31) == 0) v = atomicAdd(ticket, 1);
    return __shfl_sync(FULL, v, 0);
}

// The diagonals of one lane that hold work, read 32 at a time: bit i of
// bits is diagonal base + i. next() returns the first diagonal >= from in
// [d0, d1) for which work(d) holds, or -1; the warp calls it together.
struct Diagonals {
    int d0, d1, base, bits;

    __device__ Diagonals(int lo, int hi) : d0(lo), d1(hi), base(-1 << 30),
                                           bits(0) {}

    template <class Work>
    __device__ int next(int from, Work work) {
        while (from < d1) {
            const int b = from - ((from - d0) & 31);
            if (b != base) {
                const int d = b + (threadIdx.x & 31);
                bits = __ballot_sync(FULL, d < d1 && work(d));
                base = b;
            }
            const unsigned m = static_cast<unsigned>(bits) >> (from - b);
            if (m) return from + __ffs(m) - 1;
            from = b + 32;
        }
        return -1;
    }
};

// The CTAs of `threads` threads of `kernel` that fit the current device at
// once, cached per device (cache[64]); 0 on error, with the error in *err.
template <class Kernel>
int resident_ctas(Kernel kernel, int threads, int *cache, cudaError_t *err) {
    int dev = 0;
    if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
    if (dev < 0 || dev >= 64) {
        *err = cudaErrorInvalidDevice;
        return 0;
    }
    if (cache[dev] == 0) {
        int sms = 0, per_sm = 0;
        if ((*err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return 0;
        if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kernel, threads, 0)) != cudaSuccess)
            return 0;
        cache[dev] = sms * per_sm;
    }
    if (cache[dev] == 0) *err = cudaErrorInvalidConfiguration;
    return cache[dev];
}

// Per-phase timing (tools/time_h264_scans.py builds the kernels with
// -DJMX_SCAN_TIMING; without it the macros below compile to nothing):
// thread 0 of a warp adds the SM clock cycles since its previous stamp to
// slot i of its CTA's sums, slot 15 counts the macroblocks, and each CTA
// adds its sums into g_cycles when it ends.
#ifdef JMX_SCAN_TIMING
static __shared__ unsigned long long s_cycles[16];
static __shared__ long long s_last;
static __device__ unsigned long long g_cycles[16];
#define SCAN_TIMING_BEGIN()                                                 \
    do {                                                                    \
        if (threadIdx.x == 0) {                                             \
            for (int i_ = 0; i_ < 16; ++i_) s_cycles[i_] = 0;               \
            s_last = clock64();                                             \
        }                                                                   \
    } while (0)
#define SCAN_STAMP(i)                                                       \
    do {                                                                    \
        if (threadIdx.x == 0) {                                             \
            const long long n_ = clock64();                                 \
            s_cycles[i] += n_ - s_last;                                     \
            s_last = n_;                                                    \
        }                                                                   \
    } while (0)
#define SCAN_COUNT() do { if (threadIdx.x == 0) ++s_cycles[15]; } while (0)
#define SCAN_TIMING_END()                                                   \
    do {                                                                    \
        if (threadIdx.x == 0)                                               \
            for (int i_ = 0; i_ < 16; ++i_)                                 \
                atomicAdd(&g_cycles[i_], s_cycles[i_]);                     \
    } while (0)
// g_cycles to the host (16 values), then zeroed
#define SCAN_TIMING_READER(name)                                            \
    extern "C" int name(unsigned long long *host) {                         \
        cudaError_t e = cudaMemcpyFromSymbol(                               \
            host, lane_chain::g_cycles, sizeof(lane_chain::g_cycles));      \
        if (e) return e;                                                    \
        const unsigned long long zero[16] = {0};                            \
        return cudaMemcpyToSymbol(lane_chain::g_cycles, zero, sizeof(zero));\
    }
#else
#define SCAN_TIMING_BEGIN() do {} while (0)
#define SCAN_STAMP(i) do {} while (0)
#define SCAN_COUNT() do {} while (0)
#define SCAN_TIMING_END() do {} while (0)
#define SCAN_TIMING_READER(name)
#endif

}  // namespace lane_chain
