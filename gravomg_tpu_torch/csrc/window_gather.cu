// Windowed ELL SpMV (the gather probe) for Hopper (sm_90a), bound
// through a plain C interface and ctypes
// (gravomg_tpu_torch/ops/window_gather.py).
//
// Replaces the TPU probe kernels P1 (`kernel` in `make_variant`,
// scripts/profile_pltake.py) and P2 (`kernel` of `pl_take`,
// scripts/profile_gather2.py), which compute the same function: for row
// block b of `rows` rows, K = 32 entries a row, and a window of `wd`
// values of x starting at starts[b],
//
//   y[b*rows + i] = sum_k w[b, i, k] * x[starts[b] + lidx[b, i, k]]
//
// in f32.  Starts are clamped to [0, n_x - wd] (as lax.dynamic_slice
// clamps a window that runs off the end) and local indices to
// [0, wd - 1], so no input reads out of bounds; the plain twin clamps
// alike.
//
// What bounds it: bytes.  Each entry costs 8 bytes of lidx and w that
// are read once (256 MB at V = 1M), against one multiply-add; the window
// (32 KB at wd = 8192) is read many times.  What the design does about
// it: keep the reused bytes on chip, stream the rest in 16-byte loads,
// and put enough blocks on the card at the probes' small size too.
//
//  * Each row block is split over 4 thread blocks of rows/4 rows, so
//    V = 200,000 gives 780 thread blocks and not 195 on 132 SMs.  Each
//    of the 4 copies the window itself: the first reads it from device
//    memory, the other three find it in L2, so device-memory traffic
//    stays what it was and L2 serves 32 KB more per 64 KB of lidx and
//    w.  A cluster of 4 with one multicast copy would save those L2
//    reads, but it ties four blocks to neighbouring SMs and to one
//    start, for bytes that never reach device memory; independent
//    blocks fill the card in any order.
//  * The window copy is one 1-D bulk asynchronous copy (cp.async.bulk)
//    into shared memory, completing on an mbarrier.  Every thread starts
//    its first loads of lidx and w before it waits for the window, so
//    the two overlap.  A window whose start or width is not a multiple
//    of 4 floats (the bulk copy needs 16-byte alignment) is copied with
//    plain loads.
//  * lidx and w arrive as 16-byte loads: a lane holds 4 consecutive
//    entries of one row, 8 lanes a row, a warp 4 rows (512 contiguous
//    bytes) per load, 4 such loads of each array in flight per thread.
//    The gather reads shared memory; 3 shuffle steps sum a row.
//
// Requirements (checked by the Python wrapper): lidx and w are
// contiguous (NB, rows, 32), 16-byte aligned; rows is a multiple of 32;
// wd * 4 bytes is at most 48 KB; n_x >= wd.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kEntries = 32;
constexpr int kSplit = 4;                   // thread blocks a row block
constexpr int kRowsPerLoad = 4;             // rows a warp covers per load
constexpr int kMaxWindow = 12288;           // floats
constexpr long long kSpinLimit = 4000000000LL;   // clock cycles, ~2 s

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t ok;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    return ok != 0;
}

__global__ void __launch_bounds__(32 * kWarps)
window_gather_kernel(const float* __restrict__ x, int64_t n_x,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lidx,
                     const float* __restrict__ w, float* __restrict__ y,
                     int rows, int wd) {
    extern __shared__ __align__(128) float win[];
    __shared__ __align__(8) uint64_t bar;
    const int64_t b = blockIdx.x / kSplit;
    const int part = blockIdx.x % kSplit;
    const int rpc = rows / kSplit;              // rows of this thread block
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    int64_t s = __ldg(starts + b);
    s = s < 0 ? 0 : (s > n_x - wd ? n_x - wd : s);
    // The same for every thread of the block.
    const bool bulk = ((s | wd) & 3) == 0
                      && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (bulk) {
        if (threadIdx.x == 0) {
            const uint32_t bar_a = smem_addr(&bar);
            const uint32_t bytes = static_cast<uint32_t>(wd) * 4u;
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(bar_a) : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;\n"
                         ::: "memory");
            asm volatile(
                "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                :: "r"(bar_a), "r"(bytes) : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::"
                "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                :: "r"(smem_addr(win)), "l"(x + s), "r"(bytes), "r"(bar_a)
                : "memory");
        }
    } else {
        for (int i = threadIdx.x; i < wd; i += blockDim.x)
            win[i] = __ldg(x + s + i);
    }

    // A lane's 4 entries of row r of this thread block start at `base`
    // + r * 32.
    const int sub = lane >> 3;                   // row within the warp's 4
    const int64_t row0 = b * rows + static_cast<int64_t>(part) * rpc;
    const int64_t base = row0 * kEntries + 4 * (lane & 7);
    constexpr int kStep = kWarps * kRowsPerLoad;        // rows per load
    int4 li[kUnroll];
    float4 wv[kUnroll];
    auto load = [&](int r0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int r = r0 + u * kStep;
            li[u] = make_int4(0, 0, 0, 0);
            wv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (r < rpc) {
                li[u] = __ldg(reinterpret_cast<const int4*>(
                    lidx + base + static_cast<int64_t>(r) * kEntries));
                wv[u] = __ldg(reinterpret_cast<const float4*>(
                    w + base + static_cast<int64_t>(r) * kEntries));
            }
        }
    };

    // The first loads of lidx and w are under way before anyone waits
    // for the window.
    int r0 = warp * kRowsPerLoad + sub;
    load(r0);
    __syncthreads();        // the barrier is initialised / win is written
    if (bulk) {
        const uint32_t bar_a = smem_addr(&bar);
        if (!mbar_try_wait(bar_a, 0)) {
            const long long t0 = clock64();
            while (!mbar_try_wait(bar_a, 0))
                if (clock64() - t0 > kSpinLimit) __trap();
        }
    }
    // r0 - sub is the same for the lanes of a warp, so whole warps leave
    // the loop together and every shuffle has its 32 lanes.
    while (r0 - sub < rpc) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int r = r0 + u * kStep;
            float v = wv[u].x * win[min(max(li[u].x, 0), wd - 1)];
            v = fmaf(wv[u].y, win[min(max(li[u].y, 0), wd - 1)], v);
            v = fmaf(wv[u].z, win[min(max(li[u].z, 0), wd - 1)], v);
            v = fmaf(wv[u].w, win[min(max(li[u].w, 0), wd - 1)], v);
#pragma unroll
            for (int o = 4; o > 0; o >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, o);
            if ((lane & 7) == 0 && r < rpc) y[row0 + r] = v;
        }
        r0 += kStep * kUnroll;
        if (r0 - sub < rpc) load(r0);
    }
}

}  // namespace

extern "C" {

// y (nb*rows,) f32 <- windows of x (n_x,) f32 at starts (nb,) int32,
// lidx (nb, rows, 32) int32, w (nb, rows, 32) f32.
// Returns cudaGetLastError() after the launch (0 on success).
int gmg_window_gather(const float* x, int64_t n_x, const int32_t* starts,
                      const int32_t* lidx, const float* w, float* y,
                      int64_t nb, int rows, int wd, void* stream) {
    if (nb <= 0 || nb * kSplit > INT32_MAX || rows <= 0
            || rows % (kSplit * 8) || wd <= 0 || wd > kMaxWindow
            || n_x < wd)
        return static_cast<int>(cudaErrorInvalidValue);
    // 48 KB of window plus the barrier exceed the default limit.
    static const cudaError_t attr = cudaFuncSetAttribute(
        window_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxWindow * 4);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    window_gather_kernel<<<static_cast<unsigned>(nb * kSplit), 32 * kWarps,
                           static_cast<size_t>(wd) * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
        x, n_x, starts, lidx, w, y, rows, wd);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
