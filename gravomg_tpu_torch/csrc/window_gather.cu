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
// (32 KB at wd = 8192) is read many times.  The design keeps the reused
// bytes on chip and streams the rest coalesced: one thread block per row
// block, which copies its window into shared memory; one warp per row,
// lane k on entry k, so each row's lidx and w load as two coalesced
// 128-byte lines; 4 rows in flight per warp; the gather reads shared
// memory; a shuffle reduction sums the 32 products.
//
// Requirements (checked by the Python wrapper): lidx and w are
// contiguous (NB, rows, 32); rows is a multiple of 32; wd * 4 bytes fits
// the default 48 KB of shared memory; n_x >= wd.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr int kEntries = 32;

__global__ void __launch_bounds__(32 * kWarps)
window_gather_kernel(const float* __restrict__ x, int64_t n_x,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lidx,
                     const float* __restrict__ w, float* __restrict__ y,
                     int rows, int wd) {
    extern __shared__ float win[];
    const int64_t b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    int64_t s = __ldg(starts + b);
    s = s < 0 ? 0 : (s > n_x - wd ? n_x - wd : s);
    for (int i = threadIdx.x; i < wd; i += blockDim.x)
        win[i] = __ldg(x + s + i);
    __syncthreads();

    // rows is a multiple of kWarps * kUnroll (32).
    for (int r0 = warp; r0 < rows; r0 += kWarps * kUnroll) {
        int li[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int64_t off =
                (b * rows + r0 + u * kWarps) * kEntries + lane;
            li[u] = __ldg(lidx + off);
            wv[u] = __ldg(w + off);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            float v = wv[u] * win[min(max(li[u], 0), wd - 1)];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, o);
            if (lane == 0) y[b * rows + r0 + u * kWarps] = v;
        }
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
    if (nb <= 0 || nb > INT32_MAX || rows <= 0
            || rows % (kWarps * kUnroll) || wd <= 0 || wd > 12288
            || n_x < wd)
        return static_cast<int>(cudaErrorInvalidValue);
    window_gather_kernel<<<static_cast<unsigned>(nb), 32 * kWarps,
                           static_cast<size_t>(wd) * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
        x, n_x, starts, lidx, w, y, rows, wd);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
