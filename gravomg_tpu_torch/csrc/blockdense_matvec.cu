// Block-window dense SpMV for Hopper (sm_90a), bound through a plain C
// interface and ctypes (gravomg_tpu_torch/ops/blockdense_cuda.py).
//
// Replaces the TPU kernel `_matvec_kernel` of
// gravomg_tpu/ops/pallas_blockdense.py (launched by
// `blockdense_matvec_pallas`).  For row block b and row r of an
// operator with NW windows of 128 columns each:
//
//   y[b*BLK + r] = sum_w sum_l m[b, r, 128*w + l] * x[win_start[b, w] + l]
//
// accumulated in f32, with m in f32 or bf16 (upcast exactly) and x in
// f32, never rounded to m's type.  The escape chute and the diagonal are
// added by the caller, as the TPU kernel's caller does.
//
// What bounds it: bytes.  Each entry of m is read once and used for one
// multiply-add, so the kernel streams m (about 1.8 GB for the level-0
// operator of a 1M-vertex torus in f32) at memory bandwidth; x (4 MB at
// 1M) stays in the 50 MB L2 cache across blocks.  The design does the
// simple thing for that bound: one warp per output row, each lane reading
// 4 consecutive entries of m (a 16-byte load in f32, 8 bytes in bf16) and
// the matching 4 entries of x, so one warp iteration covers one whole
// 128-column window with fully coalesced loads, then a shuffle reduction.
// Fusing the escape chute, the diagonal and the block un-permutation,
// and cp.async/TMA pipelining, are later work.
//
// Requirements (checked by the Python wrapper): window starts are
// multiples of 128 and x is zero-padded far enough that every window
// reads in bounds; m, win_start and x are contiguous and 16-byte aligned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void load4(const float* p, float out[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __bfloat162float(lo.x);
    out[1] = __bfloat162float(lo.y);
    out[2] = __bfloat162float(hi.x);
    out[3] = __bfloat162float(hi.y);
}

// One thread block per row block: blockDim.x = 32 * blk, warp r computes
// output row r of the block.
template <typename T>
__global__ void blockdense_matvec_kernel(const T* __restrict__ m,
                                         const int32_t* __restrict__ win_start,
                                         const float* __restrict__ xp,
                                         float* __restrict__ y,
                                         int blk, int nw) {
    const int64_t b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t nww = static_cast<int64_t>(nw) * 128;
    const T* row = m + (b * blk + warp) * nww + 4 * lane;
    const int32_t* ws = win_start + b * nw;
    float acc = 0.0f;
    for (int w = 0; w < nw; ++w) {
        const int32_t s = __ldg(ws + w);
        float mv[4];
        load4(row + 128 * w, mv);
        const float4 xv =
            __ldg(reinterpret_cast<const float4*>(xp + s + 4 * lane));
        acc = fmaf(mv[0], xv.x, acc);
        acc = fmaf(mv[1], xv.y, acc);
        acc = fmaf(mv[2], xv.z, acc);
        acc = fmaf(mv[3], xv.w, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) y[b * blk + warp] = acc;
}

template <typename T>
int launch(const void* m, const int32_t* win_start, const float* xp,
           float* y, int64_t nblk, int blk, int nw, void* stream) {
    if (nblk <= 0 || blk <= 0 || blk > 32 || nw <= 0 || nblk > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    blockdense_matvec_kernel<T>
        <<<static_cast<unsigned>(nblk), 32 * blk, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(m), win_start, xp, y, blk, nw);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (nblk*blk,) f32 <- m (nblk, blk, 128*nw) f32 against padded x.
// Returns cudaGetLastError() after the launch (0 on success).
int gmg_blockdense_matvec_f32(const void* m, const int32_t* win_start,
                              const float* xp, float* y, int64_t nblk,
                              int blk, int nw, void* stream) {
    return launch<float>(m, win_start, xp, y, nblk, blk, nw, stream);
}

// The same with m in bf16.
int gmg_blockdense_matvec_bf16(const void* m, const int32_t* win_start,
                               const float* xp, float* y, int64_t nblk,
                               int blk, int nw, void* stream) {
    return launch<__nv_bfloat16>(m, win_start, xp, y, nblk, blk, nw,
                                 stream);
}

}  // extern "C"
