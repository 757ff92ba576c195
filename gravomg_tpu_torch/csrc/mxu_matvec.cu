// Transposed-tile SpMV for Hopper (sm_90a), bound through a plain C
// interface and ctypes (gravomg_tpu_torch/ops/mxu_cuda.py).
//
// Replaces the TPU kernel `_mxu_kernel` of
// gravomg_tpu/ops/pallas_blockdense.py (launched by `mxu_matvec_pallas`).
// For 128-row block b of a bucket with NSEG segments of 128 columns,
// stored as tiles mt[b, s, l, r] = A[b*128 + r, win_start[b, s] + l]:
//
//   y[b*128 + r] = sum_s sum_l rnd(x[win_start[b, s] + l]) * mt[b, s, l, r]
//
// where rnd rounds x to mt's type (as the Pallas kernel does before its
// dot), and the sum is taken in f32.  The escape chute is added by the
// caller, as the TPU kernel's caller does.
//
// What bounds it: bytes.  Each tile element is used for exactly one
// multiply-add with one right-hand side, about 0.5 operation per byte in
// bf16 against the ~295 at which the tensor cores become the limit, so
// the tensor cores buy nothing for this GEMV and the kernel uses CUDA
// cores.  f32 tiles stay exact f32 (FFMA, no TF32): CG's own matvec runs
// on the f32 form.  For bf16 tiles the products of bf16-rounded x and
// bf16 m are exact in f32.
//
// The design streams each block's tiles once at memory bandwidth: one
// thread block per 128-row block; its x segments, rounded to mt's type,
// staged in shared memory; each thread owns 4 consecutive output rows r
// (the tile's contiguous dimension), so each warp reads one whole tile
// row l per load (16-byte loads in f32, 8-byte in bf16, fully
// coalesced); the warps split the (s, l) rows, 8 rows in flight per
// thread; one shared-memory reduction over the warps and one store of 128
// outputs.
//
// Requirements (checked by the Python wrapper): win_start holds
// multiples of 128 and x is zero-padded so every segment reads in
// bounds; mt is contiguous and 16-byte aligned; 1 <= nseg <= 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 8;

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

__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
mxu_matvec_kernel(const T* __restrict__ mt,
                  const int32_t* __restrict__ win_start,
                  const float* __restrict__ xp, float* __restrict__ y,
                  int nseg) {
    extern __shared__ float xs[];               // nseg * 128 rounded x
    __shared__ float red[kWarps][128];
    const int64_t b = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nrows = nseg * 128;               // tile rows (s, l) of block b

    for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
        const int64_t start = __ldg(win_start + b * nseg + (i >> 7));
        xs[i] = round_to(__ldg(xp + start + (i & 127)), mt);
    }
    __syncthreads();

    const T* base = mt + b * static_cast<int64_t>(nrows) * 128 + 4 * lane;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    // nrows is a multiple of kWarps * kUnroll (64), so the unrolled loop
    // covers every row.
    for (int q = warp; q < nrows; q += kWarps * kUnroll) {
        float mv[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            load4(base + static_cast<int64_t>(q + u * kWarps) * 128, mv[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const float xv = xs[q + u * kWarps];
            a0 = fmaf(mv[u][0], xv, a0);
            a1 = fmaf(mv[u][1], xv, a1);
            a2 = fmaf(mv[u][2], xv, a2);
            a3 = fmaf(mv[u][3], xv, a3);
        }
    }
    red[warp][4 * lane + 0] = a0;
    red[warp][4 * lane + 1] = a1;
    red[warp][4 * lane + 2] = a2;
    red[warp][4 * lane + 3] = a3;
    __syncthreads();
    if (threadIdx.x < 128) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
        y[b * 128 + threadIdx.x] = s;
    }
}

template <typename T>
int launch(const void* mt, const int32_t* win_start, const float* xp,
           float* y, int64_t nblk, int nseg, void* stream) {
    if (nblk <= 0 || nblk > INT32_MAX || nseg <= 0 || nseg > 64)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(nseg) * 128 * sizeof(float);
    mxu_matvec_kernel<T>
        <<<static_cast<unsigned>(nblk), 32 * kWarps, smem,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(mt), win_start, xp, y, nseg);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (nblk*128,) f32 <- mt (nblk, nseg, 128, 128) f32 against padded x.
// Returns cudaGetLastError() after the launch (0 on success).
int gmg_mxu_matvec_f32(const void* mt, const int32_t* win_start,
                       const float* xp, float* y, int64_t nblk, int nseg,
                       void* stream) {
    return launch<float>(mt, win_start, xp, y, nblk, nseg, stream);
}

// The same with mt in bf16 (x rounded to bf16 before the products).
int gmg_mxu_matvec_bf16(const void* mt, const int32_t* win_start,
                        const float* xp, float* y, int64_t nblk, int nseg,
                        void* stream) {
    return launch<__nv_bfloat16>(mt, win_start, xp, y, nblk, nseg, stream);
}

}  // extern "C"
