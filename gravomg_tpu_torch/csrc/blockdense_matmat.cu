// Batched block-window SpMV (B1) for Hopper (sm_90a): one operator of
// the 8-row slab form applied to D right-hand sides at once, bound through
// a plain C interface and ctypes (gravomg_tpu_torch/ops/blockdense_cuda.py).
//
// Replaces the TPU kernel `_matvec_kernel` of
// gravomg_tpu/ops/pallas_blockdense.py as the JAX package runs it under
// jax.vmap over D right-hand sides (scripts/bench_configs.py, c5): vmap
// launches that kernel's grid once per column, so m is streamed D times.
// Here each thread block reads its part of m once for every 64 columns
// (once in all for D <= 64):
//
//   Y[b*8 + r, j] = sum_w sum_l m[b, r, 128*w + l] * Xp[win_start[b, w] + l, j]
//
// for j < D, accumulated in f32, with m in f32 or bf16 (upcast exactly)
// and X in f32, never rounded to m's type (the Pallas kernel's contract).
// The escape chute and the diagonal are added by the caller, as for K1.
//
// What bounds it: at D = 64 the multiply-adds (one per entry of m and
// column, 28.9e9 at the 1M level-0 operator: 0.86 ms at 67 TFLOP/s of
// f32 FFMA) lie above m's bytes (0.54 ms in f32 at 3.35 TB/s); bytes and
// multiply-adds cross near D = 49 in f32 and D = 24 in bf16.  The simple
// design here does not reach either: every 8-row block copies its own
// 128 x D tiles of X into shared memory, which at D = 64 moves about
// eight times m's bytes through L2 (sharing tiles between neighbouring
// blocks, and a split-x tensor-core product, are later work; wgmma with
// bf16 or TF32 operands would round X).
//
// Design: one thread block of 256 threads per 8-row block.  Columns are
// taken DC at a time (DC a power of two from 4 to 64, the smallest that
// covers min(D, 64)).  For each window the block copies the 128 x DC tile
// of X (contiguous rows of Xp: one 16-byte load a thread when D is a
// multiple of 4, else one element; the tile starts at a multiple of 128
// rows, so it is 16-byte aligned for any D) and the window's 8 x 128
// entries of m (stored transposed, 8 rows per position l) into shared
// memory.  Thread t owns column c = t % DC and the positions l of its
// group g = t / DC for all 8 rows: per l one load of X's tile, two
// broadcast 16-byte loads of m and 8 exact f32 FFMAs.  The groups' sums
// are combined in a fixed order, so the result is bitwise repeatable.
//
// Requirements (checked by the Python wrapper): 8-row blocks, window
// starts multiples of 128, Xp zero-padded far enough that every window
// reads in bounds; m, win_start, Xp contiguous, m and Xp 16-byte aligned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BLK = 8;         // rows of a block
constexpr int WIN = 128;       // columns of a window
constexpr int THREADS = 256;

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

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
blockdense_matmat_kernel(const T* __restrict__ m,
                         const int32_t* __restrict__ win_start,
                         const float* __restrict__ xp,
                         float* __restrict__ y, int nw, int d) {
    constexpr int NG = THREADS / DC;       // groups of positions l
    constexpr int LPG = WIN / NG;          // positions of a group
    __shared__ __align__(16) float xs[WIN * DC];
    __shared__ __align__(16) float ms[WIN * BLK];
    __shared__ float red[NG * BLK * DC];

    const int t = threadIdx.x;
    const int c = t % DC, g = t / DC;
    const int64_t b = blockIdx.x;
    const int64_t nww = static_cast<int64_t>(nw) * WIN;
    const int32_t* ws = win_start + b * nw;
    // m's loader: row t % 8, entries 4 * (t / 8) .. +3 of the window.
    const int mr = t % BLK, mq = t / BLK;
    const T* mrow = m + (b * BLK + mr) * nww + 4 * mq;
    const bool vec = (d % 4) == 0;

    for (int j0 = 0; j0 < d; j0 += DC) {
        float acc[BLK];
#pragma unroll
        for (int r = 0; r < BLK; ++r) acc[r] = 0.0f;
        for (int w = 0; w < nw; ++w) {
            const float* xt = xp + static_cast<int64_t>(__ldg(ws + w)) * d
                              + j0;
            if (vec) {
                for (int e = 4 * t; e < WIN * DC; e += 4 * THREADS) {
                    const int l = e / DC, cc = e % DC;
                    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    if (j0 + cc < d)
                        v = __ldg(reinterpret_cast<const float4*>(
                            xt + static_cast<int64_t>(l) * d + cc));
                    *reinterpret_cast<float4*>(xs + e) = v;
                }
            } else {
                for (int e = t; e < WIN * DC; e += THREADS) {
                    const int l = e / DC, cc = e % DC;
                    xs[e] = (j0 + cc < d)
                                ? __ldg(xt + static_cast<int64_t>(l) * d + cc)
                                : 0.0f;
                }
            }
            float mv[4];
            load4(mrow + static_cast<int64_t>(WIN) * w, mv);
#pragma unroll
            for (int i = 0; i < 4; ++i) ms[(4 * mq + i) * BLK + mr] = mv[i];
            __syncthreads();
#pragma unroll 4
            for (int i = 0; i < LPG; ++i) {
                const int l = g * LPG + i;
                const float xv = xs[l * DC + c];
                const float4 m0 = *reinterpret_cast<const float4*>(ms + l * BLK);
                const float4 m1 =
                    *reinterpret_cast<const float4*>(ms + l * BLK + 4);
                acc[0] = fmaf(m0.x, xv, acc[0]);
                acc[1] = fmaf(m0.y, xv, acc[1]);
                acc[2] = fmaf(m0.z, xv, acc[2]);
                acc[3] = fmaf(m0.w, xv, acc[3]);
                acc[4] = fmaf(m1.x, xv, acc[4]);
                acc[5] = fmaf(m1.y, xv, acc[5]);
                acc[6] = fmaf(m1.z, xv, acc[6]);
                acc[7] = fmaf(m1.w, xv, acc[7]);
            }
            __syncthreads();
        }
        // The groups' partial sums, combined in group order.
#pragma unroll
        for (int r = 0; r < BLK; ++r) red[(g * BLK + r) * DC + c] = acc[r];
        __syncthreads();
        for (int o = t; o < BLK * DC; o += THREADS) {
            const int r = o / DC, cc = o % DC;
            float sum = 0.0f;
            for (int gg = 0; gg < NG; ++gg)
                sum += red[(gg * BLK + r) * DC + cc];
            if (j0 + cc < d) y[(b * BLK + r) * d + j0 + cc] = sum;
        }
        __syncthreads();
    }
}

template <typename T>
int launch(const void* m, const int32_t* win_start, const float* xp,
           float* y, int64_t nblk, int blk, int nw, int d, void* stream) {
    if (nblk <= 0 || blk != BLK || nw <= 0 || d <= 0 || nblk > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(nblk));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* mt = static_cast<const T*>(m);
    if (d <= 4)
        blockdense_matmat_kernel<T, 4><<<grid, THREADS, 0, s>>>(
            mt, win_start, xp, y, nw, d);
    else if (d <= 8)
        blockdense_matmat_kernel<T, 8><<<grid, THREADS, 0, s>>>(
            mt, win_start, xp, y, nw, d);
    else if (d <= 16)
        blockdense_matmat_kernel<T, 16><<<grid, THREADS, 0, s>>>(
            mt, win_start, xp, y, nw, d);
    else if (d <= 32)
        blockdense_matmat_kernel<T, 32><<<grid, THREADS, 0, s>>>(
            mt, win_start, xp, y, nw, d);
    else
        blockdense_matmat_kernel<T, 64><<<grid, THREADS, 0, s>>>(
            mt, win_start, xp, y, nw, d);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Y (nblk*8, d) f32 row-major <- m (nblk, 8, 128*nw) f32 against Xp
// (rows, d) f32 row-major.  Returns cudaGetLastError() after the launch
// (0 on success).
int gmg_blockdense_matmat_f32(const void* m, const int32_t* win_start,
                              const float* xp, float* y, int64_t nblk,
                              int blk, int nw, int d, void* stream) {
    return launch<float>(m, win_start, xp, y, nblk, blk, nw, d, stream);
}

// The same with m in bf16.
int gmg_blockdense_matmat_bf16(const void* m, const int32_t* win_start,
                               const float* xp, float* y, int64_t nblk,
                               int blk, int nw, int d, void* stream) {
    return launch<__nv_bfloat16>(m, win_start, xp, y, nblk, blk, nw, d,
                                 stream);
}

}  // extern "C"
