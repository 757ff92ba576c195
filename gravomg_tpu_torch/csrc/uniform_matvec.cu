// Uniform block-dense matvec for Hopper (sm_90a): one launch applies a
// uniform block-window form (gravomg_tpu_torch/ops/blockdense.py, the
// forms attach_fast_operators gives the levels the slab forms leave) to
// one right-hand side, bound through a plain C interface and ctypes
// (gravomg_tpu_torch/ops/uniform_cuda.py).
//
// Replaces no TPU kernel: the JAX package runs these forms through XLA
// (gravomg_tpu/ops/blockdense.py::blockdense_matvec), whose plain torch
// port launches some 20 to 40 operations a matvec (the window index built
// window by window, the padding of x, the gather, its rounding, the
// product, the sum, the escape chute's scatter, the diagonal).  For row
// block b of BLK rows, window w of width W_w (window0 for w = 0, window
// after it) at m's columns off_w.. and s_w = clamp(win_start[b, w], 0,
// xlen - W_w), xlen the length of x as pad_x pads it:
//
//   y[b*BLK + r] = sum_w sum_l m[b, r, off_w + l] * round_T(x[s_w + l])
//                + sum_{escape slots i of the row} esc_w[i] * x[min(esc_cols[i], n_cols - 1)]
//                + diag[b*BLK + r] * x[b*BLK + r]
//
// where x reads as zero at and past n_x and round_T rounds to m's type T
// (f32 or bf16), as the plain path rounds the gathered windows; products
// and sums in f32, the escape and diagonal terms with x unrounded; rows
// at and past n_rows (the last block's padding) are not written.
//
// What bounds it: the launch and a few dependent memory latencies, then
// m's bytes, each read once.  The forms are small: level 4 of the
// 1M-vertex hierarchy (about 2,100 rows) has an A form of 9 blocks x 256
// rows x 1,408 columns, 6.5 MB of bf16 m, 1.9 us at 3.35 TB/s.  The
// design:
//  * one thread block per (row block, slice of 8 rows): 9 x 32 thread
//    blocks of 256 threads for that A form, so every SM holds a few;
//  * one warp a row.  Before anything else each lane starts its first
//    kPre 16-byte loads of the row's m (the whole row for a 1,408-column
//    bf16 row: 176 chunks over 32 lanes), so that m's latency overlaps
//    what follows;
//  * the thread block stages the block's gathered, rounded x windows in
//    shared memory once (NWW floats, x from L2); rows read them there;
//  * each warp finds its row's run of the row-sorted escape chute by a
//    32-way search (one load a lane a step: 3 steps for 8,192 slots)
//    before the barrier, and sums the run in slot order, as the plain
//    path's index_add does on the CPU;
//  * each lane sums its chunks in order, the warp's 32 partial sums meet
//    in a fixed butterfly of shuffles: bitwise repeatable; the escape
//    run and the diagonal are added in the epilogue by lane 0;
//  * rows whose length in bytes is not a multiple of 16 (a window0 that
//    is a form's whole column count) take 2- or 4-byte loads instead.
//
// Requirements (checked by the Python wrapper): m (nblk, block, nww)
// contiguous f32 or bf16, win_start (nblk, nw) int32, x, esc_w and diag
// f32, esc_rows and esc_cols int32 with esc_rows sorted, nww at most
// kMaxCols.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows (warps) of a thread block
constexpr int kThreads = kWarps * 32;
constexpr int kPre = 8;                   // 16-byte chunks a lane loads first
constexpr int kMaxCols = 56 * 1024;       // staged x: 224 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// A 16-byte chunk of m, loaded now (volatile: not moved past the barrier).
__device__ __forceinline__ uint4 load_chunk(const uint4* p) {
    uint4 v;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

// acc + the chunk's entries times the staged x at xs, in order.
__device__ __forceinline__ float chunk_dot(const uint4& c, const float* xs,
                                           float acc, float) {
    const float4 x = *reinterpret_cast<const float4*>(xs);
    acc = fmaf(__uint_as_float(c.x), x.x, acc);
    acc = fmaf(__uint_as_float(c.y), x.y, acc);
    acc = fmaf(__uint_as_float(c.z), x.z, acc);
    return fmaf(__uint_as_float(c.w), x.w, acc);
}

__device__ __forceinline__ float chunk_dot(const uint4& c, const float* xs,
                                           float acc, __nv_bfloat16) {
    const float4 lo = *reinterpret_cast<const float4*>(xs);
    const float4 hi = *reinterpret_cast<const float4*>(xs + 4);
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
    const float xv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        // A 32-bit word holds two bf16 entries, the lower address in its
        // low half; a bf16's f32 value is its bits shifted up by 16.
        acc = fmaf(__uint_as_float(w[k] << 16), xv[2 * k], acc);
        acc = fmaf(__uint_as_float(w[k] & 0xffff0000u), xv[2 * k + 1], acc);
    }
    return acc;
}

// First slot of the sorted a[0, n) holding a value >= key (n if none),
// found by the whole warp: each step samples 32 slots of the range and
// keeps the part between the last sample below key and the next.
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* a,
                                                    int64_t n, int32_t key,
                                                    int lane) {
    int64_t lo = 0, hi = n;             // the answer lies in [lo, hi]
    while (hi - lo > 32) {
        const int64_t step = (hi - lo + 31) / 32;
        const int64_t p = lo + lane * step;
        const unsigned ge = __ballot_sync(kFull, p >= hi || __ldg(a + p) >= key);
        if (ge & 1u) return lo;
        const int k = ge ? __ffs(ge) - 1 : 32;  // samples 0..k-1 lie below key
        const int64_t nlo = lo + (k - 1) * step + 1;
        if (k < 32) hi = lo + k * step < hi ? lo + k * step : hi;
        lo = nlo;
    }
    const int64_t p = lo + lane;
    const unsigned ge = __ballot_sync(kFull, p >= hi || __ldg(a + p) >= key);
    return ge ? lo + __ffs(ge) - 1 : hi;
}

// The row's escape terms summed in slot order (every lane gets the sum).
__device__ __forceinline__ float escape_sum(
        const int32_t* esc_rows, const int32_t* esc_cols, const float* esc_w,
        int64_t n_esc, int32_t row, const float* x, int64_t n_cols,
        int lane) {
    float e = 0.0f;
    for (int64_t base = warp_lower_bound(esc_rows, n_esc, row, lane);
         base < n_esc; base += 32) {
        const int64_t i = base + lane;
        const bool in = i < n_esc && __ldg(esc_rows + i) == row;
        float c = 0.0f;
        if (in) {
            int64_t col = __ldg(esc_cols + i);
            col = col < 0 ? 0 : (col > n_cols - 1 ? n_cols - 1 : col);
            c = __fmul_rn(__ldg(esc_w + i), __ldg(x + col));
        }
        const unsigned run = __ballot_sync(kFull, in);   // a prefix: sorted
        const int len = __popc(run);
        for (int k = 0; k < len; ++k)
            e = __fadd_rn(e, __shfl_sync(kFull, c, k));
        if (len < 32) break;
    }
    return e;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
uniform_matvec_kernel(const T* __restrict__ m,
                      const int32_t* __restrict__ win_start, int block,
                      int nww, int nw, int window0, int window, int64_t xlen,
                      const float* __restrict__ x, int64_t n_x,
                      int64_t n_cols, const int32_t* __restrict__ esc_rows,
                      const int32_t* __restrict__ esc_cols,
                      const float* __restrict__ esc_w, int64_t n_esc,
                      const float* __restrict__ diag, float* __restrict__ y,
                      int64_t n_rows, int vec) {
    extern __shared__ __align__(16) float xs[];
    constexpr int kPer = 16 / sizeof(T);       // entries of a 16-byte chunk
    const int lane = threadIdx.x & 31;
    const int64_t b = blockIdx.x;
    const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
    const int64_t row = b * block + r;
    const bool live = r < block && row < n_rows;
    const T* mrow = m + row * nww;
    const uint4* mvec = reinterpret_cast<const uint4*>(mrow);
    const int nvec = vec ? nww / kPer : 0;

    uint4 pre[kPre];
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
        const int c = lane + 32 * k;
        pre[k] = live && c < nvec ? load_chunk(mvec + c) : make_uint4(0, 0, 0, 0);
    }

    // The block's windows of x, gathered, clamped and rounded to T.
    const int32_t* ws = win_start + b * nw;
#pragma unroll 4
    for (int j = threadIdx.x; j < nww; j += kThreads) {
        int w = 0, l = j, width = window0;
        if (j >= window0) {
            w = 1 + (j - window0) / window;
            l = j - window0 - (w - 1) * window;
            width = window;
        }
        int64_t s = __ldg(ws + w);
        s = s < 0 ? 0 : (s > xlen - width ? xlen - width : s);
        const int64_t col = s + l;
        xs[j] = rounded<T>(col < n_x ? __ldg(x + col) : 0.0f);
    }
    float e = 0.0f;
    if (live && n_esc > 0)
        e = escape_sum(esc_rows, esc_cols, esc_w, n_esc,
                       static_cast<int32_t>(row), x, n_cols, lane);
    __syncthreads();
    if (!live) return;

    float acc = 0.0f;
    if (vec) {
#pragma unroll
        for (int k = 0; k < kPre; ++k) {
            const int c = lane + 32 * k;
            if (c < nvec) acc = chunk_dot(pre[k], xs + c * kPer, acc, T());
        }
        for (int c = lane + 32 * kPre; c < nvec; c += 32)
            acc = chunk_dot(load_chunk(mvec + c), xs + c * kPer, acc, T());
    } else {
        for (int l = lane; l < nww; l += 32)
            acc = fmaf(as_float(mrow[l]), xs[l], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) {
        float out = __fadd_rn(acc, e);
        if (diag != nullptr) out = __fadd_rn(out, __fmul_rn(diag[row], x[row]));
        y[row] = out;
    }
}

template <typename T>
int launch(const void* m, const int32_t* win_start, int64_t nblk, int block,
           int nww, int nw, int window0, int window, int64_t xlen,
           const float* x, int64_t n_x, int64_t n_cols,
           const int32_t* esc_rows, const int32_t* esc_cols,
           const float* esc_w, int64_t n_esc, const float* diag, float* y,
           int64_t n_rows, void* stream) {
    if (nblk <= 0 || n_rows <= 0) return 0;
    if (nww <= 0 || nww > kMaxCols || block <= 0 || nw <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(nww) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            uniform_matvec_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int vec = (static_cast<size_t>(nww) * sizeof(T)) % 16 == 0
                    && reinterpret_cast<uintptr_t>(m) % 16 == 0;
    const dim3 grid(static_cast<unsigned>(nblk), (block + kWarps - 1) / kWarps);
    uniform_matvec_kernel<T><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(m), win_start, block, nww, nw, window0, window,
        xlen, x, n_x, n_cols, esc_rows, esc_cols, esc_w, n_esc, diag, y,
        n_rows, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One uniform-form matvec: y (n_rows,) f32 <- m (nblk, block, nww) f32
// with window starts win_start (nblk, nw) int32, windows of window0 then
// window columns, against x (n_x,) f32 as pad_x pads it to xlen; plus
// the sorted escape chute (n_esc slots; rows at n_rows or past are
// padding), plus diag * x (diag NULL: none).  Returns cudaGetLastError()
// after the launch (0 on success).
int gmg_uniform_matvec_f32(const void* m, const int32_t* win_start,
                           int64_t nblk, int block, int nww, int nw,
                           int window0, int window, int64_t xlen,
                           const float* x, int64_t n_x, int64_t n_cols,
                           const int32_t* esc_rows, const int32_t* esc_cols,
                           const float* esc_w, int64_t n_esc,
                           const float* diag, float* y, int64_t n_rows,
                           void* stream) {
    return launch<float>(m, win_start, nblk, block, nww, nw, window0, window,
                         xlen, x, n_x, n_cols, esc_rows, esc_cols, esc_w,
                         n_esc, diag, y, n_rows, stream);
}

// The same with m in bf16 (x's windows rounded to bf16).
int gmg_uniform_matvec_bf16(const void* m, const int32_t* win_start,
                            int64_t nblk, int block, int nww, int nw,
                            int window0, int window, int64_t xlen,
                            const float* x, int64_t n_x, int64_t n_cols,
                            const int32_t* esc_rows, const int32_t* esc_cols,
                            const float* esc_w, int64_t n_esc,
                            const float* diag, float* y, int64_t n_rows,
                            void* stream) {
    return launch<__nv_bfloat16>(m, win_start, nblk, block, nww, nw, window0,
                                 window, xlen, x, n_x, n_cols, esc_rows,
                                 esc_cols, esc_w, n_esc, diag, y, n_rows,
                                 stream);
}

}  // extern "C"
