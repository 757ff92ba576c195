// Block-window SpMV (K1) for Hopper (sm_90a): the 8-row blocks of a slab
// form applied to one right-hand side, one launch per slab matvec over
// all buckets, bound through a plain C interface and ctypes
// (gravomg_tpu_torch/ops/blockdense_cuda.py).
//
// Replaces the TPU kernel `_matvec_kernel` of
// gravomg_tpu/ops/pallas_blockdense.py (launched by
// `blockdense_matvec_pallas`, once per bucket by the JAX package's
// `slab_matvec`).  For output block o in row order and c =
// inv_block_perm[o] its block in the buckets laid end to end (identity
// for one bucket):
//
//   y[o*8 + r] = sum_w sum_l m[c, r, 128*w + l] * x[win_start[c, w] + l]
//                + diag[o*8 + r] * x[o*8 + r]
//
// accumulated in f32, with m in f32 or bf16 (upcast exactly) and x in
// f32, never rounded to m's type; a window position at or past x's
// length reads x as zero, as the zero padding did.  The diagonal (when
// given) is fused into the store; the escape chute is added by the
// caller.
//
// What bounds it: bytes.  Each entry of m is read once for one
// multiply-add (1.8 GB for the level-0 operator of a 1M-vertex torus in
// f32, 0.9 GB in bf16); x (4 MB at 1M) stays in the 50 MB L2.  The design:
//  * m streamed once, asynchronously, by the ring of block_ring.cuh (which
//    B1 shares): one launch for all buckets, y in row order through
//    inv_block_perm (no per-bucket y, no concatenation, no un-permutation
//    pass), a persistent grid of one thread block an SM with 16 consumer
//    warps and one warp that allocates the ring; m by cp.async.bulk into
//    a 192 KB byte ring with an L2 evict-first hint.  A block of up to
//    32 KB (cap 8 in f32, 16 in bf16) is one chunk and one bulk copy, and
//    each consumer warp issues the copies of its own chunks: at level 0
//    of the 1M mesh a bf16 block averages 7 KB, and one warp issuing every
//    copy held the kernel at 0.40 ms (0.68 of its bound) where the 16
//    warps issuing take 0.31 (chip_smoke.py phase 6; probes/bulk_copy.py
//    shows why).
//  * One warp owns one 8-row block.  For each window lane t loads x's
//    entries 4t..4t+3 once (one 16-byte load from L2) and uses them for
//    all 8 rows of m in shared memory: 32 FFMAs a window for 8 shared
//    loads.  The warp loads its next block's window starts a round ahead
//    and the x windows of a chunk (its first 8) before it waits for the
//    chunk, so that no chain of dependent loads stands between one block
//    and the next (inv_block_perm is read two rounds ahead by the ring).
//  * Every position is multiplied, zero or not: at one column a skipped
//    position saves one FFMA and 4 bytes of x from L2, while m's bytes,
//    which bound the kernel, are read either way.
//  * One reduction a block: the lanes' 8 partial sums meet by a warp
//    reduce-scatter of shuffles in a fixed order; lane 4r stores row r.
//    Bitwise repeatable: a lane sums its positions in window order and
//    the tree is fixed.
//  * Tensor cores buy nothing for a GEMV bound by bytes, and wgmma on bf16
//    or TF32 operands would round x.
//
// Requirements (checked by the Python wrapper): 8-row blocks, window
// starts multiples of 128; m, win_start, inv, x, diag contiguous, m and x
// 16-byte aligned.

#include "block_ring.cuh"

namespace {

using namespace gmg_ring;

constexpr int kWarps = 16;              // consumer warps of a thread block
constexpr int kRingBytes = 192 * 1024;  // m ring of the thread block
// The ring: chunks of at most 32 KB, at most 64 in flight.
template <typename T>
using K1Ring = Ring<T, kWarps, kRingBytes, 32 * 1024, 64>;
constexpr int kThreads = K1Ring<float>::kThreads;
constexpr int kSmemBytes = kRingBytes + K1Ring<float>::kSlotBytes;
constexpr int kPre = 8;                 // x windows loaded before the wait

// x's entries base..base+3 (a lane's share of a window): one 16-byte
// load, entries at or past n_x read as zero.
__device__ __forceinline__ float4 x_quad(const float* __restrict__ x,
                                         int64_t n_x, int64_t base) {
    if (base + 4 <= n_x)
        return __ldg(reinterpret_cast<const float4*>(x + base));
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (base < n_x) v.x = __ldg(x + base);
    if (base + 1 < n_x) v.y = __ldg(x + base + 1);
    if (base + 2 < n_x) v.z = __ldg(x + base + 2);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
blockdense_matvec_kernel(const __grid_constant__ Forms f,
                         const int32_t* __restrict__ inv, int64_t n_out,
                         const float* __restrict__ x, int64_t n_x,
                         const float* __restrict__ diag, int64_t n_diag,
                         float* __restrict__ y) {
    using R = K1Ring<T>;
    extern __shared__ __align__(128) unsigned char smem[];
    const Slots slots = R::slots(smem + kRingBytes);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    R::init(slots);
    __syncthreads();
    if (warp == kWarps) {
        R::produce(f, inv, n_out, slots, lane);
        return;
    }

    // Lane w < 32 holds the start of window w of the warp's block;
    // windows from 32 on (an operator built with more than 32) read
    // theirs from ws.  ws_next holds those of its block in the next round,
    // loaded a round ahead.
    const int32_t* ws = nullptr;
    int wsv = 0, ws_next = 0;
    int64_t o_next = -1;
    // Lane 4r: the diagonal and x at row r of the block, loaded as it
    // starts (the store then waits for no load).
    float dg = 0.0f, xd = 0.0f;
    float acc[kBlk];
    float4 xv[kPre];
    auto window_x = [&](int wi) {
        const int64_t s = wi < 32 ? __shfl_sync(kFull, wsv, wi)
                                  : __ldg(ws + wi);
        return x_quad(x, n_x, s + 4 * lane);
    };
    // acc[r] += the lane's four entries of row r, window w of the chunk.
    auto fma_window = [&](const T* chunk, int nwc, int w, const float4& xw) {
#pragma unroll
        for (int r = 0; r < kBlk; ++r) {
            const float4 mv = load4(chunk + (r * nwc + w) * kWin);
            acc[r] = fmaf(mv.x, xw.x, acc[r]);
            acc[r] = fmaf(mv.y, xw.y, acc[r]);
            acc[r] = fmaf(mv.z, xw.z, acc[r]);
            acc[r] = fmaf(mv.w, xw.w, acc[r]);
        }
    };
    R::consume(
        f, inv, n_out, smem, slots, warp, lane,
        [&](const Block& blk, const Block& next) {
            ws = f.win_start[blk.k] + blk.b * blk.cap;
            wsv = blk.o == o_next ? ws_next
                                  : (lane < blk.cap ? __ldg(ws + lane) : 0);
            o_next = next.cap > 0 ? next.o : -1;
            ws_next = lane < next.cap
                      ? __ldg(f.win_start[next.k] + next.b * next.cap + lane)
                      : 0;
            const int64_t row = blk.o * kBlk + (lane >> 2);
            dg = 0.0f;
            xd = 0.0f;
            if (diag != nullptr && (lane & 3) == 0 && row < n_diag) {
                dg = __ldg(diag + row);
                xd = __ldg(x + row);
            }
#pragma unroll
            for (int r = 0; r < kBlk; ++r) acc[r] = 0.0f;
        },
        [&](int w0, int nwc) {
#pragma unroll
            for (int u = 0; u < kPre; ++u)
                if (u < nwc) xv[u] = window_x(w0 + u);
        },
        [&](const unsigned char* bytes, int64_t, int w0, int nwc) {
            const T* chunk = reinterpret_cast<const T*>(bytes) + 4 * lane;
#pragma unroll
            for (int u = 0; u < kPre; ++u)
                if (u < nwc) fma_window(chunk, nwc, u, xv[u]);
            for (int w = kPre; w < nwc; ++w)
                fma_window(chunk, nwc, w, window_x(w0 + w));
        },
        [&](int64_t o) {
            reduce_scatter<kBlk, 16, 1>(acc, lane);
            // Lanes 4r..4r+3 now each hold the sum of row r.
            if ((lane & 3) == 0)
                y[o * kBlk + (lane >> 2)] = fmaf(dg, xd, acc[0]);
        });
}

template <typename T>
int launch(const void* const* m, const void* const* win_start,
           const int* caps, const int* starts, int n_buckets,
           const int32_t* inv, int64_t n_out, const float* x, int64_t n_x,
           const float* diag, int64_t n_diag, float* y, void* stream) {
    Forms f;
    if (!make_forms(m, win_start, caps, starts, n_buckets, f) || n_out <= 0
            || n_out > INT32_MAX || n_x < 0 || n_x > INT32_MAX
            || n_diag < 0 || n_diag > n_out * kBlk || n_diag > n_x)
        return static_cast<int>(cudaErrorInvalidValue);
    static const int resident = resident_blocks(blockdense_matvec_kernel<T>,
                                                kThreads, kSmemBytes);
    if (resident <= 0) {
        const cudaError_t e = cudaGetLastError();
        return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
    }
    const int64_t need = (n_out + kWarps - 1) / kWarps;
    const int grid = static_cast<int>(need < resident ? need : resident);
    blockdense_matvec_kernel<T><<<grid, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
        f, inv, n_out, x, n_x, diag, n_diag, y);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One slab matvec: y (n_out*8,) f32 <- the buckets' m[k] (nblk_k, 8,
// 128*caps[k]) f32 and window starts win_start[k] (nblk_k, caps[k])
// against x (n_x,) f32, entries from n_x on read as zero; output block o
// reads block inv[o] of the buckets laid end to end (bucket k's first
// block at starts[k], ascending), or block o of the one bucket where inv
// is NULL; rows below n_diag add diag[row] * x[row] (diag NULL: none).
// m, win_start, caps and starts are host arrays of n_buckets entries.
// Returns cudaGetLastError() after the launch (0 on success).
int gmg_blockdense_matvec_f32(const void* const* m,
                              const void* const* win_start, const int* caps,
                              const int* starts, int n_buckets,
                              const int32_t* inv, int64_t n_out,
                              const float* x, int64_t n_x, const float* diag,
                              int64_t n_diag, float* y, void* stream) {
    return launch<float>(m, win_start, caps, starts, n_buckets, inv, n_out,
                         x, n_x, diag, n_diag, y, stream);
}

// The same with m in bf16.
int gmg_blockdense_matvec_bf16(const void* const* m,
                               const void* const* win_start, const int* caps,
                               const int* starts, int n_buckets,
                               const int32_t* inv, int64_t n_out,
                               const float* x, int64_t n_x,
                               const float* diag, int64_t n_diag, float* y,
                               void* stream) {
    return launch<__nv_bfloat16>(m, win_start, caps, starts, n_buckets, inv,
                                 n_out, x, n_x, diag, n_diag, y, stream);
}

}  // extern "C"
