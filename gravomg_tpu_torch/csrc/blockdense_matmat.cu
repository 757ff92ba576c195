// Batched block-window SpMV (B1) for Hopper (sm_90a): the 8-row blocks
// of a slab form applied to D right-hand sides at once, one launch per
// slab matvec over all buckets, bound through a plain C interface and
// ctypes (gravomg_tpu_torch/ops/blockdense_cuda.py).
//
// Replaces the TPU kernel `_matvec_kernel` of
// gravomg_tpu/ops/pallas_blockdense.py as the JAX package runs it under
// jax.vmap over D right-hand sides (scripts/bench_configs.py, c5): vmap
// launches that kernel's grid once per column, so m is streamed D times.
// Here m is read from device memory once for all columns:
//
//   Y[o*8 + r, j] = sum_w sum_l m[c, r, 128*w + l] * X[win_start[c, w] + l, j]
//
// for output block o in row order, c = inv_block_perm[o] its block in the
// buckets laid end to end (identity for one bucket), j < D; accumulated
// in f32, m in f32 or bf16 (upcast exactly), X in f32 and never rounded
// (the Pallas kernel's contract).  The escape chute and the diagonal are
// added by the caller.
//
// What bounds it: bytes.  The slab form keeps 128-wide dense windows, and
// on the meshes it is built for only about one (block, position) pair in
// ten has a nonzero in any of the block's 8 rows (10.9% at the 1M level-0
// operator).  Counting only those, the multiply-adds at D = 64 take
// under a sixth of the time m's bytes take at 3.35 TB/s.  So the kernel
// reads m once, asynchronously and at full width, and spends no work and
// no X traffic on the zero positions.  Tensor cores would buy nothing
// once the zeros are skipped, and wgmma on bf16 or TF32 operands would
// round X: the products are exact f32 FFMA on the CUDA cores.
//
// Design:
//  * One launch for all buckets of a form, Y written in row order
//    through inv_block_perm (no concatenation, no un-permutation pass
//    follows), m streamed once by cp.async.bulk into a 112 KB byte ring
//    in shared memory, a persistent grid of one thread block an SM with
//    12 consumer warps, each issuing the copies of its own chunks, and one
//    warp that allocates the ring: the ring of block_ring.cuh, which K1
//    shares.  A block of up to 32 KB (cap 8 in f32, 16 in bf16: 99.4% of
//    the 1M level-0 blocks) is one chunk and one bulk copy.  X
//    is read where it lies, unpadded: a window position past X's rows
//    counts as zero, as the zero padding did.
//  * Zero positions skipped at run time.  When a chunk has arrived its
//    warp reads each window's 8 x 128 entries (lane t: positions
//    4t..4t+3 of every row), flags the positions where any row is
//    nonzero, and with four ballots and popc compacts them, in
//    ascending order, into a per-warp list in shared memory: the 8
//    entries upcast to f32 (two 16-byte words) and the X row.  Then the
//    chunk is released.  An exact zero times a finite x adds nothing, so
//    skipping it does not change the sum.
//  * The list is multiplied once it holds more than 128 positions or the
//    block ends.  Lanes split the columns and the positions: LW lanes
//    cover a pass of 4*LW columns (DS = 4 each, one 16-byte X load) and
//    the warp's 32 / LW slots take alternate list entries, 8 entries in
//    flight a lane; each X row is read straight from device memory (L2),
//    never staged.  Per entry a lane does 32 FFMAs for one X load and
//    two broadcast 16-byte list loads.  At small D (D <= 4) LW = 1, every
//    lane taking its own entries on all D columns (D rounded up to 4).
//    Where that threshold lies was measured once, with both forms built
//    for D = 8 (level-0 A at 1M, f32, alone, NVIDIA H100 80GB HBM3 at
//    700 W; chip_smoke.py phase 15 as it then stood): lanes splitting the
//    positions took 0.888-0.899 ms, lanes splitting the columns 0.701 ms,
//    so only D <= 4 takes the small-D form.
//  * One reduction a block: the slots' partial sums meet by a warp
//    reduce-scatter of shuffles (no shared memory, no barrier), in a
//    fixed order, and each lane stores the rows it ends with (16-byte
//    stores where D is a multiple of 4).  D > 64 takes passes of 64
//    columns over the same list, and then each list flush adds its sums
//    into Y; m is still read once.
//  * Bitwise repeatable: a lane sums its entries in list order, the list
//    is in position order, and the reduction tree is fixed.
//
//  * Why so (chip_smoke.py phase 15, level-0 A at 1M, alone): one bulk
//    copy per row and window (8 a window) held the kernel at 1.0-1.3 ms
//    whatever m's type, and a producer whose lanes waited apart (lane 0
//    issuing, the others at the next shuffle) near 0.70 ms at D = 3; with
//    whole-block copies, the round walk, the producer in step and the
//    evict-first hint it took 0.615 / 0.514 ms at D = 3 (f32 / bf16 m)
//    and 0.909 / 0.875 ms at D = 64; with each consumer warp issuing its
//    own copies 0.619 / 0.382 and 0.818 / 0.696 ms (NVIDIA H100 80GB HBM3
//    at 700 W).  At D = 64 the X rows, about 1.6 GB through L2 (nearly
//    m's bytes again), set the pace.
//
// Requirements (checked by the Python wrapper): 8-row blocks, window
// starts multiples of 128; m, win_start, inv and X contiguous, m and X
// 16-byte aligned.

#include "block_ring.cuh"

namespace {

using namespace gmg_ring;

constexpr int kList = 256;              // list entries of one warp
constexpr int kWarps = 12;              // consumer warps of a thread block
constexpr int kRingBytes = 112 * 1024;  // m ring of the thread block
// The ring: chunks of at most 32 KB, at most 32 in flight.
template <typename T>
using B1Ring = Ring<T, kWarps, kRingBytes, 32 * 1024, 32>;
constexpr int kThreads = B1Ring<float>::kThreads;
constexpr int kSmemBytes = kRingBytes + kWarps * kList * 36
                           + B1Ring<float>::kSlotBytes;

__device__ __forceinline__ float pick(const float4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <typename T, int DS, int LW>
__global__ void __launch_bounds__(kThreads, 1)
blockdense_matmat_kernel(const __grid_constant__ Forms f,
                         const int32_t* __restrict__ inv, int64_t n_out,
                         const float* __restrict__ x, int64_t n_x,
                         float* __restrict__ y, int d) {
    constexpr int kLanesSlots = 32 / LW;                // position slots
    constexpr int kAcc = kBlk * DS;
    constexpr int kU = DS > 4 ? 2 : 8;                  // entries in flight
    constexpr int kCols = DS * LW;                      // columns a pass
    static_assert(kAcc >= kLanesSlots, "a lane ends with whole sums");
    using R = B1Ring<T>;
    extern __shared__ __align__(128) unsigned char smem[];
    const unsigned char* ring = smem;
    float4* lm0 = reinterpret_cast<float4*>(smem + kRingBytes);
    int* lx0 = reinterpret_cast<int*>(lm0 + kWarps * kList * 2);
    const Slots slots = R::slots(
        reinterpret_cast<unsigned char*>(lx0 + kWarps * kList));
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    R::init(slots);
    __syncthreads();
    if (warp == kWarps) {
        R::produce(f, inv, n_out, slots, lane);
        return;
    }

    // Consumer warp `warp`: block i of the thread block's walk is warp
    // i % kWarps's (block_ring.cuh's Ring::consume).
    float4* lm = lm0 + warp * kList * 2;
    int* lx = lx0 + warp * kList;
    const int slot = lane / LW;
    const int cg = lane % LW;
    const bool vec = (d % 4) == 0;
    const int passes = (d + kCols - 1) / kCols;
    const unsigned lt = (1u << lane) - 1u;
    float acc[kAcc];
    // acc += the list's entries [0, n) on columns c0 + cg*DS ... +DS-1.
    auto multiply = [&](int n, int c0) {
        const int col = c0 + cg * DS;
        for (int e0 = slot; e0 < n; e0 += kLanesSlots * kU) {
            float xv[kU][DS];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int e = e0 + u * kLanesSlots;
#pragma unroll
                for (int j = 0; j < DS; ++j) xv[u][j] = 0.0f;
                if (e < n) {
                    const float* xr = x + static_cast<int64_t>(lx[e]) * d + col;
                    if (vec) {
#pragma unroll
                        for (int j = 0; j < DS; j += 4)
                            if (col + j < d) {
                                const float4 v = __ldg(
                                    reinterpret_cast<const float4*>(xr + j));
                                xv[u][j] = v.x;
                                xv[u][j + 1] = v.y;
                                xv[u][j + 2] = v.z;
                                xv[u][j + 3] = v.w;
                            }
                    } else {
#pragma unroll
                        for (int j = 0; j < DS; ++j)
                            if (col + j < d) xv[u][j] = __ldg(xr + j);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int e = e0 + u * kLanesSlots;
                if (e < n) {
                    const float4 ma = lm[2 * e];
                    const float4 mb = lm[2 * e + 1];
                    const float mr[kBlk] = {ma.x, ma.y, ma.z, ma.w,
                                            mb.x, mb.y, mb.z, mb.w};
#pragma unroll
                    for (int r = 0; r < kBlk; ++r)
#pragma unroll
                        for (int j = 0; j < DS; ++j)
                            acc[r * DS + j] =
                                fmaf(mr[r], xv[u][j], acc[r * DS + j]);
                }
            }
        }
    };

    // Y rows of block o, columns of this pass, = (or +=) the slots' sums:
    // after the reduce-scatter a lane holds entries slot*kOut ... of the
    // 8 x DS sums (row r, column j at r*DS + j).
    auto flush = [&](int64_t o, int c0, bool add) {
        reduce_scatter<kAcc, 16, LW>(acc, lane);
        constexpr int kOut = kAcc / kLanesSlots;
        float* yb = y + o * kBlk * d;
        const int col = c0 + cg * DS;
        const int idx0 = slot * kOut;
        if (DS == 4 && kOut % 4 == 0 && vec) {
            if (col < d) {
#pragma unroll
                for (int i = 0; i < kOut; i += 4) {
                    float4* p = reinterpret_cast<float4*>(
                        yb + static_cast<int64_t>((idx0 + i) / 4) * d + col);
                    float4 v = make_float4(acc[i], acc[i + 1], acc[i + 2],
                                           acc[i + 3]);
                    if (add) {
                        const float4 old = *p;
                        v.x += old.x; v.y += old.y; v.z += old.z; v.w += old.w;
                    }
                    *p = v;
                }
            }
        } else {
#pragma unroll
            for (int i = 0; i < kOut; ++i) {
                const int idx = idx0 + i;
                const int c = col + idx % DS;
                if (c < d) {
                    float* p = yb + static_cast<int64_t>(idx / DS) * d + c;
                    *p = add ? *p + acc[i] : acc[i];
                }
            }
        }
    };

    // The list's entries [0, n) into Y's block o.  One pass: into acc,
    // flushed (stored) at the block's end.  Several: each pass flushed at
    // once, the block's first flush storing, later ones adding.
    bool flushed = false;
    auto apply_list = [&](int64_t o, int n, bool last) {
        if (passes == 1) {
            multiply(n, 0);
            if (last) flush(o, 0, false);
        } else {
            for (int p = 0; p < passes; ++p) {
#pragma unroll
                for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
                multiply(n, kCols * p);
                flush(o, kCols * p, flushed);
            }
            flushed = true;
        }
        __syncwarp();               // the list may be written again
    };

    // Lane w < 32 holds the start of window w of the warp's block;
    // windows from 32 on (an operator built with more than 32) read
    // theirs from ws.
    const int32_t* ws = nullptr;
    int wsv = 0;
    int n = 0;
    R::consume(
        f, inv, n_out, ring, slots, warp, lane,
        [&](const Block& blk, const Block&) {
            ws = f.win_start[blk.k] + blk.b * blk.cap;
            wsv = lane < blk.cap ? __ldg(ws + lane) : 0;
            n = 0;
#pragma unroll
            for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;
            flushed = false;
        },
        [](int, int) {},
        [&](const unsigned char* bytes, int64_t o, int w0, int nwc) {
            const T* chunk = reinterpret_cast<const T*>(bytes) + 4 * lane;
            for (int w = 0; w < nwc; ++w) {
                if (n > kList - kWin) {
                    apply_list(o, n, false);
                    n = 0;
                }
                // Positions past x's rows read x as zero: skipped.
                const int wi = w0 + w;
                const int64_t base =
                    (wi < 32 ? __shfl_sync(kFull, wsv, wi)
                             : __ldg(ws + wi)) + 4 * lane;
                float4 mv[kBlk];
#pragma unroll
                for (int r = 0; r < kBlk; ++r)
                    mv[r] = load4(chunk + (r * nwc + w) * kWin);
                int rank = n;
                unsigned nzq[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    bool nz = false;
#pragma unroll
                    for (int r = 0; r < kBlk; ++r)
                        nz = nz || pick(mv[r], q) != 0.0f;
                    nzq[q] = __ballot_sync(kFull, nz && base + q < n_x);
                    rank += __popc(nzq[q] & lt);
                    n += __popc(nzq[q]);
                }
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if ((nzq[q] >> lane) & 1u) {
                        lm[2 * rank] = make_float4(
                            pick(mv[0], q), pick(mv[1], q),
                            pick(mv[2], q), pick(mv[3], q));
                        lm[2 * rank + 1] = make_float4(
                            pick(mv[4], q), pick(mv[5], q),
                            pick(mv[6], q), pick(mv[7], q));
                        lx[rank] = static_cast<int>(base) + q;
                        ++rank;
                    }
                __syncwarp();   // the list is complete
            }
        },
        [&](int64_t o) { apply_list(o, n, true); });
}

template <typename T, int DS, int LW>
int run(const Forms& f, const int32_t* inv, int64_t n_out, const float* x,
        int64_t n_x, float* y, int d, cudaStream_t st) {
    static const int resident = resident_blocks(
        blockdense_matmat_kernel<T, DS, LW>, kThreads, kSmemBytes);
    if (resident <= 0) {
        const cudaError_t e = cudaGetLastError();
        return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
    }
    const int64_t need = (n_out + kWarps - 1) / kWarps;
    const int grid = static_cast<int>(need < resident ? need : resident);
    blockdense_matmat_kernel<T, DS, LW><<<grid, kThreads, kSmemBytes, st>>>(
        f, inv, n_out, x, n_x, y, d);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* const* m, const void* const* win_start,
           const int* caps, const int* starts, int n_buckets,
           const int32_t* inv, int64_t n_out, const float* x, int64_t n_x,
           float* y, int d, void* stream) {
    Forms f;
    if (!make_forms(m, win_start, caps, starts, n_buckets, f) || n_out <= 0
            || d <= 0 || n_x < 0 || n_x > INT32_MAX || n_out > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define B1_RUN(DS, LW) run<T, DS, LW>(f, inv, n_out, x, n_x, y, d, st)
    if (d <= 4) return B1_RUN(4, 1);
    if (d <= 8) return B1_RUN(4, 2);
    if (d <= 16) return B1_RUN(4, 4);
    if (d <= 32) return B1_RUN(4, 8);
    return B1_RUN(4, 16);
#undef B1_RUN
}

}  // namespace

extern "C" {

// One slab matvec: Y (n_out*8, d) f32 row-major <- the buckets' m[k]
// (nblk_k, 8, 128*caps[k]) f32 and window starts win_start[k] (nblk_k,
// caps[k]) against X (n_x, d) f32 row-major, rows from n_x on read as
// zero; output block o reads block inv[o] of the buckets laid end to end
// (bucket k's first block at starts[k], ascending), or block o of the
// one bucket where inv is NULL.  m, win_start, caps and starts are host
// arrays of n_buckets entries.  Returns cudaGetLastError() after the
// launch (0 on success).
int gmg_blockdense_matmat_f32(const void* const* m,
                              const void* const* win_start, const int* caps,
                              const int* starts, int n_buckets,
                              const int32_t* inv, int64_t n_out,
                              const float* x, int64_t n_x, float* y, int d,
                              void* stream) {
    return launch<float>(m, win_start, caps, starts, n_buckets, inv, n_out,
                         x, n_x, y, d, stream);
}

// The same with m in bf16.
int gmg_blockdense_matmat_bf16(const void* const* m,
                               const void* const* win_start, const int* caps,
                               const int* starts, int n_buckets,
                               const int32_t* inv, int64_t n_out,
                               const float* x, int64_t n_x, float* y, int d,
                               void* stream) {
    return launch<__nv_bfloat16>(m, win_start, caps, starts, n_buckets, inv,
                                 n_out, x, n_x, y, d, stream);
}

}  // extern "C"
