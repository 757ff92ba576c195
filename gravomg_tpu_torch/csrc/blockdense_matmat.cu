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
//  * One launch for all buckets of a form.  The buckets' base pointers,
//    caps and first concatenated block go in one parameter struct (at
//    most 12 buckets); each output block finds its bucket through
//    inv_block_perm and writes Y in row order, so no concatenation and
//    no un-permutation pass follows.  X is read where it lies, unpadded:
//    a window position past X's rows counts as zero, as the zero padding
//    did.
//  * A persistent grid of one thread block an SM (12 consumer warps, one
//    producer warp).  Thread block i of G takes output blocks i, i + G,
//    i + 2G, ... in rounds of 12, block j of a round being warp j's; lane
//    j locates block j, so a round costs one dependent load of
//    inv_block_perm, not 12.  Neighbouring blocks have similar caps, so
//    every warp gets the same mix of caps (no sort needed), and at any
//    time the grid works on one band of consecutive rows, whose X windows
//    overlap in L2.
//  * m streamed by cp.async.bulk into a 112 KB byte ring in shared
//    memory, one full and one empty mbarrier a chunk, with an L2
//    evict-first hint (m is read once; the X rows are read again).  A
//    block's m is contiguous (8 x 128*cap entries), so a block of up to
//    32 KB (cap 8 in f32, 16 in bf16: 99.4% of the 1M level-0 blocks) is
//    one chunk and one bulk copy; a larger block is cut into chunks of
//    32 KB of windows, 8 row copies each.  The producer warp places each
//    chunk where the last ended, skips the ring's tail when a chunk
//    would cross it, and reclaims chunks oldest first as their warps
//    release them; each consumer warp recomputes the placement while
//    walking the same chunks.  A warp may reach its chunk g before the
//    chunk g - kChunks of the same barrier slot has landed (a round of
//    12 blocks can hold more than kChunks chunks), and a parity wait that
//    far ahead would return at once.  So the producer writes g into the
//    slot's sequence word once it has reclaimed the slot, and a warp
//    waits for that word before it waits on the slot's barrier.
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
//    evict-first hint it takes 0.615 / 0.514 ms at D = 3 (f32 / bf16 m)
//    and 0.909 / 0.875 ms at D = 64.  At D = 64 the X rows, about 1.6 GB
//    through L2 (nearly m's bytes again), now set the pace.
//
// Requirements (checked by the Python wrapper): 8-row blocks, window
// starts multiples of 128; m, win_start, inv and X contiguous, m and X
// 16-byte aligned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kBlk = 8;                 // rows of a block
constexpr int kWin = 128;               // columns of a window
constexpr int kWarps = 12;              // consumer warps of a thread block
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int kRingBytes = 112 * 1024;  // m ring of the thread block
constexpr int kChunkMax = 32 * 1024;    // largest chunk of m in the ring
constexpr int kChunks = 32;             // chunks in flight at most
constexpr int kList = 256;              // list entries of one warp
constexpr int kMaxBuckets = 12;
constexpr int kSmemBytes = kRingBytes + kWarps * kList * 36
                           + kChunks * (2 * 8 + 4 + 4);
constexpr unsigned kFull = 0xffffffffu;
// A wait that outlasts this many clock cycles (about two seconds) means
// a copy was lost: trap, so that the caller sees an error, not a hang.
constexpr long long kSpinLimit = 4000000000LL;

struct Forms {
    const void* m[kMaxBuckets];
    const int32_t* win_start[kMaxBuckets];
    int cap[kMaxBuckets];
    int start[kMaxBuckets];     // first concatenated block of the bucket
    int n_buckets;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - t0 > kSpinLimit) __trap();
}

// Wait until the producer has given barrier slot `seq` to chunk g.
__device__ __forceinline__ void seq_wait(const volatile uint32_t* seq,
                                         uint32_t g) {
    if (*seq != g) {
        const long long t0 = clock64();
        while (*seq != g)
            if (clock64() - t0 > kSpinLimit) __trap();
    }
    __threadfence_block();
}

// 1-D bulk copy global -> shared, completing on an mbarrier, its lines
// first out of L2 (m is read once; the X rows it would evict are read
// again).  Source, destination and size are multiples of 16 bytes.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
        : "memory");
}

// Four consecutive entries of a row of m in shared memory, as f32.
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__bfloat162float(lo.x), __bfloat162float(lo.y),
                       __bfloat162float(hi.x), __bfloat162float(hi.y));
}

__device__ __forceinline__ float pick(const float4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Output block o's place: bucket k and block b within it.
__device__ __forceinline__ void locate(const Forms& f,
                                       const int32_t* __restrict__ inv,
                                       int64_t o, int& k, int64_t& b) {
    const int c = inv != nullptr ? __ldg(inv + o) : static_cast<int>(o);
    k = 0;
#pragma unroll
    for (int i = 1; i < kMaxBuckets; ++i)
        if (i < f.n_buckets && c >= f.start[i]) k = i;
    b = c - f.start[k];
}

// Lane j < kWarps of a warp: bucket k, block b and cap of output block
// o (cap 0 past the end); the other lanes cap 0.
__device__ __forceinline__ void locate_round(const Forms& f,
                                             const int32_t* __restrict__ inv,
                                             int64_t o, int64_t n_out, int lane,
                                             int& k, int64_t& b, int& cap) {
    k = 0;
    b = 0;
    cap = 0;
    if (lane < kWarps && o < n_out) {
        locate(f, inv, o, k, b);
        cap = f.cap[k];
    }
}

// Sums of the warp's slots (the lane bits from MASK down to STOP) by
// reduce-scatter: K values a lane in, max(K / slots, 1) out, in a fixed
// order.  A lane keeps the upper half where its bit is set.
template <int K, int MASK, int STOP>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
    if constexpr (MASK >= STOP) {
        if constexpr (K > 1) {
            const bool hi = (lane & MASK) != 0;
#pragma unroll
            for (int i = 0; i < K / 2; ++i) {
                const float send = hi ? v[i] : v[i + K / 2];
                const float keep = hi ? v[i + K / 2] : v[i];
                v[i] = keep + __shfl_xor_sync(kFull, send, MASK);
            }
            reduce_scatter<K / 2, MASK / 2, STOP>(v, lane);
        } else {
            v[0] += __shfl_xor_sync(kFull, v[0], MASK);
            reduce_scatter<1, MASK / 2, STOP>(v, lane);
        }
    }
}

// A block's chunks: windows [w0, w0 + n) of its cap, n = the chunk's
// window count (the whole block when it fits in kChunkMax bytes).
template <typename T>
__device__ __forceinline__ int chunk_windows(int cap, int w0) {
    constexpr int kMaxWin = kChunkMax / (kBlk * kWin * static_cast<int>(sizeof(T)));
    const int per = cap <= kMaxWin ? cap : kMaxWin;
    return cap - w0 < per ? cap - w0 : per;
}

// Where a chunk of `bytes` goes in the ring after the one that ended at
// `head`: at `head`, or at 0 when it would cross the ring's end.
__device__ __forceinline__ uint32_t ring_place(uint32_t head, uint32_t bytes) {
    return head + bytes > static_cast<uint32_t>(kRingBytes) ? 0u : head;
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
    constexpr uint32_t kWinBytes = kBlk * kWin * sizeof(T);
    static_assert(kAcc >= kLanesSlots, "a lane ends with whole sums");
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* ring = smem;
    float4* lm0 = reinterpret_cast<float4*>(smem + kRingBytes);
    int* lx0 = reinterpret_cast<int*>(lm0 + kWarps * kList * 2);
    uint64_t* full = reinterpret_cast<uint64_t*>(lx0 + kWarps * kList);
    uint64_t* empty = full + kChunks;
    uint32_t* held = reinterpret_cast<uint32_t*>(empty + kChunks);
    volatile uint32_t* seq = held + kChunks;   // chunk a slot was given to
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int i = 0; i < kChunks; ++i) {
            mbar_init(smem_addr(full + i), 1);
            mbar_init(smem_addr(empty + i), 1);
            seq[i] = 0xffffffffu;
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // The walk goes by rounds of kWarps output blocks, block j of a round
    // (o = r0 + j * stride) being warp j's; lane j of every warp locates
    // block j, so a round costs one dependent load, not kWarps.
    const int64_t stride = gridDim.x;
    const int64_t span = stride * kWarps;

    if (warp == kWarps) {
        // Producer: the thread block's chunks in order into the ring,
        // each where the last one ended; a chunk's bytes (and any tail
        // skipped before it) are held until its warp releases it, and
        // reclaimed oldest first.  The whole warp runs this bookkeeping
        // in step and lane 0 alone issues the copies, so no lane waits
        // apart from the others (see "Why so" at the top).
        uint32_t head = 0, used = 0;
        int64_t g = 0, oldest = 0;
        for (int64_t r0 = blockIdx.x; r0 < n_out; r0 += span) {
            int kj, capj;
            int64_t bj;
            locate_round(f, inv, r0 + lane * stride, n_out, lane, kj, bj, capj);
            for (int j = 0; j < kWarps; ++j) {
                const int cap = __shfl_sync(kFull, capj, j);
                const int k = __shfl_sync(kFull, kj, j);
                const int64_t b = __shfl_sync(kFull, bj, j);
                if (cap == 0) break;
                const int64_t nww = static_cast<int64_t>(cap) * kWin;
                const T* mb = static_cast<const T*>(f.m[k]) + b * kBlk * nww;
                for (int w0 = 0; w0 < cap;) {
                    const int nwc = chunk_windows<T>(cap, w0);
                    const uint32_t bytes = nwc * kWinBytes;
                    const uint32_t at = ring_place(head, bytes);
                    const uint32_t need =
                        bytes + (at != head ? kRingBytes - head : 0);
                    while (g - oldest >= kChunks || kRingBytes - used < need) {
                        const int c = static_cast<int>(oldest % kChunks);
                        mbar_wait(smem_addr(empty + c), (oldest / kChunks) & 1);
                        used -= held[c];
                        ++oldest;
                    }
                    const int c = static_cast<int>(g % kChunks);
                    held[c] = need;
                    used += need;
                    head = at + bytes;
                    const uint32_t bar = smem_addr(full + c);
                    if (lane == 0) {
                        __threadfence_block();
                        seq[c] = static_cast<uint32_t>(g);
                        mbar_expect_tx(bar, bytes);
                        if (nwc == cap) {
                            bulk_copy(smem_addr(ring + at), mb, bytes, bar);
                        } else {
                            const uint32_t row = nwc * kWin * sizeof(T);
#pragma unroll
                            for (int r = 0; r < kBlk; ++r)
                                bulk_copy(smem_addr(ring + at + r * row),
                                          mb + r * nww
                                          + static_cast<int64_t>(w0) * kWin,
                                          row, bar);
                        }
                    }
                    w0 += nwc;
                    ++g;
                }
            }
        }
        return;
    }

    // Consumer warp `warp`: block i of the thread block's walk is warp
    // i % kWarps's.  Every warp walks all chunks to know where each one
    // lies in the ring (the producer's placement, recomputed).
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
    auto consume = [&](int64_t o, int n, bool last) {
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

    uint32_t head = 0;
    int64_t g = 0;
    for (int64_t r0 = blockIdx.x; r0 < n_out; r0 += span) {
        int kj, capj;
        int64_t bj;
        locate_round(f, inv, r0 + lane * stride, n_out, lane, kj, bj, capj);
        for (int j = 0; j < kWarps; ++j) {
            const int cap = __shfl_sync(kFull, capj, j);
            const int k = __shfl_sync(kFull, kj, j);
            const int64_t b = __shfl_sync(kFull, bj, j);
            if (cap == 0) break;
            const bool mine = j == warp;
            const int64_t o = r0 + j * stride;
            // Lane w < 32 holds the start of window w; windows from 32 on
            // (an operator built with more than 32) read theirs from ws.
            const int32_t* ws = f.win_start[k] + b * cap;
            int wsv = 0;
            int n = 0;
            if (mine) {
                if (lane < cap) wsv = __ldg(ws + lane);
#pragma unroll
                for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;
                flushed = false;
            }
            for (int w0 = 0; w0 < cap;) {
                const int nwc = chunk_windows<T>(cap, w0);
                const uint32_t bytes = nwc * kWinBytes;
                const uint32_t at = ring_place(head, bytes);
                head = at + bytes;
                if (mine) {
                    const int c = static_cast<int>(g % kChunks);
                    seq_wait(seq + c, static_cast<uint32_t>(g));
                    mbar_wait(smem_addr(full + c), (g / kChunks) & 1);
                    const T* chunk =
                        reinterpret_cast<const T*>(ring + at) + 4 * lane;
                    for (int w = 0; w < nwc; ++w) {
                        if (n > kList - kWin) {
                            consume(o, n, false);
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
                    if (lane == 0) mbar_arrive(smem_addr(empty + c));
                }
                w0 += nwc;
                ++g;
            }
            if (mine) consume(o, n, true);
        }
    }
}

// Blocks the card holds at once: occupancy times SM count, or 0 on error.
template <typename T, int DS, int LW>
int resident_blocks() {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(blockdense_matmat_kernel<T, DS, LW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess
            || cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess
            || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, blockdense_matmat_kernel<T, DS, LW>, kThreads,
                   kSmemBytes) != cudaSuccess)
        return 0;
    return per_sm * sms;
}

template <typename T, int DS, int LW>
int run(const Forms& f, const int32_t* inv, int64_t n_out, const float* x,
        int64_t n_x, float* y, int d, cudaStream_t st) {
    static const int resident = resident_blocks<T, DS, LW>();
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
    if (n_buckets <= 0 || n_buckets > kMaxBuckets || n_out <= 0 || d <= 0
            || n_x < 0 || n_x > INT32_MAX || n_out > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    Forms f;
    for (int k = 0; k < kMaxBuckets; ++k) {
        const int j = k < n_buckets ? k : n_buckets - 1;
        if (caps[j] <= 0 || starts[j] < 0 || (j > 0 && starts[j] < starts[j - 1]))
            return static_cast<int>(cudaErrorInvalidValue);
        f.m[k] = m[j];
        f.win_start[k] = static_cast<const int32_t*>(win_start[j]);
        f.cap[k] = caps[j];
        f.start[k] = starts[j];
    }
    f.n_buckets = n_buckets;
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
