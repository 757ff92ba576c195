// Transposed-tile SpMV for Hopper (sm_90a), one launch per slab matvec,
// bound through a plain C interface and ctypes
// (gravomg_tpu_torch/ops/mxu_cuda.py).
//
// Replaces the TPU kernel `_mxu_kernel` of
// gravomg_tpu/ops/pallas_blockdense.py (launched by `mxu_matvec_pallas`,
// once per bucket of a slab form).  For 128-row block b of a bucket with
// NSEG segments of 128 columns, stored as tiles
// mt[b, s, l, r] = A[b*128 + r, win_start[b, s] + l]:
//
//   y[b*128 + r] = sum_s sum_l rnd(x[win_start[b, s] + l]) * mt[b, s, l, r]
//
// where rnd rounds x to mt's type (as the Pallas kernel does before its
// dot), and the sum is taken in f32.  The escape chute and the diagonal
// are added by the caller, as the TPU kernel's caller adds them.
//
// What bounds it: bytes.  Each tile element is used for exactly one
// multiply-add with one right-hand side, about 0.5 operation per byte in
// bf16 against the ~295 at which the tensor cores become the limit, so
// the tensor cores buy nothing for this GEMV and the kernel uses CUDA
// cores.  f32 tiles stay exact f32 (FFMA, no TF32): CG's own matvec runs
// on the f32 form.  For bf16 tiles the products of bf16-rounded x and
// bf16 m are exact in f32.
//
// What the design does about it: keep the memory system full for the
// whole matvec, whatever the sizes of the buckets.
//
//  * One launch for all buckets of a slab form.  The buckets' arrays are
//    read where they lie (a table of at most 12 base pointers, passed by
//    value); a device table of work items, built once per form
//    (ops/mxu_cuda.py::mxu_plan), names per item the bucket, the block,
//    a range of segments [s0, s1) and where the 128 sums go.  Blocks of
//    many segments are cut into several items of at most 4 tiles, so no
//    item is much longer than the rest; items are ordered longest first.
//  * A persistent grid: as many blocks as the card holds at once
//    (occupancy times the SM count, both read from the device), block i
//    taking items i, i + G, i + 2G, ...: the same order of work in every
//    run, and a small level fills the card as far as its bytes allow.
//  * A ring of 3 chunks of 32 KB in shared memory (64 tile rows in f32,
//    128 in bf16, so both types keep the same bytes in flight), each
//    filled by one 1-D bulk asynchronous copy (cp.async.bulk) of
//    contiguous tile rows plus one of the matching slice of x, both
//    completing on the chunk's mbarrier.  One thread starts the copies
//    and runs 3 chunks ahead of the consumers across item boundaries, so
//    an item's first bytes are under way before the previous item ends
//    and nothing waits for a gather of x.
//  * Consumers read the chunk from shared memory with each thread on 4
//    consecutive r (16-byte f32, 8-byte bf16 reads), the 8 warps
//    splitting the rows; x is rounded to mt's type as it is read.  At an
//    item's end the warps' sums are added in warp order.
//  * A fixed order of summation and no float atomics: an item of a block
//    that was not cut writes y directly (in row order: the item names
//    the original block, so no un-permutation pass follows); the items
//    of a cut block write their sums to a scratch row each, and a short
//    second kernel in the same call adds a block's rows in part order.
//    A scratch buffer and a second kernel were chosen over a thread
//    block cluster that reads the sums through distributed shared
//    memory: a cluster would have to hold all items of one block at
//    once, which ties the cut to the cluster size and breaks the
//    fixed-stride walk of a persistent grid; the scratch rows cost 0.4%
//    of the bytes.  Two runs on one input give bitwise the same y.
//
// Requirements (checked by the Python wrapper): win_start holds
// multiples of 128 and x is zero-padded so every segment reads in
// bounds; every mt is contiguous and 16-byte aligned, xp 16-byte
// aligned; the item and split tables are int32 (N, 4), contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kChunkBytes = 32768;          // tile bytes of one stage
constexpr int kTile = 128 * 128;            // elements of one tile
constexpr int kMaxBuckets = 12;
// Shared memory: the ring's tile chunks, their x slices, two buffers for
// the reduction over the warps, the ring's barriers.
constexpr int kSmemBytes = kStages * kChunkBytes + kStages * 128 * 4
                           + 2 * kWarps * 128 * 4 + kStages * 8;
// A wait that outlasts this many clock cycles (about two seconds) means
// a copy was lost: trap, so that the caller sees an error, not a hang.
constexpr long long kSpinLimit = 4000000000LL;

struct Buckets {
    const void* mt[kMaxBuckets];
    const int32_t* win_start[kMaxBuckets];
    int nseg[kMaxBuckets];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
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

// 1-D bulk copy global -> shared, completing on an mbarrier.  Source,
// destination and size are multiples of 16 bytes.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void load4(const float* p, float out[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
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

// A block's place in its list of chunks: item `item` (a row of the item
// table: bucket, block, s0 | s1 << 16, destination), segment `seg` of
// it, chunk `sub` of that segment's tile.  `next` holds the row of the
// item after this one, fetched an item ahead.
struct Cursor {
    int item, seg, sub;
    int4 d, next;
};

__device__ __forceinline__ void cursor_start(Cursor& c, const int4* items,
                                             int n_items, int first,
                                             int stride) {
    c.item = first;
    c.sub = 0;
    c.seg = 0;
    c.d = make_int4(0, 0, 0, 0);
    if (first < n_items) {
        c.d = __ldg(items + first);
        c.seg = c.d.z & 0xffff;
    }
    c.next = c.d;
    if (first + stride < n_items) c.next = __ldg(items + first + stride);
}

template <int kPerTile>
__device__ __forceinline__ void cursor_advance(Cursor& c, const int4* items,
                                               int n_items, int stride) {
    if (++c.sub < kPerTile) return;
    c.sub = 0;
    if (++c.seg < (c.d.z >> 16)) return;
    c.item += stride;
    c.d = c.next;
    c.seg = c.d.z & 0xffff;
    if (c.item + stride < n_items) c.next = __ldg(items + c.item + stride);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mxu_slab_kernel(const __grid_constant__ Buckets bk, const int4* __restrict__ items,
                int n_items, const float* __restrict__ xp,
                float* __restrict__ y, float* __restrict__ scratch) {
    constexpr int kRows = kChunkBytes / (128 * static_cast<int>(sizeof(T)));
    constexpr int kPerTile = 128 / kRows;     // chunks of one tile
    constexpr int kChunkElems = kRows * 128;
    extern __shared__ __align__(128) unsigned char smem[];
    T* tiles = reinterpret_cast<T*>(smem);
    float* xs = reinterpret_cast<float*>(smem + kStages * kChunkBytes);
    float* red = xs + kStages * 128;
    uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * kWarps * 128);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int first = blockIdx.x;
    const int stride = gridDim.x;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(bars + s), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Thread 0 starts the copies of chunk c + kStages once chunk c has
    // been consumed; `pc` is its place in the list, `cc` the consumers'.
    Cursor pc, cc;
    cursor_start(cc, items, n_items, first, stride);
    pc = cc;
    auto fetch = [&](int stage) {
        const int k = pc.d.x;
        const int64_t seg = static_cast<int64_t>(pc.d.y) * bk.nseg[k] + pc.seg;
        const int32_t start = __ldg(bk.win_start[k] + seg);
        const T* src = static_cast<const T*>(bk.mt[k]) + seg * kTile
                       + pc.sub * kChunkElems;
        const uint32_t bar = smem_addr(bars + stage);
        mbar_expect_tx(bar, kChunkBytes + kRows * 4);
        bulk_copy(smem_addr(tiles + stage * kChunkElems), src, kChunkBytes,
                  bar);
        bulk_copy(smem_addr(xs + stage * 128), xp + start + pc.sub * kRows,
                  kRows * 4, bar);
        cursor_advance<kPerTile>(pc, items, n_items, stride);
    };
    if (threadIdx.x == 0)
        for (int s = 0; s < kStages && pc.item < n_items; ++s) fetch(s);

    int stage = 0, done = 0;
    uint32_t parity = 0;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    while (cc.item < n_items) {
        mbar_wait(smem_addr(bars + stage), parity);
        const T* tile = tiles + stage * kChunkElems + 4 * lane;
        const float* xv = xs + stage * 128;
#pragma unroll
        for (int q = 0; q < kRows / kWarps; ++q) {
            const int row = warp + q * kWarps;
            float mv[4];
            load4(tile + row * 128, mv);
            const float x = round_to(xv[row], tile);
            a0 = fmaf(mv[0], x, a0);
            a1 = fmaf(mv[1], x, a1);
            a2 = fmaf(mv[2], x, a2);
            a3 = fmaf(mv[3], x, a3);
        }
        // The same for every thread of the block.
        const bool last = cc.sub == kPerTile - 1
                          && cc.seg == (cc.d.z >> 16) - 1;
        const int dst = cc.d.w;
        float* r = red + (done & 1) * (kWarps * 128);
        if (last) {
            *reinterpret_cast<float4*>(r + warp * 128 + 4 * lane) =
                make_float4(a0, a1, a2, a3);
            a0 = a1 = a2 = a3 = 0.0f;
        }
        __syncthreads();            // the stage is free; `r` is complete
        if (threadIdx.x == 0 && pc.item < n_items) fetch(stage);
        if (last) {
            // Warps 4-7 add the warps' sums in warp order.  `r` is
            // written again two items on, at least one barrier later.
            if (threadIdx.x >= 128) {
                const int t = threadIdx.x - 128;
                float s = 0.0f;
#pragma unroll
                for (int w = 0; w < kWarps; ++w) s += r[w * 128 + t];
                float* out = dst >= 0
                    ? y + static_cast<int64_t>(dst) * 128
                    : scratch + static_cast<int64_t>(-dst - 1) * 128;
                out[t] = s;
            }
            ++done;
        }
        cursor_advance<kPerTile>(cc, items, n_items, stride);
        if (++stage == kStages) {
            stage = 0;
            parity ^= 1u;
        }
    }
}

// y[out*128 + t] = scratch[first] + scratch[first + 1] + ... in part
// order, for each cut block (a row of the split table: out block, first
// scratch row, parts).
__global__ void __launch_bounds__(kThreads)
mxu_combine_kernel(const int4* __restrict__ splits, int n_splits,
                   const float* scratch, float* __restrict__ y) {
    const int i = blockIdx.x * (kThreads / 128) + (threadIdx.x >> 7);
    const int t = threadIdx.x & 127;
    if (i >= n_splits) return;
    const int4 s = __ldg(splits + i);
    const float* p = scratch + static_cast<int64_t>(s.y) * 128 + t;
    float acc = p[0];
    for (int q = 1; q < s.z; ++q) acc += p[q * 128];
    y[static_cast<int64_t>(s.x) * 128 + t] = acc;
}

// Blocks the card holds at once: occupancy times SM count, or 0 on error.
template <typename T>
int resident_blocks() {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(mxu_slab_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess
            || cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess
            || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, mxu_slab_kernel<T>, kThreads, kSmemBytes)
                   != cudaSuccess)
        return 0;
    return per_sm * sms;
}

template <typename T>
int launch(const void* const* mt, const void* const* win_start,
           const int* nseg, int n_buckets, const void* items, int n_items,
           const void* splits, int n_splits, const float* xp, float* y,
           float* scratch, void* stream) {
    if (n_buckets <= 0 || n_buckets > kMaxBuckets || n_items <= 0
            || n_splits < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    static const int resident = resident_blocks<T>();
    if (resident <= 0) {
        const cudaError_t e = cudaGetLastError();
        return static_cast<int>(e != cudaSuccess ? e
                                                 : cudaErrorInvalidValue);
    }
    Buckets bk;
    for (int k = 0; k < kMaxBuckets; ++k) {
        const int j = k < n_buckets ? k : 0;
        if (nseg[j] <= 0) return static_cast<int>(cudaErrorInvalidValue);
        bk.mt[k] = mt[j];
        bk.win_start[k] = static_cast<const int32_t*>(win_start[j]);
        bk.nseg[k] = nseg[j];
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = n_items < resident ? n_items : resident;
    mxu_slab_kernel<T><<<grid, kThreads, kSmemBytes, st>>>(
        bk, static_cast<const int4*>(items), n_items, xp, y, scratch);
    if (n_splits > 0) {
        const int per_block = kThreads / 128;
        mxu_combine_kernel<<<(n_splits + per_block - 1) / per_block,
                             kThreads, 0, st>>>(
            static_cast<const int4*>(splits), n_splits, scratch, y);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One slab matvec: y (n_out*128,) f32 <- the buckets' tiles mt[k]
// (nblk_k, nseg_k, 128, 128) f32 and window starts win_start[k] against
// padded x, by the item table (n_items, 4) and the split table
// (n_splits, 4), both int32 on the device; scratch holds one row of 128
// floats per item of a cut block.  mt, win_start and nseg are host
// arrays of n_buckets entries.  Returns cudaGetLastError() after the
// launches (0 on success).
int gmg_mxu_slab_matvec_f32(const void* const* mt,
                            const void* const* win_start, const int* nseg,
                            int n_buckets, const void* items, int n_items,
                            const void* splits, int n_splits,
                            const float* xp, float* y, float* scratch,
                            void* stream) {
    return launch<float>(mt, win_start, nseg, n_buckets, items, n_items,
                         splits, n_splits, xp, y, scratch, stream);
}

// The same with mt in bf16 (x rounded to bf16 before the products).
int gmg_mxu_slab_matvec_bf16(const void* const* mt,
                             const void* const* win_start, const int* nseg,
                             int n_buckets, const void* items, int n_items,
                             const void* splits, int n_splits,
                             const float* xp, float* y, float* scratch,
                             void* stream) {
    return launch<__nv_bfloat16>(mt, win_start, nseg, n_buckets, items,
                                 n_items, splits, n_splits, xp, y, scratch,
                                 stream);
}

}  // extern "C"
