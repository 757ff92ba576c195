// The m ring shared by the block-window kernels K1
// (blockdense_matvec.cu, one right-hand side) and B1
// (blockdense_matmat.cu, D of them): the buckets of an 8-row slab form in
// one launch, m streamed once by cp.async.bulk into a byte ring in shared
// memory on mbarriers, one producer warp and kWarps consumer warps in a
// persistent grid.
//
//  * The buckets' base pointers, caps and first concatenated block go in
//    one parameter struct (Forms, at most 12 buckets); each output block o
//    finds its bucket through inv_block_perm (identity for one bucket).
//  * Thread block i of G takes output blocks i, i + G, i + 2G, ... in
//    rounds of kWarps, block j of a round being warp j's; lane j locates
//    block j, so a round costs one load of inv_block_perm, not kWarps,
//    and that load is issued two rounds ahead of its use (a consumer also
//    learns its block of the next round, whose window starts it can load
//    early).  Neighbouring blocks have similar caps, so every warp gets
//    the same mix of caps, and at any time the grid works on one band of
//    consecutive rows, whose x windows overlap in L2.
//  * A block's m is contiguous (8 x 128*cap entries), so a block of up to
//    kChunkMax bytes is one chunk and one bulk copy; a larger block is cut
//    into chunks of windows, 8 row copies each.  The copies carry an L2
//    evict-first hint: m is read once, x again and again.
//  * The producer warp allocates: it places each chunk where the last
//    ended, skips the ring's tail when a chunk would cross it, reclaims
//    chunks oldest first as their warps release them, and publishes a
//    chunk's offset and number in its slot.  A warp may reach its chunk g
//    before chunk g - kChunks of the same slot has been released (a round
//    can hold more than kChunks chunks), and a parity wait that far ahead
//    would return at once: so the slot's sequence word, written once the
//    slot is reclaimed, says which chunk holds it.
//  * Each consumer warp copies its own chunks: it finds them by a warp
//    scan of the round's chunk counts, issues a chunk's bulk copy once the
//    chunk is allocated, and issues its next chunk (the next of its block,
//    or the first of its block in the next round) as soon as that one is
//    allocated too, before it waits for the current one.  The bulk copies
//    one warp issues are served about one at a time (one warp streaming
//    copies of 2 KB reads 0.74 TB/s, of 4 KB 1.48, of 8 KB 2.93; four
//    warps 2.9-3.2 TB/s at each of these sizes: probes/bulk_copy.py,
//    NVIDIA H100 80GB HBM3 at 700 W), so the copies of blocks of a few KB,
//    as most are, must come from many warps.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace gmg_ring {

constexpr int kBlk = 8;                 // rows of a block
constexpr int kWin = 128;               // columns of a window
constexpr int kMaxBuckets = 12;
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

// Forms from the host arrays of n_buckets entries (unused entries repeat
// the last bucket); false on a count, cap or start the kernels refuse.
inline bool make_forms(const void* const* m, const void* const* win_start,
                       const int* caps, const int* starts, int n_buckets,
                       Forms& f) {
    if (n_buckets <= 0 || n_buckets > kMaxBuckets) return false;
    for (int k = 0; k < kMaxBuckets; ++k) {
        const int j = k < n_buckets ? k : n_buckets - 1;
        if (caps[j] <= 0 || starts[j] < 0
                || (j > 0 && starts[j] < starts[j - 1]))
            return false;
        f.m[k] = m[j];
        f.win_start[k] = static_cast<const int32_t*>(win_start[j]);
        f.cap[k] = caps[j];
        f.start[k] = starts[j];
    }
    f.n_buckets = n_buckets;
    return true;
}

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
// first out of L2.  Source, destination and size are multiples of 16
// bytes.
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

// An output block's place: o, its bucket k, its block b in the bucket
// and the bucket's cap (0: no block).
struct Block {
    int64_t o;
    int k;
    int64_t b;
    int cap;
};

// Block c of the buckets laid end to end (c < 0: none) as (k, b, cap).
__device__ __forceinline__ void place_block(const Forms& f, int c, int& k,
                                            int64_t& b, int& cap) {
    k = 0;
    b = 0;
    cap = 0;
    if (c < 0) return;
#pragma unroll
    for (int i = 1; i < kMaxBuckets; ++i)
        if (i < f.n_buckets && c >= f.start[i]) k = i;
    b = c - f.start[k];
    cap = f.cap[k];
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

// Barrier slots of the ring, after it in shared memory: a full and an
// empty mbarrier, the bytes a chunk holds, the chunk a slot was given to
// and that chunk's offset in the ring (kChunks each).
struct Slots {
    uint64_t* full;
    uint64_t* empty;
    uint32_t* held;
    volatile uint32_t* seq;
    volatile uint32_t* at;
};

// The ring of one kernel: kWarps consumer warps (a round of output
// blocks), a ring of kRingBytes, chunks of at most kChunkMax bytes, at
// most kChunks of them in flight; m of type T.
template <typename T, int kWarps_, int kRingBytes_, int kChunkMax_,
          int kChunks_>
struct Ring {
    static constexpr int kWarps = kWarps_;
    static constexpr int kThreads = 32 * (kWarps + 1);
    static constexpr int kRingBytes = kRingBytes_;
    static constexpr int kChunkMax = kChunkMax_;
    static constexpr int kChunks = kChunks_;
    static constexpr int kSlotBytes = kChunks * (2 * 8 + 3 * 4);
    static constexpr uint32_t kWinBytes = kBlk * kWin * sizeof(T);
    static constexpr int kMaxWin = kChunkMax / static_cast<int>(kWinBytes);
    static_assert(kWarps <= 32, "lane j locates block j of a round");
    static_assert(kMaxWin >= 1, "a chunk holds a window at least");
    // A chunk placed at the ring's start after a skipped tail holds at
    // most kRingBytes: that needs two chunks of room.
    static_assert(kRingBytes % 16 == 0 && kRingBytes >= 2 * kChunkMax,
                  "a ring of two chunks at least");

    // The slots at `p` (8-byte aligned); thread 0 initialises them, and
    // the caller then syncs the thread block.
    __device__ static Slots slots(unsigned char* p) {
        Slots s;
        s.full = reinterpret_cast<uint64_t*>(p);
        s.empty = s.full + kChunks;
        s.held = reinterpret_cast<uint32_t*>(s.empty + kChunks);
        s.seq = s.held + kChunks;
        s.at = s.seq + kChunks;
        return s;
    }

    __device__ static void init(const Slots& s) {
        if (threadIdx.x == 0) {
            for (int i = 0; i < kChunks; ++i) {
                mbar_init(smem_addr(s.full + i), 1);
                mbar_init(smem_addr(s.empty + i), 1);
                s.seq[i] = 0xffffffffu;
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
    }

    // Lane j < kWarps: block j of the round that starts at r0, as the
    // concatenated block inv[o] (o itself without inv), or -1 past the end
    // and on the other lanes.  Loaded two rounds ahead of its use, so the
    // walk never waits for inv_block_perm.
    __device__ __forceinline__ static int load_round(
            const int32_t* __restrict__ inv, int64_t r0, int64_t n_out,
            int lane) {
        const int64_t o = r0 + lane * static_cast<int64_t>(gridDim.x);
        if (lane >= kWarps || o >= n_out) return -1;
        return inv != nullptr ? __ldg(inv + o) : static_cast<int>(o);
    }

    // Block j of a round held by lane j (place_block's k, b, cap).
    __device__ __forceinline__ static Block block_of(int64_t r0, int j,
                                                     int k, int64_t b,
                                                     int cap) {
        Block blk;
        blk.o = r0 + j * static_cast<int64_t>(gridDim.x);
        blk.k = __shfl_sync(kFull, k, j);
        blk.b = __shfl_sync(kFull, b, j);
        blk.cap = __shfl_sync(kFull, cap, j);
        return blk;
    }

    // A block's chunks: windows [w0, w0 + n) of its cap, n = the chunk's
    // window count (the whole block when it fits in kChunkMax bytes).
    __device__ __forceinline__ static int chunk_windows(int cap, int w0) {
        const int per = cap <= kMaxWin ? cap : kMaxWin;
        return cap - w0 < per ? cap - w0 : per;
    }

    // Where a chunk of `bytes` goes in the ring after the one that ended
    // at `head`: at `head`, or at 0 when it would cross the ring's end.
    __device__ __forceinline__ static uint32_t place(uint32_t head,
                                                     uint32_t bytes) {
        return head + bytes > static_cast<uint32_t>(kRingBytes) ? 0u : head;
    }

    // The producer warp: allocates the thread block's chunks in order in
    // the ring; a chunk's bytes (and any tail skipped before it) are held
    // until its warp releases it, and reclaimed oldest first.
    __device__ static void produce(const Forms& f,
                                   const int32_t* __restrict__ inv,
                                   int64_t n_out, const Slots& s, int lane) {
        const int64_t span = static_cast<int64_t>(gridDim.x) * kWarps;
        uint32_t head = 0, used = 0;
        int64_t g = 0, oldest = 0;
        int c0 = load_round(inv, blockIdx.x, n_out, lane);
        int c1 = load_round(inv, blockIdx.x + span, n_out, lane);
        for (int64_t r0 = blockIdx.x; r0 < n_out; r0 += span) {
            int kj, capj;
            int64_t bj;
            place_block(f, c0, kj, bj, capj);
            c0 = c1;
            c1 = load_round(inv, r0 + 2 * span, n_out, lane);
            for (int j = 0; j < kWarps; ++j) {
                const int cap = __shfl_sync(kFull, capj, j);
                if (cap == 0) break;
                for (int w0 = 0; w0 < cap;) {
                    const int nwc = chunk_windows(cap, w0);
                    const uint32_t bytes = nwc * kWinBytes;
                    const uint32_t at = place(head, bytes);
                    const uint32_t need =
                        bytes + (at != head ? kRingBytes - head : 0);
                    while (g - oldest >= kChunks || kRingBytes - used < need) {
                        const int c = static_cast<int>(oldest % kChunks);
                        mbar_wait(smem_addr(s.empty + c),
                                  (oldest / kChunks) & 1);
                        used -= s.held[c];
                        ++oldest;
                    }
                    const int c = static_cast<int>(g % kChunks);
                    s.held[c] = need;
                    used += need;
                    head = at + bytes;
                    if (lane == 0) {
                        s.at[c] = at;
                        __threadfence_block();
                        s.seq[c] = static_cast<uint32_t>(g);
                    }
                    w0 += nwc;
                    ++g;
                }
            }
        }
    }

    // Lane 0 arms chunk h's slot and copies windows [w0, w0 + nwc) of
    // block blk into its place in the ring (one copy for a whole block,
    // one a row otherwise).  The chunk must be allocated (seq = h).
    __device__ __forceinline__ static void issue(
            const Forms& f, const unsigned char* ring, const Slots& s,
            int lane, int64_t h, const Block& blk, int w0, int nwc) {
        if (lane != 0) return;
        const int c = static_cast<int>(h % kChunks);
        const uint32_t at = s.at[c];
        const uint32_t bytes = nwc * kWinBytes;
        const uint32_t bar = smem_addr(s.full + c);
        const int64_t nww = static_cast<int64_t>(blk.cap) * kWin;
        const T* mb = static_cast<const T*>(f.m[blk.k]) + blk.b * kBlk * nww;
        mbar_expect_tx(bar, bytes);
        if (nwc == blk.cap) {
            bulk_copy(smem_addr(ring + at), mb, bytes, bar);
        } else {
            const uint32_t row = nwc * kWin * sizeof(T);
#pragma unroll
            for (int r = 0; r < kBlk; ++r)
                bulk_copy(smem_addr(ring + at + r * row),
                          mb + r * nww + static_cast<int64_t>(w0) * kWin,
                          row, bar);
        }
    }

    // Consumer warp `warp`: for its output block of each round (block j
    // of the round is warp j's) calls
    //   begin(blk, next)              when its block blk starts (next: its
    //                                 block of the next round, cap 0 if
    //                                 none),
    //   prefetch(w0, nwc)             before it waits for a chunk,
    //   chunk(bytes, o, w0, nwc)      once the chunk is in shared memory
    //                                 (windows [w0, w0 + nwc), row r's
    //                                 window w at entry (r*nwc + w)*128),
    //   end(o)                        after its last chunk;
    // the chunk is released after `chunk` returns.  The round's chunks are
    // numbered in block order, as the producer allocates them: a warp's
    // first is the round's first plus the chunks of the blocks before its
    // own.
    template <class Begin, class Prefetch, class Chunk, class End>
    __device__ __forceinline__ static void consume(
            const Forms& f, const int32_t* __restrict__ inv, int64_t n_out,
            const unsigned char* ring, const Slots& s, int warp, int lane,
            Begin&& begin, Prefetch&& prefetch, Chunk&& chunk, End&& end) {
        const int64_t span = static_cast<int64_t>(gridDim.x) * kWarps;
        // This warp's first chunk in the round of a lane's blocks, and the
        // round's chunk count: a warp scan of the lanes' chunk counts.
        auto first_chunk = [&](int cap, int64_t& g_round) {
            const int nch = (cap + kMaxWin - 1) / kMaxWin;
            int upto = nch;                 // chunks of lanes 0..lane
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int v = __shfl_up_sync(kFull, upto, d);
                if (lane >= d) upto += v;
            }
            const int64_t g = g_round + __shfl_sync(kFull, upto - nch, warp);
            g_round += __shfl_sync(kFull, upto, 31);
            return g;
        };
        int64_t issued = -1;                // the last chunk it issued
        // Issue chunk h now if it is allocated (and not issued yet).
        auto try_issue = [&](int64_t h, const Block& blk, int w0) {
            if (h > issued && s.seq[h % kChunks] == static_cast<uint32_t>(h)) {
                __threadfence_block();
                issue(f, ring, s, lane, h, blk, w0, chunk_windows(blk.cap, w0));
                issued = h;
            }
        };
        int64_t g_round = 0;
        int c0 = load_round(inv, blockIdx.x, n_out, lane);
        int c1 = load_round(inv, blockIdx.x + span, n_out, lane);
        int kj, capj;
        int64_t bj;
        place_block(f, c0, kj, bj, capj);
        int64_t g = first_chunk(capj, g_round);
        for (int64_t r0 = blockIdx.x; r0 < n_out; r0 += span) {
            int kn, capn;
            int64_t bn;
            place_block(f, c1, kn, bn, capn);
            c1 = load_round(inv, r0 + 2 * span, n_out, lane);
            const int64_t g_next = first_chunk(capn, g_round);
            const Block blk = block_of(r0, warp, kj, bj, capj);
            const Block next = block_of(r0 + span, warp, kn, bn, capn);
            if (blk.cap > 0) {
                begin(blk, next);
                for (int w0 = 0; w0 < blk.cap; ++g) {
                    const int nwc = chunk_windows(blk.cap, w0);
                    prefetch(w0, nwc);
                    const int c = static_cast<int>(g % kChunks);
                    if (g > issued) {
                        seq_wait(s.seq + c, static_cast<uint32_t>(g));
                        issue(f, ring, s, lane, g, blk, w0, nwc);
                        issued = g;
                    }
                    if (w0 + nwc < blk.cap)
                        try_issue(g + 1, blk, w0 + nwc);
                    else if (next.cap > 0)
                        try_issue(g_next, next, 0);
                    mbar_wait(smem_addr(s.full + c), (g / kChunks) & 1);
                    chunk(ring + s.at[c], blk.o, w0, nwc);
                    __syncwarp();           // every lane is done with it
                    if (lane == 0) mbar_arrive(smem_addr(s.empty + c));
                    w0 += nwc;
                }
                end(blk.o);
            }
            kj = kn;
            bj = bn;
            capj = capn;
            g = g_next;
        }
    }
};

// Blocks of `kernel` the card holds at once: occupancy times SM count,
// or 0 on error.
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, int smem_bytes) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes) != cudaSuccess
            || cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess
            || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, kernel, threads, smem_bytes) != cudaSuccess)
        return 0;
    return per_sm * sms;
}

}  // namespace gmg_ring
