// Probe program (not a kernel of the port): how fast cp.async.bulk, the
// copy with which the ring of block_ring.cuh streams m, moves device
// memory into shared memory, by copy size and by the number of warps that
// issue the copies.  Each of W warps of a thread block (one an SM)
// streams its share of a 1 GiB buffer in copies of S bytes through D
// slots of its own, each an mbarrier; D = min(16, 200 KB / (W * S)), and
// a (S, W) with no room for D = 1 is left out.
// Prints one line a (S, W): "S W D ms".  Built and run by
// gravomg_tpu_torch/probes/bulk_copy.py.

#include <cstdint>
#include <cstdio>

#include "block_ring.cuh"

namespace {

using namespace gmg_ring;

constexpr int kSlotMax = 16;
constexpr int kBufBytes = 200 * 1024;
constexpr int kBarBytes = 32 * 8 * kSlotMax;
constexpr int64_t kTotal = int64_t{1} << 30;

__global__ void bulk_copy_probe(const char* __restrict__ src, int bytes,
                                int slots, float* sink) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int warps = blockDim.x / 32;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * kSlotMax;
    unsigned char* buf = smem + kBarBytes
                         + static_cast<int64_t>(warp) * slots * bytes;
    if (lane == 0) {
        for (int d = 0; d < slots; ++d) mbar_init(smem_addr(bars + d), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    const int64_t copies = kTotal / bytes;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * warps + warp;
    auto start = [&](int64_t i, int64_t n) {
        const int d = static_cast<int>(n % slots);
        const uint32_t bar = smem_addr(bars + d);
        if (lane == 0) {
            mbar_expect_tx(bar, bytes);
            bulk_copy(smem_addr(buf + static_cast<int64_t>(d) * bytes),
                      src + i * bytes, bytes, bar);
        }
    };
    int64_t issued = 0;
    for (int64_t i = first; i < copies && issued < slots; i += stride)
        start(i, issued++);
    float acc = 0.0f;
    int64_t next = first + issued * stride;
    int64_t done = 0;
    for (int64_t i = first; i < copies; i += stride, ++done) {
        const int d = static_cast<int>(done % slots);
        mbar_wait(smem_addr(bars + d), (done / slots) & 1);
        acc += reinterpret_cast<const float*>(
            buf + static_cast<int64_t>(d) * bytes)[lane];
        __syncwarp();
        if (next < copies) {
            start(next, issued++);
            next += stride;
        }
    }
    if (acc == 1234.5f) sink[0] = acc;    // keeps the reads
}

int fail(cudaError_t e) {
    std::fprintf(stderr, "bulk-copy probe: %s\n", cudaGetErrorString(e));
    return 1;
}

}  // namespace

int main() {
    char* src = nullptr;
    float* sink = nullptr;
    int sms = 0;
    cudaError_t e = cudaMalloc(&src, kTotal);
    if (e == cudaSuccess) e = cudaMalloc(&sink, sizeof(float));
    if (e == cudaSuccess) e = cudaMemset(src, 0, kTotal);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(bulk_copy_probe,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBarBytes + kBufBytes);
    if (e != cudaSuccess) return fail(e);
    cudaEvent_t t0, t1;
    cudaEventCreate(&t0);
    cudaEventCreate(&t1);
    const int sizes[] = {2048, 4096, 8192, 16384};
    const int warps[] = {1, 2, 4, 8, 16};
    for (int bytes : sizes) {
        for (int w : warps) {
            int slots = kBufBytes / (w * bytes);
            slots = slots > kSlotMax ? kSlotMax : slots;
            if (slots < 1) continue;            // no room for one copy each
            const int smem = kBarBytes + w * slots * bytes;
            float best = 1e30f;
            for (int rep = 0; rep < 6; ++rep) {
                cudaEventRecord(t0);
                bulk_copy_probe<<<sms, 32 * w, smem>>>(src, bytes, slots, sink);
                cudaEventRecord(t1);
                if ((e = cudaEventSynchronize(t1)) != cudaSuccess) return fail(e);
                float ms = 0.0f;
                cudaEventElapsedTime(&ms, t0, t1);
                if (rep > 0 && ms < best) best = ms;      // rep 0 warms up
            }
            if ((e = cudaGetLastError()) != cudaSuccess) return fail(e);
            std::printf("%d %d %d %.6f\n", bytes, w, slots, best);
        }
    }
    return 0;
}
