// ELL product for Hopper (sm_90a), kernel E1: one launch applies one
// operator in padded ELL form (gravomg_tpu_torch/types.py::EllOperator)
// to x (V,) or (V, D), bound through a plain C interface and ctypes
// (gravomg_tpu_torch/ops/ell_cuda.py):
//
//   y[v, :] = diag[v] * x[v, :]
//           + sum over k with neighbors[v, k] != INVALID_INDEX
//                 of offdiag[v, k] * x[neighbors[v, k], :]
//
// f32 values, int32 neighbors, sums in f32.  A padding slot is skipped
// wherever it sits in its row (RAP'd levels may pad between real slots),
// not multiplied by x[0].
//
// Replaces no TPU kernel: the JAX package runs the ELL product through
// XLA (gravomg_tpu/solve/spmv.py), and its plain torch port
// (solve/spmv.py::spmv_plain) launches 8 to 12 operations a product and
// builds a (V, K) or (V, K, D) gather in device memory: 346 MB for L on
// a (100k, 36) block, every LOBPCG step.
//
// What bounds it: each slot's index read once (4 B; a padding slot is
// known by it), each real slot's value once (4 B), the diagonal, x once
// from device memory and y written once.  x's rows are gathered K times,
// but x is 0.4 to 14.4 MB at 100k and 4 MB at 1M, and Morton order keeps
// neighbours near: after first touch the gathers hit L1 or L2 (50 MB).
// A slot's index, then its value and x's row, are two dependent trips to
// memory, so every lane keeps several slots in flight, and the load
// instructions are few and wide:
//  * the table's slots are read `vk` at a time (4 as one int4 and one
//    float4 when K % 4 == 0 and the table is 16-byte aligned, else 1);
//    the values of a group of slots that is all padding are not read;
//  * D = 1: `lanes` lanes a row (a power of two, about K / 4: 8 for
//    K = 24 to 32), 32 / lanes rows a warp.  Lane j takes slots
//    [vk (i lanes + j), + vk) for i = 0, 1, ..., so a warp's load reads
//    whole sectors of consecutive rows; each lane sums its slots in
//    order, then a fixed butterfly of shuffles adds the group's partial
//    sums;
//  * D >= 2: `group` lanes a row, lanes over columns in 16-byte loads
//    where x and y are 16-byte aligned: 12 columns a lane (three float4)
//    where D % 12 == 0, so 1 lane a row at D = 12 and 3 at D = 36, else
//    4 where D % 4 == 0, else one column a lane; rows laid end to end
//    over the threads, so that no lane idles.  Each lane reads kSlots
//    slots of its row's table at a time (8, or 4 at 12 columns a lane
//    for registers), gathers their rows of x (kSlots loads in flight),
//    then sums its columns over the slots in slot order.  The fewer
//    lanes a row, the fewer copies of its table the lanes read.  More
//    than 32 lanes' worth of columns are tiled over blockIdx.y.
// Both are bitwise repeatable: each sum has a fixed order.  The lanes a
// row and the load widths follow D, K and the pointers' alignment, which
// the launcher reads from its arguments.
//
// Requirements: neighbors (V, K) int32, offdiag (V, K) f32, diag (V,)
// f32, x and y (V, D) f32, all contiguous (checked by the Python
// wrapper); a real slot's index lies in [0, V), which nothing checks per
// product (it would take a read back to the host): the port's builds
// make no other, and io/serialization.py checks tables read from files.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads of a thread block
constexpr int32_t kInvalid = 0x7fffffff;    // types.py::INVALID_INDEX
constexpr unsigned kFull = 0xffffffffu;

// Slots [s, s + VK) of a row: indices (kInvalid past k or padding) and
// values (0 where the index is kInvalid).  With VK = 4, s is a multiple
// of 4 and k % 4 == 0.
template <int VK>
__device__ __forceinline__ void load_slots(const int32_t* nrow,
                                           const float* vrow, int s, int k,
                                           int32_t* c, float* w);

template <>
__device__ __forceinline__ void load_slots<4>(const int32_t* nrow,
                                              const float* vrow, int s,
                                              int k, int32_t* c, float* w) {
    int4 t = make_int4(kInvalid, kInvalid, kInvalid, kInvalid);
    if (s < k) t = __ldg(reinterpret_cast<const int4*>(nrow + s));
    c[0] = t.x; c[1] = t.y; c[2] = t.z; c[3] = t.w;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t.x != kInvalid || t.y != kInvalid || t.z != kInvalid
            || t.w != kInvalid)
        v = __ldg(reinterpret_cast<const float4*>(vrow + s));
    w[0] = t.x != kInvalid ? v.x : 0.0f;
    w[1] = t.y != kInvalid ? v.y : 0.0f;
    w[2] = t.z != kInvalid ? v.z : 0.0f;
    w[3] = t.w != kInvalid ? v.w : 0.0f;
}

template <>
__device__ __forceinline__ void load_slots<1>(const int32_t* nrow,
                                              const float* vrow, int s,
                                              int k, int32_t* c, float* w) {
    c[0] = s < k ? __ldg(nrow + s) : kInvalid;
    w[0] = c[0] != kInvalid ? __ldg(vrow + s) : 0.0f;
}

// D = 1: `lanes` lanes a row over its slots, VK slots a load.
template <int VK>
__global__ void __launch_bounds__(kThreads)
ell_spmv_slots(const int32_t* __restrict__ nbr, const float* __restrict__ val,
               const float* __restrict__ diag, const float* __restrict__ x,
               float* __restrict__ y, int64_t n_rows, int k, int lanes) {
    const int lane = threadIdx.x & 31;
    const int j = lane & (lanes - 1);
    const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads
                          + threadIdx.x) >> 5;
    const int64_t row = warp * (32 / lanes) + lane / lanes;
    const bool live = row < n_rows;
    float acc = 0.0f;
    if (live) {
        const int32_t* nrow = nbr + row * k;
        const float* vrow = val + row * k;
        for (int s = j * VK; s < k; s += lanes * VK) {
            int32_t c[VK];
            float w[VK];
            load_slots<VK>(nrow, vrow, s, k, c, w);
            float xv[VK];
#pragma unroll
            for (int q = 0; q < VK; ++q)
                xv[q] = c[q] != kInvalid ? __ldg(x + c[q]) : 0.0f;
#pragma unroll
            for (int q = 0; q < VK; ++q)
                if (c[q] != kInvalid) acc = fmaf(w[q], xv[q], acc);
        }
    }
    // Every lane of the warp takes part: groups are aligned powers of two.
    for (int o = lanes >> 1; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o);
    if (live && j == 0)
        y[row] = __fadd_rn(__fmul_rn(__ldg(diag + row), __ldg(x + row)), acc);
}

template <int VEC>
struct Cols {
    float v[VEC];
    __device__ __forceinline__ void load(const float* p) {
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
            v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
        }
    }
    __device__ __forceinline__ void store(float* p) const {
#pragma unroll
        for (int i = 0; i < VEC; i += 4)
            *reinterpret_cast<float4*>(p + i) =
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
};

template <>
struct Cols<1> {
    float v[1];
    __device__ __forceinline__ void load(const float* p) { v[0] = __ldg(p); }
    __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};

// D >= 2: `group` lanes a row over its columns, VEC columns a lane,
// VK slots a load of the table, kSlots slots in flight; blockIdx.y is
// the tile of group * VEC columns.
template <int VEC, int VK, int kSlots = (VEC > 4 ? 4 : 8)>
__global__ void __launch_bounds__(kThreads)
ell_spmv_cols(const int32_t* __restrict__ nbr, const float* __restrict__ val,
              const float* __restrict__ diag, const float* __restrict__ x,
              float* __restrict__ y, int64_t n_rows, int k, int64_t d,
              int group) {
    static_assert(kSlots % VK == 0, "whole table loads a chunk of slots");
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x;
    const int64_t row = t / group;
    const int j = static_cast<int>(t - row * group);
    const int64_t col = (static_cast<int64_t>(blockIdx.y) * group + j) * VEC;
    if (row >= n_rows || col >= d) return;
    const int32_t* nrow = nbr + row * k;
    const float* vrow = val + row * k;

    Cols<VEC> acc;
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc.v[q] = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kSlots) {
        int32_t c[kSlots];
        float w[kSlots];
#pragma unroll
        for (int u = 0; u < kSlots; u += VK)
            load_slots<VK>(nrow, vrow, k0 + u, k, c + u, w + u);
        Cols<VEC> xv[kSlots];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
            if (c[u] != kInvalid) {
                xv[u].load(x + static_cast<int64_t>(c[u]) * d + col);
            } else {
#pragma unroll
                for (int q = 0; q < VEC; ++q) xv[u].v[q] = 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
            if (c[u] != kInvalid) {
#pragma unroll
                for (int q = 0; q < VEC; ++q)
                    acc.v[q] = fmaf(w[u], xv[u].v[q], acc.v[q]);
            }
        }
    }
    const float dv = __ldg(diag + row);
    Cols<VEC> xr;
    xr.load(x + row * d + col);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
        acc.v[q] = __fadd_rn(__fmul_rn(dv, xr.v[q]), acc.v[q]);
    acc.store(y + row * d + col);
}

struct Args {
    const int32_t* nbr;
    const float* val;
    const float* diag;
    const float* x;
    float* y;
    int64_t n_rows;
    int k;
    int64_t d;
    int group;
};

template <int VEC>
void launch_cols(dim3 grid, cudaStream_t st, bool vk4, const Args& a) {
    if (vk4)
        ell_spmv_cols<VEC, 4><<<grid, kThreads, 0, st>>>(
            a.nbr, a.val, a.diag, a.x, a.y, a.n_rows, a.k, a.d, a.group);
    else
        ell_spmv_cols<VEC, 1><<<grid, kThreads, 0, st>>>(
            a.nbr, a.val, a.diag, a.x, a.y, a.n_rows, a.k, a.d, a.group);
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch(const int32_t* nbr, const float* val, const float* diag,
           const float* x, float* y, int64_t n_rows, int k, int64_t d,
           void* stream) {
    if (n_rows <= 0 || d <= 0) return 0;
    if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vk4 = k % 4 == 0 && aligned16(nbr) && aligned16(val);
    if (d == 1) {
        int lanes = 1;                        // about K / 4, a power of two
        while (lanes < 32 && lanes * 4 < k) lanes <<= 1;
        const int64_t per_block = static_cast<int64_t>(kThreads / 32)
                                  * (32 / lanes);
        const dim3 grid(static_cast<unsigned>((n_rows + per_block - 1)
                                              / per_block));
        if (vk4)
            ell_spmv_slots<4><<<grid, kThreads, 0, st>>>(nbr, val, diag, x,
                                                         y, n_rows, k, lanes);
        else
            ell_spmv_slots<1><<<grid, kThreads, 0, st>>>(nbr, val, diag, x,
                                                         y, n_rows, k, lanes);
        return static_cast<int>(cudaGetLastError());
    }
    const bool vec4 = d % 4 == 0 && aligned16(x) && aligned16(y);
    const int vec = vec4 ? (d % 12 == 0 ? 12 : 4) : 1;
    const int64_t chunks = d / vec + (d % vec != 0);  // lanes the columns need
    const int group = chunks < 32 ? static_cast<int>(chunks) : 32;
    const int64_t tiles = (chunks + group - 1) / group;
    const int64_t blocks = (n_rows * group + kThreads - 1) / kThreads;
    if (tiles > 65535 || blocks > 0x7fffffff)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>(tiles));
    const Args a{nbr, val, diag, x, y, n_rows, k, d, group};
    if (vec == 12)
        launch_cols<12>(grid, st, vk4, a);
    else if (vec == 4)
        launch_cols<4>(grid, st, vk4, a);
    else
        launch_cols<1>(grid, st, vk4, a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (n_rows, d) f32 <- the ELL operator (neighbors (n_rows, k) int32,
// offdiag (n_rows, k) f32, diag (n_rows,) f32) on x (n_rows, d) f32, all
// contiguous; d = 1 for a 1-D x.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
int gmg_ell_spmv_f32(const int32_t* neighbors, const float* offdiag,
                     const float* diag, const float* x, float* y,
                     int64_t n_rows, int k, int64_t d, void* stream) {
    return launch(neighbors, offdiag, diag, x, y, n_rows, k, d, stream);
}

}  // extern "C"
