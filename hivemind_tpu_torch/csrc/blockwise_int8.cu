// Blockwise absmax int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces: hivemind_tpu/ops/pallas_quantization.py — `pallas_blockwise_quantize`
// (kernel body `_quantize_kernel`) and `pallas_blockwise_dequantize` (kernel body
// `_dequantize_kernel`). The plain PyTorch versions are
// hivemind_tpu_torch/ops/quantization.py; the wrappers are ops/blockwise_int8.py.
//
// What bounds it: bytes. Quantize reads 4 B and writes 1 B per element, with ~4
// operations per element; dequantize reads 1 B and writes 4 B. Both sit far below
// the H100's ~295 operations per byte, so the least time is the bytes over the
// memory rate.
//
// Design: one thread block of 256 threads per 4096-element quantization block.
// Each thread moves 16 elements as four 16-byte vector accesses, neighbouring
// threads on neighbouring addresses. Quantize keeps its 16 values in registers
// between the absmax reduction (warp shuffles, then 8 partials in shared memory)
// and the write of the codes, so the input is read from device memory exactly
// once. The TPU kernel took 32 rows per grid step to fill the (32, 128) int8
// tile; here many independent blocks in flight (11,008 for a 4096 x 11008
// weight) fill the 132 SMs instead.
//
// Bit-identity with jnp (hivemind_tpu/ops/quantization.py:32-42): the same
// operations in the same order, each rounded once in fp32 — scale = 127/absmax
// by IEEE division (never built with fast math), rintf (round half to even, as
// jnp.round; never roundf), then the clip; dequantize forms absmax/127 first and
// then multiplies.
//
// The window entry (hm_blockwise_dequantize_window) replaces no TPU kernel of its
// own: it is queue B row 5 on one shard of a tensor-parallel serving mesh
// (moe/server/mesh_backend.py), where the JAX package leaves the same cut to GSPMD.
// A 2-D weight is coded in flax [in, out] order, so a column-parallel shard (the
// columns [c0, c0 + cols) of every row) is strided, and at out = 11008 its
// 4096-element blocks straddle rows. The entry dequantizes a window of `rows` rows
// of `cols` codes, stored densely, whose element (i, j) is element
// base + i * row_stride + j of the whole tensor's flat codes: its scale is
// absmax[(base + i * row_stride + j) / 4096] / 127. Bytes bound it too (1 B in,
// 4 B out an element; absmax is 1/1024 of the codes and stays in L1/L2). Each
// thread dequantizes 4 neighbouring elements of one row (a char4 load and a float4
// store when `cols` is a multiple of 4, which every Llama width is) and looks up
// the scale of each; a block of 256 threads covers 1024 columns of one row, and
// the grid walks rows in its y dimension.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlockSize = 4096;
constexpr int kThreads = 256;
constexpr int kVectors = kBlockSize / (kThreads * 4);  // float4 accesses per thread: 4
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ signed char quantize_one(float x, float scale) {
    float r = rintf(x * scale);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    return static_cast<signed char>(static_cast<int>(r));
}

__device__ __forceinline__ float abs_max4(float4 v) {
    return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__global__ void __launch_bounds__(kThreads) quantize_kernel(
    const float* __restrict__ x, int8_t* __restrict__ codes, float* __restrict__ absmax) {
    const long long block = blockIdx.x;
    const float4* src = reinterpret_cast<const float4*>(x + block * kBlockSize);
    float4 values[kVectors];
    float local_max = 0.0f;
#pragma unroll
    for (int i = 0; i < kVectors; ++i) {
        values[i] = src[threadIdx.x + i * kThreads];
        local_max = fmaxf(local_max, abs_max4(values[i]));
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
        local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, offset));
    }
    __shared__ float warp_max[kWarps];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local_max;
    __syncthreads();
    float block_max = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) block_max = fmaxf(block_max, warp_max[w]);

    const float scale = block_max > 0.0f ? 127.0f / block_max : 0.0f;
    char4* dst = reinterpret_cast<char4*>(codes + block * kBlockSize);
#pragma unroll
    for (int i = 0; i < kVectors; ++i) {
        const float4 v = values[i];
        dst[threadIdx.x + i * kThreads] = make_char4(
            quantize_one(v.x, scale), quantize_one(v.y, scale),
            quantize_one(v.z, scale), quantize_one(v.w, scale));
    }
    if (threadIdx.x == 0) absmax[block] = block_max;
}

__global__ void __launch_bounds__(kThreads) dequantize_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ absmax, float* __restrict__ out) {
    const long long block = blockIdx.x;
    const float scale = absmax[block] / 127.0f;
    const char4* src = reinterpret_cast<const char4*>(codes + block * kBlockSize);
    float4* dst = reinterpret_cast<float4*>(out + block * kBlockSize);
#pragma unroll
    for (int i = 0; i < kVectors; ++i) {
        const char4 c = src[threadIdx.x + i * kThreads];
        dst[threadIdx.x + i * kThreads] = make_float4(
            static_cast<float>(c.x) * scale, static_cast<float>(c.y) * scale,
            static_cast<float>(c.z) * scale, static_cast<float>(c.w) * scale);
    }
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads) dequantize_window_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ absmax, float* __restrict__ out,
    long long rows, long long cols, long long row_stride, long long base) {
    const long long j = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
    if (j >= cols) return;
    for (long long i = blockIdx.y; i < rows; i += gridDim.y) {
        const long long at = i * cols + j;  // in the window
        const long long flat = base + i * row_stride + j;  // in the whole tensor
        if (kVector) {
            const char4 c = *reinterpret_cast<const char4*>(codes + at);
            float4 v;
            v.x = static_cast<float>(c.x) * (absmax[flat / kBlockSize] / 127.0f);
            v.y = static_cast<float>(c.y) * (absmax[(flat + 1) / kBlockSize] / 127.0f);
            v.z = static_cast<float>(c.z) * (absmax[(flat + 2) / kBlockSize] / 127.0f);
            v.w = static_cast<float>(c.w) * (absmax[(flat + 3) / kBlockSize] / 127.0f);
            *reinterpret_cast<float4*>(out + at) = v;
        } else {
            for (int e = 0; e < 4 && j + e < cols; ++e) {
                out[at + e] = static_cast<float>(codes[at + e]) * (absmax[(flat + e) / kBlockSize] / 127.0f);
            }
        }
    }
}

}  // namespace

// x: fp32 [n_blocks * 4096], 16-byte aligned -> codes int8 [n_blocks, 4096], absmax fp32 [n_blocks]
extern "C" int hm_blockwise_quantize(const float* x, int8_t* codes, float* absmax,
                                     long long n_blocks, cudaStream_t stream) {
    if (n_blocks <= 0) return 0;
    quantize_kernel<<<static_cast<unsigned int>(n_blocks), kThreads, 0, stream>>>(x, codes, absmax);
    return static_cast<int>(cudaGetLastError());
}

// codes int8 [n_blocks, 4096], absmax fp32 [n_blocks] -> out fp32 [n_blocks * 4096]
extern "C" int hm_blockwise_dequantize(const int8_t* codes, const float* absmax, float* out,
                                       long long n_blocks, cudaStream_t stream) {
    if (n_blocks <= 0) return 0;
    dequantize_kernel<<<static_cast<unsigned int>(n_blocks), kThreads, 0, stream>>>(codes, absmax, out);
    return static_cast<int>(cudaGetLastError());
}

// codes int8 [rows, cols], the window of a tensor's flat codes whose element (i, j)
// is flat element base + i * row_stride + j; absmax fp32, the whole tensor's
// -> out fp32 [rows, cols]. The vector path needs cols % 4 == 0 and 16-byte aligned
// codes and out (the wrapper checks both).
extern "C" int hm_blockwise_dequantize_window(const int8_t* codes, const float* absmax, float* out,
                                              long long rows, long long cols, long long row_stride,
                                              long long base, int vector, cudaStream_t stream) {
    if (rows <= 0 || cols <= 0) return 0;
    const long long column_blocks = (cols + kThreads * 4 - 1) / (kThreads * 4);
    if (column_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned int>(column_blocks),
                    static_cast<unsigned int>(rows < 65535 ? rows : 65535));
    if (vector) {
        dequantize_window_kernel<true><<<grid, kThreads, 0, stream>>>(codes, absmax, out, rows, cols, row_stride, base);
    } else {
        dequantize_window_kernel<false><<<grid, kThreads, 0, stream>>>(codes, absmax, out, rows, cols, row_stride, base);
    }
    return static_cast<int>(cudaGetLastError());
}
