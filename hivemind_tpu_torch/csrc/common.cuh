// Shared by every kernel library of hivemind_tpu_torch: each .cu is built into its
// own shared library with a plain C interface (loaded with ctypes), and each
// library exports this helper so a Python wrapper can name a CUDA error code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

extern "C" const char* hm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Element conversions of the SIMT flash kernels, which read fp32, bf16 or fp16
// and compute in fp32: a load widens exactly, a store rounds to nearest even.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }

// The element types of the SIMT kernels, as the Python wrappers name them.
enum SimtDtype { kSimtF32 = 0, kSimtBf16 = 1, kSimtF16 = 2 };

// The padded widths the SIMT kernels are built for: a head_dim is computed at the
// least of these that holds it, its extra columns staged as zeros. `launch` has a
// member `template <int kD> int run() const`.
constexpr int kSimtMaxHeadDim = 256;

template <typename Launch>
int dispatch_simt_width(int head_dim, const Launch& launch) {
    if (head_dim <= 0 || head_dim > kSimtMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
    if (head_dim <= 32) return launch.template run<32>();
    if (head_dim <= 64) return launch.template run<64>();
    if (head_dim <= 96) return launch.template run<96>();
    if (head_dim <= 128) return launch.template run<128>();
    return launch.template run<256>();
}
