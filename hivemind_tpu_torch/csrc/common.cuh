// Shared by every kernel library of hivemind_tpu_torch: each .cu is built into its
// own shared library with a plain C interface (loaded with ctypes), and each
// library exports this helper so a Python wrapper can name a CUDA error code.
#pragma once

#include <cuda.h>  // CUtensorMapDataType (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// A source whose kernels take long to compile is built from several translation units at
// once (ops/_build.py's PARTS): each is compiled with -DHM_PART=<i> and keeps only the entry
// points that the source assigns to part i (HM_IN_PART(i)), so it instantiates only their
// kernels; nvcc then links the parts into the one library. Without HM_PART a source is whole.
#ifdef HM_PART
#define HM_IN_PART(i) (HM_PART == (i))
#else
#define HM_IN_PART(i) 1
#endif

#if HM_IN_PART(0)
extern "C" const char* hm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

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

// The element types of the flash kernels, as the Python wrappers name them: the
// SIMT kernels take all three, the wgmma kernels bf16 and fp16.
enum SimtDtype { kSimtF32 = 0, kSimtBf16 = 1, kSimtF16 = 2 };

// Whether a head_dim is read through the packed-heads view (heads * head_dim columns
// a row) rather than the 4-D view, whose head stride of 2 * head_dim bytes TMA takes
// only as a multiple of 16.
inline bool packed_heads(int head_dim) { return head_dim % 8 != 0; }

// The columns a wgmma tile of one head spans: head_dim in the 4-D view; in the
// packed-heads view head_dim plus the most columns any head's boxes start before it
// (TMA takes only a start column that is a multiple of 8, so head h's boxes start
// (h * head_dim) % 8 columns early: sm90::head_shift). The kernels pad it to 64, 128
// or 256.
inline int tma_span(int head_dim, int heads) {
    int shift = 0;
    for (int h = 1; packed_heads(head_dim) && h < heads && h < 8; ++h) {
        shift = h * head_dim % 8 > shift ? h * head_dim % 8 : shift;
    }
    return head_dim + shift;
}

// What the wgmma kernels (every pass) take: bf16 or fp16 at a head_dim from 16 to 256
// that TMA can read: a multiple of 8 (the 4-D view), or any other whose heads *
// head_dim is a multiple of 8 and whose span is at most 256 (the packed-heads view).
inline bool wgmma_takes(int dtype, int head_dim, int heads) {
    if (!((dtype == kSimtBf16 || dtype == kSimtF16) && head_dim >= 16 && head_dim <= 256)) return false;
    if (!packed_heads(head_dim)) return true;
    return static_cast<long long>(heads) * head_dim % 8 == 0 && tma_span(head_dim, heads) <= 256;
}

// What the copied-rows view of the wgmma forward and dK/dV pass takes (every 16-bit input
// that no TMA view does): bf16 or fp16 at a head_dim from 1 to 256, and a shift modulus of
// 2, 4, 8 or 16 bytes (sm90::copied_shift).
inline bool copied_takes(int dtype, int head_dim, int modulus) {
    return (dtype == kSimtBf16 || dtype == kSimtF16) && head_dim >= 1 && head_dim <= 256 &&
           (modulus == 2 || modulus == 4 || modulus == 8 || modulus == 16);
}

// The columns a copied-rows tile spans: head_dim plus the largest shift of any block
// (sm90::copied_shift of its head's row 0 of q, at byte strides sb and sh). b * sb and h * sh
// modulo a modulus of at most 16 bytes repeat within 8 steps (the strides are even), so the
// first 8 batches and heads show every shift.
inline int copied_span(const void* q, long long sb, long long sh, int batch, int heads, int head_dim, int modulus) {
    int shift = 0;
    for (int b = 0; b < batch && b < 8; ++b) {
        for (int h = 0; h < heads && h < 8; ++h) {
            const unsigned long long row0 = reinterpret_cast<unsigned long long>(q) + b * sb + h * sh;
            const int s = static_cast<int>(row0 & static_cast<unsigned long long>(modulus - 1)) / 2;
            shift = s > shift ? s : shift;
        }
    }
    return head_dim + shift;
}

// What the 3xTF32 kernels (every fp32 pass) take: fp32 at a head_dim from 16
// to 128 that is a multiple of 4, so a head's row is whole 16-byte chunks.
inline bool tf32x3_takes(int dtype, int head_dim) {
    return dtype == kSimtF32 && head_dim >= 16 && head_dim <= 128 && head_dim % 4 == 0;
}

inline CUtensorMapDataType tma_type(int dtype) {
    return dtype == kSimtF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

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
