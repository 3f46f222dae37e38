// Shared by every kernel library of hivemind_tpu_torch: each .cu is built into its
// own shared library with a plain C interface (loaded with ctypes), and each
// library exports this helper so a Python wrapper can name a CUDA error code.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* hm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
