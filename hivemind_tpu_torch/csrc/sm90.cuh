// Hopper (sm_90a) building blocks shared by the bf16 flash kernels
// (flash_attention.cu, flash_attention_bwd.cu), written as inline PTX:
//  * mbarriers: init, arrive, arrive with an expected transaction byte count,
//    parity wait;
//  * 4-D tiled TMA loads that complete on an mbarrier, and the host-side encoding
//    of their tensor maps (cuTensorMapEncodeTiled, reached through the runtime's
//    driver entry point, so no -lcuda is needed);
//  * wgmma shared-memory descriptors for 128-byte-swizzled tiles, K-major and
//    MN-major;
//  * wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate, N in {64, 128}: A and B
//    from shared memory (SS, both K-major), or A from registers and B MN-major
//    (RS with the transpose-B immediate); fence / commit / wait;
//  * setmaxnreg, to move registers from the producer warpgroup to the consumers.
//
// Tile layout. A TMA box of 64 bf16 columns (128 bytes) x R rows, loaded with
// CU_TENSOR_MAP_SWIZZLE_128B, lands as R rows of 128 bytes whose 16-byte chunks
// are XOR-permuted by (row % 8): the canonical 128-byte-swizzled layout that
// wgmma reads. The box's shared-memory base must be 1024-byte aligned (8 rows,
// one swizzle period). A head_dim-128 tile is two such boxes, one after the other.
//  * K-major operand (rows = M or N, the 64 columns = K): a k16 step is 32 bytes
//    along the row; SBO = 1024 bytes (the next 8 rows); LBO is unused.
//  * MN-major operand (rows = K, the 64 columns = N): a k16 step is 16 rows
//    (2048 bytes); SBO = 1024 bytes (the next 8 k-rows); LBO = the distance to
//    the next 64-column box (N = 128 spans two).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

#include <cstdint>

namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kSwizzleRowBytes = 128;    // one row of a 64-column bf16 box
constexpr uint32_t kSwizzleAtomBytes = 1024;  // 8 rows: the swizzle period
constexpr int kBoxCols = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 2^x as one SFU instruction (ex2.approx.ftz: about 2 ulp; results below 2^-126
// flush to 0, far below what a bf16 probability keeps).
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
    return *reinterpret_cast<uint32_t*>(&pair);
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// Makes initialized barriers visible to the other threads and to the TMA unit.
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` more transaction bytes (from TMA) this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A fresh barrier is in
// phase 0, and the phase before it (parity 1) counts as complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

// ------------------------------------------------------------------ TMA

// Copy one box at coordinates (c0, c1, c2, c3), innermost first, into shared
// memory at `dst`; completion is counted in bytes on the mbarrier `bar`.
// Coordinates past the tensor's extent read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
        : "memory");
}

// The geometry of a [B, T, H, D] bf16 tensor as the wrapper computes it
// (hivemind_tpu_torch/ops/flash_attention.py, tma_geometry): dims (D, H, T, B),
// innermost first; byte strides of H, T and B; the box (64, 1, rows, 1).
struct TmaGeometry {
    long long dims[4];
    long long strides[3];
    long long box[4];
};

// Encode the tensor map of `base` with `geometry`, whose box must be 64 columns
// by `rows` rows of a head_dim-`head_dim` tensor. Returns a cudaError_t.
inline int encode_tma_map(CUtensorMap* map, const void* base, const TmaGeometry& geometry, int rows, int head_dim) {
    static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (found != cudaDriverEntryPointSuccess || fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
        encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }
    if (geometry.dims[0] != head_dim || geometry.box[0] != kBoxCols || geometry.box[1] != 1 ||
        geometry.box[2] != rows || geometry.box[3] != 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cuuint64_t dims[4], strides[3];
    cuuint32_t box[4], element_strides[4] = {1, 1, 1, 1};
    for (int i = 0; i < 4; ++i) {
        dims[i] = static_cast<cuuint64_t>(geometry.dims[i]);
        box[i] = static_cast<cuuint32_t>(geometry.box[i]);
    }
    for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(geometry.strides[i]);
    const CUresult result = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                                   box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return result == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a 128-byte-swizzled operand at shared address `addr` (start
// address, LBO and SBO in 16-byte units; layout type 1 = 128-byte swizzle).
// Adding (bytes >> 4) to a descriptor moves its start address by `bytes`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
           (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
    return desc_sw128(addr, 16, kSwizzleAtomBytes);
}

// `box_bytes`: the distance between the operand's 64-column boxes.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t box_bytes) {
    return desc_sw128(addr, box_bytes, kSwizzleAtomBytes);
}

// Orders register writes before the wgmmas that read them (accumulators, A fragments).
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of `regs` across the wgmma
// fence and wait: an asynchronous wgmma's results exist only after its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&regs)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(regs[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&regs)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(regs[i][j])::"memory");
    }
}

// Accumulator layout of m64nN (per thread, per warp w of the warpgroup, lane =
// 4g + t): d[4c + e] holds row 16w + g + 8*(e >> 1), column 8c + 2t + (e & 1).
// That is the register layout of an m64k16 A operand, so a score tile becomes
// the A operand of the next product by packing pairs to bf16: for k-step kc,
// a = {d[8kc..8kc+1], d[8kc+2..+3], d[8kc+4..+5], d[8kc+6..+7]}.

// d (+)= A[64 x 16] * B[16 x N], A and B K-major in shared memory (scale_d = 0: d = A*B).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A[64 x 16] * B[16 x N], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


// ------------------------------------------------------------------ named barriers

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a multiple of 32:
// sync waits for all of them, arrive counts this warp in and goes on.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ setmaxnreg

// Each warpgroup role calls one of these first, in a branch that never rejoins
// the other role's (else ptxas ignores it: warning C7508).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace sm90
