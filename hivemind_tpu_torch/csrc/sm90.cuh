// Hopper (sm_90a) building blocks shared by the wgmma flash kernels
// (flash_attention.cu, flash_attention_bwd.cu), written as inline PTX:
//  * mbarriers: init, arrive, arrive with an expected transaction byte count,
//    parity wait;
//  * 4-D tiled TMA loads that complete on an mbarrier, and the host-side encoding
//    of their tensor maps (cuTensorMapEncodeTiled, reached through the runtime's
//    driver entry point, so no -lcuda is needed), for bf16 or fp16;
//  * wgmma shared-memory descriptors for 128-byte-swizzled tiles, K-major and
//    MN-major;
//  * wgmma.mma_async m64nNk16, bf16 or fp16 in (the element type is a template
//    argument), fp32 accumulate: A and B from shared memory (SS, both K-major,
//    N in {32, 64, 128}), or A from registers and B MN-major (RS with the
//    transpose-B immediate, N in {64, 128, 256}); fence / commit / wait;
//  * setmaxnreg, to move registers from the producer warpgroup to the consumers;
//  * cp.async of one head's bytes of a packed-heads tensor into a swizzled tile,
//    completing on an mbarrier (load_head_row); the same for a row of any even alignment
//    (the copied-rows view: load_head_row<true>, with copied_shift; a row 2 bytes off the
//    tile's words by aligned 4-byte loads and byte permutes, copy_row_permuted);
//  * 3xTF32 for fp32 inputs: the TF32 hi / lo split, wgmma m64nNk8 .tf32 (SS with both
//    operands K-major, N in {16, 32, 64}; RS with A from registers, N in {64, 128}), the A
//    fragment taken from an accumulator without register moves (tf32_a_fragment,
//    tf32_k_slot), and a producer thread's 16-byte loads of fp32 rows split and stored into
//    swizzled tiles, as they stand or transposed (Tf32RowLoader). An fp32 tile uses the same
//    128-byte-swizzled regions as a 16-bit box, 32 columns a region, and a k8 step is 32 bytes
//    along a K-major row, as a k16 step is for 16-bit types.
//
// Tile layout. A TMA box of 64 16-bit columns (128 bytes) x R rows, loaded with
// CU_TENSOR_MAP_SWIZZLE_128B, lands as R rows of 128 bytes whose 16-byte chunks
// are XOR-permuted by (row % 8): the canonical 128-byte-swizzled layout that
// wgmma reads. The box's shared-memory base must be 1024-byte aligned (8 rows,
// one swizzle period). A tile of padded width Dp (64, 128 or 256) is Dp / 64
// such regions, one after the other. bf16 and fp16 are both 2 bytes, so they
// share every layout, descriptor and box. A head_dim below Dp reads its columns
// past head_dim as zeros (TMA's out-of-bounds fill), which add nothing to a
// product. In the packed-heads view (a head_dim that is not a multiple of 8, see
// TmaGeometry) a head's columns start head_shift columns into the tile, and the
// columns around them hold the neighbouring heads' values; a kernel zeroes those in
// the tiles it keeps resident (zero_columns), and fills the tiles it streams with the
// head's bytes alone (load_head_row, by cp.async), so no neighbour's value meets a
// product. In the copied-rows view (a 16-bit tensor no TMA view takes) a kernel fills
// every tile so (load_head_row<true>), the head at column copied_shift, from rows of any
// even alignment.
//  * K-major operand (rows = M or N, the 64 columns = K): a k16 step is 32 bytes
//    along the row; SBO = 1024 bytes (the next 8 rows); LBO is unused.
//  * MN-major operand (rows = K, the 64 columns = N): a k16 step is 16 rows
//    (2048 bytes); SBO = 1024 bytes (the next 8 k-rows); LBO = the distance to
//    the next 64-column region (N = 128 spans two, N = 256 four).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

#include <cstdint>
#include <type_traits>

namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kSwizzleRowBytes = 128;    // one row of a 64-column 16-bit box
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

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// Two floats rounded to nearest even as a pair of T (bf16 or fp16), `lo` in the
// low 16 bits: an A-operand register, or two neighbouring columns of a row.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    if constexpr (kIsHalf<T>) {
        __half2 pair = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&pair);
    } else {
        __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&pair);
    }
}

// Zero `bytes` (a multiple of 16) of shared memory from `addr`, the block's
// threads striding by 16 bytes. A region that wgmma reads afterwards needs
// fence_proxy_async() and a barrier between.
__device__ __forceinline__ void zero_shared(uint32_t addr, uint32_t bytes) {
    for (uint32_t off = threadIdx.x * 16; off < bytes; off += blockDim.x * 16) {
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                     ::"r"(addr + off), "r"(0), "r"(0), "r"(0), "r"(0) : "memory");
    }
}

// Zero columns [col_begin, col_end) of the first `rows` rows of a tile in the
// 128-byte-swizzled layout at `tile`, whose 64-column regions lie `region_bytes`
// apart: a 16-byte chunk wholly inside by one vector store at its swizzled place
// (chunk ^ row % 8), a chunk holding either end by 2-byte stores. Thread `thread` of
// `threads` takes every threads-th (row, chunk), neighbouring threads on neighbouring
// rows (8 rows fill the 32 banks). A tile that wgmma reads afterwards needs
// fence_proxy_async() and a barrier between.
__device__ __forceinline__ void zero_columns(uint32_t tile, uint32_t region_bytes, int rows, int col_begin, int col_end,
                                             int thread, int threads) {
    const int chunk0 = col_begin / 8, chunks = (col_end + 7) / 8 - chunk0;
    for (int i = thread; i < rows * chunks; i += threads) {
        const int row = i % rows, chunk = chunk0 + i / rows;
        const uint32_t addr = tile + (chunk / 8) * region_bytes + row * kSwizzleRowBytes + (((chunk % 8) ^ (row % 8)) * 16);
        if (chunk * 8 >= col_begin && chunk * 8 + 8 <= col_end) {
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                         ::"r"(addr), "r"(0), "r"(0), "r"(0), "r"(0) : "memory");
        } else {
            for (int col = max(col_begin, chunk * 8); col < min(col_end, chunk * 8 + 8); ++col) {
                asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr + 2 * (col % 8)),
                             "h"(static_cast<unsigned short>(0)) : "memory");
            }
        }
    }
}

// Zero the columns of a packed-heads tile (as zero_columns) around its head's, [shift,
// shift + head_dim), up to `width`, the columns TMA loaded.
__device__ __forceinline__ void zero_around_head(uint32_t tile, uint32_t region_bytes, int rows, int shift, int head_dim,
                                                 int width, int thread, int threads) {
    zero_columns(tile, region_bytes, rows, 0, shift, thread, threads);
    zero_columns(tile, region_bytes, rows, shift + head_dim, width, thread, threads);
}

// Orders this thread's generic shared-memory writes before the async proxy's
// (TMA, wgmma) accesses; after an mbarrier wait, also the writes that wait made visible
// (cp.async's and other threads' plain stores) before this thread's wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ------------------------------------------------------------------ cp.async

// Copy kBytes (16, 8 or 4) from global `src` to shared `dst`, both aligned to kBytes, or
// write kBytes of zeros where `valid` is false (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
    const int src_bytes = valid ? kBytes : 0;
    if constexpr (kBytes == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(kBytes), "r"(src_bytes)
                     : "memory");
    }
}

// Copy `bytes` (2, or 0 where the row is not valid) from global `src` to shared `dst`, both
// 4-byte aligned, and zero the rest of the 4 bytes at `dst`.
__device__ __forceinline__ void cp_async_zfill4(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

// An arrival on the mbarrier `bar` once every cp.async this thread issued before it has
// landed. The barrier's pending count is raised by one now, so the thread's own
// mbar_arrive is what counts it among the barrier's arrivals.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The shared address of byte x of row r of a 128-byte-swizzled tile whose 64-column regions lie
// region_bytes apart (dst_row: the row's address in region 0).
__device__ __forceinline__ uint32_t swizzled_byte(uint32_t dst_row, uint32_t region_bytes, int r, int x) {
    return dst_row + (x / 128) * region_bytes + ((((x / 16) % 8) ^ (r % 8)) * 16) + x % 16;
}

// The copied-rows view (a 16-bit [B, T, H, D] tensor that no TMA view takes): the column a block's
// head lands at in its tiles, (address of the head's row 0 of q) mod `modulus` bytes, halved. Every
// row of the head is congruent to row 0 modulo `modulus` (the wrapper takes it from the row
// stride), so each of q's rows is copied by pieces as wide as the modulus; the wrapper narrows it
// where the shift would carry the head into a wider tile (ops/flash_attention.py, copy_plan).
__device__ __forceinline__ int copied_shift(const void* row0, int modulus) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(row0) & static_cast<uintptr_t>(modulus - 1)) / 2;
}

// Tile bytes [first, last) of row r (dst_row: its address in region 0) from a source `src`
// (where tile byte 0 would lie) that is 2 bytes off the tile's 4-byte words: each tile word at
// x takes the upper half of the aligned source word at src + x - 2 and the lower half of the
// next (a byte permute), so the row is read as aligned 4-byte words, kWords tile words (kWords
// + 1 loads) in flight at a time. A half outside [first, last) is stored as zero (the tile's
// own), and a source word that holds none of the head's bytes is not read. `valid` false:
// zeros.
__device__ __forceinline__ void copy_row_permuted(uint32_t dst_row, uint32_t region_bytes, const char* src, int first,
                                                  int last, int r, bool valid) {
    constexpr int kWords = 8;  // 16 spilled in the producer's 40 registers
    const unsigned int* words = reinterpret_cast<const unsigned int*>(src - 2);  // words[i]: tile bytes [4i - 2, 4i + 2)
    const int x0 = first & ~3, x1 = (last + 3) & ~3;
    for (int x = x0; x < x1; x += 4 * kWords) {
        unsigned int w[kWords + 1];
#pragma unroll
        for (int i = 0; i <= kWords; ++i) {
            const int y = x + 4 * i;
            w[i] = valid && y + 2 > first && y - 2 < last ? __ldg(words + y / 4) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
            const int y = x + 4 * i;
            if (y < x1) {
                unsigned int value = __byte_perm(w[i], w[i + 1], 0x5432);
                if (y < first) value &= 0xffff0000u;     // tile bytes [y, y + 2) precede the head
                if (y + 4 > last) value &= 0x0000ffffu;  // [y + 2, y + 4) follow it
                asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(swizzled_byte(dst_row, region_bytes, r, y)), "r"(value)
                             : "memory");
            }
        }
    }
}

// Row r of a tile of rows from row0 of one head of a packed-heads tensor, in the
// 128-byte-swizzled layout TMA writes (region j of 64 columns at tile + j * region_bytes),
// the head's column d at the tile's column shift + d, as a TMA box from the head's origin
// lands it; but only the head's own bytes are copied, by cp.async: `line` points at the
// head's origin column (16-byte aligned) of row 0, a row is `row_bytes` long, and the
// head's bytes are [first, last) from there (2 * shift, 2 * (shift + head_dim)). Every
// aligned 16-byte piece is one copy; the ends take 8-, 4- and, at an odd head_dim, 2-byte
// pieces (a plain load and store: cp.async copies 4 bytes or more). A row at or past `seq`
// is written as zeros. The tile's other columns are never written, so once zeroed they
// stay zeros: a neighbouring head's values never reach the tile. A producer thread copies
// a row of a tile, or half of one (row_part; one warp copying every row was what bounded
// the packed passes on an H100), then calls cp_async_arrive and mbar_arrive on the tile's
// barrier, which counts every such thread; its waiters fence_proxy_async() before their
// wgmma reads.
// kAnySource (the copied-rows view): `line` is where the tile's byte 0 of row 0 would lie,
// of any even alignment, and so is each row, so a piece is also as narrow as the row's
// source alignment: the widest of 16, 8 and 4 bytes that divides both its tile offset and
// its source address, else 2; a 2-byte piece at a multiple of 4 (a row's last, past which
// the tile holds zeros) goes by a 4-byte cp.async of which 2 bytes are zero-filled, not by
// a load the thread waits for. A row whose source is only 2-byte aligned (an odd row stride
// in elements) takes every tile word from two source words (copy_row_permuted).
template <bool kAnySource = false>
__device__ __forceinline__ void load_head_row(uint32_t tile, uint32_t region_bytes, const char* line,
                                              long long row_bytes, int first, int last, int row0, int r, int seq) {
    const bool valid = row0 + r < seq;
    const char* src = line + (valid ? row0 + r : 0) * row_bytes;
    const uint32_t dst_row = tile + r * kSwizzleRowBytes;
    int align = 16;  // the packed-heads view: the source is aligned as the tile
    if constexpr (kAnySource) {
        const int low = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
        align = low == 0 ? 16 : low & -low;
        if (align == 2) {
            copy_row_permuted(dst_row, region_bytes, src, first, last, r, valid);
            return;
        }
    }
    for (int x = first; x < last;) {
        const uint32_t dst = swizzled_byte(dst_row, region_bytes, r, x);
        if (align >= 16 && x % 16 == 0 && x + 16 <= last) {
            cp_async<16>(dst, src + x, valid);
            x += 16;
        } else if (align >= 8 && x % 8 == 0 && x + 8 <= last) {
            cp_async<8>(dst, src + x, valid);
            x += 8;
        } else if (align >= 4 && x % 4 == 0 && x + 4 <= last) {
            cp_async<4>(dst, src + x, valid);
            x += 4;
        } else if (kAnySource && align >= 4 && x % 4 == 0) {  // the row's last 2 bytes; the tile's next 2 are zeros
            cp_async_zfill4(dst, src + x, valid ? 2 : 0);
            x += 2;
        } else {
            const unsigned short value = valid ? *reinterpret_cast<const unsigned short*>(src + x) : 0;
            asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(value) : "memory");
            x += 2;
        }
    }
}

// The bytes of a row's [first, last) that part `part` of the `parts` (1 or 2) producer
// threads sharing a row copies (where a tile has fewer rows than its threads): the row
// is cut at a 16-byte boundary near its middle.
__device__ __forceinline__ int2 row_part(int first, int last, int part, int parts) {
    const int cut = parts == 1 ? last : max(first, (first + last) / 32 * 16);
    return part == 0 ? make_int2(first, cut) : make_int2(cut, last);
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

// The geometry of a [B, T, H, D] bf16 or fp16 tensor as the wrapper computes it
// (hivemind_tpu_torch/ops/flash_attention.py, tma_geometry), innermost first, with
// byte strides of the outer three dimensions and the box (64, 1, rows, 1):
//  * D a multiple of 8: the 4-D view, dims (D, H, T, B). Head h's boxes start at
//    coordinates (64 j, h). D may be below the box's 64 columns, or not a multiple
//    of 64: the columns past D read as zeros.
//  * any other D (the packed-heads view): dims (H * D, 1, T, B), H * D a multiple of
//    8, the heads packed in the row. TMA takes only a start column that is a multiple
//    of 8 (16 bytes; any other raises an illegal instruction on an H100), so head h's
//    boxes start at (h * D - s + 64 j, 0), s = head_shift(h) = (h * D) % 8: head h's
//    columns are the tile's [s, s + D), the columns around them the neighbouring
//    heads' values, and past H * D zeros.
struct TmaGeometry {
    long long dims[4];
    long long strides[3];
    long long box[4];
};

// The columns head h's boxes start before its first column: (h * head_dim) % 8 in the
// packed-heads view (`packed`), 0 in the 4-D view.
__device__ __forceinline__ int head_shift(int h, int head_dim, bool packed) { return packed ? h * head_dim % 8 : 0; }

// Head h's TMA coordinates (column, head) in the view of a head_dim-`head_dim` tensor.
__device__ __forceinline__ int2 head_origin(int h, int head_dim, bool packed) {
    return packed ? make_int2(h * head_dim - head_shift(h, head_dim, packed), 0) : make_int2(0, h);
}

// Encode the tensor map of `base` with `geometry`, whose box must be 64 columns
// by `rows` rows of a tensor of `heads` heads of head_dim `head_dim` of `type`
// (bf16 or fp16), in the view its head_dim takes. Returns a cudaError_t.
inline int encode_tma_map(CUtensorMap* map, const void* base, const TmaGeometry& geometry, int rows, int head_dim,
                          int heads, CUtensorMapDataType type) {
    static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (found != cudaDriverEntryPointSuccess || fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
        encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }
    const bool packed = head_dim % 8 != 0;
    const long long columns = packed ? static_cast<long long>(heads) * head_dim : head_dim;
    if (geometry.dims[0] != columns || geometry.dims[1] != (packed ? 1 : heads) || geometry.box[0] != kBoxCols ||
        geometry.box[1] != 1 ||
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
    const CUresult result = encode(map, type, 4, const_cast<void*>(base), dims, strides,
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
// the A operand of the next product by packing pairs to T: for k-step kc,
// a = {d[8kc..8kc+1], d[8kc+2..+3], d[8kc+4..+5], d[8kc+6..+7]}.
//
// Each helper below is templated on the element type T (__nv_bfloat16 or __half,
// bf16 by default) and overloaded on N through the accumulator's length N / 2.

// The accumulator operands of m64nN: "{%0, ..., %(N/2 - 1)}" and their "+f" bindings.
#define HM_ACC16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HM_ACC32 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HM_ACC64 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HM_ACC128 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define HM_OUT32_AT(d, o) \
    "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), \
    "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]), \
    "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]), "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), \
    "+f"(d[o + 24]), "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]), "+f"(d[o + 30]), "+f"(d[o + 31])
#define HM_OUT16(d) \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HM_OUT32(d) HM_OUT32_AT(d, 0)
#define HM_OUT64(d) HM_OUT32_AT(d, 0), HM_OUT32_AT(d, 32)
#define HM_OUT128(d) HM_OUT32_AT(d, 0), HM_OUT32_AT(d, 32), HM_OUT32_AT(d, 64), HM_OUT32_AT(d, 96)

// d (+)= A * B, A and B K-major in shared memory; SCALE is the operand number of scale_d.
#define HM_WGMMA_SS(SHAPE, TYPE, ACC, OUTS, A, B, SCALE)                                          \
    asm volatile("{\n.reg .pred p;\n"                                                            \
                 "setp.ne.b32 p, " SCALE ", 0;\n"                                                 \
                 "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPE "." TYPE " " ACC ", " A ", " B \
                 ", p, 1, 1, 0, 0;\n}\n"                                                         \
                 : OUTS                                                                          \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// d (+)= A * B, A in registers (operands A0..A3), B MN-major through the transpose-B immediate.
#define HM_WGMMA_RS(SHAPE, TYPE, ACC, OUTS, A0, B, SCALE)                                         \
    asm volatile("{\n.reg .pred p;\n"                                                            \
                 "setp.ne.b32 p, " SCALE ", 0;\n"                                                 \
                 "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPE "." TYPE " " ACC ", " A0 ", " B \
                 ", p, 1, 1, 1;\n}\n"                                                            \
                 : OUTS                                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

// d (+)= A[64 x 16] * B[16 x N], A and B K-major in shared memory (scale_d = 0: d = A*B).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    if constexpr (kIsHalf<T>) {
        HM_WGMMA_SS("m64n32k16", "f16", HM_ACC16, HM_OUT16(d), "%16", "%17", "%18");
    } else {
        HM_WGMMA_SS("m64n32k16", "bf16", HM_ACC16, HM_OUT16(d), "%16", "%17", "%18");
    }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    if constexpr (kIsHalf<T>) {
        HM_WGMMA_SS("m64n64k16", "f16", HM_ACC32, HM_OUT32(d), "%32", "%33", "%34");
    } else {
        HM_WGMMA_SS("m64n64k16", "bf16", HM_ACC32, HM_OUT32(d), "%32", "%33", "%34");
    }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    if constexpr (kIsHalf<T>) {
        HM_WGMMA_SS("m64n128k16", "f16", HM_ACC64, HM_OUT64(d), "%64", "%65", "%66");
    } else {
        HM_WGMMA_SS("m64n128k16", "bf16", HM_ACC64, HM_OUT64(d), "%64", "%65", "%66");
    }
}

// d (+)= A[64 x 16] * B[16 x N], A in registers, B MN-major in shared memory.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    if constexpr (kIsHalf<T>) {
        HM_WGMMA_RS("m64n64k16", "f16", HM_ACC32, HM_OUT32(d), "{%32, %33, %34, %35}", "%36", "%37");
    } else {
        HM_WGMMA_RS("m64n64k16", "bf16", HM_ACC32, HM_OUT32(d), "{%32, %33, %34, %35}", "%36", "%37");
    }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    if constexpr (kIsHalf<T>) {
        HM_WGMMA_RS("m64n128k16", "f16", HM_ACC64, HM_OUT64(d), "{%64, %65, %66, %67}", "%68", "%69");
    } else {
        HM_WGMMA_RS("m64n128k16", "bf16", HM_ACC64, HM_OUT64(d), "{%64, %65, %66, %67}", "%68", "%69");
    }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    if constexpr (kIsHalf<T>) {
        HM_WGMMA_RS("m64n256k16", "f16", HM_ACC128, HM_OUT128(d), "{%128, %129, %130, %131}", "%132", "%133");
    } else {
        HM_WGMMA_RS("m64n256k16", "bf16", HM_ACC128, HM_OUT128(d), "{%128, %129, %130, %131}", "%132", "%133");
    }
}

#undef HM_WGMMA_SS
#undef HM_WGMMA_RS

// ------------------------------------------------------------------ 3xTF32 (fp32 on the tensor cores)

// x rounded to TF32 (10 explicit mantissa bits, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x), as the bits of an fp32 whose low 13 bits are zero: what a
// tf32 wgmma operand is given, so nothing rests on what the tensor core does with an operand's
// low bits. Half of the dropped bits' range is added to the magnitude, which carries into the kept
// bits from the half-way point up, and the dropped bits are cleared: two integer operations. (cvt
// runs on the conversion unit, at a quarter of their rate, and was the slower of the two on an
// H100.)
__device__ __forceinline__ uint32_t tf32_bits(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo + e with hi, lo TF32 values and |e| <= 2^-22 |x| (x - hi is exact in fp32; each
// rounding keeps 11 significant bits). A product a b is then a_lo b_hi + a_hi b_lo + a_hi b_hi
// with an error near 2^-21 |a b| (3xTF32), where a_hi b_hi alone errs near 2^-10.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_bits(x);
    lo = tf32_bits(x - __uint_as_float(hi));
}

// The tf32 A-operand fragment (m64k8) of k-step kc of an m64nN fp32 accumulator d, split:
// the register of an A fragment at (row g or g + 8, column t or t + 4) of the k-step, as
// mma.m16n8k8.tf32 lays it, gets the accumulator's (same row, column 2t or 2t + 1). The
// k-step's 8 columns are so read in the order 0, 2, 4, 6, 1, 3, 5, 7, and the B operand's 8
// k-rows must be stored in that order too (tf32_k_slot): the product sums over k alike.
__device__ __forceinline__ void tf32_a_fragment(const float* d, int kc, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const float regs[4] = {d[4 * kc], d[4 * kc + 2], d[4 * kc + 1], d[4 * kc + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) tf32_split(regs[r], hi[r], lo[r]);
}

// Where k-row `k` of a B operand stands in its K-major tile when A comes from tf32_a_fragment:
// within each group of 8, row 2i at slot i and row 2i + 1 at slot 4 + i.
__host__ __device__ constexpr int tf32_k_slot(int k) { return (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2); }

#define HM_ACC8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define HM_OUT8(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])

// d (+)= A * B, tf32 operands, A and B K-major in shared memory (tf32 has no transpose flag).
#define HM_WGMMA_TF32_SS(SHAPE, ACC, OUTS, A, B, SCALE)                                                         \
    asm volatile("{\n.reg .pred p;\n"                                                                          \
                 "setp.ne.b32 p, " SCALE ", 0;\n"                                                               \
                 "wgmma.mma_async.sync.aligned." SHAPE ".f32.tf32.tf32 " ACC ", " A ", " B ", p, 1, 1;\n}\n"    \
                 : OUTS                                                                                        \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// d (+)= A * B, A in registers (tf32_a_fragment), B K-major in shared memory.
#define HM_WGMMA_TF32_RS(SHAPE, ACC, OUTS, A0, B, SCALE)                                                        \
    asm volatile("{\n.reg .pred p;\n"                                                                          \
                 "setp.ne.b32 p, " SCALE ", 0;\n"                                                               \
                 "wgmma.mma_async.sync.aligned." SHAPE ".f32.tf32.tf32 " ACC ", " A0 ", " B ", p, 1, 1;\n}\n"   \
                 : OUTS                                                                                        \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

// d (+)= A[64 x 8] * B[8 x N], tf32, both from shared memory (scale_d = 0: d = A*B).
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    HM_WGMMA_TF32_SS("m64n16k8", HM_ACC8, HM_OUT8(d), "%8", "%9", "%10");
}
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    HM_WGMMA_TF32_SS("m64n32k8", HM_ACC16, HM_OUT16(d), "%16", "%17", "%18");
}
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    HM_WGMMA_TF32_SS("m64n64k8", HM_ACC32, HM_OUT32(d), "%32", "%33", "%34");
}

// d (+)= A[64 x 8] * B[8 x N], tf32, A from registers.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    HM_WGMMA_TF32_RS("m64n64k8", HM_ACC32, HM_OUT32(d), "{%32, %33, %34, %35}", "%36", "%37");
}
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    HM_WGMMA_TF32_RS("m64n128k8", HM_ACC64, HM_OUT64(d), "{%64, %65, %66, %67}", "%68", "%69");
}

#undef HM_WGMMA_TF32_SS
#undef HM_WGMMA_TF32_RS

// Split the 4 fp32 of `v` and store hi at `hi` and lo at `lo` (shared addresses, 16-byte aligned).
// The values pass through an empty asm first, which keeps the split after the stores before it, so
// that a producer holds the parts of one chunk at a time, not of a whole tile.
__device__ __forceinline__ void st_split4(uint32_t hi, uint32_t lo, float4 v) {
    asm volatile("" : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w));
    uint32_t h[4], l[4];
    tf32_split(v.x, h[0], l[0]);
    tf32_split(v.y, h[1], l[1]);
    tf32_split(v.z, h[2], l[2]);
    tf32_split(v.w, h[3], l[3]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi), "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo), "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                 : "memory");
}

// Split x and store hi at `hi`, lo at `lo` (shared addresses), as st_split4.
__device__ __forceinline__ void st_split(uint32_t hi, uint32_t lo, float x) {
    asm volatile("" : "+f"(x));
    uint32_t h, l;
    tf32_split(x, h, l);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi), "r"(h) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo), "r"(l) : "memory");
}

// An fp32 tile of `rows` rows and 32 * regions columns in shared memory, K-major for tf32
// wgmma: region j (columns 32 j to 32 j + 31, 128 bytes a row) at j * region_bytes, each
// 128-byte-swizzled as a 16-bit TMA box would be (16-byte chunk c of row r at (c ^ r % 8) * 16).
// The byte address of 16-byte chunk `chunk` (columns 4 chunk to 4 chunk + 3) of row `row`.
__device__ __forceinline__ uint32_t kmajor_chunk(uint32_t tile, uint32_t region_bytes, int row, int chunk) {
    return tile + (chunk / 8) * region_bytes + row * kSwizzleRowBytes + (((chunk % 8) ^ (row % 8)) * 16);
}

// 16-byte chunks of rows of an fp32 [rows, columns] source as one producer thread of
// a warpgroup reads them: thread `thread` of 128 takes row thread % kRows (a warp 32 rows) and,
// of the row's head_dim / 4 chunks (padded to Dp / 4), the pairs (2 i, 2 i + 1) with
// i = part, part + kParts, ... (part = thread / kRows, kParts = 128 / kRows): each pair a whole
// 32-byte sector. Rows at or past `seq` and chunks at or past head_dim read as zeros.
template <int kRows, int Dp>
struct Tf32RowLoader {
    static constexpr int kParts = 128 / kRows;
    static constexpr int kChunks = Dp / 4 / kParts;  // chunks a thread holds
    static __device__ __forceinline__ int row(int thread) { return thread % kRows; }
    static __device__ __forceinline__ int chunk(int thread, int i) {
        return 2 * (thread / kRows + kParts * (i / 2)) + i % 2;
    }
    // (Chunk i of a thread is its first, 2 part, plus a constant, 2 kParts (i / 2) + i % 2: one
    // pointer a thread, and each load and column test against an immediate.)
    static __device__ __forceinline__ void load(float4 (&regs)[kChunks], const float* base, long long row_stride,
                                                int row0, int thread, int seq, int head_dim) {
        const int r = row0 + row(thread), first = 2 * (thread / kRows);
        const float4* src = reinterpret_cast<const float4*>(base + static_cast<long long>(r < seq ? r : 0) * row_stride) +
                            first;
        const int chunks = r < seq ? head_dim / 4 - first : 0;  // the row's chunks from `first` on
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
            const int offset = 2 * kParts * (i / 2) + i % 2;
            regs[i] = offset < chunks ? __ldg(src + offset) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    }
    // the chunks as they stand: row-major, K-major for wgmma (tile_hi, tile_lo of `rows` rows).
    // `thread` passes through an empty asm, so that the addresses are computed at each call and
    // not held in registers across a producer's loop.
    static __device__ __forceinline__ void store(const float4 (&regs)[kChunks], uint32_t tile_hi, uint32_t tile_lo,
                                                 uint32_t region_bytes, int thread) {
        asm volatile("" : "+r"(thread));
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
            const uint32_t off = kmajor_chunk(0, region_bytes, row(thread), chunk(thread, i));
            st_split4(tile_hi + off, tile_lo + off, regs[i]);
        }
    }
    // the chunks transposed: column d of the source becomes row d of a K-major tile whose
    // columns are the source's rows, each at its tf32_k_slot (a warp's 32 rows then store to
    // 32 words of one 128-byte row: no bank conflict)
    // (Row d = 4 chunk + e of the tile, chunk = 2 (part + kParts (i / 2)) + i % 2, so d % 8 =
    // 4 (i % 2) + e is known at compile time and each element's address is a per-thread base
    // plus a constant: the arithmetic is unsigned so that the compiler can see it.)
    static __device__ __forceinline__ void store_transposed(const float4 (&regs)[kChunks], uint32_t tile_hi,
                                                            uint32_t tile_lo, uint32_t region_bytes, int thread) {
        asm volatile("" : "+r"(thread));
        const uint32_t slot = tf32_k_slot(row(thread)), part = static_cast<uint32_t>(thread) / kRows;
        // the slot's 128-byte row offset (without the swizzle) and its swizzled chunk before the XOR
        const uint32_t base = (slot / 32) * region_bytes + part * 8 * kSwizzleRowBytes + (slot % 4) * 4;
        const uint32_t slot_chunk = (slot % 32) / 4;
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
            const float values[4] = {regs[i].x, regs[i].y, regs[i].z, regs[i].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const uint32_t d_high = 8 * kParts * (i / 2) * kSwizzleRowBytes, d_low = 4 * (i % 2) + e;
                const uint32_t off = base + d_high + d_low * kSwizzleRowBytes + ((slot_chunk ^ d_low) * 16);
                st_split(tile_hi + off, tile_lo + off, values[e]);
            }
        }
    }
};

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
