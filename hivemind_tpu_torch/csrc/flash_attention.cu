// Flash-attention forward for Hopper (sm_90a): out = softmax(Q K^T * D^-1/2) V and
// lse = rowmax + log(rowsum), on [B, T, H, D] tensors read through their strides.
//
// Replaces: hivemind_tpu/ops/pallas_attention.py — `_flash_forward` (the
// `pl.pallas_call` of the kernel body `_flash_kernel`), reached through
// `flash_attention` and `flash_attention_lse`. The plain PyTorch version and the
// wrapper are hivemind_tpu_torch/ops/flash_attention.py.
//
// What bounds it: operations. At the serving shapes (H = 32, D = 128, T = 512 to
// 2048) the two products do 4*T*T*D*H operations (half of that causal) against
// 4*T*H*D*2 bytes in and out: hundreds of operations per byte, above the H100's
// ~295 bf16 operations per byte. The design keeps every score and probability in
// registers (never in device memory) and keeps the tensor cores fed from tiles
// that TMA brings in ahead of use.
//
// Design, wgmma (`flash_forward_wgmma<T, Dp, kFull, kPacked, kCopied>`: bf16 and fp16 at
// a head_dim from 16 to 256 that is a multiple of 8, the serving and training paths, or
// any other whose H * head_dim is; and, on the copied-rows view, every other 16-bit
// head_dim from 1 to 256; the building blocks are sm90.cuh). T is the element type, Dp
// the head_dim padded to 64, 128 or 256, kFull whether head_dim is Dp, kPacked whether
// TMA reads the packed-heads view, kCopied whether the producer copies every tile (the
// copied-rows view; both below); all are template arguments, never runtime branches.
//  * One thread block per (128 query rows, batch*head); three warpgroups. Two
//    consumer warpgroups own 64 query rows each; one warp of the third (the
//    producer) issues the TMA loads: the block's Q tile once, then K and V tiles
//    through a ring of two stages. Each K and V slot has a "full" mbarrier (TMA
//    bytes) and an "empty" one (the 8 consumer warps), so a K slot is refilled as
//    soon as its S product is done. The producer warpgroup gives its registers to
//    the consumers (setmaxnreg 24 / 240; 40 / 232 on the packed-heads view, below).
//  * KV tiles are 128 rows at Dp <= 128 and 64 rows at Dp = 256, where a consumer
//    thread holds O (64 x 256 fp32: 128 registers), S (32) and P (16) within its
//    240. Shared memory: Q 32 KB and K, V 2 x 2 x 32 KB at Dp = 128 (160 KB in
//    all); Q 64 KB and K, V 2 x 2 x 32 KB at Dp = 256 (192 KB).
//  * Tiles live in shared memory in the 128-byte-swizzled layout TMA writes and
//    wgmma reads, Dp / 64 regions of 64 columns. A head_dim below Dp: TMA reads
//    the columns past it as zeros, which add nothing to S or to O, and the
//    epilogue stores only the columns below it; a region wholly past it (Dp = 256,
//    head_dim <= 192) is zeroed once and never loaded. The scale is the real
//    head_dim's D^-1/2.
//  * S = Q K^T is wgmma m64nNk16 (N = the KV tile's rows) with Q and K both
//    K-major in shared memory. O += P V is wgmma m64nDpk16 with P from registers
//    (the S accumulator's layout is the A-register layout, so P is packed to T in
//    place) and V read MN-major through the transpose-B flag: no transposed copy
//    of V exists anywhere. fp16 uses the .f16 forms; its P rounds to fp16 as
//    bf16's rounds to bf16, the only rounding the tensor cores add to the TPU
//    kernel's fp32 arithmetic (a product of two 16-bit values is exact in fp32).
//  * The consumer warpgroups take turns on the tensor cores ("ping-pong", two
//    named barriers): a turn issues S of tile j and P V of tile j - 1 as one
//    wgmma group, then hands the turn over, so one warpgroup's softmax runs while
//    the other's products do. Every wgmma is issued outside any branch (the
//    first and last turns are peeled): under a branch ptxas serializes them.
//  * Online softmax in base 2: 2^x (ex2.approx) of the raw score times
//    D^-1/2 * log2(e), less the running row maximum likewise scaled; lse is
//    stored as a natural log (the backward recomputes P = exp(S * scale - lse)).
//  * Masking only where it can bite: the tiles that meet the diagonal when causal
//    (column > row takes the finite -1e30, as the TPU kernel) and the tile
//    holding T. TMA reads rows past T as zeros, which still score 0, so columns
//    past T are masked there; rows past T are never stored.
//  * Query tiles are launched heaviest first (the last tile of each batch*head
//    first), so the causal tail is short.
//  * The packed-heads view (kPacked: a head_dim that is not a multiple of 8, such
//    as TinyBERT's 26). TMA takes strides in multiples of 16 bytes, and a head stride
//    of 2 * head_dim bytes is not one, so the tensor is described as (H * head_dim,
//    T, B) with the heads packed in the row. TMA also takes only a start column that
//    is a multiple of 8 (any other raised an illegal instruction on an H100), so head
//    h's boxes start at h * head_dim rounded down to one, and its columns land at the
//    tile's [s, s + head_dim), s = (h * head_dim) % 8 (sm90::head_shift); the padded
//    width holds head_dim + the largest s (tma_span). Heads are kept apart as the TPU
//    kernel keeps them: S = Q K^T sums over the tile's columns, so outside the head's
//    both operands must be zeros, not merely one (0 * inf is NaN). Q's box brings its
//    neighbours' columns, and the consumers zero them once it lands (swizzle-aware
//    stores, a proxy fence and a named barrier before any wgmma). The streamed K tiles
//    are never given them: the producer warpgroup's 128 threads copy each K tile's head
//    bytes alone by cp.async, a row each (sm90::load_head_row: 16-byte pieces, 8-, 4-
//    and 2-byte ones at the ends), into a ring zeroed once at the start, and the
//    consumers fence the async proxy after each K tile's barrier. V keeps its TMA box: column s + d of O = P V
//    reads only V's column s + d, and it is the head's column d; the rest hold other
//    heads' sums and are never stored. Each output column is stored by a 2-byte store
//    of its own (a row starts only 2-byte aligned at an odd head_dim).
//  * The copied-rows view (kCopied: a 16-bit input no TMA view takes, a head_dim below 16,
//    or one that is not a multiple of 8 whose H * head_dim is not one either or whose
//    packed span passes 256). TMA needs outer strides that are multiples of 16 bytes, and
//    such a tensor's rows are 2 * H * head_dim bytes apart. So the producer warpgroup's
//    128 threads copy every tile a head's bytes at a time: Q once (a row a thread), then
//    each K and V tile (a row, or half of one at Dp = 256) by sm90::load_head_row<true>, into
//    tiles zeroed once at the start in the 128-byte-swizzled layout the descriptors read; no
//    tensor map is read. A head's rows are congruent modulo the largest power of two up to
//    16 that divides the row stride in bytes (the wrapper's modulus, copy_plan), so the head
//    lands at one column s of its tiles for all rows, s = (address of q's row 0 of the head
//    mod the modulus) / 2 (sm90::copied_shift), and q's rows are copied in pieces as wide as
//    the modulus: cp.async of 16, 8 or 4 bytes where both sides are that aligned, plain
//    2-byte loads below (eight in flight before their stores). k and v follow q's shift in
//    pieces their own alignment allows. Where s would carry the head into a wider tile than
//    head_dim alone needs, the wrapper halves the modulus (at 2 the shift is 0). A
//    neighbour's byte never enters a tile, so the consumers zero nothing (C10); they fence
//    the async proxy after each barrier, and every producer thread arrives on each "full"
//    barrier. The consumers, masks, turns and the 2-byte column stores are the packed view's.
//    setmaxnreg 40 / 232 as the packed view's: no spill on either side.
//  * Later work (not here): a persistent grid, so that one tile's loads and
//    epilogue overlap another's products (at D = 64 and T = 512 a block runs
//    only 4 KV tiles), and TMA stores of O.
//
// Design, 3xTF32 (`flash_forward_tf32x3<Dp>`: fp32 at a head_dim from 16 to 128 that is a
// multiple of 4; Dp 64 or 128). The TPU kernel multiplies fp32 tiles in fp32; one TF32
// product rounds each input to 10 mantissa bits (about 2^-11 relative), which the fp32 limits
// reject. So every operand x is split as hi = rna_tf32(x), lo = rna_tf32(x - hi) (both kept
// with their low 13 bits zero, sm90::tf32_split) and each product a b is formed as a_lo b_hi
// + a_hi b_lo + a_hi b_hi, the small terms first, in one fp32 accumulator: about 2^-21
// relative a product, at three times the tensor work (the bound: 3 x operations at the TF32
// rate, 495 TFLOP/s on an H100 SXM, against the CUDA cores' 67 fp32 TFLOP/s).
//  * tf32 wgmma (m64nNk8) reads its shared-memory operands K-major only (the transpose
//    flags exist for 16-bit types alone). S = Q K^T reads Q and K as they stand; O += P V
//    takes P from registers and V as V^T, a copy the producer writes transposed.
//  * P's register fragment: the f32 accumulator gives a thread columns 2t and 2t + 1 of each
//    group of 8, where the tf32 A fragment wants t and t + 4. No register moves: the k-step's
//    8 keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7 in A (sm90::tf32_a_fragment) and the
//    producer stores V^T's columns in the same order (sm90::tf32_k_slot); a sum over k is the
//    same in any order.
//  * TMA can neither split nor transpose, so the producer warpgroup's 128 threads load each
//    tile with 16-byte loads (a warp on 32 rows, each thread whole 32-byte sectors), split the
//    values in registers and store hi and lo into 128-byte-swizzled tiles (sm90::Tf32RowLoader;
//    V^T by 4-byte stores, a warp's 32 keys to 32 words of one row: no bank conflict), then
//    fence the async proxy and arrive on the slot's "full" mbarrier (every producer thread
//    counts). Q is split once a block. The next K and V tiles are loaded into registers as
//    soon as the ones before are stored, so the loads run while their slot drains.
//  * Tiles (each twice, hi and lo; 32-column regions of 128 bytes): at Dp = 64, two consumer
//    warpgroups of 64 query rows take turns (the 16-bit design's ping-pong, turns of S of
//    tile j and P V of tile j - 1); Q 2 x 32 KB, 64-key K and V^T tiles in two slots each
//    (2 x 2 x 16 KB each): 192 KB. At Dp = 128, Q of 128 rows would take 128 KB, so a block
//    owns 64 query rows (one consumer warpgroup, 256 threads): Q 2 x 32 KB, 32-key K and V^T
//    tiles in two slots each (2 x 2 x 16 KB each): 192 KB. Registers: at Dp = 64 setmaxnreg
//    104 / 200 (the producer holds 64 fp32 of the next tiles); at Dp = 128 no setmaxnreg. On an
//    H100 at Dp = 64, one consumer warpgroup of 64 rows (no ping-pong) was the slower.
//  * O is summed a tile at a time: P V of a tile into a partial from zero, added to O (and O
//    rescaled) by the CUDA cores, as the dK/dV pass sums dK and dV (its note on the tensor
//    core's rounding); carried on the tensor cores, O's norm ratio to the plain version was
//    3.6e-6 at ALBERT's shape, a tile's partial 6.8e-7, and the query and key projections'
//    gradients of [train_fp32] followed (7.3e-5 against 3.7e-6 of plain fp32 attention's).
//  * Otherwise as the wgmma design: every wgmma outside a branch; masks only on the
//    diagonal's tiles and the tile holding T; query tiles heaviest first; lse as a natural
//    log; rows past T never stored; views read through their strides (a fused [B, T, 3, H,
//    D] projection's slices included), and an unaligned one copied by the wrapper. The
//    exponent is ex2.approx, as the 16-bit design's: its error (about 2 ulp) is far inside
//    the fp32 limits, which chip_smoke.py holds every fp32 case to.
//
// Design, SIMT (every input the wgmma and 3xTF32 designs do not take: fp32 at a head_dim
// that is not a multiple of 4 or outside 16 to 128; any head_dim up to 256, as the TPU kernel
// takes the whole head_dim as its block. Its bf16 and fp16 instantiations run on no path since
// the copied-rows view; chip_smoke.py times them beside it on the same tensors): the
// same online softmax on the CUDA cores in fp32 FMAs only (no TF32), the inputs
// widened to fp32 as they are staged, as the TPU kernel casts its tiles. A block
// owns 16 query rows of one batch*head, a warp 4 of them; lane j scores key j of a
// 32-key tile, and each lane accumulates kD/32 output columns from probabilities
// broadcast by shuffles. kD is head_dim rounded up to 32, 64, 96, 128 or 256, its
// extra columns zeros.

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // large-but-finite, as the TPU kernel

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    float* lse;  // [B, H, T] contiguous
    int batch, seq, heads, head_dim;
    long long q_sb, q_st, q_sh;
    long long k_sb, k_st, k_sh;
    long long v_sb, v_st, v_sh;
    long long o_sb, o_st, o_sh;
    float scale;
    int causal;
};

// ------------------------------------------------------------------ wgmma path

constexpr int kRows = 128;        // query rows per block
constexpr int kStages = 2;        // depth of the K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreadsWgmma = 384;  // two consumer warpgroups and the producer's
constexpr int kProducerThreads = kThreadsWgmma - kConsumerWarps * 32;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168
// the packed-heads view's producer threads copy rows by cp.async (sm90::load_head_row), which
// spilled 4-8 bytes in 24 registers: 128 * 40 + 256 * 232 = 384 * 168, with no spill on either side
constexpr int kPackedProducerRegs = 40, kPackedConsumerRegs = 232;
// the copied-rows view's producer threads copy Q, K and V by cp.async (load_head_row<true>)
constexpr int kCopiedProducerRegs = 40, kCopiedConsumerRegs = 232;

struct WgmmaParams {
    void* out;
    float* lse;  // [B, H, T] contiguous
    int seq, heads, head_dim;
    long long o_sb, o_st, o_sh;
    float scale;
    int causal;
    const void* k;             // the packed-heads view's K, which its kernel copies by cp.async
    long long k_sb, k_st;      // its batch and row strides, in bytes
};

// The copied-rows view's parameters, which copies q, k and v by cp.async: q and v, the head
// strides and q's and v's other strides (bytes), and the shift modulus (sm90::copied_shift). A
// struct of its own, so that the other views' kernels take WgmmaParams alone (a larger parameter
// struct changed their SASS and cost the 4-D view's forward 2-5% on an H100).
struct CopiedParams : WgmmaParams {
    const void* q;
    const void* v;
    long long k_sh, q_sb, q_st, q_sh, v_sb, v_st, v_sh;
    int modulus;
};

template <bool kCopied>
using ForwardParams = std::conditional_t<kCopied, CopiedParams, WgmmaParams>;

// Shared-memory layout at the padded width Dp (byte offsets from a 1024-aligned base).
template <int Dp>
struct ForwardTiles {
    // KV rows per tile, and the rows of every TMA box: at Dp = 256 a 128-row tile's
    // scores would not fit the registers beside O (64 x 256 fp32: 128 a thread)
    static constexpr int kKvRows = Dp > 128 ? 64 : 128;
    static constexpr int kBoxes = Dp / sm90::kBoxCols;                          // 64-column regions of a tile
    static constexpr uint32_t kQBox = kRows * sm90::kSwizzleRowBytes;          // one region of the Q tile
    static constexpr uint32_t kKvBox = kKvRows * sm90::kSwizzleRowBytes;       // one region of a K or V tile
    static constexpr uint32_t kQTile = kQBox * kBoxes, kKvTile = kKvBox * kBoxes;
    static constexpr uint32_t kQ = 0, kK = kQTile, kV = kK + kStages * kKvTile;
    static constexpr uint32_t kBarriers = kV + kStages * kKvTile;  // full_q, full_k[S], full_v[S], empty_k[S], empty_v[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 4 * kStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// TMA of a tile of kTileRows rows from row `row0`: in each of its first `boxes`
// 64-column regions, kTileRows / kBoxRows boxes of kBoxRows rows, one after the
// other (8 rows of 128 bytes are one swizzle period, so a box lands where the same
// rows of one taller box would). `origin`: the head's (column, head) coordinates.
template <int kBoxRows, int kTileRows>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int boxes, int2 origin,
                                          int row0, int b) {
#pragma unroll
    for (int col = 0; col < boxes; ++col) {
#pragma unroll
        for (int part = 0; part < kTileRows / kBoxRows; ++part) {
            sm90::tma_load_4d(dst + (col * kTileRows + part * kBoxRows) * sm90::kSwizzleRowBytes, map, bar,
                              origin.x + col * sm90::kBoxCols, origin.y, row0 + part * kBoxRows, b);
        }
    }
}

// T: __nv_bfloat16 or __half. Dp: head_dim padded to 64, 128 or 256; columns at or
// past head_dim read as zeros and are never stored. kFull: head_dim == Dp, whose
// stores need no column test (its mere presence in a kernel costs a full-width
// tile about 1%, as measured against one without it). kPacked: the packed-heads
// view (a head_dim that is not a multiple of 8): Q's columns outside the head's are
// zeroed once it lands, K is copied a head's bytes at a time into a ring zeroed once,
// and each column is stored by its own 2-byte store. kCopied: the copied-rows view (a
// 16-bit input no TMA view takes): Q, K and V are all copied a head's bytes at a time into
// tiles zeroed once, the maps are not read, and each column is stored as kPacked's.
template <typename T, int Dp, bool kFull, bool kPacked, bool kCopied>
__global__ void __launch_bounds__(kThreadsWgmma, 1)
    flash_forward_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const ForwardParams<kCopied> p) {
    static_assert(!(kPacked && kCopied), "one view at a time");
    using L = ForwardTiles<Dp>;
    constexpr int kKvRows = L::kKvRows;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (sm90::smem_addr(smem_raw) + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    const uint32_t full_q = base + L::kBarriers;
    const auto full_k = [&](int s) { return full_q + 8 * (1 + s); };
    const auto full_v = [&](int s) { return full_q + 8 * (1 + kStages + s); };
    const auto empty_k = [&](int s) { return full_q + 8 * (1 + 2 * kStages + s); };
    const auto empty_v = [&](int s) { return full_q + 8 * (1 + 3 * kStages + s); };

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q_tiles = (p.seq + kRows - 1) / kRows;
    const int q_tile = q_tiles - 1 - static_cast<int>(blockIdx.y);  // heaviest first
    const int q0 = q_tile * kRows;
    const int kv_end = p.causal ? min(p.seq, q0 + kRows) : p.seq;  // causal: up to the diagonal
    const int kv_tiles = (kv_end + kKvRows - 1) / kKvRows;
    // the head's TMA coordinates, and the tile column its first column lands at (0 but
    // in the packed-heads view)
    const int2 origin = sm90::head_origin(h, p.head_dim, kPacked);
    int shift = sm90::head_shift(h, p.head_dim, kPacked);
    if constexpr (kCopied) {  // where q's row 0 of the head lies decides it (the wrapper's copy_plan)
        shift = sm90::copied_shift(static_cast<const char*>(p.q) + b * p.q_sb + h * p.q_sh, p.modulus);
    }
    // The regions TMA loads: at Dp <= 128 every one holds a column below head_dim
    // (head_dim >= 16, and > 64 at Dp = 128; packed, each is loaded and zeroed around the
    // head); at Dp = 256 the last lies wholly past a head_dim of 192 or less (past shift
    // + head_dim, packed), so it is zeroed once here and never loaded.
    const int boxes =
        !kFull && Dp > 128 ? (shift + p.head_dim + sm90::kBoxCols - 1) / sm90::kBoxCols : L::kBoxes;
    if (!kCopied && !kFull && Dp > 128 && boxes < L::kBoxes) {
        for (int region = boxes; region < L::kBoxes; ++region) {
            sm90::zero_shared(base + L::kQ + region * L::kQBox, L::kQBox);
            for (int s = 0; s < kStages; ++s) {
                sm90::zero_shared(base + L::kK + s * L::kKvTile + region * L::kKvBox, L::kKvBox);
                sm90::zero_shared(base + L::kV + s * L::kKvTile + region * L::kKvBox, L::kKvBox);
            }
        }
        sm90::fence_proxy_async();
    }
    if constexpr (kPacked) {  // K's ring: zeros, of which load_head_row overwrites only the head's columns
        sm90::zero_shared(base + L::kK, kStages * L::kKvTile);
        sm90::fence_proxy_async();
    }
    if constexpr (kCopied) {  // Q and both rings: zeros, of which load_head_row overwrites only the head's columns
        sm90::zero_shared(base, L::kBarriers);
        sm90::fence_proxy_async();
    }

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_q, kCopied ? kProducerThreads : 1);  // copied: every producer thread
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(full_k(s), kPacked || kCopied ? kProducerThreads : 1);  // packed: every producer thread
            sm90::mbar_init(full_v(s), kCopied ? kProducerThreads : 1);
            sm90::mbar_init(empty_k(s), kConsumerWarps);
            sm90::mbar_init(empty_v(s), kConsumerWarps);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumerWarps * 32) {  // the producer warpgroup; one thread issues every TMA load
        sm90::setmaxnreg_dec<kCopied ? kCopiedProducerRegs : kPacked ? kPackedProducerRegs : kProducerRegs>();
        if constexpr (kCopied) {  // every producer thread copies a row of Q, then a row (or half) of each K and V tile
            const int thread = threadIdx.x - kConsumerWarps * 32;
            // where tile byte 0 of the head's row 0 of each tensor would lie
            const char* q_line = static_cast<const char*>(p.q) + b * p.q_sb + h * p.q_sh - 2 * shift;
            const char* k_line = static_cast<const char*>(p.k) + b * p.k_sb + h * p.k_sh - 2 * shift;
            const char* v_line = static_cast<const char*>(p.v) + b * p.v_sb + h * p.v_sh - 2 * shift;
            sm90::load_head_row<true>(base + L::kQ, L::kQBox, q_line, p.q_st, 2 * shift, 2 * (shift + p.head_dim), q0,
                                      thread, p.seq);
            sm90::cp_async_arrive(full_q);
            sm90::mbar_arrive(full_q);
            constexpr int kParts = kProducerThreads / kKvRows;  // threads a row: 1, or 2 at Dp = 256
            const int2 bytes = sm90::row_part(2 * shift, 2 * (shift + p.head_dim), thread / kKvRows, kParts);
            for (int j = 0; j < kv_tiles; ++j) {
                const int s = j % kStages;
                const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round passes at once
                sm90::mbar_wait(empty_k(s), parity);
                sm90::load_head_row<true>(base + L::kK + s * L::kKvTile, L::kKvBox, k_line, p.k_st, bytes.x, bytes.y,
                                          j * kKvRows, thread % kKvRows, p.seq);
                sm90::cp_async_arrive(full_k(s));
                sm90::mbar_arrive(full_k(s));
                sm90::mbar_wait(empty_v(s), parity);
                sm90::load_head_row<true>(base + L::kV + s * L::kKvTile, L::kKvBox, v_line, p.v_st, bytes.x, bytes.y,
                                          j * kKvRows, thread % kKvRows, p.seq);
                sm90::cp_async_arrive(full_v(s));
                sm90::mbar_arrive(full_v(s));
            }
        } else if constexpr (kPacked) {  // every producer thread copies K's head bytes of a row (or half); thread 0 Q and V by TMA
            const int thread = threadIdx.x - kConsumerWarps * 32;
            if (thread == 0) {
                sm90::mbar_arrive_expect_tx(full_q, boxes * L::kQBox);
                load_tile<kKvRows, kRows>(base + L::kQ, &tm_q, full_q, boxes, origin, q0, b);
            }
            const char* k_line = static_cast<const char*>(p.k) + b * p.k_sb + 2LL * origin.x;
            constexpr int kParts = kProducerThreads / kKvRows;  // threads a row: 1, or 2 at Dp = 256
            const int2 bytes = sm90::row_part(2 * shift, 2 * (shift + p.head_dim), thread / kKvRows, kParts);
            for (int j = 0; j < kv_tiles; ++j) {
                const int s = j % kStages;
                const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round passes at once
                sm90::mbar_wait(empty_k(s), parity);
                sm90::load_head_row(base + L::kK + s * L::kKvTile, L::kKvBox, k_line, p.k_st, bytes.x, bytes.y,
                                    j * kKvRows, thread % kKvRows, p.seq);
                sm90::cp_async_arrive(full_k(s));
                sm90::mbar_arrive(full_k(s));
                if (thread == 0) {
                    sm90::mbar_wait(empty_v(s), parity);
                    sm90::mbar_arrive_expect_tx(full_v(s), boxes * L::kKvBox);
                    load_tile<kKvRows, kKvRows>(base + L::kV + s * L::kKvTile, &tm_v, full_v(s), boxes, origin,
                                                j * kKvRows, b);
                }
            }
        } else if (threadIdx.x == kConsumerWarps * 32) {
            sm90::mbar_arrive_expect_tx(full_q, boxes * L::kQBox);
            load_tile<kKvRows, kRows>(base + L::kQ, &tm_q, full_q, boxes, origin, q0, b);
            for (int j = 0; j < kv_tiles; ++j) {
                const int s = j % kStages;
                const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round passes at once
                sm90::mbar_wait(empty_k(s), parity);
                sm90::mbar_arrive_expect_tx(full_k(s), boxes * L::kKvBox);
                load_tile<kKvRows, kKvRows>(base + L::kK + s * L::kKvTile, &tm_k, full_k(s), boxes, origin, j * kKvRows,
                                            b);
                sm90::mbar_wait(empty_v(s), parity);
                sm90::mbar_arrive_expect_tx(full_v(s), boxes * L::kKvBox);
                load_tile<kKvRows, kKvRows>(base + L::kV + s * L::kKvTile, &tm_v, full_v(s), boxes, origin, j * kKvRows,
                                            b);
            }
        }
    } else {  // two consumer warpgroups, 64 query rows each
        sm90::setmaxnreg_inc<kCopied ? kCopiedConsumerRegs : kPacked ? kPackedConsumerRegs : kConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_lo = wg * 64 + warp * 16 + g;  // this thread's rows of the tile: row_lo, row_lo + 8
        const float scale2 = p.scale * sm90::kLog2e;

        float o[Dp / 2];
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) o[i] = 0.0f;
        float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;  // raw row maxima, partial row sums

        const uint32_t q_wg = base + L::kQ + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        float sc[kKvRows / 2];         // S = Q K^T of one KV tile, 64 x kKvRows, then its P
        uint32_t pf[kKvRows / 16][4];  // P as the A operand of P V, one 16-column k-step each
        float corr_lo = 0.0f, corr_hi = 0.0f;

        // S = Q K^T of KV tile j into sc
        const auto issue_s = [&](int j) {
            const uint32_t k_tile = base + L::kK + (j % kStages) * L::kKvTile;
#pragma unroll
            for (int kk = 0; kk < Dp / 16; ++kk) {
                // region kk / 4, then 32 bytes (16 columns) along its swizzled 128-byte rows
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                const uint32_t k_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                sm90::wgmma_ss<T>(sc, sm90::desc_kmajor(q_wg + q_off), sm90::desc_kmajor(k_tile + k_off), kk > 0);
            }
        };
        // O += P V of KV tile j, P from pf
        const auto issue_pv = [&](int j) {
            const uint32_t v_tile = base + L::kV + (j % kStages) * L::kKvTile;
#pragma unroll
            for (int kc = 0; kc < kKvRows / 16; ++kc) {  // 16 KV rows per k-step: 2048 bytes down V's regions
                sm90::wgmma_rs_tb<T>(o, pf[kc], sm90::desc_mnmajor(v_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kKvBox),
                                     1);
            }
        };
        // Mask and exponentiate tile j's scores in place; fold them into the row
        // maxima and partial sums; corr_* take the factor that rescales O.
        const auto softmax = [&](int j) {
            const int kv0 = j * kKvRows;
            if ((p.causal && kv0 + kKvRows > q0) || kv0 + kKvRows > p.seq) {  // the diagonal's tiles, the tile holding T
#pragma unroll
                for (int i = 0; i < kKvRows / 2; ++i) {
                    const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
                    const int row = q0 + row_lo + (i & 2) * 4;
                    if (col >= p.seq || (p.causal && col > row)) sc[i] = kNegInf;
                }
            }
            float max_lo = m_lo, max_hi = m_hi;
#pragma unroll
            for (int i = 0; i < kKvRows / 2; ++i) {
                if (i & 2) {
                    max_hi = fmaxf(max_hi, sc[i]);
                } else {
                    max_lo = fmaxf(max_lo, sc[i]);
                }
            }
#pragma unroll
            for (int offset = 1; offset < 4; offset <<= 1) {  // the 4 threads of a quad share a row
                max_lo = fmaxf(max_lo, __shfl_xor_sync(0xffffffffu, max_lo, offset));
                max_hi = fmaxf(max_hi, __shfl_xor_sync(0xffffffffu, max_hi, offset));
            }
            corr_lo = sm90::exp2_approx((m_lo - max_lo) * scale2);
            corr_hi = sm90::exp2_approx((m_hi - max_hi) * scale2);
            m_lo = max_lo;
            m_hi = max_hi;
            const float shift_lo = max_lo * scale2, shift_hi = max_hi * scale2;
            float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
            for (int i = 0; i < kKvRows / 2; ++i) {
                if (i & 2) {
                    sc[i] = sm90::exp2_approx(fmaf(sc[i], scale2, -shift_hi));
                    sum_hi += sc[i];
                } else {
                    sc[i] = sm90::exp2_approx(fmaf(sc[i], scale2, -shift_lo));
                    sum_lo += sc[i];
                }
            }
            l_lo = l_lo * corr_lo + sum_lo;  // per-thread partial; the quad is summed at the end
            l_hi = l_hi * corr_hi + sum_hi;
        };

        const auto pack_p = [&]() {
#pragma unroll
            for (int kc = 0; kc < kKvRows / 16; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) pf[kc][r] = sm90::pack2<T>(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
            }
        };
        // Turn j issues S of tile j and P V of tile j - 1 as one wgmma group (the
        // first turn S only, the last P V only). The two warpgroups take turns
        // (named barriers 1 and 2, warpgroup 0 first), so one warpgroup's softmax
        // runs while the other's products occupy the tensor cores. Every wgmma is
        // issued on a path without branches: under a branch ptxas serializes them
        // (C7520).
        const auto take_turn = [&]() {
            sm90::named_bar_sync(1 + wg, 2 * 128);
            sm90::fence_regs(sc);
            sm90::fence_regs(o);
            sm90::fence_regs(pf);
            sm90::wgmma_fence();
        };
        const auto pass_turn = [&]() { sm90::named_bar_arrive(2 - wg, 2 * 128); };
        const auto finish_turn = [&]() {
            sm90::wgmma_wait<0>();
            sm90::fence_regs(sc);
            sm90::fence_regs(o);
        };
        // K tile j has landed; packed or copied, its cp.async bytes are then fenced for wgmma's reads
        const auto wait_k = [&](int j) {
            sm90::mbar_wait(full_k(j % kStages), (j / kStages) & 1);
            if constexpr (kPacked || kCopied) sm90::fence_proxy_async();
        };
        if (wg == 1) pass_turn();
        sm90::mbar_wait(full_q, 0);
        if constexpr (kCopied) sm90::fence_proxy_async();
        if constexpr (kPacked) {  // Q's columns around the head's hold its neighbours': zero them before any S
            sm90::zero_around_head(base + L::kQ, L::kQBox, kRows, shift, p.head_dim, boxes * sm90::kBoxCols, threadIdx.x,
                                   kConsumerWarps * 32);
            sm90::fence_proxy_async();
            sm90::named_bar_sync(3, kConsumerWarps * 32);
        }
        wait_k(0);
        take_turn();
        issue_s(0);
        sm90::wgmma_commit();
        pass_turn();
        finish_turn();
        if (lane == 0) sm90::mbar_arrive(empty_k(0));
        softmax(0);  // O is still 0: no rescale
        pack_p();
        for (int j = 1; j < kv_tiles; ++j) {
            wait_k(j);
            sm90::mbar_wait(full_v((j - 1) % kStages), ((j - 1) / kStages) & 1);
            if constexpr (kCopied) sm90::fence_proxy_async();  // V's cp.async bytes too
            take_turn();
            issue_s(j);
            issue_pv(j - 1);
            sm90::wgmma_commit();
            pass_turn();
            finish_turn();
            if (lane == 0) {  // this warp is done with K of tile j and V of tile j - 1
                sm90::mbar_arrive(empty_k(j % kStages));
                sm90::mbar_arrive(empty_v((j - 1) % kStages));
            }
            softmax(j);
#pragma unroll
            for (int i = 0; i < Dp / 2; ++i) o[i] *= (i & 2) ? corr_hi : corr_lo;
            pack_p();
        }
        const int last = kv_tiles - 1;
        sm90::mbar_wait(full_v(last % kStages), (last / kStages) & 1);
        if constexpr (kCopied) sm90::fence_proxy_async();
        take_turn();
        issue_pv(last);
        sm90::wgmma_commit();
        if (wg == 0) pass_turn();  // warpgroup 1's last turn has no taker
        finish_turn();

#pragma unroll
        for (int offset = 1; offset < 4; offset <<= 1) {
            l_lo += __shfl_xor_sync(0xffffffffu, l_lo, offset);
            l_hi += __shfl_xor_sync(0xffffffffu, l_hi, offset);
        }
        const float denom_lo = fmaxf(l_lo, 1e-30f), denom_hi = fmaxf(l_hi, 1e-30f);
        const int row_a = q0 + row_lo, row_b = row_a + 8;
        T* o_base = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
        for (int c = 0; c < Dp / 8; ++c) {
            const int col = c * 8 + t * 2;
            if constexpr (kPacked || kCopied) {  // tile column shift + d is the head's d; a row starts only 2-byte aligned
                const float vals[4] = {o[4 * c] / denom_lo, o[4 * c + 1] / denom_lo, o[4 * c + 2] / denom_hi,
                                       o[4 * c + 3] / denom_hi};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = e < 2 ? row_a : row_b, d = col + (e & 1) - shift;
                    if (row < p.seq && d >= 0 && d < p.head_dim) o_base[row * p.o_st + d] = from_float<T>(vals[e]);
                }
            } else if (kFull || c * 8 < p.head_dim) {  // columns past a head_dim below Dp (a multiple of 8) are not stored
                if (row_a < p.seq) {
                    *reinterpret_cast<uint32_t*>(o_base + row_a * p.o_st + col) =
                        sm90::pack2<T>(o[4 * c] / denom_lo, o[4 * c + 1] / denom_lo);
                }
                if (row_b < p.seq) {
                    *reinterpret_cast<uint32_t*>(o_base + row_b * p.o_st + col) =
                        sm90::pack2<T>(o[4 * c + 2] / denom_hi, o[4 * c + 3] / denom_hi);
                }
            }
        }
        if (t == 0) {
            float* lse = p.lse + static_cast<long long>(bh) * p.seq;
            if (row_a < p.seq) lse[row_a] = m_lo * p.scale + logf(denom_lo);
            if (row_b < p.seq) lse[row_b] = m_hi * p.scale + logf(denom_hi);
        }
    }
}

// ------------------------------------------------------------------ 3xTF32 path (fp32)

// Shared-memory layout at the padded width Dp (64 or 128; byte offsets from a 1024-aligned
// base). Every tile is fp32 in 32-column (128-byte) regions, 128-byte-swizzled (sm90.cuh,
// kmajor_chunk), and held twice, as its TF32 hi part and its lo part.
template <int Dp>
struct Tf32ForwardTiles {
    // consumer warpgroups of 64 query rows: two at Dp = 64, taking turns (ping-pong); one at
    // Dp = 128, where Q of 128 rows (hi and lo: 128 KB) and two stages of K and V^T would not fit
    static constexpr int kConsumers = Dp > 64 ? 1 : 2;
    static constexpr int kThreads = 128 * (kConsumers + 1);
    static constexpr int kRows = 64 * kConsumers;       // query rows a block
    static constexpr int kKvRows = Dp > 64 ? 32 : 64;   // KV rows a tile
    static constexpr int kRegions = Dp / 32;
    static constexpr uint32_t kQBox = kRows * sm90::kSwizzleRowBytes, kQTile = kQBox * kRegions;
    static constexpr uint32_t kKBox = kKvRows * sm90::kSwizzleRowBytes, kKTile = kKBox * kRegions;
    // V^T: Dp rows (V's columns) of kKvRows keys, in kKvRows / 32 regions
    static constexpr uint32_t kVtBox = Dp * sm90::kSwizzleRowBytes, kVtTile = kVtBox * (kKvRows / 32);
    static constexpr uint32_t kQ = 0;                        // Q hi, then Q lo
    static constexpr uint32_t kK = 2 * kQTile;               // slot s: K hi at kK + 2 s kKTile, K lo after it
    static constexpr uint32_t kVt = kK + 2 * kStages * kKTile;
    static constexpr uint32_t kBarriers = kVt + 2 * kStages * kVtTile;  // full_q, full_k[S], full_v[S], empty_k[S], empty_v[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 4 * kStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// The producer warpgroup's registers where two consumer warpgroups take the rest: it holds a
// prefetched K and V tile (64 fp32 a thread). 128 * 104 + 256 * 200 = 384 * 168, the registers the
// block is launched with: setmaxnreg.inc waits for registers the other warpgroups released, so a
// split past that total never completes.
constexpr int kTf32ProducerRegs = 104, kTf32ConsumerRegs = 200;

// fp32 q, k, v at a head_dim from 16 to Dp that is a multiple of 4 (a head's row is whole
// 16-byte chunks). Dp: 64 or 128. The producer warpgroup loads each tile with 16-byte loads,
// splits every value into TF32 hi and lo in registers and stores both, K-major: Q and K as
// they stand, V transposed (tf32 wgmma reads its shared-memory operands K-major only), its
// keys in tf32_k_slot order to match P's register fragments. Columns past head_dim and rows
// past T are stored as zeros.
template <int Dp>
__global__ void __launch_bounds__(Tf32ForwardTiles<Dp>::kThreads, 1) flash_forward_tf32x3(const Params p) {
    using L = Tf32ForwardTiles<Dp>;
    constexpr int kKvRows = L::kKvRows, kConsumers = L::kConsumers;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (sm90::smem_addr(smem_raw) + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    const uint32_t full_q = base + L::kBarriers;
    const auto full_k = [&](int s) { return full_q + 8 * (1 + s); };
    const auto full_v = [&](int s) { return full_q + 8 * (1 + kStages + s); };
    const auto empty_k = [&](int s) { return full_q + 8 * (1 + 2 * kStages + s); };
    const auto empty_v = [&](int s) { return full_q + 8 * (1 + 3 * kStages + s); };
    const auto k_slot = [&](int s) { return base + L::kK + 2 * s * L::kKTile; };    // hi; lo at + kKTile
    const auto vt_slot = [&](int s) { return base + L::kVt + 2 * s * L::kVtTile; };  // hi; lo at + kVtTile

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q_tiles = (p.seq + L::kRows - 1) / L::kRows;
    const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.y)) * L::kRows;  // heaviest first
    const int kv_end = p.causal ? min(p.seq, q0 + L::kRows) : p.seq;         // causal: up to the diagonal
    const int kv_tiles = (kv_end + kKvRows - 1) / kKvRows;

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_q, 128);
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(full_k(s), 128);  // every producer thread stores a part of each tile
            sm90::mbar_init(full_v(s), 128);
            sm90::mbar_init(empty_k(s), 4 * kConsumers);
            sm90::mbar_init(empty_v(s), 4 * kConsumers);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers * 128) {  // the producer warpgroup
        if constexpr (kConsumers == 2) sm90::setmaxnreg_dec<kTf32ProducerRegs>();
        const int thread = threadIdx.x - kConsumers * 128;
        const float* q_base = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
        const float* k_base = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
        const float* v_base = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
        using QRows = sm90::Tf32RowLoader<64, Dp>;  // Q a warpgroup's 64 rows at a time
        using KvRows = sm90::Tf32RowLoader<kKvRows, Dp>;
#pragma unroll 1
        for (int rows = 0; rows < L::kRows; rows += 64) {
            float4 q_regs[QRows::kChunks];
            QRows::load(q_regs, q_base, p.q_st, q0 + rows, thread, p.seq, p.head_dim);
            const uint32_t q_rows = base + L::kQ + rows * sm90::kSwizzleRowBytes;
            QRows::store(q_regs, q_rows, q_rows + L::kQTile, L::kQBox, thread);
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(full_q);
        // K and V of tile j in registers, each loaded as soon as the one before is stored, so
        // the loads are in flight while the slot they go to drains
        float4 k_regs[KvRows::kChunks], v_regs[KvRows::kChunks];
        KvRows::load(k_regs, k_base, p.k_st, 0, thread, p.seq, p.head_dim);
        KvRows::load(v_regs, v_base, p.v_st, 0, thread, p.seq, p.head_dim);
        for (int j = 0; j < kv_tiles; ++j) {
            const int s = j % kStages;
            const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round passes at once
            const bool next = j + 1 < kv_tiles;
            sm90::mbar_wait(empty_k(s), parity);
            KvRows::store(k_regs, k_slot(s), k_slot(s) + L::kKTile, L::kKBox, thread);
            sm90::fence_proxy_async();
            sm90::mbar_arrive(full_k(s));
            if (next) KvRows::load(k_regs, k_base, p.k_st, (j + 1) * kKvRows, thread, p.seq, p.head_dim);
            sm90::mbar_wait(empty_v(s), parity);
            KvRows::store_transposed(v_regs, vt_slot(s), vt_slot(s) + L::kVtTile, L::kVtBox, thread);
            sm90::fence_proxy_async();
            sm90::mbar_arrive(full_v(s));
            if (next) KvRows::load(v_regs, v_base, p.v_st, (j + 1) * kKvRows, thread, p.seq, p.head_dim);
        }
    } else {  // the consumer warpgroups, 64 query rows each
        if constexpr (kConsumers == 2) sm90::setmaxnreg_inc<kTf32ConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_lo = wg * 64 + warp * 16 + g;  // this thread's rows of the tile: row_lo, row_lo + 8
        const float scale2 = p.scale * sm90::kLog2e;

        float o[Dp / 2];
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) o[i] = 0.0f;
        float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;  // raw row maxima, partial row sums

        const uint32_t q_hi = base + L::kQ + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        const uint32_t q_lo = q_hi + L::kQTile;
        float sc[kKvRows / 2];                               // S = Q K^T of one KV tile, then its P
        uint32_t p_hi[kKvRows / 8][4], p_lo[kKvRows / 8][4];  // P's A fragments, 8 keys each
        // P V of one tile, summed from zero and added to O by the CUDA cores: the tensor core's
        // additions round toward zero relative to the sum they add to, so O carried through the
        // sweep on the tensor cores drifted by the sweep's length (as dK and dV did; the dK/dV
        // pass's note), and a tile's partial drifts by the tile's
        float part[Dp / 2];
        float corr_lo = 0.0f, corr_hi = 0.0f;

        // S = Q K^T of KV tile j: Q_lo K_hi + Q_hi K_lo, then Q_hi K_hi (the small terms first). The
        // tiles' bases pass through an empty asm, so the descriptors are made at each call, not
        // held across the sweep (Q's 16 and both slots' 32 of K: 96 registers; the consumers spilled)
        const auto issue_s = [&](int j) {
            uint32_t q_hi_j = q_hi, q_lo_j = q_lo, k_hi = k_slot(j % kStages);
            asm volatile("" : "+r"(q_hi_j), "+r"(q_lo_j), "+r"(k_hi));
            const uint32_t k_lo = k_hi + L::kKTile;
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kk = 0; kk < Dp / 8; ++kk) {
                    // region kk / 4, then 32 bytes (8 columns) along its swizzled 128-byte rows
                    const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                    const uint32_t k_off = (kk / 4) * L::kKBox + (kk % 4) * 32;
                    sm90::wgmma_ss_tf32(sc, sm90::desc_kmajor((term == 0 ? q_lo_j : q_hi_j) + q_off),
                                        sm90::desc_kmajor((term == 1 ? k_lo : k_hi) + k_off), term > 0 || kk > 0);
                }
            }
        };
        // part = P V of KV tile j: P_lo V_hi + P_hi V_lo + P_hi V_hi, V^T K-major
        const auto issue_pv = [&](int j) {
            uint32_t vt_hi = vt_slot(j % kStages);
            asm volatile("" : "+r"(vt_hi));  // as issue_s's bases
            const uint32_t vt_lo = vt_hi + L::kVtTile;
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kc = 0; kc < kKvRows / 8; ++kc) {
                    const uint32_t vt_off = (kc / 4) * L::kVtBox + (kc % 4) * 32;
                    sm90::wgmma_rs_tf32(part, term == 0 ? p_lo[kc] : p_hi[kc],
                                        sm90::desc_kmajor((term == 1 ? vt_lo : vt_hi) + vt_off), term > 0 || kc > 0);
                }
            }
        };
        // as the 16-bit kernel's: mask and exponentiate tile j's scores in place, fold them
        // into the row maxima and partial sums; corr_* take the factor that rescales O
        const auto softmax = [&](int j) {
            const int kv0 = j * kKvRows;
            if ((p.causal && kv0 + kKvRows > q0) || kv0 + kKvRows > p.seq) {  // the diagonal's tiles, the tile holding T
#pragma unroll
                for (int i = 0; i < kKvRows / 2; ++i) {
                    const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
                    const int row = q0 + row_lo + (i & 2) * 4;
                    if (col >= p.seq || (p.causal && col > row)) sc[i] = kNegInf;
                }
            }
            float max_lo = m_lo, max_hi = m_hi;
#pragma unroll
            for (int i = 0; i < kKvRows / 2; ++i) {
                if (i & 2) {
                    max_hi = fmaxf(max_hi, sc[i]);
                } else {
                    max_lo = fmaxf(max_lo, sc[i]);
                }
            }
#pragma unroll
            for (int offset = 1; offset < 4; offset <<= 1) {  // the 4 threads of a quad share a row
                max_lo = fmaxf(max_lo, __shfl_xor_sync(0xffffffffu, max_lo, offset));
                max_hi = fmaxf(max_hi, __shfl_xor_sync(0xffffffffu, max_hi, offset));
            }
            corr_lo = sm90::exp2_approx((m_lo - max_lo) * scale2);
            corr_hi = sm90::exp2_approx((m_hi - max_hi) * scale2);
            m_lo = max_lo;
            m_hi = max_hi;
            const float shift_lo = max_lo * scale2, shift_hi = max_hi * scale2;
            float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
            for (int i = 0; i < kKvRows / 2; ++i) {
                if (i & 2) {
                    sc[i] = sm90::exp2_approx(fmaf(sc[i], scale2, -shift_hi));
                    sum_hi += sc[i];
                } else {
                    sc[i] = sm90::exp2_approx(fmaf(sc[i], scale2, -shift_lo));
                    sum_lo += sc[i];
                }
            }
            l_lo = l_lo * corr_lo + sum_lo;  // per-thread partial; the quad is summed at the end
            l_hi = l_hi * corr_hi + sum_hi;
        };
        const auto split_p = [&]() {
#pragma unroll
            for (int kc = 0; kc < kKvRows / 8; ++kc) sm90::tf32_a_fragment(sc, kc, p_hi[kc], p_lo[kc]);
        };
        // the 16-bit kernel's turns: turn j issues S of tile j and P V of tile j - 1 as one
        // wgmma group; with two consumer warpgroups they take turns (named barriers 1 and 2)
        const auto take_turn = [&]() {
            if constexpr (kConsumers == 2) sm90::named_bar_sync(1 + wg, 2 * 128);
            sm90::fence_regs(sc);
            sm90::fence_regs(part);
            sm90::fence_regs(p_hi);
            sm90::fence_regs(p_lo);
            sm90::wgmma_fence();
        };
        const auto pass_turn = [&]() {
            if constexpr (kConsumers == 2) sm90::named_bar_arrive(2 - wg, 2 * 128);
        };
        const auto finish_turn = [&]() {
            sm90::wgmma_wait<0>();
            sm90::fence_regs(sc);
            sm90::fence_regs(part);
        };
        // a tile the producer stored has landed: its generic-proxy stores are fenced for wgmma's reads
        const auto wait_full = [&](uint32_t bar, int j) {
            sm90::mbar_wait(bar, (j / kStages) & 1);
            sm90::fence_proxy_async();
        };
        if (wg == 1) pass_turn();
        sm90::mbar_wait(full_q, 0);
        sm90::fence_proxy_async();
        wait_full(full_k(0), 0);
        take_turn();
        issue_s(0);
        sm90::wgmma_commit();
        pass_turn();
        finish_turn();
        if (lane == 0) sm90::mbar_arrive(empty_k(0));
        softmax(0);  // O is still 0: no rescale
        split_p();
        for (int j = 1; j < kv_tiles; ++j) {
            wait_full(full_k(j % kStages), j);
            wait_full(full_v((j - 1) % kStages), j - 1);
            take_turn();
            issue_s(j);
            issue_pv(j - 1);
            sm90::wgmma_commit();
            pass_turn();
            finish_turn();
            if (lane == 0) {  // this warp is done with K of tile j and V of tile j - 1
                sm90::mbar_arrive(empty_k(j % kStages));
                sm90::mbar_arrive(empty_v((j - 1) % kStages));
            }
            softmax(j);
#pragma unroll
            for (int i = 0; i < Dp / 2; ++i) o[i] = (o[i] + part[i]) * ((i & 2) ? corr_hi : corr_lo);
            split_p();
        }
        const int last = kv_tiles - 1;
        wait_full(full_v(last % kStages), last);
        take_turn();
        issue_pv(last);
        sm90::wgmma_commit();
        if (wg == 0) pass_turn();  // warpgroup 1's last turn has no taker
        finish_turn();
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) o[i] += part[i];

#pragma unroll
        for (int offset = 1; offset < 4; offset <<= 1) {
            l_lo += __shfl_xor_sync(0xffffffffu, l_lo, offset);
            l_hi += __shfl_xor_sync(0xffffffffu, l_hi, offset);
        }
        const float denom_lo = fmaxf(l_lo, 1e-30f), denom_hi = fmaxf(l_hi, 1e-30f);
        const int row_a = q0 + row_lo, row_b = row_a + 8;
        float* o_base = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
        for (int c = 0; c < Dp / 8; ++c) {
            const int col = c * 8 + t * 2;  // a pair below head_dim (a multiple of 4) or none of it
            if (col < p.head_dim) {
                if (row_a < p.seq) {
                    *reinterpret_cast<float2*>(o_base + row_a * p.o_st + col) =
                        make_float2(o[4 * c] / denom_lo, o[4 * c + 1] / denom_lo);
                }
                if (row_b < p.seq) {
                    *reinterpret_cast<float2*>(o_base + row_b * p.o_st + col) =
                        make_float2(o[4 * c + 2] / denom_hi, o[4 * c + 3] / denom_hi);
                }
            }
        }
        if (t == 0) {
            float* lse = p.lse + static_cast<long long>(bh) * p.seq;
            if (row_a < p.seq) lse[row_a] = m_lo * p.scale + logf(denom_lo);
            if (row_b < p.seq) lse[row_b] = m_hi * p.scale + logf(denom_hi);
        }
    }
}

// ------------------------------------------------------------------ SIMT path

constexpr int kWarpsSimt = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsSimt = kWarpsSimt * kRowsPerWarp;  // query rows per block
constexpr int kKeysSimt = 32;                         // keys per tile: one per lane

// T: the element type (float, bf16 or fp16), widened on load. kD: head_dim padded
// to a multiple of 32; columns at or past p.head_dim are staged as zeros, which
// add nothing to a score or an output, and are never stored.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarpsSimt * 32) flash_forward_simt(const Params p) {
    constexpr int kCols = kD / 32;  // output columns per lane
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* q_s = reinterpret_cast<float*>(smem_raw);  // [kRowsSimt][kD], read as broadcasts
    float* k_s = q_s + kRowsSimt * kD;                 // [kKeysSimt][kD + 1]: lane j reads row j, no bank conflicts
    float* v_s = k_s + kKeysSimt * (kD + 1);           // [kKeysSimt][kD]: lanes read neighbouring columns

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsSimt;  // heaviest first when causal
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

    for (int i = threadIdx.x; i < kRowsSimt * kD; i += kWarpsSimt * 32) {
        const int row = i / kD, col = i % kD;
        q_s[i] = q0 + row < p.seq && col < p.head_dim ? to_float(q_base[(q0 + row) * p.q_st + col]) : 0.0f;
    }

    float acc[kRowsPerWarp][kCols];
    float row_max[kRowsPerWarp], lane_sum[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        row_max[r] = kNegInf;
        lane_sum[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    }
    const int row0 = q0 + warp * kRowsPerWarp;  // sequence position of this warp's first row

    const int kv_end = p.causal ? min(p.seq, q0 + kRowsSimt) : p.seq;
    for (int kv0 = 0; kv0 < kv_end; kv0 += kKeysSimt) {
        __syncthreads();
        for (int i = threadIdx.x; i < kKeysSimt * kD; i += kWarpsSimt * 32) {
            const int row = i / kD, col = i % kD;
            const bool valid = kv0 + row < p.seq && col < p.head_dim;
            k_s[row * (kD + 1) + col] = valid ? to_float(k_base[(kv0 + row) * p.k_st + col]) : 0.0f;
            v_s[row * kD + col] = valid ? to_float(v_base[(kv0 + row) * p.v_st + col]) : 0.0f;
        }
        __syncthreads();

        const int key = kv0 + lane;
        float score[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) score[r] = 0.0f;
        for (int d = 0; d < kD; ++d) {
            const float k_val = k_s[lane * (kD + 1) + d];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                score[r] = fmaf(q_s[(warp * kRowsPerWarp + r) * kD + d], k_val, score[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool masked = key >= p.seq || (p.causal && key > row0 + r);
            score[r] = masked ? kNegInf : score[r] * p.scale;
            float tile_max = score[r];
#pragma unroll
            for (int offset = 16; offset > 0; offset >>= 1) {
                tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, offset));
            }
            const float new_max = fmaxf(row_max[r], tile_max);
            const float corr = expf(row_max[r] - new_max);
            row_max[r] = new_max;
            score[r] = expf(score[r] - new_max);
            lane_sum[r] = lane_sum[r] * corr + score[r];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
        }
        for (int j = 0; j < kKeysSimt; ++j) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const float prob = __shfl_sync(0xffffffffu, score[r], j);
#pragma unroll
                for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(prob, v_s[j * kD + c * 32 + lane], acc[r][c]);
            }
        }
    }

    T* o_base = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        float total = lane_sum[r];
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) total += __shfl_xor_sync(0xffffffffu, total, offset);
        const float denom = fmaxf(total, 1e-30f);
        const int row = row0 + r;
        if (row < p.seq) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                const int col = c * 32 + lane;
                if (col < p.head_dim) o_base[row * p.o_st + col] = from_float<T>(acc[r][c] / denom);
            }
            if (lane == 0) p.lse[static_cast<long long>(bh) * p.seq + row] = row_max[r] + logf(denom);
        }
    }
}

// ------------------------------------------------------------------ launch

template <typename T, int Dp, bool kFull, bool kPacked, bool kCopied = false>
int launch_wgmma(const CUtensorMap (&maps)[3], const ForwardParams<kCopied>& p, int batch, cudaStream_t stream) {
    constexpr size_t smem = ForwardTiles<Dp>::kBytes;
    const auto kernel = flash_forward_wgmma<T, Dp, kFull, kPacked, kCopied>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * p.heads, (p.seq + kRows - 1) / kRows);
    kernel<<<grid, kThreadsWgmma, smem, stream>>>(maps[0], maps[1], maps[2], p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int Dp>
int launch_width(const CUtensorMap (&maps)[3], const WgmmaParams& p, int batch, cudaStream_t stream) {
    if (p.head_dim == Dp) return launch_wgmma<T, Dp, true, false>(maps, p, batch, stream);
    if (packed_heads(p.head_dim)) return launch_wgmma<T, Dp, false, true>(maps, p, batch, stream);
    return launch_wgmma<T, Dp, false, false>(maps, p, batch, stream);
}

// The padded width: the least of 64, 128 and 256 that holds the tile's span (tma_span).
template <typename T>
int dispatch_wgmma_width(const CUtensorMap (&maps)[3], const WgmmaParams& p, int batch, cudaStream_t stream) {
    const int span = tma_span(p.head_dim, p.heads);
    if (span <= 64) return launch_width<T, 64>(maps, p, batch, stream);
    if (span <= 128) return launch_width<T, 128>(maps, p, batch, stream);
    return launch_width<T, 256>(maps, p, batch, stream);
}

// The copied-rows view at the least padded width that holds its span (copied_span).
template <typename T>
int dispatch_copied_width(const CUtensorMap (&maps)[3], const CopiedParams& p, int batch, int span, cudaStream_t stream) {
    if (span <= 64) return launch_wgmma<T, 64, false, false, true>(maps, p, batch, stream);
    if (span <= 128) return launch_wgmma<T, 128, false, false, true>(maps, p, batch, stream);
    return launch_wgmma<T, 256, false, false, true>(maps, p, batch, stream);
}

template <int Dp>
int launch_tf32x3(const Params& p, cudaStream_t stream) {
    using L = Tf32ForwardTiles<Dp>;
    const auto kernel = flash_forward_tf32x3<Dp>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(p.batch * p.heads, (p.seq + L::kRows - 1) / L::kRows);
    kernel<<<grid, L::kThreads, L::kBytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// A block per (batch*head, 16 query rows): grid (B*H, ceil(T / 16)).
template <typename T>
struct ForwardSimt {
    const Params& p;
    cudaStream_t stream;

    template <int kD>
    int run() const {
        const size_t smem = (kRowsSimt * kD + kKeysSimt * (kD + 1) + kKeysSimt * kD) * sizeof(float);
        cudaError_t err = cudaFuncSetAttribute(flash_forward_simt<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid(p.batch * p.heads, (p.seq + kRowsSimt - 1) / kRowsSimt);
        flash_forward_simt<T, kD><<<grid, kWarpsSimt * 32, smem, stream>>>(p);
        return static_cast<int>(cudaGetLastError());
    }
};

}  // namespace

// Built in three parts (HM_IN_PART): the wgmma entry, whose kernels take most of the compile, the
// copied-rows entry, and the others.
#if HM_IN_PART(1)
// q, k, v: [B, T, H, D] of one element type `dtype` (SimtDtype: bf16 or fp16),
// head_dim from 16 to 256, a multiple of 8 or with H * head_dim one, each described by
// its TMA geometry (sm90::TmaGeometry: the 4-D or the packed-heads view, byte strides,
// box of 64 columns x forward_box_rows(head_dim) rows) -> out [B, T, H, D] of that type
// (strides in elements) and lse [B, H, T] fp32 contiguous.
extern "C" int hm_flash_forward_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
                                      int batch, int seq, int heads, int head_dim,
                                      const long long* q_geometry, const long long* k_geometry,
                                      const long long* v_geometry, long long o_sb, long long o_st, long long o_sh,
                                      int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (!wgmma_takes(dtype, head_dim, heads)) return static_cast<int>(cudaErrorInvalidValue);
    const void* bases[3] = {q, k, v};
    const long long* geometries[3] = {q_geometry, k_geometry, v_geometry};
    const int box_rows = tma_span(head_dim, heads) > 128 ? ForwardTiles<256>::kKvRows : ForwardTiles<128>::kKvRows;
    CUtensorMap maps[3];
    for (int i = 0; i < 3; ++i) {
        const int err = sm90::encode_tma_map(&maps[i], bases[i], *reinterpret_cast<const sm90::TmaGeometry*>(geometries[i]),
                                             box_rows, head_dim, heads, tma_type(dtype));
        if (err != 0) return err;
    }
    const auto& k_view = *reinterpret_cast<const sm90::TmaGeometry*>(k_geometry);
    const WgmmaParams p{out, lse, seq, heads, head_dim, o_sb, o_st, o_sh, scale, causal,
                        k, k_view.strides[2], k_view.strides[1]};
    if (dtype == kSimtF16) return dispatch_wgmma_width<__half>(maps, p, batch, stream);
    return dispatch_wgmma_width<__nv_bfloat16>(maps, p, batch, stream);
}

#endif

#if HM_IN_PART(2)
// q, k, v: [B, T, H, D] of one element type `dtype` (SimtDtype: bf16 or fp16), head_dim 1 to
// 256, last dim contiguous, strides in elements, of which no TMA view exists (the wrapper's
// copied_rows): read through the copied-rows view, each block's head landing at its
// sm90::copied_shift under `modulus` (2, 4, 8 or 16 bytes) -> out [B, T, H, D] of that type and
// lse [B, H, T] fp32 contiguous, on the tensor cores.
extern "C" int hm_flash_forward_copied(const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
                                       int batch, int seq, int heads, int head_dim,
                                       long long q_sb, long long q_st, long long q_sh,
                                       long long k_sb, long long k_st, long long k_sh,
                                       long long v_sb, long long v_st, long long v_sh,
                                       long long o_sb, long long o_st, long long o_sh,
                                       int modulus, int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (!copied_takes(dtype, head_dim, modulus)) return static_cast<int>(cudaErrorInvalidValue);
    const int span = copied_span(q, 2 * q_sb, 2 * q_sh, batch, heads, head_dim, modulus);
    if (span > 256) return static_cast<int>(cudaErrorInvalidValue);
    CopiedParams p{};
    p.out = out;
    p.lse = lse;
    p.seq = seq;
    p.heads = heads;
    p.head_dim = head_dim;
    p.o_sb = o_sb;
    p.o_st = o_st;
    p.o_sh = o_sh;
    p.scale = scale;
    p.causal = causal;
    p.q = q;
    p.k = k;
    p.v = v;
    p.q_sb = 2 * q_sb, p.q_st = 2 * q_st, p.q_sh = 2 * q_sh;  // bytes
    p.k_sb = 2 * k_sb, p.k_st = 2 * k_st, p.k_sh = 2 * k_sh;
    p.v_sb = 2 * v_sb, p.v_st = 2 * v_st, p.v_sh = 2 * v_sh;
    p.modulus = modulus;
    const CUtensorMap maps[3] = {};  // not read: the copied-rows view copies every tile
    if (dtype == kSimtF16) return dispatch_copied_width<__half>(maps, p, batch, span, stream);
    return dispatch_copied_width<__nv_bfloat16>(maps, p, batch, span, stream);
}
#endif

#if HM_IN_PART(0)
// q, k, v: [B, T, H, D] fp32 (`dtype` kSimtF32) at a head_dim from 16 to 128 that is a
// multiple of 4, 16-byte aligned with strides in elements that are multiples of 4 (last dim
// contiguous) -> out [B, T, H, D] fp32 and lse [B, H, T] fp32 contiguous, on the tensor cores
// in 3xTF32.
extern "C" int hm_flash_forward_tf32x3(const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
                                       int batch, int seq, int heads, int head_dim,
                                       long long q_sb, long long q_st, long long q_sh,
                                       long long k_sb, long long k_st, long long k_sh,
                                       long long v_sb, long long v_st, long long v_sh,
                                       long long o_sb, long long o_st, long long o_sh,
                                       int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (!tf32x3_takes(dtype, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
    const Params p{q, k, v, out, lse, batch, seq, heads, head_dim,
                   q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                   scale, causal};
    return head_dim <= 64 ? launch_tf32x3<64>(p, stream) : launch_tf32x3<128>(p, stream);
}

// q, k, v: [B, T, H, D] of one element type `dtype` (SimtDtype: fp32, bf16 or
// fp16; last dim contiguous, strides in elements), head_dim 1 to 256 -> out
// [B, T, H, D] of that type and lse [B, H, T] fp32 contiguous.
extern "C" int hm_flash_forward_simt(const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
                                     int batch, int seq, int heads, int head_dim,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_st, long long k_sh,
                                     long long v_sb, long long v_st, long long v_sh,
                                     long long o_sb, long long o_st, long long o_sh,
                                     int causal, float scale, cudaStream_t stream) {
    const Params p{q, k, v, out, lse, batch, seq, heads, head_dim,
                   q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                   scale, causal};
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (dtype == kSimtF32) return dispatch_simt_width(head_dim, ForwardSimt<float>{p, stream});
    if (dtype == kSimtBf16) return dispatch_simt_width(head_dim, ForwardSimt<__nv_bfloat16>{p, stream});
    if (dtype == kSimtF16) return dispatch_simt_width(head_dim, ForwardSimt<__half>{p, stream});
    return static_cast<int>(cudaErrorInvalidValue);
}
#endif
