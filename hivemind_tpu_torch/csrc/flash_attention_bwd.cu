// Flash-attention backward for Hopper (sm_90a): the two passes of the standard
// two-pass scheme, from the forward's saved lse and delta = rowsum(dO * O):
//   dQ pass:    dQ = sum_kv dS K
//   dK/dV pass: dV = sum_q P^T dO,  dK = sum_q dS^T Q
// with P = exp(S*scale - lse) recomputed per tile (S = Q K^T) and
// dS = P * (dO V^T - delta) * scale. Tensors are [B, T, H, D], read through their
// strides; lse and delta are [B, H, T] fp32 contiguous.
//
// Replaces: hivemind_tpu/ops/pallas_attention.py — `_flash_backward`, its two
// `pl.pallas_call`s: the dQ pass (body `_flash_bwd_dq_kernel`) and the dK/dV pass
// (body `_flash_bwd_dkv_kernel`), both built on `_bwd_tile`. The plain PyTorch
// versions and the wrappers are hivemind_tpu_torch/ops/flash_attention.py.
//
// What bounds it: operations. The dQ pass does three products per (query, key)
// pair (S, dP, dQ: 6*D operations), the dK/dV pass four (S, dP, dV, dK: 8*D),
// half of that when causal. At ALBERT's training shape [32, 512, 12, 64] the dK/dV
// pass does 8*32*12*512*512*64 = 5.2e10 operations against ~0.2 GB read and
// written: ~260 operations per byte, near the H100's ~295 bf16 operations per
// byte; at the Llama shape [1, 2048, 32, 128] it is far above. The design keeps
// every score, probability and dS in registers (never in device memory) and feeds
// the tensor cores; the accumulators stay in registers across the whole sweep.
//
// The TPU carried dq_acc and dk_acc/dv_acc in VMEM across sequential grid steps;
// blocks here run in parallel in no order, so each sweep is a loop inside the
// block and its accumulators live in registers in fp32. Two passes and no
// atomics: the result is deterministic. In the wgmma passes P and dS are rounded
// to the input type (bf16 or fp16) before their products: that rounding is their
// only difference from the TPU kernel, which multiplied fp32 tiles (a product of
// two 16-bit values is exact in fp32, and every sum is fp32). fp16's dS overflows
// past 65504, as FlashAttention-2's does: |dS| = P |dP - delta| D^-1/2 <= 65504
// holds while |dP - delta| stays below 65504 * D^1/2 (5.2e5 at D = 64). Columns
// past T (and above the diagonal when causal) are masked to P = 0 explicitly, so
// nothing relies on a padded lse.
//
// Both wgmma passes (building blocks in sm90.cuh; bf16 and fp16 at a head_dim from 16
// to 256 that is a multiple of 8, or any other whose H * head_dim is, and the dK/dV pass
// on the copied-rows view at every other 16-bit head_dim from 1 to 256; templates <T, Dp,
// kFull, kPacked> and, dK/dV, kCopied: T the element type, Dp the head_dim padded to 64,
// 128 or 256, kFull whether head_dim is Dp, kPacked whether the packed-heads view is read,
// kCopied whether the producer copies every tile, below) run one
// thread block per 128 rows (query rows for dQ, KV rows for dK/dV; 64 KV rows at a
// padded width of 256) of one batch*head, in three warpgroups: two consumer
// warpgroups own 64 of those rows each (or, in the dK/dV pass at 256, the same 64
// rows and half the columns each), whose tiles stay resident in shared memory, and
// one warp of the third (the producer) streams the other side's tiles by TMA
// through a ring. The producer warpgroup gives its registers to the consumers
// (setmaxnreg 24 / 240; 40 / 232 on the packed-heads view). Every tensor is read by
// TMA through one geometry the wrapper gives both passes: boxes of 64 columns x 64
// rows, so a 128-row tile is two boxes per 64 columns, which land where one 128-row
// box would (the dQ pass at 256 encodes K's and V's maps with boxes of 32 rows). A head_dim below Dp: TMA
// reads the columns past it as zeros, a 64-column region wholly past it (Dp = 256,
// head_dim <= 192) is zeroed once and never loaded, and only columns below it are
// stored (kFull keeps the full-width stores free of the column test, which costs a
// full-width tile 1-3%). fp16 uses the .f16 wgmma forms; swizzle, descriptors and
// boxes are bf16's (both are 2 bytes). Every wgmma is issued outside any branch
// (ptxas serializes them all otherwise, note C7520). The exponent is
// 2^(S * D^-1/2 * log2(e) - lse * log2(e)) by ex2.approx. Masking is applied only
// on the tiles that meet the diagonal when causal and on the tile holding T; TMA
// reads rows past T as zeros, and rows past T are never stored.
//
// dQ pass, wgmma (`flash_bwd_dq_wgmma<T, Dp, kFull, kPacked>`):
//  * Grid (B*H, query tiles of 128 rows), the heaviest query tiles first when
//    causal (the last tile of each batch*head first), as the forward. Q and dO of
//    the block's 128 rows are loaded once; K and V tiles stream through a ring,
//    with separate full / empty mbarriers for K and for V: V's slot is freed once
//    dP is done, K's once dS K is. At Dp <= 128 the tiles are 64 rows and the ring
//    four stages (Q, dO and the ring: 192 KB of shared memory at 128). Each
//    consumer thread keeps lse (times log2 e) and delta of its two rows in
//    registers for the whole sweep.
//  * S = Q K^T and dP = dO V^T are wgmma m64nNk16 (N = the KV tile's rows) with
//    every operand K-major in shared memory; dS = P * (dP - delta) * D^-1/2 is
//    computed in place in the accumulator layout, which is the A-register layout,
//    and packed to T.
//  * dQ += dS K is wgmma m64nDpk16 with dS from registers and K read MN-major
//    through the transpose-B flag (the k dimension is K's rows): no transposed
//    copy of K.
//  * One wgmma group per KV tile: S and dP of tile j with dS K of tile j - 1
//    (the first group S and dP only, a last one dS K only), so each tile waits on
//    the tensor cores once. At Dp = 128 a consumer thread holds S, dP (32 + 32),
//    dQ (64) and the dS fragments (16): 144 of its 240 registers.
//  * Dp = 256: dQ of a warpgroup's 64 rows is 128 fp32 registers a thread, and Q
//    and dO of 128 rows take 128 KB, so K and V tiles are 32 rows (S and dP are
//    m64n32k16: 16 + 16 registers, dS 8) in a ring of three 32 KB stages (224 KB
//    in all). Each turn computes dO's descriptors anew (an empty asm on its base):
//    held across the sweep beside Q's, they are 64 more registers, and spill.
//    The other candidate, the dK/dV pass's layout (64 query rows a block, each
//    warpgroup half of dQ's columns and the whole S and dP: 5/3 of the products;
//    a ring of two 64 KB stages), measured 1.7-1.9x slower at 2048 tokens
//    (PERF.md, the dQ pass at 256): a K slot is freed only a turn after its S,
//    so two stages leave the producer a turn behind. It was faster only where
//    128-row blocks leave most SMs idle ([1, 512, 4, 256]: 16 blocks).
//  * The two consumer warpgroups take turns issuing their groups (ping-pong, two
//    named barriers, as the forward), so one computes dS while the other's
//    products run: faster on an H100 than letting them issue freely, at every
//    shape timed. The ring is deep because a K slot is freed only a turn after
//    its tile's S: at ALBERT's shape two stages were slower than three, and
//    three slower than four (PERF.md, the dQ pass's redesign).
//  * Causal: the KV loop ends at the block's diagonal tiles; warpgroup 0 also runs
//    the last 64 KV rows (a tile, or two at 256), which lie wholly above its rows
//    and mask to zero, so that both warpgroups release every ring slot.
//
// dK/dV pass, wgmma (`flash_bwd_dkv_wgmma<T, Dp, kFull, kPacked>`):
//  * Grid (B*H, KV tiles of 128 rows; 64 at Dp = 256). K and V of the block stay
//    resident; Q and dO tiles of 64 rows stream through a ring of two stages, and
//    the producer
//    warp stages their lse (times log2 e) and delta by plain loads, which a TMA
//    map on [B*H, T] fp32 could not take for a T that is not a multiple of 4. At
//    D = 128 each consumer thread holds dK and dV (64 + 64 fp32) and S^T, dP^T
//    (32 + 32).
//  * S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with every operand K-major
//    in shared memory; P^T and dS^T are rounded to T in place as A operands.
//  * dV += P^T dO and dK += dS^T Q are wgmma with the A operand from registers
//    and dO, Q read MN-major through the transpose-B flag.
//  * Causal: the query loop starts at the diagonal tile.
//  * Dp = 256: a consumer warpgroup cannot hold dK and dV of 64 rows (2 x 128 fp32
//    registers a thread) beside S^T and dP^T. The block owns 64 KV rows and the
//    two warpgroups split the head dim's columns: each computes S^T and dP^T of
//    the same rows (over all 256 columns) and accumulates dK and dV of its 128
//    columns. That keeps both warpgroups on one code path, with no role branch
//    around a wgmma, and each thread's registers exactly as at Dp = 128 (dK, dV
//    64 + 64, S^T, dP^T 32 + 32), which builds without a spill; it costs S^T and
//    dP^T twice, 1.5x the products of one pass (FlashAttention-3's alternative,
//    P^T and dS^T through shared memory, computes them once). Shared memory: K, V
//    2 x 32 KB resident, Q, dO 2 stages x 2 x 32 KB, lse and delta (193 KB).
//
// The packed-heads view (kPacked, both passes: a head_dim that is not a multiple of 8,
// as the forward's): every tensor is read as (H * head_dim, T, B), head h's columns at
// the tile's [s, s + head_dim), s = (h * head_dim) % 8, as the forward lands them.
// Heads are kept apart as the TPU kernels keep them: every product that sums over the
// tile's columns (S, dP; S^T, dP^T) must meet zeros on both sides outside the head's
// (0 * inf is NaN). The resident tiles come by TMA with their neighbours' columns,
// which the consumers zero once they land (Q and dO in the dQ pass, K and V in the
// dK/dV pass; a proxy fence and a named barrier before the first wgmma). The streamed
// tiles (K and V; Q and dO) are never given them: the producer warpgroup's 128
// threads copy each tile's head bytes alone by cp.async, a row a thread (half of them
// on each of the two streamed tensors; sm90::load_head_row), into rings zeroed once at
// the start, and the consumers fence the async proxy after each stage's barrier.
// The products that sum over rows (dS K; P^T dO, dS^T Q) read column c of the streamed
// tile into column c of the result alone. Column s + d of dQ, dK and dV is the head's
// column d, the rest are never stored, and each stored column is a 2-byte store of its
// own.
//
// The copied-rows view (kCopied, the dK/dV pass: a 16-bit input no TMA view takes, as the
// forward's, flash_attention.cu). No tensor map is read: the producer warpgroup's 128 threads
// copy K and V once (half the threads each, two rows a thread at 128 rows) and then each Q
// and dO tile (a row a thread, half on each) a head's bytes at a time by
// sm90::load_head_row<true>, into tiles and rings zeroed once, the head at column s =
// sm90::copied_shift of q's row 0 under the wrapper's modulus, each row in pieces its own
// alignment allows; lse and delta are staged as the packed view's. The consumers zero
// nothing and fence the async proxy after the K/V barrier and each stage's; stores as the
// packed view's; the Dp = 256 column split as above; setmaxnreg 40 / 232. The dQ pass on
// these inputs stays on SIMT (the next redesign).
//
// Later work (not here): the ping-pong of the two consumer warpgroups and a deeper
// ring in the dK/dV pass, a persistent grid, TMA stores of the outputs.
//
// dK/dV pass, 3xTF32 (`flash_bwd_dkv_tf32x3<Dp>`: fp32 at a head_dim from 16 to 128 that is
// a multiple of 4; Dp 64 or 128), the arithmetic of the forward's 3xTF32 design
// (flash_attention.cu): every operand split into TF32 hi and lo, each product a_lo b_hi +
// a_hi b_lo + a_hi b_hi, the small terms first; three times the tensor work, each product
// near 2^-21 relative where plain TF32 errs near 2^-10.
//  * One consumer warpgroup owns the block's 64 KV rows (grid (B*H, T / 64)); K and V stay
//    resident (hi and lo), Q and dO stream in stages of 32 query rows (Dp = 64, two stages)
//    or 16 (Dp = 128, one stage: K and V take 128 KB there).
//  * S^T = K Q^T and dP^T = V dO^T read every operand K-major as it stands. dV += P^T dO and
//    dK += dS^T Q sum over query rows, and tf32 wgmma reads shared memory K-major only, so a
//    stage also holds dO^T and Q^T, stored transposed by the producer with their queries in
//    sm90::tf32_k_slot order to match the A fragments of P^T and dS^T built from the
//    accumulators in registers (sm90::tf32_a_fragment). A stage: Q, dO, Q^T, dO^T, each hi and
//    lo (Q^T and dO^T in one 32-query region, half unread at 16 queries), with lse (times log2
//    e) and delta: 64 KB at Dp = 64 (192 KB in all with K and V), 96 KB at 128 (224 KB).
//  * The producer warpgroup's 128 threads load each stage with 16-byte loads into registers
//    while the ring drains (sm90::Tf32RowLoader), split and store it, fence the async proxy
//    and arrive on the stage's "full" mbarrier.
//  * dV and dK are summed over each stage's queries into a partial that starts from zero
//    and added to their accumulators by the CUDA cores. The tensor core's additions round
//    toward zero, relative to the sum they add to: carried through the whole sweep, dK and dV
//    drifted by the sweep's length (their norm ratio to the plain version grew with T, past
//    fp32's 1e-5 on an H100); a stage's partial drifts by the stage's.
//  * Masks only on the tiles that meet the diagonal and the tile holding T; rows past T are
//    never stored; views read through their strides.
//
// dQ pass, 3xTF32 (`flash_bwd_dq_tf32x3<Dp>`: the inputs the 3xTF32 dK/dV pass takes), the
// dK/dV pass turned round, in the 3xTF32 forward's block shape. What bounds it: operations, three
// TF32 products for each of the pass's 6 D a (query, key) pair (0.2343 ms at ALBERT's
// [32, 512, 12, 64] on an H100 SXM); the SIMT pass it replaces reached 22% of the CUDA cores' FMA
// bound, restaging K and V for every 16 query rows.
//  * Q and dO of the block's query rows stay resident (hi and lo, split once a block); K and V
//    stream in 32-key tiles through a ring. S = Q K^T and dP = dO V^T read every operand
//    K-major as it stands, three SS wgmmas a k-step. dQ += dS K sums over keys, and tf32 wgmma
//    reads shared memory K-major only, so the producer also stores K^T, its keys in tf32_k_slot
//    order, through a ring of its own: dS is the A operand, taken from the accumulator by
//    sm90::tf32_a_fragment without register moves. K and V of a tile are freed once S and dP are
//    done, K^T a turn later, once dS K is, so each has its own full / empty mbarriers, and the
//    producer stores K and V of tile j before K^T of tile j - 1, the order the consumers read them.
//  * Turns as the 16-bit dQ pass's: turn j issues S and dP of tile j with dS K of tile j - 1 as
//    one wgmma group. Dp = 64: two consumer warpgroups of 64 query rows take turns (ping-pong,
//    setmaxnreg 104 / 200); Q and dO of 128 rows (hi and lo) 128 KB, 32-key K and V tiles in two
//    slots (2 x 32 KB), K^T in two (2 x 16 KB): 224 KB; on an H100 one consumer warpgroup of 64
//    rows with three slots of each ring (208 KB) was the slower. Dp = 128: one consumer warpgroup
//    of 64 rows; Q and dO 128 KB, 32-key K and V tiles in one slot (64 KB), K^T in one (32 KB):
//    224 KB; 16-key tiles in two K and V slots (S and dP as m64n16k8 wgmmas) were the slower. A
//    consumer thread at Dp = 128 holds dQ (64 fp32), the tile's partial (64), S and dP (16 + 16)
//    and dS's fragments (32).
//  * dQ is summed a tile at a time: dS K of a tile into a partial from zero, added to dQ by the
//    CUDA cores (the tensor core's rounding, above). lse (times log2 e) and delta of a thread's
//    two rows stay in registers for the whole sweep; P = ex2.approx(S scale log2 e - lse log2 e).
//  * Query tiles heaviest first; causal, the KV loop ends at the block's diagonal, both
//    warpgroups run every tile (the first one's last 64 keys mask to zero) and free every slot;
//    masks only on the tiles that meet a warpgroup's diagonal and the tile holding T; rows past T
//    never stored, dQ stored as float2 pairs below head_dim; views read through their strides.
//
// SIMT (every input the wgmma and 3xTF32 passes do not take: fp32 at a head_dim that is not a
// multiple of 4 or outside 16 to 128; and the dQ pass of the 16-bit inputs the copied-rows view
// takes, whose dK/dV pass SIMT ran before it and chip_smoke.py still times beside it; any
// head_dim up to 256, as the TPU kernels take the whole head_dim as their block):
// plain fp32 FMAs on the CUDA cores, no TF32, the inputs widened to fp32 as they are
// staged and P and dS kept in fp32, as the TPU kernels. A warp owns 4 rows (query
// rows in the dQ kernel, KV rows in the dK/dV kernel); lane j takes column j of a
// 32-wide tile, and each lane accumulates kD/32 output columns from the per-column
// terms broadcast by shuffles. kD is head_dim rounded up to 32, 64, 96, 128 or 256,
// its extra columns zeros.

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;    // [B, H, T]
    const float* delta;  // [B, H, T]
    void* out0;          // dq, or dk
    void* out1;          // dv (dK/dV pass)
    int batch, seq, heads, head_dim;
    long long q_sb, q_st, q_sh;
    long long k_sb, k_st, k_sh;
    long long v_sb, v_st, v_sh;
    long long d_sb, d_st, d_sh;
    long long o_sb, o_st, o_sh;  // the outputs' layout (one for all)
    float scale;
    int causal;
};

constexpr int kWarps = 4;  // warps of an fp32 block

// ------------------------------------------------------------------ wgmma path

constexpr int kBlockRows = 128;  // query rows a dQ block owns: two consumer warpgroups of 64
constexpr int kBoxRows = 64;     // rows of the wrapper's TMA boxes, and of every streamed tile but the dQ pass's at 256
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;  // two consumer warpgroups and the producer's
constexpr int kProducerThreads = kThreads - kConsumerWarps * 32;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168
// the packed-heads view's producer threads copy rows by cp.async (sm90::load_head_row), which
// spilled 4-8 bytes in 24 registers: 128 * 40 + 256 * 232 = 384 * 168, with no spill on either side
constexpr int kPackedProducerRegs = 40, kPackedConsumerRegs = 232;
// the copied-rows view's producer threads copy K and V, then Q and dO, by cp.async (load_head_row<true>)
constexpr int kCopiedProducerRegs = 40, kCopiedConsumerRegs = 232;

struct WgmmaParams {
    const float* lse;    // [B, H, T]
    const float* delta;  // [B, H, T]
    void* out0;          // dq, or dk
    void* out1;          // dv (dK/dV pass)
    int seq, heads, head_dim;
    long long o_sb, o_st, o_sh;  // the outputs' layout
    float scale;
    int causal;
    // the tensors a pass streams (dQ: k, v; dK/dV: q, dout), which the packed-heads
    // view's kernels copy by cp.async; their batch and row strides in bytes
    const void* streamed[2];
    long long streamed_sb[2], streamed_st[2];
};

// The copied-rows view's parameters (the dK/dV pass), which copies every tile by cp.async:
// WgmmaParams' fields, then the streamed tensors' head strides, the resident ones (k, v) with their
// batch, row and head strides (bytes), and the shift modulus (sm90::copied_shift). A struct of its
// own, so that the other views' kernels take WgmmaParams alone, as the forward's
// (flash_attention.cu); and a flat one: the same fields in a struct derived from WgmmaParams ran
// this pass 20% slower at head dim 20 on an H100 (PERF.md, section 6).
struct CopiedParams {
    const float* lse;
    const float* delta;
    void* out0;
    void* out1;
    int seq, heads, head_dim;
    long long o_sb, o_st, o_sh;
    float scale;
    int causal;
    const void* streamed[2];
    long long streamed_sb[2], streamed_st[2], streamed_sh[2];
    const void* resident[2];
    long long resident_sb[2], resident_st[2], resident_sh[2];
    int modulus;
};

template <bool kCopied>
using DkvParams = std::conditional_t<kCopied, CopiedParams, WgmmaParams>;

// Write a warpgroup's 64 x N fp32 accumulator as T into rows `row_a` and `row_a + 8`
// of this thread and columns from `col0`: acc[4n + e] holds row row_a + 8*(e >> 1),
// column col0 + 8n + 2t + (e & 1) (the wgmma m64nN accumulator layout); rows at or
// past `seq` are not stored, nor (kMasked) columns at or past `head_dim`, a multiple
// of 8. kPacked: `head_dim` is any other, in the packed-heads view, where tile column
// shift + d holds the head's column d and a row starts only 2-byte aligned: each
// column is stored (or not) on its own.
template <bool kMasked, bool kPacked, typename T, int N>
__device__ __forceinline__ void store_rows(T* base, long long row_stride, const float* acc, int row_a, int seq, int t,
                                           int col0, int head_dim, int shift = 0) {
    const int row_b = row_a + 8;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
        const int col = col0 + n * 8 + t * 2;
        if constexpr (kPacked) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = e < 2 ? row_a : row_b, d = col + (e & 1) - shift;
                if (row < seq && d >= 0 && d < head_dim) base[row * row_stride + d] = from_float<T>(acc[4 * n + e]);
            }
        } else if (!kMasked || col0 + n * 8 < head_dim) {
            if (row_a < seq) {
                *reinterpret_cast<uint32_t*>(base + row_a * row_stride + col) = sm90::pack2<T>(acc[4 * n], acc[4 * n + 1]);
            }
            if (row_b < seq) {
                *reinterpret_cast<uint32_t*>(base + row_b * row_stride + col) =
                    sm90::pack2<T>(acc[4 * n + 2], acc[4 * n + 3]);
            }
        }
    }
}

// TMA of one tile of kRows rows from row `row0`: its first `boxes` regions of 64
// columns x kRows rows, one after the other, each loaded as kRows / kBox boxes of
// kBox rows (8 rows of 128 bytes are one swizzle period, so a box lands where the
// same rows of one taller box would). `origin`: the head's (column, head) coordinates.
template <int kBox, int kRows>
__device__ __forceinline__ void load_tile_tma(uint32_t dst, const CUtensorMap* map, uint32_t bar, int boxes, int2 origin,
                                              int row0, int b) {
#pragma unroll
    for (int col = 0; col < boxes; ++col) {
#pragma unroll
        for (int part = 0; part < kRows / kBox; ++part) {
            sm90::tma_load_4d(dst + (col * kRows + part * kBox) * sm90::kSwizzleRowBytes, map, bar,
                              origin.x + col * sm90::kBoxCols, origin.y, row0 + part * kBox, b);
        }
    }
}

// dQ pass: shared-memory layout at the padded width Dp (byte offsets from a
// 1024-aligned base).
template <int Dp>
struct DqTiles {
    // K and V tiles of 64 rows, or 32 at Dp = 256, where a consumer thread holds dQ of
    // its warpgroup's 64 rows (64 x 256 fp32: 128 registers) beside S and dP of a tile;
    // a ring of four stages, or three at 256 (3 x 32 KB beside Q and dO's 128 KB)
    static constexpr int kKvRows = Dp > 128 ? 32 : 64;
    static constexpr int kStages = Dp > 128 ? 3 : 4;
    static constexpr int kBoxes = Dp / sm90::kBoxCols;  // 64-column regions of a tile
    static constexpr uint32_t kQBox = kBlockRows * sm90::kSwizzleRowBytes;  // one region of Q or dO: 16 KB
    static constexpr uint32_t kKvBox = kKvRows * sm90::kSwizzleRowBytes;    // one region of a K or V tile: 8 or 4 KB
    static constexpr uint32_t kQTile = kQBox * kBoxes, kKvTile = kKvBox * kBoxes;
    static constexpr uint32_t kQ = 0, kDo = kQTile, kK = 2 * kQTile, kV = kK + kStages * kKvTile;
    static constexpr uint32_t kBarriers = kV + kStages * kKvTile;  // full_qdo, full_k[S], full_v[S], empty_k[S], empty_v[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 4 * kStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// T: __nv_bfloat16 or __half. Dp: head_dim padded to 64, 128 or 256; columns at or
// past head_dim read as zeros and are never stored. kFull: head_dim == Dp, whose
// stores need no column test. kPacked: the packed-heads view (a head_dim that is not a
// multiple of 8): Q's and dO's columns outside the head's are zeroed once they land, K
// and V are copied a head's bytes at a time into rings zeroed once, and each column of
// dQ is stored on its own.
template <typename T, int Dp, bool kFull, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                       const WgmmaParams p) {
    using L = DqTiles<Dp>;
    constexpr int kKvRows = L::kKvRows, kStages = L::kStages;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (sm90::smem_addr(smem_raw) + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    const uint32_t full_qdo = base + L::kBarriers;
    const auto full_k = [&](int s) { return full_qdo + 8 * (1 + s); };
    const auto full_v = [&](int s) { return full_qdo + 8 * (1 + kStages + s); };
    const auto empty_k = [&](int s) { return full_qdo + 8 * (1 + 2 * kStages + s); };
    const auto empty_v = [&](int s) { return full_qdo + 8 * (1 + 3 * kStages + s); };

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q_tiles = (p.seq + kBlockRows - 1) / kBlockRows;
    const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.y)) * kBlockRows;  // heaviest first
    const int kv_end = p.causal ? min(p.seq, q0 + kBlockRows) : p.seq;        // causal: up to the diagonal
    const int kv_tiles = (kv_end + kKvRows - 1) / kKvRows;
    const int2 origin = sm90::head_origin(h, p.head_dim, kPacked);  // as the forward's
    const int shift = sm90::head_shift(h, p.head_dim, kPacked);
    // The regions TMA loads, as the other passes: at Dp = 256 a region wholly past a
    // head_dim of 192 or less (past shift + head_dim, packed) is zeroed once here and
    // never loaded.
    const int boxes =
        !kFull && Dp > 128 ? (shift + p.head_dim + sm90::kBoxCols - 1) / sm90::kBoxCols : L::kBoxes;
    if (!kFull && Dp > 128 && boxes < L::kBoxes) {
        for (int region = boxes; region < L::kBoxes; ++region) {
            sm90::zero_shared(base + L::kQ + region * L::kQBox, L::kQBox);
            sm90::zero_shared(base + L::kDo + region * L::kQBox, L::kQBox);
            for (int s = 0; s < kStages; ++s) {
                sm90::zero_shared(base + L::kK + s * L::kKvTile + region * L::kKvBox, L::kKvBox);
                sm90::zero_shared(base + L::kV + s * L::kKvTile + region * L::kKvBox, L::kKvBox);
            }
        }
        sm90::fence_proxy_async();
    }
    if constexpr (kPacked) {  // K's and V's rings: zeros, of which load_head_row overwrites only the head's columns
        sm90::zero_shared(base + L::kK, 2 * kStages * L::kKvTile);
        sm90::fence_proxy_async();
    }

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_qdo, 1);
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(full_k(s), kPacked ? kProducerThreads / 2 : 1);  // packed: half the producer threads each
            sm90::mbar_init(full_v(s), kPacked ? kProducerThreads / 2 : 1);
            sm90::mbar_init(empty_k(s), kConsumerWarps);
            sm90::mbar_init(empty_v(s), kConsumerWarps);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumerWarps * 32) {  // the producer warpgroup; one thread issues every TMA load
        sm90::setmaxnreg_dec<kPacked ? kPackedProducerRegs : kProducerRegs>();
        if constexpr (kPacked) {  // half the producer threads copy K's head bytes, half V's, a row (or half) each;
                                  // thread 0 also loads Q and dO by TMA
            const int thread = threadIdx.x - kConsumerWarps * 32;
            if (thread == 0) {
                sm90::mbar_arrive_expect_tx(full_qdo, 2 * boxes * L::kQBox);
                load_tile_tma<kBoxRows, kBlockRows>(base + L::kQ, &tm_q, full_qdo, boxes, origin, q0, b);
                load_tile_tma<kBoxRows, kBlockRows>(base + L::kDo, &tm_do, full_qdo, boxes, origin, q0, b);
            }
            constexpr int kHalf = kProducerThreads / 2, kParts = kHalf / kKvRows;  // threads a row: 1, or 2 at Dp = 256
            const int which = thread / kHalf, row = thread % kKvRows;  // which: 0 K, 1 V
            const int2 bytes = sm90::row_part(2 * shift, 2 * (shift + p.head_dim), thread % kHalf / kKvRows, kParts);
            // selects, not p.streamed[which]: a kernel parameter indexed at run time is copied to local memory
            const char* line = static_cast<const char*>(which ? p.streamed[1] : p.streamed[0]) +
                               b * (which ? p.streamed_sb[1] : p.streamed_sb[0]) + 2LL * origin.x;
            const long long row_bytes = which ? p.streamed_st[1] : p.streamed_st[0];
            const uint32_t ring = base + (which ? L::kV : L::kK);
            for (int j = 0; j < kv_tiles; ++j) {
                const int s = j % kStages;
                const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round passes at once
                sm90::mbar_wait(which ? empty_v(s) : empty_k(s), parity);
                sm90::load_head_row(ring + s * L::kKvTile, L::kKvBox, line, row_bytes, bytes.x, bytes.y, j * kKvRows,
                                    row, p.seq);
                sm90::cp_async_arrive(which ? full_v(s) : full_k(s));
                sm90::mbar_arrive(which ? full_v(s) : full_k(s));
            }
        } else if (threadIdx.x == kConsumerWarps * 32) {
            sm90::mbar_arrive_expect_tx(full_qdo, 2 * boxes * L::kQBox);
            load_tile_tma<kBoxRows, kBlockRows>(base + L::kQ, &tm_q, full_qdo, boxes, origin, q0, b);
            load_tile_tma<kBoxRows, kBlockRows>(base + L::kDo, &tm_do, full_qdo, boxes, origin, q0, b);
            for (int j = 0; j < kv_tiles; ++j) {
                const int s = j % kStages;
                const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round passes at once
                sm90::mbar_wait(empty_k(s), parity);
                sm90::mbar_arrive_expect_tx(full_k(s), boxes * L::kKvBox);
                load_tile_tma<kKvRows, kKvRows>(base + L::kK + s * L::kKvTile, &tm_k, full_k(s), boxes, origin,
                                                j * kKvRows, b);
                sm90::mbar_wait(empty_v(s), parity);
                sm90::mbar_arrive_expect_tx(full_v(s), boxes * L::kKvBox);
                load_tile_tma<kKvRows, kKvRows>(base + L::kV + s * L::kKvTile, &tm_v, full_v(s), boxes, origin,
                                                j * kKvRows, b);
            }
        }
    } else {  // two consumer warpgroups, 64 query rows each
        sm90::setmaxnreg_inc<kPacked ? kPackedConsumerRegs : kConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;  // this thread's query rows
        const float scale2 = p.scale * sm90::kLog2e;
        const long long rows = static_cast<long long>(bh) * p.seq;
        const float lse_a = row_a < p.seq ? p.lse[rows + row_a] * sm90::kLog2e : 0.0f;
        const float lse_b = row_b < p.seq ? p.lse[rows + row_b] * sm90::kLog2e : 0.0f;
        const float delta_a = row_a < p.seq ? p.delta[rows + row_a] : 0.0f;
        const float delta_b = row_b < p.seq ? p.delta[rows + row_b] : 0.0f;

        float dq[Dp / 2];
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) dq[i] = 0.0f;
        float sc[kKvRows / 2], dp[kKvRows / 2];  // S = Q K^T (then dS) and dP = dO V^T of one KV tile: 64 x kKvRows
        uint32_t df[kKvRows / 16][4];            // dS as the A operand of dS K, 16 keys each

        const uint32_t q_wg = base + L::kQ + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        const uint32_t do_wg = base + L::kDo + wg * 64 * sm90::kSwizzleRowBytes;
        // S and dP of KV tile j. The descriptors of Q and dO are loop-invariant, and the
        // compiler holds them across the sweep; at Dp = 256 their 32 (64 registers)
        // beside dQ's 128 spill, so dO's base passes through an empty asm at each
        // call and its 16 are stepped from one descriptor there (by the offset / 16:
        // the 14-bit address field cannot carry).
        const auto issue_s_dp = [&](int j) {
            uint32_t do_rows = do_wg;
            if constexpr (Dp > 128) asm volatile("" : "+r"(do_rows));
            const uint64_t q_desc = sm90::desc_kmajor(q_wg), do_desc = sm90::desc_kmajor(do_rows);
            const uint32_t k_tile = base + L::kK + (j % kStages) * L::kKvTile;
            const uint32_t v_tile = base + L::kV + (j % kStages) * L::kKvTile;
#pragma unroll
            for (int kk = 0; kk < Dp / 16; ++kk) {
                // region kk / 4, then 32 bytes (16 columns) along its swizzled 128-byte rows
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                sm90::wgmma_ss<T>(sc, q_desc + (q_off >> 4), sm90::desc_kmajor(k_tile + kv_off), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < Dp / 16; ++kk) {
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                sm90::wgmma_ss<T>(dp, do_desc + (q_off >> 4), sm90::desc_kmajor(v_tile + kv_off), kk > 0);
            }
        };
        // dQ += dS K of KV tile j, dS from df
        const auto issue_dq = [&](int j) {
            const uint32_t k_tile = base + L::kK + (j % kStages) * L::kKvTile;
#pragma unroll
            for (int kc = 0; kc < kKvRows / 16; ++kc) {  // 16 keys per k-step: 2048 bytes down K's regions
                sm90::wgmma_rs_tb<T>(dq, df[kc], sm90::desc_mnmajor(k_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kKvBox),
                                     1);
            }
        };
        // dS of tile j in place of its scores (column c of the tile is key kv0 + c), packed into df
        const auto make_ds = [&](int j) {
            const int kv0 = j * kKvRows;
            const bool edge = kv0 + kKvRows > p.seq || (p.causal && kv0 + kKvRows - 1 > q0 + wg * 64);
#pragma unroll
            for (int e = 0; e < kKvRows / 2; ++e) {
                const bool hi = e & 2;  // row_b's entries
                float prob = sm90::exp2_approx(fmaf(sc[e], scale2, -(hi ? lse_b : lse_a)));
                if (edge) {
                    const int col = kv0 + (e / 4) * 8 + 2 * t + (e & 1);
                    if (col >= p.seq || (p.causal && col > (hi ? row_b : row_a))) prob = 0.0f;
                }
                sc[e] = prob * (dp[e] - (hi ? delta_b : delta_a)) * p.scale;
            }
#pragma unroll
            for (int kc = 0; kc < kKvRows / 16; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) df[kc][r] = sm90::pack2<T>(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
            }
        };
        // Turn j issues S and dP of tile j and dS K of tile j - 1 as one wgmma group
        // (the first turn S and dP only, the last dS K only). The two warpgroups
        // take turns (named barriers 1 and 2, warpgroup 0 first), so one
        // warpgroup's dS runs while the other's products occupy the tensor cores.
        const auto take_turn = [&]() {
            sm90::named_bar_sync(1 + wg, 2 * 128);
            sm90::fence_regs(sc);
            sm90::fence_regs(dp);
            sm90::fence_regs(dq);
            sm90::fence_regs(df);
            sm90::wgmma_fence();
        };
        const auto pass_turn = [&]() { sm90::named_bar_arrive(2 - wg, 2 * 128); };
        const auto finish_turn = [&]() {
            sm90::wgmma_wait<0>();
            sm90::fence_regs(sc);
            sm90::fence_regs(dp);
            sm90::fence_regs(dq);
        };
        // K and V of tile j have landed; packed, their cp.async bytes are then fenced for wgmma's reads
        const auto wait_kv = [&](int j) {
            sm90::mbar_wait(full_k(j % kStages), (j / kStages) & 1);
            sm90::mbar_wait(full_v(j % kStages), (j / kStages) & 1);
            if constexpr (kPacked) sm90::fence_proxy_async();
        };
        if (wg == 1) pass_turn();
        sm90::mbar_wait(full_qdo, 0);
        if constexpr (kPacked) {  // Q's and dO's columns around the head's hold its neighbours': zero them before any S
            sm90::zero_around_head(base + L::kQ, L::kQBox, kBlockRows, shift, p.head_dim, boxes * sm90::kBoxCols,
                                   threadIdx.x, kConsumerWarps * 32);
            sm90::zero_around_head(base + L::kDo, L::kQBox, kBlockRows, shift, p.head_dim, boxes * sm90::kBoxCols,
                                   threadIdx.x, kConsumerWarps * 32);
            sm90::fence_proxy_async();
            sm90::named_bar_sync(3, kConsumerWarps * 32);
        }
        wait_kv(0);
        take_turn();
        issue_s_dp(0);
        sm90::wgmma_commit();
        pass_turn();
        finish_turn();
        if (lane == 0) sm90::mbar_arrive(empty_v(0));  // this warp is done with V of tile 0
        make_ds(0);
        for (int j = 1; j < kv_tiles; ++j) {
            const int s = j % kStages;
            wait_kv(j);
            take_turn();
            issue_s_dp(j);
            issue_dq(j - 1);
            sm90::wgmma_commit();
            pass_turn();
            finish_turn();
            if (lane == 0) {  // this warp is done with V of tile j and K of tile j - 1
                sm90::mbar_arrive(empty_v(s));
                sm90::mbar_arrive(empty_k((j - 1) % kStages));
            }
            make_ds(j);
        }
        take_turn();
        issue_dq(kv_tiles - 1);
        sm90::wgmma_commit();
        if (wg == 0) pass_turn();  // warpgroup 1's last turn has no taker
        finish_turn();
        store_rows<!kFull, kPacked, T, Dp>(static_cast<T*>(p.out0) + b * p.o_sb + h * p.o_sh, p.o_st, dq, row_a,
                                           p.seq, t, 0, p.head_dim, shift);
    }
}

// dK/dV pass: shared-memory layout at the padded width Dp (byte offsets from a
// 1024-aligned base).
constexpr int kDkvStages = 2;  // depth of the Q / dO ring
template <int Dp>
struct DkvTiles {
    // The block's KV rows: 128 (two warpgroups of 64 rows) at Dp <= 128. At Dp = 256
    // a warpgroup cannot hold dK and dV of 64 rows (2 x 128 fp32 registers a
    // thread) beside S^T and dP^T, so the block owns 64 rows and its two
    // warpgroups split the head dim's columns: each computes S^T and dP^T of the
    // same rows and accumulates dK and dV of its 128 columns.
    static constexpr int kKvRows = Dp > 128 ? 64 : 128;
    static constexpr int kColGroups = Dp > 128 ? 2 : 1;   // warpgroups splitting the columns
    static constexpr int kAccCols = Dp / kColGroups;      // dK and dV columns a warpgroup accumulates
    static constexpr int kBoxes = Dp / sm90::kBoxCols;    // 64-column regions of a tile
    static constexpr uint32_t kKvBox = kKvRows * sm90::kSwizzleRowBytes;  // one region of K or V: 16 or 8 KB
    static constexpr uint32_t kQBox = kBoxRows * sm90::kSwizzleRowBytes;  // one region of a Q or dO tile: 8 KB
    static constexpr uint32_t kKvTile = kKvBox * kBoxes;
    static constexpr uint32_t kQTile = kQBox * kBoxes;
    static constexpr uint32_t kK = 0, kV = kKvTile, kQ = 2 * kKvTile, kDo = kQ + kDkvStages * kQTile;
    static constexpr uint32_t kLse = kDo + kDkvStages * kQTile;             // [S][64] fp32: lse * log2(e)
    static constexpr uint32_t kDelta = kLse + kDkvStages * kBoxRows * 4;    // [S][64] fp32
    static constexpr uint32_t kBarriers = kDelta + kDkvStages * kBoxRows * 4;  // full_kv, full[S], empty[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 2 * kDkvStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// T: __nv_bfloat16 or __half. Dp: head_dim padded to 64, 128 or 256; columns at or
// past head_dim read as zeros and are never stored. kFull: head_dim == Dp, whose
// stores need no column test (its mere presence in a kernel costs a full-width
// tile 1-3%, as measured against one without it). kPacked: the packed-heads view (a
// head_dim that is not a multiple of 8): K's and V's columns outside the head's are
// zeroed once they land, Q and dO are copied a head's bytes at a time into rings zeroed
// once, and each column of dK and dV is stored on its own. kCopied: the copied-rows view (a
// 16-bit input no TMA view takes): K and V too are copied a head's bytes at a time, into
// tiles zeroed once, the maps are not read, and the stores are kPacked's.
template <typename T, int Dp, bool kFull, bool kPacked, bool kCopied>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                        const DkvParams<kCopied> p) {
    static_assert(!(kPacked && kCopied), "one view at a time");
    using L = DkvTiles<Dp>;
    constexpr int kAccCols = L::kAccCols;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = sm90::smem_addr(smem_raw);
    const uint32_t base = (raw + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kLse);
    float* delta_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kDelta);
    const uint32_t full_kv = base + L::kBarriers;
    const auto full = [&](int s) { return full_kv + 8 * (1 + s); };
    const auto empty = [&](int s) { return full_kv + 8 * (1 + kDkvStages + s); };

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int kv0 = blockIdx.y * L::kKvRows;
    const int q_tiles = (p.seq + kBoxRows - 1) / kBoxRows;
    const int q_begin = p.causal ? kv0 / kBoxRows : 0;  // causal: start at the diagonal tile
    const int2 origin = sm90::head_origin(h, p.head_dim, kPacked);  // as the forward's
    int shift = sm90::head_shift(h, p.head_dim, kPacked);
    if constexpr (kCopied) {  // where q's row 0 of the head lies decides it, as in the forward
        shift = sm90::copied_shift(static_cast<const char*>(p.streamed[0]) + b * p.streamed_sb[0] + h * p.streamed_sh[0],
                                   p.modulus);
    }
    // The regions TMA loads, as the forward: at Dp = 256 a region wholly past a
    // head_dim of 192 or less (past shift + head_dim, packed) is zeroed once here and
    // never loaded.
    const int boxes =
        !kFull && Dp > 128 ? (shift + p.head_dim + sm90::kBoxCols - 1) / sm90::kBoxCols : L::kBoxes;
    if (!kCopied && !kFull && Dp > 128 && boxes < L::kBoxes) {
        for (int region = boxes; region < L::kBoxes; ++region) {
            sm90::zero_shared(base + L::kK + region * L::kKvBox, L::kKvBox);
            sm90::zero_shared(base + L::kV + region * L::kKvBox, L::kKvBox);
            for (int s = 0; s < kDkvStages; ++s) {
                sm90::zero_shared(base + L::kQ + s * L::kQTile + region * L::kQBox, L::kQBox);
                sm90::zero_shared(base + L::kDo + s * L::kQTile + region * L::kQBox, L::kQBox);
            }
        }
        sm90::fence_proxy_async();
    }
    if constexpr (kPacked) {  // Q's and dO's rings: zeros, of which load_head_row overwrites only the head's columns
        sm90::zero_shared(base + L::kQ, 2 * kDkvStages * L::kQTile);
        sm90::fence_proxy_async();
    }
    if constexpr (kCopied) {  // K, V and both rings: zeros, of which load_head_row overwrites only the head's columns
        sm90::zero_shared(base, L::kLse);
        sm90::fence_proxy_async();
    }

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_kv, kCopied ? kProducerThreads : 1);  // copied: every producer thread
        for (int s = 0; s < kDkvStages; ++s) {
            // the producer warp's lanes, one of them with the TMA bytes; packed or copied, every producer thread
            sm90::mbar_init(full(s), kPacked || kCopied ? kProducerThreads : 32);
            sm90::mbar_init(empty(s), kConsumerWarps);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumerWarps * 32) {  // the producer warpgroup; its first warp loads
        sm90::setmaxnreg_dec<kCopied ? kCopiedProducerRegs : kPacked ? kPackedProducerRegs : kProducerRegs>();
        const int lane = threadIdx.x - kConsumerWarps * 32;
        if constexpr (kCopied) {  // half the producer threads copy K's rows and then Q's and stage lse, half V's
                                  // and then dO's and stage delta, a row (of K and V two at 128 rows) each
            const int which = lane / kBoxRows, row = lane % kBoxRows;  // which: 0 K, Q and lse, 1 V, dO and delta
            const int first = 2 * shift, last = 2 * (shift + p.head_dim);
            // selects, not p.resident[which]: a kernel parameter indexed at run time is copied to local memory;
            // each line is where tile byte 0 of the head's row 0 would lie
            const char* kv_line = static_cast<const char*>(which ? p.resident[1] : p.resident[0]) +
                                  b * (which ? p.resident_sb[1] : p.resident_sb[0]) +
                                  h * (which ? p.resident_sh[1] : p.resident_sh[0]) - 2 * shift;
            const uint32_t kv_tile = base + (which ? L::kV : L::kK);
            for (int r = row; r < L::kKvRows; r += kBoxRows) {
                sm90::load_head_row<true>(kv_tile, L::kKvBox, kv_line, which ? p.resident_st[1] : p.resident_st[0], first,
                                          last, kv0, r, p.seq);
            }
            sm90::cp_async_arrive(full_kv);
            sm90::mbar_arrive(full_kv);
            const char* line = static_cast<const char*>(which ? p.streamed[1] : p.streamed[0]) +
                               b * (which ? p.streamed_sb[1] : p.streamed_sb[0]) +
                               h * (which ? p.streamed_sh[1] : p.streamed_sh[0]) - 2 * shift;
            const long long row_bytes = which ? p.streamed_st[1] : p.streamed_st[0];
            const float* stat = (which ? p.delta : p.lse) + static_cast<long long>(bh) * p.seq;
            const uint32_t stat_s = sm90::smem_addr(which ? delta_s : lse_s) + 4 * row;
            const uint32_t ring = base + (which ? L::kDo : L::kQ);
            for (int i = q_begin; i < q_tiles; ++i) {
                const int n = i - q_begin, s = n % kDkvStages;
                sm90::mbar_wait(empty(s), ((n / kDkvStages) & 1) ^ 1);  // the first round passes at once
                const int q0 = i * kBoxRows;
                sm90::load_head_row<true>(ring + s * L::kQTile, L::kQBox, line, row_bytes, first, last, q0, row, p.seq);
                sm90::cp_async_arrive(full(s));  // the copies are in flight while the statistic is loaded
                const float value = q0 + row < p.seq ? stat[q0 + row] * (which ? 1.0f : sm90::kLog2e) : 0.0f;
                asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(stat_s + s * kBoxRows * 4), "f"(value) : "memory");
                sm90::mbar_arrive(full(s));
            }
        } else if constexpr (kPacked) {  // half the producer threads copy Q's head bytes and stage lse, half dO's and
                                         // delta, a row each; thread 0 also loads K and V by TMA
            if (lane == 0) {
                sm90::mbar_arrive_expect_tx(full_kv, 2 * boxes * L::kKvBox);
                load_tile_tma<kBoxRows, L::kKvRows>(base + L::kK, &tm_k, full_kv, boxes, origin, kv0, b);
                load_tile_tma<kBoxRows, L::kKvRows>(base + L::kV, &tm_v, full_kv, boxes, origin, kv0, b);
            }
            const int which = lane / kBoxRows, row = lane % kBoxRows;  // which: 0 Q and lse, 1 dO and delta
            // selects, not p.streamed[which]: a kernel parameter indexed at run time is copied to local memory
            const char* line = static_cast<const char*>(which ? p.streamed[1] : p.streamed[0]) +
                               b * (which ? p.streamed_sb[1] : p.streamed_sb[0]) + 2LL * origin.x;
            const long long row_bytes = which ? p.streamed_st[1] : p.streamed_st[0];
            const float* stat = (which ? p.delta : p.lse) + static_cast<long long>(bh) * p.seq;
            const uint32_t stat_s = sm90::smem_addr(which ? delta_s : lse_s) + 4 * row;
            const uint32_t ring = base + (which ? L::kDo : L::kQ);
            for (int i = q_begin; i < q_tiles; ++i) {
                const int n = i - q_begin, s = n % kDkvStages;
                sm90::mbar_wait(empty(s), ((n / kDkvStages) & 1) ^ 1);  // the first round passes at once
                const int q0 = i * kBoxRows;
                sm90::load_head_row(ring + s * L::kQTile, L::kQBox, line, row_bytes, 2 * shift, 2 * (shift + p.head_dim),
                                    q0, row, p.seq);
                sm90::cp_async_arrive(full(s));  // the copies are in flight while the statistic is loaded
                const float value = q0 + row < p.seq ? stat[q0 + row] * (which ? 1.0f : sm90::kLog2e) : 0.0f;
                asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(stat_s + s * kBoxRows * 4), "f"(value) : "memory");
                sm90::mbar_arrive(full(s));
            }
        } else if (lane < 32) {
            if (lane == 0) {
                sm90::mbar_arrive_expect_tx(full_kv, 2 * boxes * L::kKvBox);
                load_tile_tma<kBoxRows, L::kKvRows>(base + L::kK, &tm_k, full_kv, boxes, origin, kv0, b);
                load_tile_tma<kBoxRows, L::kKvRows>(base + L::kV, &tm_v, full_kv, boxes, origin, kv0, b);
            }
            const float* lse = p.lse + static_cast<long long>(bh) * p.seq;
            const float* delta = p.delta + static_cast<long long>(bh) * p.seq;
            for (int i = q_begin; i < q_tiles; ++i) {
                const int n = i - q_begin, s = n % kDkvStages;
                sm90::mbar_wait(empty(s), ((n / kDkvStages) & 1) ^ 1);  // the first round passes at once
                const int q0 = i * kBoxRows;
#pragma unroll
                for (int r = lane; r < kBoxRows; r += 32) {
                    const bool valid = q0 + r < p.seq;
                    lse_s[s * kBoxRows + r] = valid ? lse[q0 + r] * sm90::kLog2e : 0.0f;
                    delta_s[s * kBoxRows + r] = valid ? delta[q0 + r] : 0.0f;
                }
                if (lane == 0) {
                    sm90::mbar_arrive_expect_tx(full(s), 2 * boxes * L::kQBox);
                    load_tile_tma<kBoxRows, kBoxRows>(base + L::kQ + s * L::kQTile, &tm_q, full(s), boxes, origin, q0, b);
                    load_tile_tma<kBoxRows, kBoxRows>(base + L::kDo + s * L::kQTile, &tm_do, full(s), boxes, origin, q0,
                                                      b);
                } else {
                    sm90::mbar_arrive(full(s));
                }
            }
        }
    } else {  // two consumer warpgroups: 64 KV rows each, or the same 64 rows and half the columns each
        sm90::setmaxnreg_inc<kCopied ? kCopiedConsumerRegs : kPacked ? kPackedConsumerRegs : kConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int wg_row = L::kColGroups == 1 ? wg * 64 : 0;      // this warpgroup's first row of the block
        const int col0 = L::kColGroups == 1 ? 0 : wg * kAccCols;  // and its first column of dK and dV
        const int row_a = kv0 + wg_row + warp * 16 + g;  // this thread's KV rows: row_a, row_a + 8
        const float scale2 = p.scale * sm90::kLog2e;

        float dk[kAccCols / 2], dv[kAccCols / 2];
#pragma unroll
        for (int i = 0; i < kAccCols / 2; ++i) dk[i] = dv[i] = 0.0f;

        const uint32_t k_wg = base + L::kK + wg_row * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        const uint32_t v_wg = base + L::kV + wg_row * sm90::kSwizzleRowBytes;
        const uint32_t col_off = (col0 / sm90::kBoxCols) * L::kQBox;  // its columns' first region of Q and dO
        sm90::mbar_wait(full_kv, 0);
        if constexpr (kCopied) sm90::fence_proxy_async();  // K's and V's cp.async bytes, for wgmma's reads
        if constexpr (kPacked) {  // K's and V's columns around the head's hold its neighbours': zero them
            sm90::zero_around_head(base + L::kK, L::kKvBox, L::kKvRows, shift, p.head_dim, boxes * sm90::kBoxCols,
                                   threadIdx.x, kConsumerWarps * 32);
            sm90::zero_around_head(base + L::kV, L::kKvBox, L::kKvRows, shift, p.head_dim, boxes * sm90::kBoxCols,
                                   threadIdx.x, kConsumerWarps * 32);
            sm90::fence_proxy_async();
            sm90::named_bar_sync(1, kConsumerWarps * 32);
        }
        for (int i = q_begin; i < q_tiles; ++i) {
            const int n = i - q_begin, s = n % kDkvStages;
            const uint32_t q_tile = base + L::kQ + s * L::kQTile, do_tile = base + L::kDo + s * L::kQTile;

            float st[kBoxRows / 2], dpt[kBoxRows / 2];  // S^T = K Q^T and dP^T = V dO^T: 64 x 64 each
            sm90::mbar_wait(full(s), (n / kDkvStages) & 1);
            if constexpr (kPacked || kCopied) sm90::fence_proxy_async();  // the stage's cp.async bytes, for wgmma's reads
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < Dp / 16; ++kk) {
                // region kk / 4, then 32 bytes (16 columns) along its swizzled 128-byte rows
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                sm90::wgmma_ss<T>(st, sm90::desc_kmajor(k_wg + kv_off), sm90::desc_kmajor(q_tile + q_off), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < Dp / 16; ++kk) {
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                sm90::wgmma_ss<T>(dpt, sm90::desc_kmajor(v_wg + kv_off), sm90::desc_kmajor(do_tile + q_off), kk > 0);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(st);
            sm90::fence_regs(dpt);

            // P^T and dS^T in place, column c of the tile being query q0 + c
            const int q0 = i * kBoxRows;
            const float* lse_t = lse_s + s * kBoxRows;
            const float* delta_t = delta_s + s * kBoxRows;
            const bool edge = q0 + kBoxRows > p.seq || (p.causal && q0 < kv0 + L::kKvRows);
#pragma unroll
            for (int e = 0; e < kBoxRows / 2; ++e) {
                const int c = (e / 4) * 8 + 2 * t + (e & 1);
                float prob = sm90::exp2_approx(fmaf(st[e], scale2, -lse_t[c]));
                if (edge) {
                    const int row = row_a + (e & 2) * 4;
                    if (q0 + c >= p.seq || (p.causal && row > q0 + c)) prob = 0.0f;
                }
                st[e] = prob;
                dpt[e] = prob * (dpt[e] - delta_t[c]) * p.scale;
            }
            uint32_t pf[kBoxRows / 16][4], df[kBoxRows / 16][4];  // P^T and dS^T as A operands, 16 queries each
#pragma unroll
            for (int kc = 0; kc < kBoxRows / 16; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    pf[kc][r] = sm90::pack2<T>(st[8 * kc + 2 * r], st[8 * kc + 2 * r + 1]);
                    df[kc][r] = sm90::pack2<T>(dpt[8 * kc + 2 * r], dpt[8 * kc + 2 * r + 1]);
                }
            }

            sm90::fence_regs(dv);
            sm90::fence_regs(dk);
            sm90::fence_regs(pf);
            sm90::fence_regs(df);
            sm90::wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < kBoxRows / 16; ++kc) {  // 16 query rows per k-step: 2048 bytes down the regions
                sm90::wgmma_rs_tb<T>(dv, pf[kc],
                                     sm90::desc_mnmajor(do_tile + col_off + kc * 16 * sm90::kSwizzleRowBytes, L::kQBox), 1);
            }
#pragma unroll
            for (int kc = 0; kc < kBoxRows / 16; ++kc) {
                sm90::wgmma_rs_tb<T>(dk, df[kc],
                                     sm90::desc_mnmajor(q_tile + col_off + kc * 16 * sm90::kSwizzleRowBytes, L::kQBox), 1);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(dv);
            sm90::fence_regs(dk);
            if (lane == 0) sm90::mbar_arrive(empty(s));  // this warp is done with stage s
        }
        store_rows<!kFull, kPacked || kCopied, T, kAccCols>(static_cast<T*>(p.out0) + b * p.o_sb + h * p.o_sh, p.o_st,
                                                            dk, row_a, p.seq, t, col0, p.head_dim, shift);
        store_rows<!kFull, kPacked || kCopied, T, kAccCols>(static_cast<T*>(p.out1) + b * p.o_sb + h * p.o_sh, p.o_st,
                                                            dv, row_a, p.seq, t, col0, p.head_dim, shift);
    }
}

// ------------------------------------------------------------------ 3xTF32 dK/dV pass (fp32)

// Shared-memory layout at the padded width Dp (64 or 128; byte offsets from a 1024-aligned
// base). Every tile is fp32 in 32-column (128-byte) regions, 128-byte-swizzled
// (sm90::kmajor_chunk), held as its TF32 hi part and its lo part.
template <int Dp>
struct Tf32DkvTiles {
    static constexpr int kKvRows = 64;                  // one consumer warpgroup's rows, resident
    static constexpr int kQRows = Dp > 64 ? 16 : 32;    // query rows a stage
    static constexpr int kStages = Dp > 64 ? 1 : 2;     // at 128 the resident K and V (hi, lo) take 128 KB
    static constexpr int kRegions = Dp / 32;
    static constexpr uint32_t kKvBox = kKvRows * sm90::kSwizzleRowBytes, kKvTile = kKvBox * kRegions;
    static constexpr uint32_t kQBox = kQRows * sm90::kSwizzleRowBytes, kQTile = kQBox * kRegions;
    // Q^T and dO^T: Dp rows of kQRows queries, in one 32-column region (at kQRows = 16 half of
    // each 128-byte row is never read)
    static constexpr uint32_t kQtBox = Dp * sm90::kSwizzleRowBytes, kQtTile = kQtBox;
    // a stage: Q hi, lo, dO hi, lo (row-major), Q^T hi, lo, dO^T hi, lo
    static constexpr uint32_t kStage = 4 * kQTile + 4 * kQtTile;
    static constexpr uint32_t kK = 0, kV = 2 * kKvTile, kStages0 = 4 * kKvTile;  // K hi, lo; V hi, lo
    static constexpr uint32_t kLse = kStages0 + kStages * kStage;             // [S][kQRows] fp32: lse * log2(e)
    static constexpr uint32_t kDelta = kLse + kStages * kQRows * 4;           // [S][kQRows] fp32
    static constexpr uint32_t kBarriers = kDelta + kStages * kQRows * 4;      // full_kv, full[S], empty[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 2 * kStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// fp32 q, k, v, dout at a head_dim from 16 to Dp that is a multiple of 4 (whole 16-byte
// chunks a head's row). One consumer warpgroup owns the block's 64 KV rows, K and V resident;
// Q and dO stream in tiles of kQRows rows. The producer warpgroup loads each tile with 16-byte
// loads (the next stage's while the consumers drain the ring), splits every value into TF32 hi
// and lo and stores Q and dO K-major as they stand (the B operands of S^T = K Q^T and dP^T =
// V dO^T) and transposed, their queries in tf32_k_slot order (the B operands of dK += dS^T Q
// and dV += P^T dO, whose A operands are dS^T and P^T from registers). Columns past head_dim
// and rows past T are stored as zeros.
template <int Dp>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkv_tf32x3(const Params p) {
    using L = Tf32DkvTiles<Dp>;
    constexpr int kQRows = L::kQRows, kStages = L::kStages;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = sm90::smem_addr(smem_raw);
    const uint32_t base = (raw + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kLse);
    float* delta_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kDelta);
    const uint32_t full_kv = base + L::kBarriers;
    const auto full = [&](int s) { return full_kv + 8 * (1 + s); };
    const auto empty = [&](int s) { return full_kv + 8 * (1 + kStages + s); };
    // stage s: Q hi, Q lo, dO hi, dO lo, then Q^T hi, Q^T lo, dO^T hi, dO^T lo
    const auto stage = [&](int s) { return base + L::kStages0 + s * L::kStage; };
    const auto q_t = [&](int s) { return stage(s) + 4 * L::kQTile; };

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int kv0 = blockIdx.y * L::kKvRows;  // the first KV tiles are the heaviest when causal
    const int q_tiles = (p.seq + kQRows - 1) / kQRows;
    const int q_begin = p.causal ? kv0 / kQRows : 0;  // causal: start at the diagonal tile

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_kv, 128);
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(full(s), 128);  // every producer thread stores a part of each stage
            sm90::mbar_init(empty(s), 4);   // the consumer warps
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= 128) {  // the producer warpgroup
        const int thread = threadIdx.x - 128;
        using KvRows = sm90::Tf32RowLoader<L::kKvRows, Dp>;
        using QRows = sm90::Tf32RowLoader<kQRows, Dp>;
        {
            float4 regs[KvRows::kChunks];
            KvRows::load(regs, static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh, p.k_st, kv0, thread, p.seq,
                         p.head_dim);
            KvRows::store(regs, base + L::kK, base + L::kK + L::kKvTile, L::kKvBox, thread);
            KvRows::load(regs, static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh, p.v_st, kv0, thread, p.seq,
                         p.head_dim);
            KvRows::store(regs, base + L::kV, base + L::kV + L::kKvTile, L::kKvBox, thread);
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(full_kv);
        const float* q_base = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
        const float* d_base = static_cast<const float*>(p.dout) + b * p.d_sb + h * p.d_sh;
        // lse (times log2 e) by threads 0 to kQRows - 1, delta by the next kQRows
        const bool stat_thread = thread < 2 * kQRows;
        const float* stat = (thread < kQRows ? p.lse : p.delta) + static_cast<long long>(bh) * p.seq;
        float4 q_regs[QRows::kChunks], d_regs[QRows::kChunks];  // stage i, loaded while the ring drains
        float stat_value = 0.0f;
        const auto load = [&](int i) {
            const int q0 = i * kQRows;
            QRows::load(q_regs, q_base, p.q_st, q0, thread, p.seq, p.head_dim);
            QRows::load(d_regs, d_base, p.d_st, q0, thread, p.seq, p.head_dim);
            const int r = q0 + thread % kQRows;
            stat_value = stat_thread && r < p.seq ? stat[r] * (thread < kQRows ? sm90::kLog2e : 1.0f) : 0.0f;
        };
        load(q_begin);
        for (int i = q_begin; i < q_tiles; ++i) {
            const int n = i - q_begin, s = n % kStages;
            sm90::mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);  // the first round passes at once
            const uint32_t st = stage(s), qt = q_t(s);
            QRows::store(q_regs, st, st + L::kQTile, L::kQBox, thread);
            QRows::store(d_regs, st + 2 * L::kQTile, st + 3 * L::kQTile, L::kQBox, thread);
            QRows::store_transposed(q_regs, qt, qt + L::kQtTile, L::kQtBox, thread);
            QRows::store_transposed(d_regs, qt + 2 * L::kQtTile, qt + 3 * L::kQtTile, L::kQtBox, thread);
            if (stat_thread) (thread < kQRows ? lse_s : delta_s)[s * kQRows + thread % kQRows] = stat_value;
            sm90::fence_proxy_async();
            sm90::mbar_arrive(full(s));
            if (i + 1 < q_tiles) load(i + 1);
        }
    } else {  // the consumer warpgroup: 64 KV rows
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_a = kv0 + warp * 16 + g;  // this thread's KV rows: row_a, row_a + 8
        const float scale2 = p.scale * sm90::kLog2e;

        float dk[Dp / 2], dv[Dp / 2];
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) dk[i] = dv[i] = 0.0f;
        const uint32_t k_hi = base + L::kK, k_lo = k_hi + L::kKvTile, v_hi = base + L::kV, v_lo = v_hi + L::kKvTile;
        sm90::mbar_wait(full_kv, 0);
        sm90::fence_proxy_async();
        for (int i = q_begin; i < q_tiles; ++i) {
            const int n = i - q_begin, s = n % kStages;
            const uint32_t q_hi = stage(s), q_lo = q_hi + L::kQTile, do_hi = q_hi + 2 * L::kQTile,
                           do_lo = q_hi + 3 * L::kQTile;
            const uint32_t qt_hi = q_t(s), qt_lo = qt_hi + L::kQtTile, dot_hi = qt_hi + 2 * L::kQtTile,
                           dot_lo = qt_hi + 3 * L::kQtTile;

            float st[kQRows / 2], dpt[kQRows / 2];  // S^T = K Q^T and dP^T = V dO^T: 64 x kQRows each
            sm90::mbar_wait(full(s), (n / kStages) & 1);
            sm90::fence_proxy_async();
            sm90::wgmma_fence();
            // the small terms first: A_lo B_hi, A_hi B_lo, then A_hi B_hi
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kk = 0; kk < Dp / 8; ++kk) {
                    // region kk / 4, then 32 bytes (8 columns) along its swizzled 128-byte rows
                    const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                    const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                    sm90::wgmma_ss_tf32(st, sm90::desc_kmajor((term == 0 ? k_lo : k_hi) + kv_off),
                                        sm90::desc_kmajor((term == 1 ? q_lo : q_hi) + q_off), term > 0 || kk > 0);
                }
            }
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kk = 0; kk < Dp / 8; ++kk) {
                    const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                    const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                    sm90::wgmma_ss_tf32(dpt, sm90::desc_kmajor((term == 0 ? v_lo : v_hi) + kv_off),
                                        sm90::desc_kmajor((term == 1 ? do_lo : do_hi) + q_off), term > 0 || kk > 0);
                }
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(st);
            sm90::fence_regs(dpt);

            // P^T and dS^T in place, column c of the tile being query q0 + c
            const int q0 = i * kQRows;
            const float* lse_t = lse_s + s * kQRows;
            const float* delta_t = delta_s + s * kQRows;
            const bool edge = q0 + kQRows > p.seq || (p.causal && q0 < kv0 + L::kKvRows);
#pragma unroll
            for (int e = 0; e < kQRows / 2; ++e) {
                const int c = (e / 4) * 8 + 2 * t + (e & 1);
                float prob = sm90::exp2_approx(fmaf(st[e], scale2, -lse_t[c]));
                if (edge) {
                    const int row = row_a + (e & 2) * 4;
                    if (q0 + c >= p.seq || (p.causal && row > q0 + c)) prob = 0.0f;
                }
                st[e] = prob;
                dpt[e] = prob * (dpt[e] - delta_t[c]) * p.scale;
            }
            // P^T and dS^T as A fragments, 8 queries each
            uint32_t pf_hi[kQRows / 8][4], pf_lo[kQRows / 8][4], df_hi[kQRows / 8][4], df_lo[kQRows / 8][4];
#pragma unroll
            for (int kc = 0; kc < kQRows / 8; ++kc) {
                sm90::tf32_a_fragment(st, kc, pf_hi[kc], pf_lo[kc]);
                sm90::tf32_a_fragment(dpt, kc, df_hi[kc], df_lo[kc]);
            }

            // dV += P^T dO, then dK += dS^T Q, each summed over the stage's queries into `part`
            // (from zero) and added to its accumulator by the CUDA cores: the tensor core's
            // additions round toward zero (relative to the sum they add to), so a sum carried
            // through the whole sweep would drift by the sweep's length; a stage's partial drifts by
            // the stage's
            float part[Dp / 2];
            sm90::fence_regs(pf_hi);
            sm90::fence_regs(pf_lo);
            sm90::fence_regs(df_hi);
            sm90::fence_regs(df_lo);
            sm90::wgmma_fence();
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kc = 0; kc < kQRows / 8; ++kc) {  // 8 queries a k-step: 32 bytes along dO^T's rows
                    sm90::wgmma_rs_tf32(part, term == 0 ? pf_lo[kc] : pf_hi[kc],
                                        sm90::desc_kmajor((term == 1 ? dot_lo : dot_hi) + kc * 32), term > 0 || kc > 0);
                }
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(part);
#pragma unroll
            for (int i = 0; i < Dp / 2; ++i) dv[i] += part[i];
            sm90::fence_regs(part);
            sm90::wgmma_fence();
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kc = 0; kc < kQRows / 8; ++kc) {
                    sm90::wgmma_rs_tf32(part, term == 0 ? df_lo[kc] : df_hi[kc],
                                        sm90::desc_kmajor((term == 1 ? qt_lo : qt_hi) + kc * 32), term > 0 || kc > 0);
                }
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(part);
            if (lane == 0) sm90::mbar_arrive(empty(s));  // this warp is done with stage s
#pragma unroll
            for (int i = 0; i < Dp / 2; ++i) dk[i] += part[i];
        }
        float* dk_base = static_cast<float*>(p.out0) + b * p.o_sb + h * p.o_sh;
        float* dv_base = static_cast<float*>(p.out1) + b * p.o_sb + h * p.o_sh;
        const int row_b = row_a + 8;
#pragma unroll
        for (int c = 0; c < Dp / 8; ++c) {
            const int col = c * 8 + t * 2;  // a pair below head_dim (a multiple of 4) or none of it
            if (col < p.head_dim) {
                if (row_a < p.seq) {
                    *reinterpret_cast<float2*>(dk_base + row_a * p.o_st + col) = make_float2(dk[4 * c], dk[4 * c + 1]);
                    *reinterpret_cast<float2*>(dv_base + row_a * p.o_st + col) = make_float2(dv[4 * c], dv[4 * c + 1]);
                }
                if (row_b < p.seq) {
                    *reinterpret_cast<float2*>(dk_base + row_b * p.o_st + col) =
                        make_float2(dk[4 * c + 2], dk[4 * c + 3]);
                    *reinterpret_cast<float2*>(dv_base + row_b * p.o_st + col) =
                        make_float2(dv[4 * c + 2], dv[4 * c + 3]);
                }
            }
        }
    }
}

// ------------------------------------------------------------------ 3xTF32 dQ pass (fp32)

// Shared-memory layout at the padded width Dp (64 or 128; byte offsets from a 1024-aligned
// base), in the dK/dV pass's fp32 regions. Q and dO of the block's rows stay resident (hi, lo);
// K and V tiles stream through a ring, K^T tiles through a ring of its own.
template <int Dp>
struct Tf32DqTiles {
    // consumer warpgroups of 64 query rows: two at Dp = 64, taking turns (ping-pong); one at
    // Dp = 128, where Q and dO of 64 rows (hi and lo) already take 128 KB
    static constexpr int kConsumers = Dp > 64 ? 1 : 2;
    static constexpr int kThreads = 128 * (kConsumers + 1);
    static constexpr int kRows = 64 * kConsumers;      // query rows a block
    static constexpr int kKvRows = 32;                 // keys a tile
    static constexpr int kStages = Dp > 64 ? 1 : 2;    // slots of the K and V ring, and of the K^T ring
    static constexpr int kRegions = Dp / 32;
    static constexpr uint32_t kQBox = kRows * sm90::kSwizzleRowBytes, kQTile = kQBox * kRegions;
    static constexpr uint32_t kKBox = kKvRows * sm90::kSwizzleRowBytes, kKTile = kKBox * kRegions;
    // K^T: Dp rows (K's columns) of kKvRows keys, in one 32-column region
    static constexpr uint32_t kKtBox = Dp * sm90::kSwizzleRowBytes, kKtTile = kKtBox;
    static constexpr uint32_t kQ = 0;                      // Q hi, Q lo, dO hi, dO lo
    static constexpr uint32_t kKv = 4 * kQTile;            // slot s: K hi, K lo, V hi, V lo at kKv + 4 s kKTile
    static constexpr uint32_t kKt = kKv + 4 * kStages * kKTile;  // slot s: K^T hi, lo at kKt + 2 s kKtTile
    // full_qdo, full_kv[S], empty_kv[S], full_kt[S], empty_kt[S]
    static constexpr uint32_t kBarriers = kKt + 2 * kStages * kKtTile;
    static constexpr uint32_t kBytes = kBarriers + (1 + 4 * kStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// The producer warpgroup's registers where two consumer warpgroups take the rest (Dp = 64), as the
// 3xTF32 forward's: 128 * 104 + 256 * 200 = 384 * 168, the registers the block is launched with.
constexpr int kTf32DqProducerRegs = 104, kTf32DqConsumerRegs = 200;

// fp32 q, k, v, dout at a head_dim from 16 to Dp that is a multiple of 4. The producer warpgroup
// loads Q and dO of the block's rows once, then each K and V tile, with 16-byte loads, splits every
// value into TF32 hi and lo and stores Q, dO, K and V K-major as they stand (the operands of S = Q K^T
// and dP = dO V^T) and K once more transposed, its keys in tf32_k_slot order (the B operand of
// dQ += dS K, whose A operand is dS from registers). Columns past head_dim and rows past T are
// stored as zeros.
template <int Dp>
__global__ void __launch_bounds__(Tf32DqTiles<Dp>::kThreads, 1) flash_bwd_dq_tf32x3(const Params p) {
    using L = Tf32DqTiles<Dp>;
    constexpr int kKvRows = L::kKvRows, kConsumers = L::kConsumers, kStages = L::kStages;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (sm90::smem_addr(smem_raw) + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    const uint32_t full_qdo = base + L::kBarriers;
    const auto full_kv = [&](int s) { return full_qdo + 8 * (1 + s); };
    const auto empty_kv = [&](int s) { return full_qdo + 8 * (1 + kStages + s); };
    const auto full_kt = [&](int s) { return full_qdo + 8 * (1 + 2 * kStages + s); };
    const auto empty_kt = [&](int s) { return full_qdo + 8 * (1 + 3 * kStages + s); };
    const auto kv_slot = [&](int s) { return base + L::kKv + 4 * s * L::kKTile; };  // K hi; K lo, V hi, V lo after it
    const auto kt_slot = [&](int s) { return base + L::kKt + 2 * s * L::kKtTile; };  // hi; lo at + kKtTile

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q_tiles = (p.seq + L::kRows - 1) / L::kRows;
    const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.y)) * L::kRows;  // heaviest first
    const int kv_end = p.causal ? min(p.seq, q0 + L::kRows) : p.seq;         // causal: up to the diagonal
    const int kv_tiles = (kv_end + kKvRows - 1) / kKvRows;

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_qdo, 128);  // every producer thread stores a part of each tile
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(full_kv(s), 128);
            sm90::mbar_init(full_kt(s), 128);
            sm90::mbar_init(empty_kv(s), 4 * kConsumers);  // the consumer warps
            sm90::mbar_init(empty_kt(s), 4 * kConsumers);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers * 128) {  // the producer warpgroup
        if constexpr (kConsumers == 2) sm90::setmaxnreg_dec<kTf32DqProducerRegs>();
        const int thread = threadIdx.x - kConsumers * 128;
        const float* k_base = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
        const float* v_base = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
        using QRows = sm90::Tf32RowLoader<64, Dp>;  // Q and dO a warpgroup's 64 rows at a time
        using KvRows = sm90::Tf32RowLoader<kKvRows, Dp>;
#pragma unroll 1
        for (int i = 0; i < 2 * L::kRows / 64; ++i) {  // Q's rows, then dO's
            const bool is_q = i < L::kRows / 64;
            const int rows = (is_q ? i : i - L::kRows / 64) * 64;
            const float* src = is_q ? static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh
                                    : static_cast<const float*>(p.dout) + b * p.d_sb + h * p.d_sh;
            float4 regs[QRows::kChunks];
            QRows::load(regs, src, is_q ? p.q_st : p.d_st, q0 + rows, thread, p.seq, p.head_dim);
            const uint32_t tile = base + L::kQ + (is_q ? 0 : 2 * L::kQTile) + rows * sm90::kSwizzleRowBytes;
            QRows::store(regs, tile, tile + L::kQTile, L::kQBox, thread);
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(full_qdo);
        // Iteration j stores K and V of tile j, then K^T of tile j - 1: the order the consumers take
        // them in (turn j reads K and V of tile j and K^T of tile j - 1). K of tile j is loaded into
        // registers as soon as its K^T's predecessor is stored, V as soon as V of the tile before is
        // stored, so the loads run while the slots drain.
        float4 k_regs[KvRows::kChunks], k_prev[KvRows::kChunks], v_regs[KvRows::kChunks];
        KvRows::load(k_regs, k_base, p.k_st, 0, thread, p.seq, p.head_dim);
        KvRows::load(v_regs, v_base, p.v_st, 0, thread, p.seq, p.head_dim);
        for (int j = 0; j <= kv_tiles; ++j) {
            if (j < kv_tiles) {
                const int s = j % kStages;
                sm90::mbar_wait(empty_kv(s), ((j / kStages) & 1) ^ 1);  // the first round passes at once
                const uint32_t slot = kv_slot(s);
                KvRows::store(k_regs, slot, slot + L::kKTile, L::kKBox, thread);
                KvRows::store(v_regs, slot + 2 * L::kKTile, slot + 3 * L::kKTile, L::kKBox, thread);
                sm90::fence_proxy_async();
                sm90::mbar_arrive(full_kv(s));
                if (j + 1 < kv_tiles) KvRows::load(v_regs, v_base, p.v_st, (j + 1) * kKvRows, thread, p.seq, p.head_dim);
            }
            if (j > 0) {
                const int s = (j - 1) % kStages;
                sm90::mbar_wait(empty_kt(s), (((j - 1) / kStages) & 1) ^ 1);
                KvRows::store_transposed(k_prev, kt_slot(s), kt_slot(s) + L::kKtTile, L::kKtBox, thread);
                sm90::fence_proxy_async();
                sm90::mbar_arrive(full_kt(s));
            }
            if (j < kv_tiles) {
#pragma unroll
                for (int i = 0; i < KvRows::kChunks; ++i) k_prev[i] = k_regs[i];
                if (j + 1 < kv_tiles) KvRows::load(k_regs, k_base, p.k_st, (j + 1) * kKvRows, thread, p.seq, p.head_dim);
            }
        }
    } else {  // the consumer warpgroups, 64 query rows each
        if constexpr (kConsumers == 2) sm90::setmaxnreg_inc<kTf32DqConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;  // this thread's query rows
        const float scale2 = p.scale * sm90::kLog2e;
        const long long rows = static_cast<long long>(bh) * p.seq;
        const float lse_a = row_a < p.seq ? p.lse[rows + row_a] * sm90::kLog2e : 0.0f;
        const float lse_b = row_b < p.seq ? p.lse[rows + row_b] * sm90::kLog2e : 0.0f;
        const float delta_a = row_a < p.seq ? p.delta[rows + row_a] : 0.0f;
        const float delta_b = row_b < p.seq ? p.delta[rows + row_b] : 0.0f;

        float dq[Dp / 2];
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) dq[i] = 0.0f;
        float sc[kKvRows / 2], dp[kKvRows / 2];               // S = Q K^T (then dS) and dP = dO V^T of one tile
        uint32_t df_hi[kKvRows / 8][4], df_lo[kKvRows / 8][4];  // dS's A fragments, 8 keys each
        // dS K of one tile, summed from zero and added to dQ by the CUDA cores: the tensor core's
        // additions round toward zero relative to the sum they add to, so dQ carried through the
        // sweep would drift by the sweep's length (the dK/dV pass's note); a tile's partial drifts by
        // the tile's
        float part[Dp / 2];
        const uint32_t q_wg = base + L::kQ + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's rows of Q hi

        // S and dP of tile j: the small terms first (A_lo B_hi, A_hi B_lo, then A_hi B_hi). The bases pass
        // through an empty asm, so the descriptors are made at each call, not held across the sweep.
        const auto issue_s_dp = [&](int j) {
            uint32_t q_hi = q_wg, k_hi = kv_slot(j % kStages);
            asm volatile("" : "+r"(q_hi), "+r"(k_hi));
            const uint32_t q_lo = q_hi + L::kQTile, do_hi = q_hi + 2 * L::kQTile, do_lo = q_hi + 3 * L::kQTile;
            const uint32_t k_lo = k_hi + L::kKTile, v_hi = k_hi + 2 * L::kKTile, v_lo = k_hi + 3 * L::kKTile;
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kk = 0; kk < Dp / 8; ++kk) {
                    // region kk / 4, then 32 bytes (8 columns) along its swizzled 128-byte rows
                    const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                    const uint32_t k_off = (kk / 4) * L::kKBox + (kk % 4) * 32;
                    sm90::wgmma_ss_tf32(sc, sm90::desc_kmajor((term == 0 ? q_lo : q_hi) + q_off),
                                        sm90::desc_kmajor((term == 1 ? k_lo : k_hi) + k_off), term > 0 || kk > 0);
                }
            }
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kk = 0; kk < Dp / 8; ++kk) {
                    const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                    const uint32_t k_off = (kk / 4) * L::kKBox + (kk % 4) * 32;
                    sm90::wgmma_ss_tf32(dp, sm90::desc_kmajor((term == 0 ? do_lo : do_hi) + q_off),
                                        sm90::desc_kmajor((term == 1 ? v_lo : v_hi) + k_off), term > 0 || kk > 0);
                }
            }
        };
        // part = dS K of tile j: dS_lo K_hi + dS_hi K_lo + dS_hi K_hi, K^T K-major
        const auto issue_dq = [&](int j) {
            uint32_t kt_hi = kt_slot(j % kStages);
            asm volatile("" : "+r"(kt_hi));  // as issue_s_dp's bases
            const uint32_t kt_lo = kt_hi + L::kKtTile;
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
                for (int kc = 0; kc < kKvRows / 8; ++kc) {  // 8 keys a k-step: 32 bytes along K^T's rows
                    sm90::wgmma_rs_tf32(part, term == 0 ? df_lo[kc] : df_hi[kc],
                                        sm90::desc_kmajor((term == 1 ? kt_lo : kt_hi) + kc * 32), term > 0 || kc > 0);
                }
            }
        };
        // dS of tile j in place of its scores (column c of the tile is key kv0 + c), split into df_*
        const auto make_ds = [&](int j) {
            const int kv0 = j * kKvRows;
            const bool edge = kv0 + kKvRows > p.seq || (p.causal && kv0 + kKvRows - 1 > q0 + wg * 64);
#pragma unroll
            for (int e = 0; e < kKvRows / 2; ++e) {
                const bool hi = e & 2;  // row_b's entries
                float prob = sm90::exp2_approx(fmaf(sc[e], scale2, -(hi ? lse_b : lse_a)));
                if (edge) {
                    const int col = kv0 + (e / 4) * 8 + 2 * t + (e & 1);
                    if (col >= p.seq || (p.causal && col > (hi ? row_b : row_a))) prob = 0.0f;
                }
                sc[e] = prob * (dp[e] - (hi ? delta_b : delta_a)) * p.scale;
            }
#pragma unroll
            for (int kc = 0; kc < kKvRows / 8; ++kc) sm90::tf32_a_fragment(sc, kc, df_hi[kc], df_lo[kc]);
        };
        // the 16-bit dQ pass's turns: turn j issues S and dP of tile j and dS K of tile j - 1 as one
        // wgmma group; with two consumer warpgroups they take turns (named barriers 1 and 2)
        const auto take_turn = [&]() {
            if constexpr (kConsumers == 2) sm90::named_bar_sync(1 + wg, 2 * 128);
            sm90::fence_regs(sc);
            sm90::fence_regs(dp);
            sm90::fence_regs(part);
            sm90::fence_regs(df_hi);
            sm90::fence_regs(df_lo);
            sm90::wgmma_fence();
        };
        const auto pass_turn = [&]() {
            if constexpr (kConsumers == 2) sm90::named_bar_arrive(2 - wg, 2 * 128);
        };
        const auto finish_turn = [&]() {
            sm90::wgmma_wait<0>();
            sm90::fence_regs(sc);
            sm90::fence_regs(dp);
            sm90::fence_regs(part);
        };
        // a tile the producer stored has landed: its generic-proxy stores are fenced for wgmma's reads
        const auto wait_full = [&](uint32_t bar, int n) {
            sm90::mbar_wait(bar, n & 1);
            sm90::fence_proxy_async();
        };
        if (wg == 1) pass_turn();
        wait_full(full_qdo, 0);
        wait_full(full_kv(0), 0);
        take_turn();
        issue_s_dp(0);
        sm90::wgmma_commit();
        pass_turn();
        finish_turn();
        if (lane == 0) sm90::mbar_arrive(empty_kv(0));  // this warp is done with K and V of tile 0
        make_ds(0);
        for (int j = 1; j < kv_tiles; ++j) {
            wait_full(full_kv(j % kStages), j / kStages);
            wait_full(full_kt((j - 1) % kStages), (j - 1) / kStages);
            take_turn();
            issue_s_dp(j);
            issue_dq(j - 1);
            sm90::wgmma_commit();
            pass_turn();
            finish_turn();
            if (lane == 0) {  // this warp is done with K and V of tile j and K^T of tile j - 1
                sm90::mbar_arrive(empty_kv(j % kStages));
                sm90::mbar_arrive(empty_kt((j - 1) % kStages));
            }
#pragma unroll
            for (int i = 0; i < Dp / 2; ++i) dq[i] += part[i];
            make_ds(j);
        }
        const int last = kv_tiles - 1;
        wait_full(full_kt(last % kStages), last / kStages);
        take_turn();
        issue_dq(last);
        sm90::wgmma_commit();
        if (wg == 0) pass_turn();  // warpgroup 1's last turn has no taker
        finish_turn();
#pragma unroll
        for (int i = 0; i < Dp / 2; ++i) dq[i] += part[i];

        float* dq_base = static_cast<float*>(p.out0) + b * p.o_sb + h * p.o_sh;
#pragma unroll
        for (int c = 0; c < Dp / 8; ++c) {
            const int col = c * 8 + t * 2;  // a pair below head_dim (a multiple of 4) or none of it
            if (col < p.head_dim) {
                if (row_a < p.seq) {
                    *reinterpret_cast<float2*>(dq_base + row_a * p.o_st + col) = make_float2(dq[4 * c], dq[4 * c + 1]);
                }
                if (row_b < p.seq) {
                    *reinterpret_cast<float2*>(dq_base + row_b * p.o_st + col) =
                        make_float2(dq[4 * c + 2], dq[4 * c + 3]);
                }
            }
        }
    }
}

// ------------------------------------------------------------------ SIMT path

constexpr int kRowsPerWarp = 4;
constexpr int kRowsSimt = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kColsSimt = 32;                     // columns per tile: one per lane

// Stage `count` rows of one slice from row `row0` as [count][kD + 1] floats (the
// padding keeps both row-per-lane and column-per-lane reads free of bank
// conflicts), widened from T; rows at or past `seq` and columns at or past
// `head_dim` become zeros.
template <typename T, int kD>
__device__ __forceinline__ void load_rows_simt(float* dst, const T* src, long long row_stride, int row0, int count,
                                               int seq, int head_dim) {
    for (int i = threadIdx.x; i < count * kD; i += kWarps * 32) {
        const int row = i / kD, col = i % kD;
        dst[row * (kD + 1) + col] = row0 + row < seq && col < head_dim ? to_float(src[(row0 + row) * row_stride + col]) : 0.0f;
    }
}

// dQ pass: a warp owns 4 query rows; lane j takes key j of a 32-key tile. T and kD
// as in the forward's SIMT kernel.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_simt(const Params p) {
    constexpr int kCols = kD / 32;
    constexpr int S = kD + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* q_s = reinterpret_cast<float*>(smem_raw);  // [kRowsSimt][S]
    float* do_s = q_s + kRowsSimt * S;
    float* k_s = do_s + kRowsSimt * S;  // [kColsSimt][S]
    float* v_s = k_s + kColsSimt * S;

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsSimt;  // heaviest first when causal
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    const T* d_base = static_cast<const T*>(p.dout) + b * p.d_sb + h * p.d_sh;
    load_rows_simt<T, kD>(q_s, q_base, p.q_st, q0, kRowsSimt, p.seq, p.head_dim);
    load_rows_simt<T, kD>(do_s, d_base, p.d_st, q0, kRowsSimt, p.seq, p.head_dim);

    const long long rows = static_cast<long long>(bh) * p.seq;
    const int row0 = q0 + warp * kRowsPerWarp;
    float lse[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        const bool valid = row0 + r < p.seq;
        lse[r] = valid ? p.lse[rows + row0 + r] : 0.0f;
        delta[r] = valid ? p.delta[rows + row0 + r] : 0.0f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    }

    const int kv_end = p.causal ? min(p.seq, q0 + kRowsSimt) : p.seq;
    for (int kv0 = 0; kv0 < kv_end; kv0 += kColsSimt) {
        __syncthreads();
        load_rows_simt<T, kD>(k_s, k_base, p.k_st, kv0, kColsSimt, p.seq, p.head_dim);
        load_rows_simt<T, kD>(v_s, v_base, p.v_st, kv0, kColsSimt, p.seq, p.head_dim);
        __syncthreads();

        float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.0f;
        for (int d = 0; d < kD; ++d) {
            const float k_val = k_s[lane * S + d], v_val = v_s[lane * S + d];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const int row = warp * kRowsPerWarp + r;
                s[r] = fmaf(q_s[row * S + d], k_val, s[r]);
                dp[r] = fmaf(do_s[row * S + d], v_val, dp[r]);
            }
        }
        const int key = kv0 + lane;
        float ds[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool masked = key >= p.seq || (p.causal && key > row0 + r);
            const float prob = masked ? 0.0f : expf(s[r] * p.scale - lse[r]);
            ds[r] = prob * (dp[r] - delta[r]) * p.scale;
        }
        for (int j = 0; j < kColsSimt; ++j) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const float term = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
                for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(term, k_s[j * S + c * 32 + lane], acc[r][c]);
            }
        }
    }
    T* o_base = static_cast<T*>(p.out0) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        if (row0 + r < p.seq) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                const int col = c * 32 + lane;
                if (col < p.head_dim) o_base[(row0 + r) * p.o_st + col] = from_float<T>(acc[r][c]);
            }
        }
    }
}

// dK/dV pass: a warp owns 4 KV rows; lane j takes query j of a 32-query tile.
template <typename T, int kD>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkv_simt(const Params p) {
    constexpr int kCols = kD / 32;
    constexpr int S = kD + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* k_s = reinterpret_cast<float*>(smem_raw);  // [kRowsSimt][S]
    float* v_s = k_s + kRowsSimt * S;
    float* q_s = v_s + kRowsSimt * S;  // [kColsSimt][S]
    float* do_s = q_s + kColsSimt * S;

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int kv0 = blockIdx.y * kRowsSimt;  // the first KV tiles are the heaviest when causal
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    const T* d_base = static_cast<const T*>(p.dout) + b * p.d_sb + h * p.d_sh;
    load_rows_simt<T, kD>(k_s, k_base, p.k_st, kv0, kRowsSimt, p.seq, p.head_dim);
    load_rows_simt<T, kD>(v_s, v_base, p.v_st, kv0, kRowsSimt, p.seq, p.head_dim);

    const long long rows = static_cast<long long>(bh) * p.seq;
    const int row0 = kv0 + warp * kRowsPerWarp;
    float dk[kRowsPerWarp][kCols], dv[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.0f;
    }

    const int q_begin = p.causal ? kv0 / kColsSimt * kColsSimt : 0;  // causal: from the diagonal tile
    for (int q0 = q_begin; q0 < p.seq; q0 += kColsSimt) {
        __syncthreads();
        load_rows_simt<T, kD>(q_s, q_base, p.q_st, q0, kColsSimt, p.seq, p.head_dim);
        load_rows_simt<T, kD>(do_s, d_base, p.d_st, q0, kColsSimt, p.seq, p.head_dim);
        __syncthreads();

        const int query = q0 + lane;
        const bool valid = query < p.seq;
        const float lse = valid ? p.lse[rows + query] : 0.0f;
        const float delta = valid ? p.delta[rows + query] : 0.0f;
        float st[kRowsPerWarp], dpt[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) st[r] = dpt[r] = 0.0f;
        for (int d = 0; d < kD; ++d) {
            const float q_val = q_s[lane * S + d], do_val = do_s[lane * S + d];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const int row = warp * kRowsPerWarp + r;
                st[r] = fmaf(k_s[row * S + d], q_val, st[r]);
                dpt[r] = fmaf(v_s[row * S + d], do_val, dpt[r]);
            }
        }
        float pt[kRowsPerWarp], dst[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool masked = !valid || (p.causal && row0 + r > query);
            pt[r] = masked ? 0.0f : expf(st[r] * p.scale - lse);
            dst[r] = pt[r] * (dpt[r] - delta) * p.scale;
        }
        for (int j = 0; j < kColsSimt; ++j) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const float prob = __shfl_sync(0xffffffffu, pt[r], j);
                const float term = __shfl_sync(0xffffffffu, dst[r], j);
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    dv[r][c] = fmaf(prob, do_s[j * S + c * 32 + lane], dv[r][c]);
                    dk[r][c] = fmaf(term, q_s[j * S + c * 32 + lane], dk[r][c]);
                }
            }
        }
    }
    T* dk_base = static_cast<T*>(p.out0) + b * p.o_sb + h * p.o_sh;
    T* dv_base = static_cast<T*>(p.out1) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        if (row0 + r < p.seq) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                const int col = c * 32 + lane;
                if (col < p.head_dim) {
                    dk_base[(row0 + r) * p.o_st + col] = from_float<T>(dk[r][c]);
                    dv_base[(row0 + r) * p.o_st + col] = from_float<T>(dv[r][c]);
                }
            }
        }
    }
}

// ------------------------------------------------------------------ launch

// Both SIMT passes: a block per (batch*head, 16 rows), grid (B*H, ceil(T / 16)), its
// rows and a 32-row tile of the other side staged as [rows][kD + 1] floats.
template <typename T, bool kDq>
struct BackwardSimt {
    const Params& p;
    cudaStream_t stream;

    template <int kD>
    int run() const {
        const auto kernel = kDq ? flash_bwd_dq_simt<T, kD> : flash_bwd_dkv_simt<T, kD>;
        const size_t smem = (2 * kRowsSimt + 2 * kColsSimt) * (kD + 1) * sizeof(float);
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid(p.batch * p.heads, (p.seq + kRowsSimt - 1) / kRowsSimt);
        kernel<<<grid, kWarps * 32, smem, stream>>>(p);
        return static_cast<int>(cudaGetLastError());
    }
};

template <bool kDq>
int launch_simt(const Params& p, int dtype, cudaStream_t stream) {
    if (p.batch <= 0 || p.seq <= 0 || p.heads <= 0) return 0;
    if (dtype == kSimtF32) return dispatch_simt_width(p.head_dim, BackwardSimt<float, kDq>{p, stream});
    if (dtype == kSimtBf16) return dispatch_simt_width(p.head_dim, BackwardSimt<__nv_bfloat16, kDq>{p, stream});
    if (dtype == kSimtF16) return dispatch_simt_width(p.head_dim, BackwardSimt<__half, kDq>{p, stream});
    return static_cast<int>(cudaErrorInvalidValue);
}

// Both wgmma passes: a block per (batch*head, `rows` rows); P: WgmmaParams, or CopiedParams.
template <typename Kernel, typename P>
int launch_wgmma(Kernel kernel, size_t smem, int rows, const CUtensorMap (&maps)[4], const P& p, int batch,
                 cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * p.heads, (p.seq + rows - 1) / rows);
    kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
    return static_cast<int>(cudaGetLastError());
}

// A wgmma pass (kDq: the dQ pass, else the dK/dV pass) at the padded width Dp:
// full width or not, with its tiles' shared memory and its block's rows.
template <bool kDq, typename T, int Dp>
int launch_pass(const CUtensorMap (&maps)[4], const WgmmaParams& p, int batch, cudaStream_t stream) {
    if constexpr (kDq) {
        const auto kernel = p.head_dim == Dp            ? flash_bwd_dq_wgmma<T, Dp, true, false>
                            : packed_heads(p.head_dim) ? flash_bwd_dq_wgmma<T, Dp, false, true>
                                                       : flash_bwd_dq_wgmma<T, Dp, false, false>;
        return launch_wgmma(kernel, DqTiles<Dp>::kBytes, kBlockRows, maps, p, batch, stream);
    } else {
        const auto kernel = p.head_dim == Dp            ? flash_bwd_dkv_wgmma<T, Dp, true, false, false>
                            : packed_heads(p.head_dim) ? flash_bwd_dkv_wgmma<T, Dp, false, true, false>
                                                       : flash_bwd_dkv_wgmma<T, Dp, false, false, false>;
        return launch_wgmma(kernel, DkvTiles<Dp>::kBytes, DkvTiles<Dp>::kKvRows, maps, p, batch, stream);
    }
}

// The padded width: the least of 64, 128 and 256 that holds the tile's span (tma_span).
template <bool kDq, typename T>
int dispatch_width(const CUtensorMap (&maps)[4], const WgmmaParams& p, int batch, cudaStream_t stream) {
    const int span = tma_span(p.head_dim, p.heads);
    if (span <= 64) return launch_pass<kDq, T, 64>(maps, p, batch, stream);
    if (span <= 128) return launch_pass<kDq, T, 128>(maps, p, batch, stream);
    return launch_pass<kDq, T, 256>(maps, p, batch, stream);
}

// The dK/dV pass on the copied-rows view at the least padded width that holds its span (copied_span).
template <typename T>
int dispatch_dkv_copied(const CopiedParams& p, int batch, int span, cudaStream_t stream) {
    const CUtensorMap maps[4] = {};  // not read: the copied-rows view copies every tile
    if (span <= 64) return launch_wgmma(flash_bwd_dkv_wgmma<T, 64, false, false, true>, DkvTiles<64>::kBytes,
                                        DkvTiles<64>::kKvRows, maps, p, batch, stream);
    if (span <= 128) return launch_wgmma(flash_bwd_dkv_wgmma<T, 128, false, false, true>, DkvTiles<128>::kBytes,
                                         DkvTiles<128>::kKvRows, maps, p, batch, stream);
    return launch_wgmma(flash_bwd_dkv_wgmma<T, 256, false, false, true>, DkvTiles<256>::kBytes, DkvTiles<256>::kKvRows,
                        maps, p, batch, stream);
}

// The tensor maps of q, k, v, dout from the wrapper's geometries (boxes of 64 x 64),
// with boxes of `kv_rows` rows for k and v.
#if HM_IN_PART(1) || HM_IN_PART(2)
int encode_maps(CUtensorMap (&maps)[4], const void* const (&bases)[4], const long long* const (&geometries)[4],
                int head_dim, int heads, int dtype, int kv_rows) {
    for (int i = 0; i < 4; ++i) {
        sm90::TmaGeometry geometry = *reinterpret_cast<const sm90::TmaGeometry*>(geometries[i]);
        if (geometry.box[2] != kBoxRows) return static_cast<int>(cudaErrorInvalidValue);
        const int rows = i == 1 || i == 2 ? kv_rows : kBoxRows;
        geometry.box[2] = rows;
        const int err = sm90::encode_tma_map(&maps[i], bases[i], geometry, rows, head_dim, heads, tma_type(dtype));
        if (err != 0) return err;
    }
    return 0;
}

// Both wgmma passes' C entries: bf16 or fp16 at a head_dim from 16 to 256 that is a
// multiple of 8, or any other whose heads * head_dim is (and whose span is at most 256).
template <bool kDq>
int launch_wgmma_pass(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* out0, void* out1, int dtype, int batch, int seq, int heads,
                      int head_dim, const long long* q_geometry, const long long* k_geometry,
                      const long long* v_geometry, const long long* d_geometry, long long o_sb, long long o_st,
                      long long o_sh, int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (!wgmma_takes(dtype, head_dim, heads)) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[4];
    const int kv_rows = kDq && tma_span(head_dim, heads) > 128 ? DqTiles<256>::kKvRows : kBoxRows;
    const int err = encode_maps(maps, {q, k, v, dout}, {q_geometry, k_geometry, v_geometry, d_geometry}, head_dim,
                                heads, dtype, kv_rows);
    if (err != 0) return err;
    // the tensors the pass streams, as the packed-heads view's kernels copy them
    const auto& view0 = *reinterpret_cast<const sm90::TmaGeometry*>(kDq ? k_geometry : q_geometry);
    const auto& view1 = *reinterpret_cast<const sm90::TmaGeometry*>(kDq ? v_geometry : d_geometry);
    const WgmmaParams p{lse, delta, out0, out1, seq, heads, head_dim, o_sb, o_st, o_sh, scale, causal,
                        {kDq ? k : q, kDq ? v : dout}, {view0.strides[2], view1.strides[2]},
                        {view0.strides[1], view1.strides[1]}};
    if (dtype == kSimtF16) return dispatch_width<kDq, __half>(maps, p, batch, stream);
    return dispatch_width<kDq, __nv_bfloat16>(maps, p, batch, stream);
}
#endif

// The 3xTF32 dK/dV pass: a block per (batch*head, 64 KV rows).
template <int Dp>
int launch_dkv_tf32x3(const Params& p, cudaStream_t stream) {
    using L = Tf32DkvTiles<Dp>;
    const auto kernel = flash_bwd_dkv_tf32x3<Dp>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(p.batch * p.heads, (p.seq + L::kKvRows - 1) / L::kKvRows);
    kernel<<<grid, 256, L::kBytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// The 3xTF32 dQ pass: a block per (batch*head, 128 query rows at Dp = 64, 64 at 128).
template <int Dp>
int launch_dq_tf32x3(const Params& p, cudaStream_t stream) {
    using L = Tf32DqTiles<Dp>;
    const auto kernel = flash_bwd_dq_tf32x3<Dp>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(p.batch * p.heads, (p.seq + L::kRows - 1) / L::kRows);
    kernel<<<grid, L::kThreads, L::kBytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

#if HM_IN_PART(0)
Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, void* out0, void* out1, int batch, int seq, int heads, int head_dim,
                   long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh, long long d_sb, long long d_st, long long d_sh,
                   long long o_sb, long long o_st, long long o_sh, int causal, float scale) {
    return Params{q, k, v, dout, lse, delta, out0, out1, batch, seq, heads, head_dim,
                  q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                  scale, causal};
}
#endif

}  // namespace

// Built in four parts (HM_IN_PART): the wgmma dQ entry, the wgmma dK/dV entry, whose kernels take
// most of the compile, the copied-rows dK/dV entry, and the others.
#if HM_IN_PART(0)
// q, k, v, dout: [B, T, H, D] of one element type `dtype` (SimtDtype: fp32, bf16
// or fp16; last dim contiguous, strides in elements), head_dim 1 to 256; lse,
// delta: [B, H, T] fp32 contiguous -> dq [B, T, H, D] of that type.
extern "C" int hm_flash_backward_dq_simt(const void* q, const void* k, const void* v, const void* dout,
                                         const float* lse, const float* delta, void* dq, int dtype,
                                         int batch, int seq, int heads, int head_dim,
                                         long long q_sb, long long q_st, long long q_sh,
                                         long long k_sb, long long k_st, long long k_sh,
                                         long long v_sb, long long v_st, long long v_sh,
                                         long long d_sb, long long d_st, long long d_sh,
                                         long long o_sb, long long o_st, long long o_sh,
                                         int causal, float scale, cudaStream_t stream) {
    const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, batch, seq, heads, head_dim, q_sb, q_st, q_sh,
                                 k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                                 causal, scale);
    return launch_simt<true>(p, dtype, stream);
}

// As above -> dk, dv [B, T, H, D] of that type, sharing one layout (o_*).
extern "C" int hm_flash_backward_dkv_simt(const void* q, const void* k, const void* v, const void* dout,
                                          const float* lse, const float* delta, void* dk, void* dv, int dtype,
                                          int batch, int seq, int heads, int head_dim,
                                          long long q_sb, long long q_st, long long q_sh,
                                          long long k_sb, long long k_st, long long k_sh,
                                          long long v_sb, long long v_st, long long v_sh,
                                          long long d_sb, long long d_st, long long d_sh,
                                          long long o_sb, long long o_st, long long o_sh,
                                          int causal, float scale, cudaStream_t stream) {
    const Params p = make_params(q, k, v, dout, lse, delta, dk, dv, batch, seq, heads, head_dim, q_sb, q_st, q_sh,
                                 k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                                 causal, scale);
    return launch_simt<false>(p, dtype, stream);
}

// As hm_flash_backward_dkv_simt, for fp32 (`dtype` kSimtF32) at a head_dim from 16 to 128 that
// is a multiple of 4, q, k, v, dout 16-byte aligned with strides that are multiples of 4
// elements -> dk, dv fp32, on the tensor cores in 3xTF32.
extern "C" int hm_flash_backward_dkv_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                                            const float* lse, const float* delta, void* dk, void* dv, int dtype,
                                            int batch, int seq, int heads, int head_dim,
                                            long long q_sb, long long q_st, long long q_sh,
                                            long long k_sb, long long k_st, long long k_sh,
                                            long long v_sb, long long v_st, long long v_sh,
                                            long long d_sb, long long d_st, long long d_sh,
                                            long long o_sb, long long o_st, long long o_sh,
                                            int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (!tf32x3_takes(dtype, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
    const Params p = make_params(q, k, v, dout, lse, delta, dk, dv, batch, seq, heads, head_dim, q_sb, q_st, q_sh,
                                 k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                                 causal, scale);
    return head_dim <= 64 ? launch_dkv_tf32x3<64>(p, stream) : launch_dkv_tf32x3<128>(p, stream);
}

// As hm_flash_backward_dq_simt, for fp32 (`dtype` kSimtF32) at a head_dim from 16 to 128 that is
// a multiple of 4, q, k, v, dout 16-byte aligned with strides that are multiples of 4 elements
// -> dq fp32, on the tensor cores in 3xTF32.
extern "C" int hm_flash_backward_dq_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                                           const float* lse, const float* delta, void* dq, int dtype,
                                           int batch, int seq, int heads, int head_dim,
                                           long long q_sb, long long q_st, long long q_sh,
                                           long long k_sb, long long k_st, long long k_sh,
                                           long long v_sb, long long v_st, long long v_sh,
                                           long long d_sb, long long d_st, long long d_sh,
                                           long long o_sb, long long o_st, long long o_sh,
                                           int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (!tf32x3_takes(dtype, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
    const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, batch, seq, heads, head_dim, q_sb, q_st, q_sh,
                                 k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                                 causal, scale);
    return head_dim <= 64 ? launch_dq_tf32x3<64>(p, stream) : launch_dq_tf32x3<128>(p, stream);
}

#endif

#if HM_IN_PART(1)
// q, k, v, dout: [B, T, H, D] of one element type `dtype` (SimtDtype: bf16 or fp16, at
// a head_dim from 16 to 256 that is a multiple of 8, or any other whose H * head_dim is,
// in the packed-heads view), each described by its TMA geometry (sm90::TmaGeometry,
// boxes of 64 columns x 64 rows; one set serves both passes); lse, delta: [B, H, T]
// fp32 contiguous -> dq [B, T, H, D] of that type (strides o_*, in elements).
extern "C" int hm_flash_backward_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                          const float* lse, const float* delta, void* dq, int dtype,
                                          int batch, int seq, int heads, int head_dim,
                                          const long long* q_geometry, const long long* k_geometry,
                                          const long long* v_geometry, const long long* d_geometry,
                                          long long o_sb, long long o_st, long long o_sh,
                                          int causal, float scale, cudaStream_t stream) {
    return launch_wgmma_pass<true>(q, k, v, dout, lse, delta, dq, nullptr, dtype, batch, seq, heads, head_dim,
                                   q_geometry, k_geometry, v_geometry, d_geometry, o_sb, o_st, o_sh, causal, scale,
                                   stream);
}

#endif

#if HM_IN_PART(2)
// As above -> dk, dv [B, T, H, D] of that type, sharing one layout (o_*).
extern "C" int hm_flash_backward_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                           const float* lse, const float* delta, void* dk, void* dv, int dtype,
                                           int batch, int seq, int heads, int head_dim,
                                           const long long* q_geometry, const long long* k_geometry,
                                           const long long* v_geometry, const long long* d_geometry,
                                           long long o_sb, long long o_st, long long o_sh,
                                           int causal, float scale, cudaStream_t stream) {
    return launch_wgmma_pass<false>(q, k, v, dout, lse, delta, dk, dv, dtype, batch, seq, heads, head_dim,
                                    q_geometry, k_geometry, v_geometry, d_geometry, o_sb, o_st, o_sh, causal, scale,
                                    stream);
}
#endif

#if HM_IN_PART(3)
// q, k, v, dout: [B, T, H, D] of one element type `dtype` (SimtDtype: bf16 or fp16), head_dim 1
// to 256, last dim contiguous, strides in elements, of which no TMA view exists (the wrapper's
// copied_rows): read through the copied-rows view, each block's head landing at its
// sm90::copied_shift under `modulus` (2, 4, 8 or 16 bytes); lse, delta: [B, H, T] fp32
// contiguous -> dk, dv [B, T, H, D] of that type, sharing one layout (o_*), on the tensor cores.
extern "C" int hm_flash_backward_dkv_copied(const void* q, const void* k, const void* v, const void* dout,
                                            const float* lse, const float* delta, void* dk, void* dv, int dtype,
                                            int batch, int seq, int heads, int head_dim,
                                            long long q_sb, long long q_st, long long q_sh,
                                            long long k_sb, long long k_st, long long k_sh,
                                            long long v_sb, long long v_st, long long v_sh,
                                            long long d_sb, long long d_st, long long d_sh,
                                            long long o_sb, long long o_st, long long o_sh,
                                            int modulus, int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (!copied_takes(dtype, head_dim, modulus)) return static_cast<int>(cudaErrorInvalidValue);
    const int span = copied_span(q, 2 * q_sb, 2 * q_sh, batch, heads, head_dim, modulus);
    if (span > 256) return static_cast<int>(cudaErrorInvalidValue);
    // byte strides; the streamed tensors are q and dout, the resident ones k and v
    const CopiedParams p{lse, delta, dk, dv, seq, heads, head_dim, o_sb, o_st, o_sh, scale, causal,
                         {q, dout}, {2 * q_sb, 2 * d_sb}, {2 * q_st, 2 * d_st},
                         {2 * q_sh, 2 * d_sh}, {k, v}, {2 * k_sb, 2 * v_sb}, {2 * k_st, 2 * v_st}, {2 * k_sh, 2 * v_sh},
                         modulus};
    if (dtype == kSimtF16) return dispatch_dkv_copied<__half>(p, batch, span, stream);
    return dispatch_dkv_copied<__nv_bfloat16>(p, batch, span, stream);
}
#endif
