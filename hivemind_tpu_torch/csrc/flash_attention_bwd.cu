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
// atomics: the result is deterministic. P and dS are rounded to bf16 before their
// products: that rounding is the kernels' main difference from the TPU kernel,
// which multiplied fp32 tiles. Columns past T (and above the diagonal when
// causal) are masked to P = 0 explicitly, so nothing relies on a padded lse.
//
// Both bf16 passes (building blocks in sm90.cuh) run one thread block per 128
// rows (query rows for dQ, KV rows for dK/dV) of one batch*head, in three
// warpgroups: two consumer warpgroups own 64 of those rows each, whose tiles stay
// resident in shared memory, and one warp of the third (the producer) streams the
// other side's 64-row tiles by TMA through a ring. The producer warpgroup gives
// its registers to the consumers (setmaxnreg 24 / 240). Every tensor is read by
// TMA through one geometry shared by both passes: boxes of 64 columns x 64 rows,
// so a 128-row tile is two boxes per 64 columns, which land where one 128-row box
// would. Every wgmma is issued outside any branch (ptxas serializes them all
// otherwise, note C7520). The exponent is 2^(S * D^-1/2 * log2(e) - lse * log2(e))
// by ex2.approx. Masking is applied only on the tiles that meet the diagonal when
// causal and on the tile holding T; TMA reads rows past T as zeros, and rows past
// T are never stored.
//
// dQ pass, bf16:
//  * Grid (B*H, query tiles), the heaviest query tiles first when causal (the
//    last tile of each batch*head first), as the forward. Q and dO of the block's
//    128 rows are loaded once; K and V tiles of 64 rows stream through a ring of
//    four stages, with separate full / empty mbarriers for K and for V: V's slot
//    is freed once dP is done, K's once dS K is (Q, dO and the ring: 192 KB of
//    shared memory at D = 128). Each consumer thread keeps lse
//    (times log2 e) and delta of its two rows in registers for the whole sweep.
//  * S = Q K^T and dP = dO V^T are wgmma m64n64k16 with every operand K-major in
//    shared memory; dS = P * (dP - delta) * D^-1/2 is computed in place in the
//    accumulator layout, which is the A-register layout, and packed to bf16.
//  * dQ += dS K is wgmma with dS from registers and K read MN-major through the
//    transpose-B flag (the k dimension is K's rows): no transposed copy of K.
//  * One wgmma group per KV tile: S and dP of tile j with dS K of tile j - 1
//    (the first group S and dP only, a last one dS K only), so each tile waits on
//    the tensor cores once. At D = 128 a consumer thread holds S, dP (32 + 32),
//    dQ (64) and the dS fragments (16): 144 of its 240 registers.
//  * The two consumer warpgroups take turns issuing their groups (ping-pong, two
//    named barriers, as the forward), so one computes dS while the other's
//    products run: faster on an H100 than letting them issue freely, at every
//    shape timed. The ring is deep because a K slot is freed only a turn after
//    its tile's S: at ALBERT's shape two stages were slower than three, and
//    three slower than four (PERF.md, the dQ pass's redesign).
//  * Causal: the KV loop ends at the block's diagonal tiles; warpgroup 0 also runs
//    the last KV tile, which lies wholly above its rows and masks to zero, so that
//    both warpgroups release every ring slot.
//
// dK/dV pass, bf16:
//  * Grid (B*H, KV tiles of 128 rows). K and V of the block stay resident; Q and
//    dO tiles of 64 rows stream through a ring of two stages, and the producer
//    warp stages their lse (times log2 e) and delta by plain loads, which a TMA
//    map on [B*H, T] fp32 could not take for a T that is not a multiple of 4. At
//    D = 128 each consumer thread holds dK and dV (64 + 64 fp32) and S^T, dP^T
//    (32 + 32).
//  * S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with every operand K-major
//    in shared memory; P^T and dS^T are rounded to bf16 in place as A operands.
//  * dV += P^T dO and dK += dS^T Q are wgmma with the A operand from registers
//    and dO, Q read MN-major through the transpose-B flag.
//  * Causal: the query loop starts at the diagonal tile.
//
// Later work (not here): the ping-pong of the two consumer warpgroups and a deeper
// ring in the dK/dV pass, a persistent grid, TMA stores of the outputs.
//
// SIMT (every input the bf16 passes do not take: fp32, fp16, and bf16 at a head_dim
// other than 64 or 128, any head_dim up to 256, as the TPU kernels take the whole
// head_dim as their block): plain fp32 FMAs on the CUDA cores, no TF32, the inputs
// widened to fp32 as they are staged and P and dS kept in fp32, as the TPU
// kernels. A warp owns 4 rows (query rows in the dQ kernel, KV rows in the dK/dV
// kernel); lane j takes column j of a 32-wide tile, and each lane accumulates
// kD/32 output columns from the per-column terms broadcast by shuffles. kD is
// head_dim rounded up to 32, 64, 96, 128 or 256, its extra columns zeros.

#include <cuda_bf16.h>

#include <cstdint>

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

// ------------------------------------------------------------------ bf16 path

constexpr int kBlockRows = 128;  // rows a bf16 block owns: two consumer warpgroups of 64
constexpr int kBoxRows = 64;     // rows of a TMA box, and of every streamed tile
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;  // two consumer warpgroups and the producer's
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168

struct Bf16Params {
    const float* lse;    // [B, H, T]
    const float* delta;  // [B, H, T]
    void* out0;          // dq, or dk
    void* out1;          // dv (dK/dV pass)
    int seq, heads;
    long long o_sb, o_st, o_sh;  // the outputs' layout
    float scale;
    int causal;
};

// Write a warpgroup's 64 x D fp32 accumulator as bf16 rows `row_a` and `row_a + 8`
// of this thread: acc[4n + e] holds row row_a + 8*(e >> 1), column 8n + 2t + (e & 1)
// (the wgmma m64nD accumulator layout); rows at or past `seq` are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride, const float* acc,
                                           int row_a, int seq, int t) {
    const int row_b = row_a + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + t * 2;
        if (row_a < seq) {
            *reinterpret_cast<__nv_bfloat162*>(base + row_a * row_stride + col) =
                __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
        }
        if (row_b < seq) {
            *reinterpret_cast<__nv_bfloat162*>(base + row_b * row_stride + col) =
                __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
        }
    }
}

// TMA of one tile of kRows rows (a multiple of 64) from row `row0`: D/64 regions of
// 64 columns x kRows rows, one after the other, each loaded as kRows/64 boxes of
// 64 rows (8 rows of 128 bytes are one swizzle period, so a box lands where the
// same rows of one taller box would).
template <int D, int kRows>
__device__ __forceinline__ void load_tile_tma(uint32_t dst, const CUtensorMap* map, uint32_t bar, int h, int row0,
                                              int b) {
#pragma unroll
    for (int col = 0; col < D / sm90::kBoxCols; ++col) {
#pragma unroll
        for (int part = 0; part < kRows / kBoxRows; ++part) {
            sm90::tma_load_4d(dst + (col * kRows + part * kBoxRows) * sm90::kSwizzleRowBytes, map, bar,
                              col * sm90::kBoxCols, h, row0 + part * kBoxRows, b);
        }
    }
}

// dQ pass: shared-memory layout (byte offsets from a 1024-aligned base).
constexpr int kDqStages = 4;  // depth of the K / V ring
template <int D>
struct DqTiles {
    static constexpr uint32_t kQBox = kBlockRows * sm90::kSwizzleRowBytes;  // 64 columns x 128 rows: 16 KB
    static constexpr uint32_t kKvBox = kBoxRows * sm90::kSwizzleRowBytes;   // 64 columns x 64 rows: 8 KB
    static constexpr uint32_t kQTile = kQBox * (D / sm90::kBoxCols);
    static constexpr uint32_t kKvTile = kKvBox * (D / sm90::kBoxCols);
    static constexpr uint32_t kQ = 0, kDo = kQTile, kK = 2 * kQTile, kV = kK + kDqStages * kKvTile;
    static constexpr uint32_t kBarriers = kV + kDqStages * kKvTile;  // full_qdo, full_k[S], full_v[S], empty_k[S], empty_v[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 4 * kDqStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                      const Bf16Params p) {
    using L = DqTiles<D>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (sm90::smem_addr(smem_raw) + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    const uint32_t full_qdo = base + L::kBarriers;
    const auto full_k = [&](int s) { return full_qdo + 8 * (1 + s); };
    const auto full_v = [&](int s) { return full_qdo + 8 * (1 + kDqStages + s); };
    const auto empty_k = [&](int s) { return full_qdo + 8 * (1 + 2 * kDqStages + s); };
    const auto empty_v = [&](int s) { return full_qdo + 8 * (1 + 3 * kDqStages + s); };

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q_tiles = (p.seq + kBlockRows - 1) / kBlockRows;
    const int q0 = (q_tiles - 1 - static_cast<int>(blockIdx.y)) * kBlockRows;  // heaviest first
    const int kv_end = p.causal ? min(p.seq, q0 + kBlockRows) : p.seq;   // causal: up to the diagonal
    const int kv_tiles = (kv_end + kBoxRows - 1) / kBoxRows;

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_qdo, 1);
        for (int s = 0; s < kDqStages; ++s) {
            sm90::mbar_init(full_k(s), 1);
            sm90::mbar_init(full_v(s), 1);
            sm90::mbar_init(empty_k(s), kConsumerWarps);
            sm90::mbar_init(empty_v(s), kConsumerWarps);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumerWarps * 32) {  // the producer warpgroup; one thread issues every load
        sm90::setmaxnreg_dec<kProducerRegs>();
        if (threadIdx.x == kConsumerWarps * 32) {
            sm90::mbar_arrive_expect_tx(full_qdo, 2 * L::kQTile);
            load_tile_tma<D, kBlockRows>(base + L::kQ, &tm_q, full_qdo, h, q0, b);
            load_tile_tma<D, kBlockRows>(base + L::kDo, &tm_do, full_qdo, h, q0, b);
            for (int j = 0; j < kv_tiles; ++j) {
                const int s = j % kDqStages;
                const uint32_t parity = ((j / kDqStages) & 1) ^ 1;  // the first round passes at once
                sm90::mbar_wait(empty_k(s), parity);
                sm90::mbar_arrive_expect_tx(full_k(s), L::kKvTile);
                load_tile_tma<D, kBoxRows>(base + L::kK + s * L::kKvTile, &tm_k, full_k(s), h, j * kBoxRows, b);
                sm90::mbar_wait(empty_v(s), parity);
                sm90::mbar_arrive_expect_tx(full_v(s), L::kKvTile);
                load_tile_tma<D, kBoxRows>(base + L::kV + s * L::kKvTile, &tm_v, full_v(s), h, j * kBoxRows, b);
            }
        }
    } else {  // two consumer warpgroups, 64 query rows each
        sm90::setmaxnreg_inc<kConsumerRegs>();
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

        float dq[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
        float sc[kBoxRows / 2], dp[kBoxRows / 2];  // S = Q K^T (then dS) and dP = dO V^T of one KV tile: 64 x 64
        uint32_t df[kBoxRows / 16][4];             // dS as the A operand of dS K, 16 keys each

        const uint32_t q_wg = base + L::kQ + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        const uint32_t do_wg = base + L::kDo + wg * 64 * sm90::kSwizzleRowBytes;
        // S and dP of KV tile j
        const auto issue_s_dp = [&](int j) {
            const uint32_t k_tile = base + L::kK + (j % kDqStages) * L::kKvTile;
            const uint32_t v_tile = base + L::kV + (j % kDqStages) * L::kKvTile;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                // box kk / 4, then 32 bytes (16 columns) along its swizzled 128-byte rows
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                sm90::wgmma_ss(sc, sm90::desc_kmajor(q_wg + q_off), sm90::desc_kmajor(k_tile + kv_off), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                sm90::wgmma_ss(dp, sm90::desc_kmajor(do_wg + q_off), sm90::desc_kmajor(v_tile + kv_off), kk > 0);
            }
        };
        // dQ += dS K of KV tile j, dS from df
        const auto issue_dq = [&](int j) {
            const uint32_t k_tile = base + L::kK + (j % kDqStages) * L::kKvTile;
#pragma unroll
            for (int kc = 0; kc < kBoxRows / 16; ++kc) {  // 16 keys per k-step: 2048 bytes down K's boxes
                sm90::wgmma_rs_tb(dq, df[kc], sm90::desc_mnmajor(k_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kKvBox), 1);
            }
        };
        // dS of tile j in place of its scores (column c of the tile is key kv0 + c), packed into df
        const auto make_ds = [&](int j) {
            const int kv0 = j * kBoxRows;
            const bool edge = kv0 + kBoxRows > p.seq || (p.causal && kv0 + kBoxRows - 1 > q0 + wg * 64);
#pragma unroll
            for (int e = 0; e < kBoxRows / 2; ++e) {
                const bool hi = e & 2;  // row_b's entries
                float prob = sm90::exp2_approx(fmaf(sc[e], scale2, -(hi ? lse_b : lse_a)));
                if (edge) {
                    const int col = kv0 + (e / 4) * 8 + 2 * t + (e & 1);
                    if (col >= p.seq || (p.causal && col > (hi ? row_b : row_a))) prob = 0.0f;
                }
                sc[e] = prob * (dp[e] - (hi ? delta_b : delta_a)) * p.scale;
            }
#pragma unroll
            for (int kc = 0; kc < kBoxRows / 16; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) df[kc][r] = sm90::pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
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
        if (wg == 1) pass_turn();
        sm90::mbar_wait(full_qdo, 0);
        sm90::mbar_wait(full_k(0), 0);
        sm90::mbar_wait(full_v(0), 0);
        take_turn();
        issue_s_dp(0);
        sm90::wgmma_commit();
        pass_turn();
        finish_turn();
        if (lane == 0) sm90::mbar_arrive(empty_v(0));  // this warp is done with V of tile 0
        make_ds(0);
        for (int j = 1; j < kv_tiles; ++j) {
            const int s = j % kDqStages;
            sm90::mbar_wait(full_k(s), (j / kDqStages) & 1);
            sm90::mbar_wait(full_v(s), (j / kDqStages) & 1);
            take_turn();
            issue_s_dp(j);
            issue_dq(j - 1);
            sm90::wgmma_commit();
            pass_turn();
            finish_turn();
            if (lane == 0) {  // this warp is done with V of tile j and K of tile j - 1
                sm90::mbar_arrive(empty_v(s));
                sm90::mbar_arrive(empty_k((j - 1) % kDqStages));
            }
            make_ds(j);
        }
        take_turn();
        issue_dq(kv_tiles - 1);
        sm90::wgmma_commit();
        if (wg == 0) pass_turn();  // warpgroup 1's last turn has no taker
        finish_turn();
        store_rows<D>(static_cast<__nv_bfloat16*>(p.out0) + b * p.o_sb + h * p.o_sh, p.o_st, dq, row_a, p.seq, t);
    }
}

// dK/dV pass: shared-memory layout (byte offsets from a 1024-aligned base).
constexpr int kDkvStages = 2;  // depth of the Q / dO ring
template <int D>
struct DkvTiles {
    static constexpr uint32_t kKvBox = kBlockRows * sm90::kSwizzleRowBytes;  // 64 columns x 128 rows: 16 KB
    static constexpr uint32_t kQBox = kBoxRows * sm90::kSwizzleRowBytes;     // 64 columns x 64 rows: 8 KB
    static constexpr uint32_t kKvTile = kKvBox * (D / sm90::kBoxCols);
    static constexpr uint32_t kQTile = kQBox * (D / sm90::kBoxCols);
    static constexpr uint32_t kK = 0, kV = kKvTile, kQ = 2 * kKvTile, kDo = kQ + kDkvStages * kQTile;
    static constexpr uint32_t kLse = kDo + kDkvStages * kQTile;             // [S][64] fp32: lse * log2(e)
    static constexpr uint32_t kDelta = kLse + kDkvStages * kBoxRows * 4;    // [S][64] fp32
    static constexpr uint32_t kBarriers = kDelta + kDkvStages * kBoxRows * 4;  // full_kv, full[S], empty[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 2 * kDkvStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                       const Bf16Params p) {
    using L = DkvTiles<D>;
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
    const int kv0 = blockIdx.y * kBlockRows;
    const int q_tiles = (p.seq + kBoxRows - 1) / kBoxRows;
    const int q_begin = p.causal ? kv0 / kBoxRows : 0;  // causal: start at the diagonal tile

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_kv, 1);
        for (int s = 0; s < kDkvStages; ++s) {
            sm90::mbar_init(full(s), 32);  // the producer warp's lanes, one of them with the TMA bytes
            sm90::mbar_init(empty(s), kConsumerWarps);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumerWarps * 32) {  // the producer warpgroup; its first warp loads
        sm90::setmaxnreg_dec<kProducerRegs>();
        const int lane = threadIdx.x - kConsumerWarps * 32;
        if (lane < 32) {
            if (lane == 0) {
                sm90::mbar_arrive_expect_tx(full_kv, 2 * L::kKvTile);
                load_tile_tma<D, kBlockRows>(base + L::kK, &tm_k, full_kv, h, kv0, b);
                load_tile_tma<D, kBlockRows>(base + L::kV, &tm_v, full_kv, h, kv0, b);
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
                    sm90::mbar_arrive_expect_tx(full(s), 2 * L::kQTile);
                    load_tile_tma<D, kBoxRows>(base + L::kQ + s * L::kQTile, &tm_q, full(s), h, q0, b);
                    load_tile_tma<D, kBoxRows>(base + L::kDo + s * L::kQTile, &tm_do, full(s), h, q0, b);
                } else {
                    sm90::mbar_arrive(full(s));
                }
            }
        }
    } else {  // two consumer warpgroups, 64 KV rows each
        sm90::setmaxnreg_inc<kConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_a = kv0 + wg * 64 + warp * 16 + g;  // this thread's KV rows: row_a, row_a + 8
        const float scale2 = p.scale * sm90::kLog2e;

        float dk[D / 2], dv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

        const uint32_t k_wg = base + L::kK + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        const uint32_t v_wg = base + L::kV + wg * 64 * sm90::kSwizzleRowBytes;
        sm90::mbar_wait(full_kv, 0);
        for (int i = q_begin; i < q_tiles; ++i) {
            const int n = i - q_begin, s = n % kDkvStages;
            const uint32_t q_tile = base + L::kQ + s * L::kQTile, do_tile = base + L::kDo + s * L::kQTile;

            float st[kBoxRows / 2], dpt[kBoxRows / 2];  // S^T = K Q^T and dP^T = V dO^T: 64 x 64 each
            sm90::mbar_wait(full(s), (n / kDkvStages) & 1);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                // box kk / 4, then 32 bytes (16 columns) along its swizzled 128-byte rows
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                sm90::wgmma_ss(st, sm90::desc_kmajor(k_wg + kv_off), sm90::desc_kmajor(q_tile + q_off), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                sm90::wgmma_ss(dpt, sm90::desc_kmajor(v_wg + kv_off), sm90::desc_kmajor(do_tile + q_off), kk > 0);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(st);
            sm90::fence_regs(dpt);

            // P^T and dS^T in place, column c of the tile being query q0 + c
            const int q0 = i * kBoxRows;
            const float* lse_t = lse_s + s * kBoxRows;
            const float* delta_t = delta_s + s * kBoxRows;
            const bool edge = q0 + kBoxRows > p.seq || (p.causal && q0 < kv0 + kBlockRows);
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
                    pf[kc][r] = sm90::pack_bf16(st[8 * kc + 2 * r], st[8 * kc + 2 * r + 1]);
                    df[kc][r] = sm90::pack_bf16(dpt[8 * kc + 2 * r], dpt[8 * kc + 2 * r + 1]);
                }
            }

            sm90::fence_regs(dv);
            sm90::fence_regs(dk);
            sm90::fence_regs(pf);
            sm90::fence_regs(df);
            sm90::wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < kBoxRows / 16; ++kc) {  // 16 query rows per k-step: 2048 bytes down the boxes
                sm90::wgmma_rs_tb(dv, pf[kc], sm90::desc_mnmajor(do_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kQBox), 1);
            }
#pragma unroll
            for (int kc = 0; kc < kBoxRows / 16; ++kc) {
                sm90::wgmma_rs_tb(dk, df[kc], sm90::desc_mnmajor(q_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kQBox), 1);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(dv);
            sm90::fence_regs(dk);
            if (lane == 0) sm90::mbar_arrive(empty(s));  // this warp is done with stage s
        }
        store_rows<D>(static_cast<__nv_bfloat16*>(p.out0) + b * p.o_sb + h * p.o_sh, p.o_st, dk, row_a, p.seq, t);
        store_rows<D>(static_cast<__nv_bfloat16*>(p.out1) + b * p.o_sb + h * p.o_sh, p.o_st, dv, row_a, p.seq, t);
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

// Both bf16 passes: a block per (batch*head, 128 rows).
template <typename Kernel>
int launch_bf16(Kernel kernel, size_t smem, const CUtensorMap (&maps)[4], const Bf16Params& p, int batch,
                cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * p.heads, (p.seq + kBlockRows - 1) / kBlockRows);
    kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
    return static_cast<int>(cudaGetLastError());
}

// The tensor maps of q, k, v, dout from their geometries (boxes of 64 x 64).
int encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout,
                const long long* q_geometry, const long long* k_geometry, const long long* v_geometry,
                const long long* d_geometry, int head_dim) {
    const void* bases[4] = {q, k, v, dout};
    const long long* geometries[4] = {q_geometry, k_geometry, v_geometry, d_geometry};
    for (int i = 0; i < 4; ++i) {
        const int err = sm90::encode_tma_map(&maps[i], bases[i], *reinterpret_cast<const sm90::TmaGeometry*>(geometries[i]),
                                             kBoxRows, head_dim);
        if (err != 0) return err;
    }
    return 0;
}

Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, void* out0, void* out1, int batch, int seq, int heads, int head_dim,
                   long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh, long long d_sb, long long d_st, long long d_sh,
                   long long o_sb, long long o_st, long long o_sh, int causal, float scale) {
    return Params{q, k, v, dout, lse, delta, out0, out1, batch, seq, heads, head_dim,
                  q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                  scale, causal};
}

}  // namespace

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

// q, k, v, dout: [B, T, H, D] bf16, each described by its TMA geometry
// (sm90::TmaGeometry, boxes of 64 columns x 64 rows; one set serves both passes);
// lse, delta: [B, H, T] fp32 contiguous -> dq [B, T, H, D] bf16 (strides o_*, in
// elements).
extern "C" int hm_flash_backward_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                         const float* lse, const float* delta, void* dq,
                                         int batch, int seq, int heads, int head_dim,
                                         const long long* q_geometry, const long long* k_geometry,
                                         const long long* v_geometry, const long long* d_geometry,
                                         long long o_sb, long long o_st, long long o_sh,
                                         int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[4];
    const int err = encode_maps(maps, q, k, v, dout, q_geometry, k_geometry, v_geometry, d_geometry, head_dim);
    if (err != 0) return err;
    const Bf16Params p{lse, delta, dq, nullptr, seq, heads, o_sb, o_st, o_sh, scale, causal};
    if (head_dim == 64) return launch_bf16(flash_bwd_dq_bf16<64>, DqTiles<64>::kBytes, maps, p, batch, stream);
    return launch_bf16(flash_bwd_dq_bf16<128>, DqTiles<128>::kBytes, maps, p, batch, stream);
}

// As above -> dk, dv [B, T, H, D] bf16, sharing one layout (o_*).
extern "C" int hm_flash_backward_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                          const float* lse, const float* delta, void* dk, void* dv,
                                          int batch, int seq, int heads, int head_dim,
                                          const long long* q_geometry, const long long* k_geometry,
                                          const long long* v_geometry, const long long* d_geometry,
                                          long long o_sb, long long o_st, long long o_sh,
                                          int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[4];
    const int err = encode_maps(maps, q, k, v, dout, q_geometry, k_geometry, v_geometry, d_geometry, head_dim);
    if (err != 0) return err;
    const Bf16Params p{lse, delta, dk, dv, seq, heads, o_sb, o_st, o_sh, scale, causal};
    if (head_dim == 64) return launch_bf16(flash_bwd_dkv_bf16<64>, DkvTiles<64>::kBytes, maps, p, batch, stream);
    return launch_bf16(flash_bwd_dkv_bf16<128>, DkvTiles<128>::kBytes, maps, p, batch, stream);
}
