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
// Design, bf16 (the serving and training path; the building blocks are sm90.cuh):
//  * One thread block per (128 query rows, batch*head); three warpgroups. Two
//    consumer warpgroups own 64 query rows each; one warp of the third (the
//    producer) issues the TMA loads: the block's Q tile once, then K and V tiles
//    of 128 rows through a ring of two stages. Each K and V slot has a "full"
//    mbarrier (TMA bytes) and an "empty" one (the 8 consumer warps), so a K slot
//    is refilled as soon as its S product is done. The producer warpgroup gives
//    its registers to the consumers (setmaxnreg 24 / 240), which hold two
//    64 x 128 fp32 accumulators at D = 128.
//  * Tiles live in shared memory in the 128-byte-swizzled layout TMA writes and
//    wgmma reads: Q 32 KB, K and V 2 x 2 x 32 KB at D = 128 (160 KB in all).
//  * S = Q K^T is wgmma m64n128k16 with Q and K both K-major in shared memory.
//    O += P V is wgmma with P from registers (the S accumulator's layout is the
//    A-register layout, so P is packed to bf16 in place) and V read MN-major
//    through the transpose-B flag: no transposed copy of V exists anywhere.
//  * The consumer warpgroups take turns on the tensor cores ("ping-pong", two
//    named barriers): a turn issues S of tile j and P V of tile j - 1 as one
//    wgmma group, then hands the turn over, so one warpgroup's softmax runs while
//    the other's products do. Every wgmma is issued outside any branch (the
//    first and last turns are peeled): under a branch ptxas serializes them.
//  * Online softmax in base 2: 2^x (ex2.approx) of the raw score times
//    D^-1/2 * log2(e), less the running row maximum likewise scaled; lse is
//    stored as a natural log (the backward recomputes P = exp(S * scale - lse)).
//  * Masking only where it can bite: the diagonal tile when causal (column >
//    row takes the finite -1e30, as the TPU kernel) and the tile holding T.
//    TMA reads rows past T as zeros, which still score 0, so columns past T are
//    masked there; rows past T are never stored.
//  * Query tiles are launched heaviest first (the last tile of each batch*head
//    first), so the causal tail is short.
//  * Later work (not here): a persistent grid, so that one tile's loads and
//    epilogue overlap another's products (at D = 64 and T = 512 a block runs
//    only 4 KV tiles), and TMA stores of O.
//
// Design, SIMT (every input the bf16 design does not take: fp32, fp16, and bf16 at
// a head_dim other than 64 or 128, any head_dim up to 256, as the TPU kernel takes
// the whole head_dim as its block): the same online softmax on the CUDA cores in
// fp32 FMAs only (no TF32), the inputs widened to fp32 as they are staged, as the
// TPU kernel casts its tiles. A block owns 16 query rows of one batch*head, a warp
// 4 of them; lane j scores key j of a 32-key tile, and each lane accumulates
// kD/32 output columns from probabilities broadcast by shuffles. kD is head_dim
// rounded up to 32, 64, 96, 128 or 256, its extra columns zeros.

#include <cuda_bf16.h>

#include <cstdint>

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

// ------------------------------------------------------------------ bf16 path

constexpr int kRows = 128;        // query rows per block, and KV rows per tile
constexpr int kStages = 2;        // depth of the K/V ring
constexpr int kConsumerWarps = 8;
constexpr int kThreadsBf16 = 384;  // two consumer warpgroups and the producer's
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168

struct Bf16Params {
    void* out;
    float* lse;  // [B, H, T] contiguous
    int seq, heads;
    long long o_sb, o_st, o_sh;
    float scale;
    int causal;
};

// Shared-memory layout (byte offsets from a 1024-aligned base).
template <int D>
struct ForwardTiles {
    static constexpr uint32_t kBox = kRows * sm90::kSwizzleRowBytes;  // 64 columns x 128 rows: 16 KB
    static constexpr uint32_t kTile = kBox * (D / sm90::kBoxCols);
    static constexpr uint32_t kQ = 0, kK = kTile, kV = kK + kStages * kTile;
    static constexpr uint32_t kBarriers = kV + kStages * kTile;  // full_q, full_k[S], full_v[S], empty_k[S], empty_v[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 4 * kStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// TMA of one 128-row tile: D/64 boxes of 64 columns, each its own swizzle region.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int h, int row0, int b) {
#pragma unroll
    for (int box = 0; box < D / sm90::kBoxCols; ++box) {
        sm90::tma_load_4d(dst + box * ForwardTiles<D>::kBox, map, bar, box * sm90::kBoxCols, h, row0, b);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_forward_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Bf16Params p) {
    using L = ForwardTiles<D>;
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
    const int kv_tiles = p.causal ? q_tile + 1 : q_tiles;  // causal: up to the diagonal tile

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_q, 1);
        for (int s = 0; s < kStages; ++s) {
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
            sm90::mbar_arrive_expect_tx(full_q, L::kTile);
            load_tile<D>(base + L::kQ, &tm_q, full_q, h, q0, b);
            for (int j = 0; j < kv_tiles; ++j) {
                const int s = j % kStages;
                const uint32_t parity = ((j / kStages) & 1) ^ 1;  // the first round passes at once
                sm90::mbar_wait(empty_k(s), parity);
                sm90::mbar_arrive_expect_tx(full_k(s), L::kTile);
                load_tile<D>(base + L::kK + s * L::kTile, &tm_k, full_k(s), h, j * kRows, b);
                sm90::mbar_wait(empty_v(s), parity);
                sm90::mbar_arrive_expect_tx(full_v(s), L::kTile);
                load_tile<D>(base + L::kV + s * L::kTile, &tm_v, full_v(s), h, j * kRows, b);
            }
        }
    } else {  // two consumer warpgroups, 64 query rows each
        sm90::setmaxnreg_inc<kConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_lo = wg * 64 + warp * 16 + g;  // this thread's rows of the tile: row_lo, row_lo + 8
        const float scale2 = p.scale * sm90::kLog2e;

        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
        float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;  // raw row maxima, partial row sums

        const uint32_t q_wg = base + L::kQ + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        float sc[kRows / 2];         // S = Q K^T of one KV tile, 64 x 128, then its P
        uint32_t pf[kRows / 16][4];  // P as the A operand of P V, one 16-column k-step each
        float corr_lo = 0.0f, corr_hi = 0.0f;

        // S = Q K^T of KV tile j into sc
        const auto issue_s = [&](int j) {
            const uint32_t k_tile = base + L::kK + (j % kStages) * L::kTile;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                // box kk / 4, then 32 bytes (16 columns) along its swizzled 128-byte rows
                const uint32_t off = (kk / 4) * L::kBox + (kk % 4) * 32;
                sm90::wgmma_ss(sc, sm90::desc_kmajor(q_wg + off), sm90::desc_kmajor(k_tile + off), kk > 0);
            }
        };
        // O += P V of KV tile j, P from pf
        const auto issue_pv = [&](int j) {
            const uint32_t v_tile = base + L::kV + (j % kStages) * L::kTile;
#pragma unroll
            for (int kc = 0; kc < kRows / 16; ++kc) {  // 16 KV rows per k-step: 2048 bytes down V's boxes
                sm90::wgmma_rs_tb(o, pf[kc], sm90::desc_mnmajor(v_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kBox), 1);
            }
        };
        // Mask and exponentiate tile j's scores in place; fold them into the row
        // maxima and partial sums; corr_* take the factor that rescales O.
        const auto softmax = [&](int j) {
            const int kv0 = j * kRows;
            if ((p.causal && j == q_tile) || kv0 + kRows > p.seq) {
#pragma unroll
                for (int i = 0; i < kRows / 2; ++i) {
                    const int col = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
                    const int row = q0 + row_lo + (i & 2) * 4;
                    if (col >= p.seq || (p.causal && col > row)) sc[i] = kNegInf;
                }
            }
            float max_lo = m_lo, max_hi = m_hi;
#pragma unroll
            for (int i = 0; i < kRows / 2; ++i) {
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
            for (int i = 0; i < kRows / 2; ++i) {
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
            for (int kc = 0; kc < kRows / 16; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) pf[kc][r] = sm90::pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
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
        if (wg == 1) pass_turn();
        sm90::mbar_wait(full_q, 0);
        sm90::mbar_wait(full_k(0), 0);
        take_turn();
        issue_s(0);
        sm90::wgmma_commit();
        pass_turn();
        finish_turn();
        if (lane == 0) sm90::mbar_arrive(empty_k(0));
        softmax(0);  // O is still 0: no rescale
        pack_p();
        for (int j = 1; j < kv_tiles; ++j) {
            sm90::mbar_wait(full_k(j % kStages), (j / kStages) & 1);
            sm90::mbar_wait(full_v((j - 1) % kStages), ((j - 1) / kStages) & 1);
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
            for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_hi : corr_lo;
            pack_p();
        }
        const int last = kv_tiles - 1;
        sm90::mbar_wait(full_v(last % kStages), (last / kStages) & 1);
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
        __nv_bfloat16* o_base = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
            const int col = c * 8 + t * 2;
            if (row_a < p.seq) {
                *reinterpret_cast<__nv_bfloat162*>(o_base + row_a * p.o_st + col) =
                    __floats2bfloat162_rn(o[4 * c] / denom_lo, o[4 * c + 1] / denom_lo);
            }
            if (row_b < p.seq) {
                *reinterpret_cast<__nv_bfloat162*>(o_base + row_b * p.o_st + col) =
                    __floats2bfloat162_rn(o[4 * c + 2] / denom_hi, o[4 * c + 3] / denom_hi);
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

template <int D>
int launch_bf16(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, const Bf16Params& p, int batch,
                cudaStream_t stream) {
    constexpr size_t smem = ForwardTiles<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(flash_forward_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * p.heads, (p.seq + kRows - 1) / kRows);
    flash_forward_bf16<D><<<grid, kThreadsBf16, smem, stream>>>(q, k, v, p);
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

// q, k, v: [B, T, H, D] bf16, each described by its TMA geometry (sm90::TmaGeometry:
// dims, byte strides, box of 64 columns x 128 rows) -> out [B, T, H, D] bf16
// (strides in elements) and lse [B, H, T] fp32 contiguous.
extern "C" int hm_flash_forward_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                                     int batch, int seq, int heads, int head_dim,
                                     const long long* q_geometry, const long long* k_geometry,
                                     const long long* v_geometry, long long o_sb, long long o_st, long long o_sh,
                                     int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
    const void* bases[3] = {q, k, v};
    const long long* geometries[3] = {q_geometry, k_geometry, v_geometry};
    CUtensorMap maps[3];
    for (int i = 0; i < 3; ++i) {
        const int err = sm90::encode_tma_map(&maps[i], bases[i], *reinterpret_cast<const sm90::TmaGeometry*>(geometries[i]),
                                             kRows, head_dim);
        if (err != 0) return err;
    }
    const Bf16Params p{out, lse, seq, heads, o_sb, o_st, o_sh, scale, causal};
    if (head_dim == 64) return launch_bf16<64>(maps[0], maps[1], maps[2], p, batch, stream);
    return launch_bf16<128>(maps[0], maps[1], maps[2], p, batch, stream);
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
